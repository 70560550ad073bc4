"""Query state and tables: the share of the sampled values lifted that the
device decoded from the .gcx's packed bits (counter `lift.gcx_values_device`
over `lift.gcx_values`, both counted once a lifted block), in the measured
window."""


def read(ctx):
    values = ctx.spans.get("lift.gcx_values")
    if values is None or not getattr(values, "count", 0):
        return None
    device = ctx.spans.get("lift.gcx_values_device")
    return getattr(device, "count", 0) / values.count
