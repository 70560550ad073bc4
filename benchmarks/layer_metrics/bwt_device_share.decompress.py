"""Query state and tables: the share of the lifted blocks' BWT symbols that
the device decoded from the wavelet tree's stored streams (counter
`lift.bwt_symbols_device` over `lift.bwt_symbols`, both counted once a
lifted block), in the measured window."""


def read(ctx):
    symbols = ctx.spans.get("lift.bwt_symbols")
    if symbols is None or not getattr(symbols, "count", 0):
        return None
    device = ctx.spans.get("lift.bwt_symbols_device")
    return getattr(device, "count", 0) / symbols.count
