"""Block encode, suffix sort and SA state: the card's peak allocation per
base sorted (counter `sa.device_peak_bytes` over `sa.sorted_bases`, both
counted once a block sorted on a CUDA device), in the measured window.
The runner resets the peak at the window's start, so over one-block
compresses this is the window's device peak per base of the block, the
measured counterpart of the 204 bytes a base by which the program routes a
block (`gecoz_tpu_torch/utils/device.py`)."""


def read(ctx):
    peak = ctx.spans.get("sa.device_peak_bytes")
    bases = ctx.spans.get("sa.sorted_bases")
    if not getattr(peak, "count", 0) or not getattr(bases, "count", 0):
        return None
    return peak.count / bases.count
