"""Host FM-index: `decode.host_bwt` (the BWT out of the wavelet tree, on the host), ms per decompress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "decode.host_bwt")
