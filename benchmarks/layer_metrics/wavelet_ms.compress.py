"""Block encode, wavelet tree: `mesh.wavelet`, ms per compress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "mesh.wavelet")
