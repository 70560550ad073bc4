"""Block encode, serialization: `mesh.serialize`, ms per compress, summed over the encode's worker threads (so it may exceed its share of the wall)."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "mesh.serialize")
