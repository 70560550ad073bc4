"""Block encode, suffix sort and SA state: `mesh.sa` (the host bounds, the sort on the card, the sampled-SA state), ms per compress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "mesh.sa")
