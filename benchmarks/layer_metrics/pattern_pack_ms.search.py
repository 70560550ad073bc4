"""Search driver: `search.pack` (the non-empty patterns right-aligned into
one matrix by `pack_patterns`), ms per search."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "search.pack")
