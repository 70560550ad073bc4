"""Query state and tables: `search.tables` (each block's query state, k-mer, rank and locate tables), ms per search."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "search.tables")
