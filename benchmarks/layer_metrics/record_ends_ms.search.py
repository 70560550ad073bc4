"""Query state and tables: `search.ends` (each block's record ends located
on the card, in the blocks with hits), ms per search."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "search.ends")
