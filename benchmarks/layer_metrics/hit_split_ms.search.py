"""Search driver: `search.expand` (each pattern's hit rows listed for the
locate) plus `search.split` (the located hits split into records), ms per
search."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "search.expand", "search.split")
