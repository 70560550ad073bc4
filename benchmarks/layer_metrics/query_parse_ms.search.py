"""FASTA reader: `search.read_queries` (the query file parsed, U read as T,
each read's reverse complement, the patterns listed), ms per search."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "search.read_queries")
