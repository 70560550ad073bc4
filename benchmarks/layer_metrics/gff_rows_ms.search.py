"""Driver: `search.rows` (the GFF3 rows written, query by query and strand
by strand), ms per search."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "search.rows")
