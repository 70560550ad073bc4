"""Block encode, suffix sort and SA state: `sa.host_bounds` (the host's
passes over the block before the sort: longest run, symbol set, run-key
bits, token table, token count), ms per compress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "sa.host_bounds")
