"""Device: 100 minus the share of the traced window in which a kernel, a
copy or a memset ran (their union), in the decompress cells."""

from gzbench.layers import idle_pct


def read(ctx):
    return idle_pct(ctx)
