"""Query state and tables: `lift.gcx` (the .gcx's sampled rows and values
decoded on the host and sorted for the lift), ms per decompress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "lift.gcx")
