"""Driver: `index.write` (the encoded blocks written to the .gcz and the
.gcx), ms per compress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "index.write")
