"""Query state and tables: `decode.lift` (the .gcx decode and the upload of the query state), ms per decompress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "decode.lift")
