"""Driver: `decode.reflow` (the decoded text written as 50-column FASTA), ms per decompress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "decode.reflow")
