"""FASTA reader: `index.read_fasta`, ms per compress."""

from gzbench.layers import span_ms


def read(ctx):
    return span_ms(ctx, "index.read_fasta")
