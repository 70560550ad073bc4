"""Decompress control: the reference's FASTA with every N written as A (a
2-bit decode: not lossless)."""

from pathlib import Path

import numpy as np

from gzbench.control import in_place_of
from gzbench.operations import gcz_order
from gzref import fasta as ref_fasta


def replaced(op):
    def decompress(ipath, opath, **_kw):
        two_bit = {h: np.where(s == ord("N"), ord("A"), s).astype(np.uint8)
                   for h, s in op.by_header.items()}
        Path(opath).write_bytes(ref_fasta.fasta_bytes(gcz_order(ipath),
                                                      two_bit))
    return in_place_of("decompress", lambda _orig: decompress)
