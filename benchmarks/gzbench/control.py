"""The control: one guarantee of the configuration broken, the step a
faster version would be tempted to take.  The judge has to find it wrong.

* compress: the program's own compress with the suffix array sampled at
  twice the configured rate (a smaller `.gcx`, the configured `.gcz`);
* decompress: the reference's FASTA with every N written as A (a 2-bit
  decode: not lossless);
* search: the reference's rows of the reads as written alone, the reverse
  complements left unsearched (half the patterns: the search the
  configuration's "both strands" rules out).

`replaced(op)` patches the program's driver for as long as it is entered;
`benchmarks/control.py` runs it on the card, the tests on the CPU.
"""

from __future__ import annotations

import contextlib
import io
from pathlib import Path

import numpy as np

from gzref import fasta as ref_fasta
from gzref import gcz as ref_gcz
from gzref import search as ref_search


def _read_fasta(path: Path) -> list[tuple[str, bytes]]:
    out, header, parts = [], None, []
    for line in Path(path).read_bytes().splitlines():
        if line.startswith(b">"):
            if header is not None:
                out.append((header, b"".join(parts)))
            header, parts = line[1:].decode(), []
        elif line:
            parts.append(line)
    if header is not None:
        out.append((header, b"".join(parts)))
    return out


@contextlib.contextmanager
def replaced(op):
    from gecoz_tpu_torch.tools import driver
    records = op.by_header
    saved = (driver.index_fasta, driver.decompress, driver.gff_search)

    def compress(ipath, opath, xpath=None, sampling=32, **kw):
        saved[0](ipath, opath, xpath, sampling=2 * sampling, **kw)

    def decompress(ipath, opath, **_kw):
        order = [h for b in ref_gcz.block_headers(Path(ipath).read_bytes())
                 for h in b]
        two_bit = {h: np.where(s == ord("N"), ord("A"), s).astype(np.uint8)
                   for h, s in records.items()}
        Path(opath).write_bytes(ref_fasta.fasta_bytes(order, two_bit))

    def gff_search(ref_path, fasta_path, out=None, **_kw):
        order = [h for b in ref_gcz.block_headers(Path(ref_path).read_bytes())
                 for h in b]
        rows = ref_search.expected_rows([_read_fasta(fasta_path)], order,
                                        records, op.device)[0]
        sink = out if out is not None else io.StringIO()
        sink.write("".join(row + "\n" for row in rows
                           if row.split("\t")[6] == "+"))

    driver.index_fasta, driver.decompress, driver.gff_search = (
        compress, decompress, gff_search)
    try:
        yield
    finally:
        driver.index_fasta, driver.decompress, driver.gff_search = saved
