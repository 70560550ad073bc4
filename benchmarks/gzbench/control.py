"""The control: one guarantee of the configuration broken, the step a
faster version would be tempted to take.  The judge has to find it wrong.

A control is `controls/<name>.py` with `replaced(op)`, a context manager
that puts something else in the program's place for as long as it is
entered.  A mix names its control under `control`; without one, each
operation has its own (`DEFAULT`):

* compress, `compress_sampling_doubled`: the program's own compress with
  the suffix array sampled at twice the configured rate (a smaller `.gcx`,
  the configured `.gcz`);
* decompress, `decompress_two_bit`: the reference's FASTA with every N
  written as A (a 2-bit decode: not lossless);
* search, `search_plus_strand`: the reference's rows of the queries as
  written alone, the reverse complements left unsearched (half the
  patterns: the search the configuration's "both strands" rules out).

`search_one_row` keeps one row of each query and strand, the locate cut
short, which fails where queries occur more than once (peptides, whose
reverse complements rarely occur in a protein, pass the strand control).
`benchmarks/control.py` runs a control on the card, the tests on the CPU.
"""

from __future__ import annotations

import contextlib
import io
from pathlib import Path

from gzbench.named import BENCH, load
from gzbench.operations import gcz_order
from gzref import search as ref_search

CONTROLS = BENCH / "controls"
DEFAULT = {"compress": "compress_sampling_doubled",
           "decompress": "decompress_two_bit",
           "search": "search_plus_strand"}


def replaced(op, name: str | None = None):
    """The control `name` (else the mix's, else the operation's default)
    over operation `op`, as a context manager."""
    name = name or op.traffic.get("control", DEFAULT[op.traffic["operation"]])
    return load(CONTROLS, name, "control").replaced(op)


@contextlib.contextmanager
def in_place_of(verb: str, make):
    """The program's `driver.<verb>` replaced by `make(the original)` while
    entered."""
    from gecoz_tpu_torch.tools import driver
    orig = getattr(driver, verb)
    setattr(driver, verb, make(orig))
    try:
        yield
    finally:
        setattr(driver, verb, orig)


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


def reference_search(op, keep):
    """In place of `driver.gff_search`: the reference's rows of each query
    of the file, of which `keep(rows)` says which are written."""
    def gff_search(ref_path, fasta_path, out=None, **_kw):
        queries = _read_fasta(fasta_path)
        each = ref_search.expected_rows([[q] for q in queries],
                                        gcz_order(ref_path), op.by_header,
                                        op.device)
        sink = out if out is not None else io.StringIO()
        sink.write("".join(row + "\n" for rows in each for row in keep(rows)))
    return in_place_of("gff_search", lambda _orig: gff_search)
