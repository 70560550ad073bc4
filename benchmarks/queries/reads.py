"""Query kind `reads`: sequencing reads in the manner of wgsim, drawn from
the records' bases (`data.simulated_reads`).  A mix whose `queries` name
no `kind` is of this kind.  The generator itself stays in
`gzbench/data.py`, which `tests/test_torch_query_reader.py` loads by its
path, with no `gzbench` package to import, to write the benchmark's reads.

A query kind is `queries/<kind>.py` with `queries(rng, records, q)`, the
(header, sequence) records of one query file drawn with `rng` from the
records by the mix's `queries` parameters `q`, and `SMALL`, the `q` keys
that cut a mix to the size of a CPU test.  Every seed gets the same sizes.
"""

from gzbench.data import simulated_reads as queries  # noqa: F401

SMALL = {"count": 200}
