"""The GFF3 search's query reader (`formats/fasta.py::read_queries`) and the
strands `tools/driver.py::gff_search` builds from it, held to the JAX
package's parse of the same bytes (`gecoz_tpu/tools/driver.py::gff_search`:
its `iter_fasta` and per-record loop, which the port ran before), on the
CPU.

Each case is a query file: the bulk path (FASTA, FASTQ in 4-line records)
and the fallback to `iter_fasta` (any other shape, headers that are not
UTF-8) must give the same headers, sequences with U read as T, reverse
complements and pattern order, byte for byte, and take the path expected.
`gff_search` runs on both tiers with the index and the search replaced by
fakes that record what they are asked and answer one hit a pattern, so
its rows and its counters `search.query_records` and
`search.query_records_bulk` are held too.
"""

import gzip
import importlib.util
import io
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from gecoz_tpu.formats.fasta import iter_fasta as ref_iter_fasta
from gecoz_tpu.tools.driver import _COMPLEMENT as REF_COMPLEMENT
from gecoz_tpu_torch.codec.gzip_file import GzipFileWriter
from gecoz_tpu_torch.formats.fasta import read_queries
from gecoz_tpu_torch.tools import driver
from gecoz_tpu_torch.utils import metrics

BULK, FALLBACK = True, False

CASES = {
    "fasta_one_line": (b">r1\nACGT\n>r2 two|x\nGGTTA\n", BULK),
    "fasta_multi_line": (b">r1\nACGT\nAC\n>r2\nGG\nTT\nA\n", BULK),
    "crlf": (b">r1\r\nACGT\r\n>r2\r\nGG\r\nTA\r\n", BULK),
    "cr_cr_lf_and_a_last_cr": (b">r1\r\r\nACGT\r\r\n>r2 x\r\nGG\r", BULK),
    "cr_inside_a_line": (b">r\r1\nAC\rGT\n", BULK),
    "blank_lines": (b"\n>r1\n\nACGT\n\n>r2\nGG\n\n\n", BULK),
    "lines_before_the_first_header": (b"junk\nACGT\n>r1\nAC\n", BULK),
    "no_header": (b"ACGT\nACGT\n", BULK),
    "empty_file": (b"", BULK),
    "last_line_without_newline": (b">r1\nACGT\n>r2\nGG", BULK),
    "empty_records": (b">r1\n>r2\nAC\n>r3\n", BULK),
    "lowercase_and_u": (b">r1\nacguACGU\n>r2\nUUuu\n>U\nU\n", BULK),
    "n_and_iupac": (b">r1\nACGTNRYKMSWBDHV\n>r2\nnnNN\n", BULK),
    "sequence_not_utf8": (b">r1\nAC\xffGT\n", BULK),
    "fastq_quality_starts_with_at_or_plus":
        (b"@r1\nACGT\n+\n@III\n@r2\nGGA\n+r2\n+II\n@r3\nU\n+\n>\n", BULK),
    "fastq_crlf": (b"@r1\r\nACGT\r\n+\r\nIIII\r\n", BULK),
    "fastq_multi_line":
        (b"@r1\nACGT\nAC\n+\nIIII\nII\n@r2\nGG\n+\nII\n", FALLBACK),
    "fastq_empty_sequence": (b"@r1\n\n+\n\n@r2\nAC\n+\nII\n", FALLBACK),
    "fastq_without_its_last_quality": (b"@r1\nAC\n+\n", FALLBACK),
    "fastq_sequence_line_starting_with_gt":
        (b"@r1\n>AC\n+\nIII\n@r2\nAC\n+\nII\n", FALLBACK),
    "fastq_sequence_line_starting_with_at":
        (b"@r1\n@AC\n+\nIII\n@r2\nAC\n+\nII\n", FALLBACK),
    "fasta_line_starting_with_plus":
        (b">r1\nAC\n+GT\n>r2\nAA\n>r3\nCC\n", FALLBACK),
    "fasta_header_line_starting_with_at": (b">r1\nAC\n@r2\nGT\n", FALLBACK),
    "header_not_utf8": (b">r1\nAC\n>r\xff2\nGT\n", UnicodeDecodeError),
}


def _long_fasta(rng, width):
    seqs = np.frombuffer(b"ACGTUN", np.uint8)[rng.integers(0, 6, (300, 97))]
    out = bytearray()
    for i, s in enumerate(seqs):
        out += b">q%d|chr\n" % i
        s = s.tobytes()
        out += b"".join(s[j:j + width] + b"\n" for j in range(0, len(s),
                                                             width))
    return bytes(out)


def _simulated_reads(path: Path) -> None:
    """10^4 reads made and written as the benchmark's search traffic does
    (`benchmarks/gzbench/data.py`), from a fixed seed."""
    src = Path(__file__).resolve().parent.parent / "benchmarks" / "gzbench" \
        / "data.py"
    spec = importlib.util.spec_from_file_location("gzbench_data", src)
    data = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(data)
    rng = data.rng_for(2 ** 33 + 17, "queries/0")
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 20_000)]
    genome[5_000:5_400] = ord("N")
    q = dict(count=10_000, length=150, differences=0.021,
             reverse_complement=0.5, avoid="N", header="read")
    data.write_queries(path, data.simulated_reads(rng, [("chr21", genome)],
                                                  q))


def _write(path: Path, case: str) -> Path:
    rng = np.random.default_rng(5)
    if case == "gzip":
        path.write_bytes(gzip.compress(_long_fasta(rng, 60)))
    elif case == "bgzf":
        with GzipFileWriter(path, bgzf=True) as w:     # several members
            w.write(_long_fasta(rng, 7) * 4)
    elif case == "benchmark_reads":
        _simulated_reads(path)
    else:
        path.write_bytes(CASES[case][0])
    return path


EXPECT = {c: want for c, (_, want) in CASES.items()} | {
    "gzip": BULK, "bgzf": BULK, "benchmark_reads": BULK}


def _before(path):
    """The reference's query parse (gecoz_tpu/tools/driver.py::gff_search):
    one `iter_fasta` record at a time, U read as T and the reverse
    complement per record."""
    queries = []
    for q in ref_iter_fasta(path):
        seq = bytes(q.data).replace(b"U", b"T")
        queries.append((q.header, seq, seq[::-1].translate(
            REF_COMPLEMENT)))
    return queries, [s for _, f, r in queries for s in (f, r)]


class _FakeIndex:
    """One block of one record; every pattern searched has one hit, at its
    index in the order searched."""

    def __init__(self):
        self.headers = [SimpleNamespace(headers=["chrA"])]
        self.searched = []

    def read(self, bheader):
        return self

    def find(self, pattern):
        self.searched.append(pattern)
        return {0: [len(self.searched) - 1]}


@pytest.mark.parametrize("tier", ["device", "numpy"])
@pytest.mark.parametrize("case", sorted(EXPECT))
def test_query_reader_matches_the_record_loop(tmp_path, monkeypatch, case,
                                              tier):
    path = _write(tmp_path / "q.fa", case)
    want = EXPECT[case]
    index = _FakeIndex()
    monkeypatch.setattr(driver, "GecozReader", lambda path: index)

    def batched(fm, pats, dev):
        assert str(dev) == "cpu"
        return {i: fm.find(p) for i, p in enumerate(pats)}

    monkeypatch.setattr(driver, "find_batched", batched)
    if want is UnicodeDecodeError:
        with pytest.raises(UnicodeDecodeError):
            _before(path)
        with pytest.raises(UnicodeDecodeError):
            read_queries(path)
        with pytest.raises(UnicodeDecodeError):
            driver.gff_search("x.gcz", path, out=io.StringIO(),
                              backend=tier, device="cpu")
        return
    queries, patterns = _before(path)
    headers, seqs, bulk = read_queries(path)
    assert bulk is want
    fwd, rev = driver._strands(seqs)
    assert list(zip(headers, fwd, rev)) == queries
    if case == "benchmark_reads":
        assert len(queries) == 10_000

    metrics.reset()
    sink = io.StringIO()
    driver.gff_search("x.gcz", path, out=sink, backend=tier, device="cpu")
    assert index.searched == patterns
    rows = io.StringIO()
    for qi, (header, f, _) in enumerate(queries):
        for si, reverse in ((2 * qi, False), (2 * qi + 1, True)):
            driver._gff_row(rows, "chrA", si, len(f), reverse, header)
    assert sink.getvalue() == rows.getvalue()
    st = metrics.stats()
    assert st["search.query_records"].count == len(queries)
    assert st["search.query_records_bulk"].count == (len(queries) * bulk)
