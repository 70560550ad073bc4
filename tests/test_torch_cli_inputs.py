"""Inputs the port's CLI refuses or answers on purpose (ROADMAP C7, C8, C9).

The reference shares each of these faults; the port repairs them as
deliberate divergences, and gecoz_tpu stays as it is.

* C7, empty query patterns.  An empty record of a GFF3 query FASTA gives
  no row on any tier, and the other records' rows are the reference CLI's
  rows for those records alone.  (The reference's device tier, and the
  port's before the repair, wrote rows `0  -1` for it; its host tier, and
  the port's, raised `IndexError`; a file of empty records made the
  device tier raise.)  `-c ""` and `-s [HEADER] ""` exit 1.
* C8, `--sampling` that is not a power of 2 exits 1 and writes nothing:
  no `.gcz`/`.gcx` is created, and an existing pair is left as it was,
  `--resume` included.  `driver.index_fasta` raises before it opens a
  file.
* C9, a range extract with a negative or non-integer coordinate exits 1
  and writes no `.seq`; `FMIndex.extract` refuses a negative coordinate.
  The in-record cases stay the reference's.

The device tier runs here on the CPU (`--device cpu`, the plain
versions of the card's route).  Everything compared is a byte, an exit
code or an integer: tolerance 0.
"""

import numpy as np
import pytest
import torch

from gecoz_tpu.cli import main as ref_cli
from gecoz_tpu_torch import cli, native
from gecoz_tpu_torch.formats.gcz import GecozReader
from gecoz_tpu_torch.ops import fmq, fmsearch
from gecoz_tpu_torch.tools import batch_search, driver

from conftest import random_dna
from test_gcz_files import write_fasta

torch.set_num_threads(1)

TIERS = {"device": ["--device", "cpu"], "numpy": ["--backend", "numpy"],
         "native": ["--backend", "native"]}


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Three records; the planner puts c2 and c3|x in one block, whose
    record ends an empty pattern used to hit.  Two queries drawn from
    them."""
    tmp = tmp_path_factory.mktemp("genome")
    rng = np.random.default_rng(11)
    records = [("c1|x", random_dna(rng, 400)), ("c2", random_dna(rng, 150)),
               ("c3|x", random_dna(rng, 120))]
    fa, gcz = tmp / "in.fa", tmp / "in.gcz"
    write_fasta(fa, records)
    assert cli.main(["-i", str(fa), "-o", str(gcz), "--device", "cpu"]) == 0
    blocks = [h.headers for h in GecozReader(gcz).headers]
    assert ["c2", "c3|x"] in blocks
    queries = {"q": bytes(records[1][1][10:18]),
               "r|note": bytes(records[0][1][50:60])}
    return fa, gcz, dict((h, bytes(s)) for h, s in records), queries


def _out(capsys, main, argv, rc: int = 0) -> str:
    capsys.readouterr()
    assert main(argv) == rc, argv
    return capsys.readouterr().out


def _queries(path, records) -> None:
    path.write_bytes(b"".join(b">" + h.encode() + b"\n" + s + b"\n"
                              for h, s in records))


# -- C7: empty query patterns ------------------------------------------------

QUERY_FILES = {
    "empty_first": ["", "q"],
    "empty_between": ["q", "", "r|note"],
    "empty_last": ["q", "r|note", ""],
    "all_empty": ["", ""],
}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("name", list(QUERY_FILES))
def test_gff_empty_queries(tmp_path, capsys, genome, tier, name):
    """No row for an empty record, and no malformed row; the other
    records' rows equal the reference CLI's for them alone."""
    if tier == "native" and not native.available():
        pytest.skip("the host library did not build")
    _, gcz, _, queries = genome
    order = QUERY_FILES[name]
    qf, alone = tmp_path / "q.fa", tmp_path / "alone.fa"
    _queries(qf, [(h or f"e{i}", queries.get(h, b""))
                  for i, h in enumerate(order)])
    rows = _out(capsys, cli.main, ["-i", str(gcz), "-s", str(qf)]
                + TIERS[tier])
    for row in rows.splitlines():
        start, end = map(int, row.split("\t")[3:5])
        assert 1 <= start <= end, row
    live = [h for h in order if h]
    if not live:
        assert rows == ""
        return
    _queries(alone, [(h, queries[h]) for h in live])
    want = _out(capsys, ref_cli, ["-i", str(gcz), "-s", str(alone),
                                  "--backend", "numpy"])
    assert want and rows == want


def test_all_empty_queries_build_no_tables(tmp_path, capsys, genome,
                                           monkeypatch):
    """A file of empty records on the device tier exits 0 with no rows,
    and builds no search tables (so it launches no kernel)."""
    _, gcz, _, _ = genome
    qf = tmp_path / "q.fa"
    qf.write_bytes(b">e\n\n>f\n\n")

    def refuse(*_):
        raise AssertionError("search tables were built")
    monkeypatch.setattr(batch_search, "search_tables", refuse)
    assert _out(capsys, cli.main, ["-i", str(gcz), "-s", str(qf),
                                   "--device", "cpu"]) == ""


@pytest.mark.parametrize("argv", [["-c", ""], ["-s", ""], ["-s", "c2", ""],
                                  ["--count", "c1|x", ""]])
def test_empty_count_and_locate_pattern(capsys, genome, argv):
    """`-c ""` and `-s [HEADER] ""` exit 1 with a one-line message and
    print no count."""
    _, gcz, _, _ = genome
    capsys.readouterr()
    assert cli.main(["-i", str(gcz)] + argv) == 1
    got = capsys.readouterr()
    assert got.out == ""
    assert got.err.count("\n") == 1 and "pattern is empty" in got.err


def test_fm_find_empty_pattern(genome):
    """The host tier's `FMIndex.find(b"")` gives the device tier's answer,
    {}; `search_range` refuses the empty pattern."""
    reader = GecozReader(genome[1])
    for h in reader.headers:
        fm = reader.read(h)
        assert fm.find(b"") == {}
        with pytest.raises(ValueError, match="empty"):
            fm.search_range(b"")


def test_find_batched_skips_empty_patterns(genome):
    """Empty patterns get {} in their places; the others' hits are those
    of a batch without them and of `FMIndex.find`."""
    _, gcz, _, queries = genome
    reader = GecozReader(gcz)
    pats = [queries["q"], queries["r|note"]]
    for h in reader.headers:
        fm = reader.read(h)
        got = batch_search.find_batched(fm, [b"", pats[0], b"", pats[1], b""],
                                        "cpu")
        alone = batch_search.find_batched(fm, pats, "cpu")
        assert got[0] == got[2] == got[4] == {}
        for g, a, p in zip((got[1], got[3]), alone, pats):
            want = fm.find(p)
            assert g.keys() == a.keys() == want.keys()
            for k in want:
                assert np.array_equal(g[k], want[k])
                assert np.array_equal(a[k], want[k])
    assert batch_search.find_batched(fm, [], "cpu") == []


def _search_case(genome):
    _, gcz, _, queries = genome
    reader = GecozReader(gcz)
    fm = reader.read(reader.headers[-1])
    blk = fmq.with_kmer_table(fmq.device_block_from_fm(fm, "cpu"))
    arr, lens = batch_search.pack_patterns([queries["q"], b"A"])
    return blk, torch.from_numpy(arr), lens


@pytest.mark.parametrize("fn", ["backward_search_ref", "backward_search",
                                "search_batch"])
def test_search_refuses_length_zero(genome, fn):
    """The search's contract is every length >= 1: a length-0 row would
    seed on the separator.  Both the kernel's wrapper and its plain
    version refuse one."""
    blk, arr, lens = _search_case(genome)
    lens[1] = 0
    call = {"backward_search_ref": fmsearch.backward_search_ref,
            "backward_search": fmsearch.backward_search,
            "search_batch": fmq.search_batch}[fn]
    with pytest.raises(ValueError, match="length must be >= 1"):
        call(blk, arr, torch.from_numpy(lens))


def test_search_checks_the_host_copy(genome):
    """`host_lengths`, the caller's host copy, is what the wrapper checks
    (`find_batched` passes the one it packed), so a call on the card reads
    nothing back; it must hold one length a pattern."""
    blk, arr, lens = _search_case(genome)
    t = torch.from_numpy(lens.copy())
    sp, ep = fmsearch.backward_search(blk, arr, t, lens)
    want = fmsearch.backward_search_ref(blk, arr, t)
    assert torch.equal(sp, want[0]) and torch.equal(ep, want[1])
    bad = lens.copy()
    bad[0] = 0
    with pytest.raises(ValueError, match="length must be >= 1"):
        fmsearch.backward_search(blk, arr, t, bad)
    with pytest.raises(TypeError, match="host lengths"):
        fmsearch.backward_search(blk, arr, t, lens[:1])


# -- C8: the sampling rate ---------------------------------------------------

BAD_SAMPLING = ["0", "-1", "10", "x", "1.5"]


@pytest.mark.parametrize("mode", ["fresh", "existing", "resume"])
@pytest.mark.parametrize("value", BAD_SAMPLING)
def test_bad_sampling_writes_nothing(tmp_path, capsys, genome, value, mode):
    """Exit 1 with one line; no pair is created, and an existing one keeps
    its bytes and its times."""
    fa = genome[0]
    out = tmp_path / "x.gcz"
    pair = (out, out.with_suffix(".gcx"))
    if mode != "fresh":
        assert cli.main(["-i", str(fa), "-o", str(out), "--device",
                         "cpu"]) == 0
    before = [(p.read_bytes(), p.stat().st_mtime_ns) for p in pair
              if p.exists()]
    argv = ["-i", str(fa), "-o", str(out), "--sampling", value, "--device",
            "cpu"] + (["--resume"] if mode == "resume" else [])
    capsys.readouterr()
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "--sampling" in err
    after = [(p.read_bytes(), p.stat().st_mtime_ns) for p in pair
             if p.exists()]
    assert after == before
    assert len(after) == (0 if mode == "fresh" else 2)


@pytest.mark.parametrize("backend", ["device", "numpy"])
@pytest.mark.parametrize("rate", [0, -1, 10])
def test_index_fasta_refuses_sampling_before_opening(tmp_path, genome,
                                                     backend, rate):
    """API callers get a ValueError before the writer opens a file."""
    out = tmp_path / "x.gcz"
    with pytest.raises(ValueError, match="power of 2"):
        driver.index_fasta(genome[0], out, sampling=rate, backend=backend,
                           device="cpu" if backend == "device" else None)
    assert not out.exists() and not out.with_suffix(".gcx").exists()


@pytest.mark.parametrize("rate", ["1", "64"])
def test_valid_sampling_keeps_the_bytes(tmp_path, genome, rate):
    """Powers of 2 still write the reference's bytes."""
    fa = genome[0]
    port, ref = tmp_path / "port.gcz", tmp_path / "ref.gcz"
    assert cli.main(["-i", str(fa), "-o", str(port), "--sampling", rate,
                     "--device", "cpu"]) == 0
    assert ref_cli(["-i", str(fa), "-o", str(ref), "--sampling", rate,
                    "--backend", "numpy"]) == 0
    for ext in (".gcz", ".gcx"):
        assert port.with_suffix(ext).read_bytes() == \
            ref.with_suffix(ext).read_bytes()


# -- C9: range extract coordinates -------------------------------------------

@pytest.mark.parametrize("coords", [["-5", "10"], ["0", "-1"], ["-3"],
                                    ["-10", "-5"], ["a", "3"], ["0", "x"],
                                    ["1.5", "4"]])
def test_extract_refuses_bad_coordinates(tmp_path, capsys, genome, coords):
    """Exit 1 with one line, and no `.seq` (the reference writes the
    records before c2 and their terminators for `c2 -5 10`)."""
    _, gcz, _, _ = genome
    seq = tmp_path / "x.seq"
    capsys.readouterr()
    assert cli.main(["-i", str(gcz), "-o", str(seq), "c2"] + coords) == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "range extract" in err
    assert not seq.exists()


@pytest.mark.parametrize("start,end", [(-5, 10), (0, -1), (-1, None)])
def test_fm_extract_refuses_negative(genome, start, end):
    _, gcz, _, _ = genome
    reader = GecozReader(gcz)
    bheader = reader.find_block("c2")
    fm = reader.read(bheader)
    with pytest.raises(ValueError, match=">= 0"):
        fm.extract(bheader.headers.index("c2"), start, end)


@pytest.mark.parametrize("header,coords", [
    ("c2", ["3", "100"]), ("c2", ["3", "1000"]), ("c2", ["7", "7"]),
    ("c2", ["9", "4"]), ("c2", ["5"]), ("c2", ["500"]), ("c2", ["0", "0"]),
    ("c3|x", ["0", "121"]), ("c1|x", ["390"])])
def test_extract_in_record_edges_equal_reference(tmp_path, genome, header,
                                                 coords):
    """`end` past the record is clamped, `start` >= `end` writes an empty
    file and a missing `end` means the record's end, as in the
    reference."""
    _, gcz, records, _ = genome
    port, ref = tmp_path / "port.seq", tmp_path / "ref.seq"
    assert cli.main(["-i", str(gcz), "-o", str(port), header] + coords) == 0
    assert ref_cli(["-i", str(gcz), "-o", str(ref), header] + coords) == 0
    assert port.read_bytes() == ref.read_bytes()
    a = int(coords[0])
    b = int(coords[1]) if len(coords) > 1 else None
    assert port.read_bytes() == records[header][a:b]
