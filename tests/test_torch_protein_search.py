"""The GFF3 search over a protein file of many blocks of many records, the
shape of the Swiss-Prot peptide search: the device tier (the card's route,
on the CPU's plain versions) writes the bytes of the host tier, of the
reference CLI's search and of the row loop the port had before its search
kept hits as arrays (query -> strand -> block -> record -> position), on
peptides that occur in several records, an empty query and one with no
hit.  The record ends located on the device equal `FMIndex.e`, the hits
of a block read as a per-pattern sequence equal `FMIndex.find`'s, and a
block's symbol planes built together equal those built one at a time.
"""

import io

import numpy as np
import pytest
import torch

from gecoz_tpu.tools import driver as ref_driver
from gecoz_tpu_torch.formats.gcz import GecozReader
from gecoz_tpu_torch.ops import fmq
from gecoz_tpu_torch.tools import batch_search, driver

from test_gcz_files import write_fasta

PROTEIN = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", np.uint8)


@pytest.fixture(scope="module")
def protein(tmp_path_factory):
    """320 records in families (copies with 10% of residues changed), one
    of 3,000 residues that caps the blocks; tryptic peptides of them."""
    rng = np.random.default_rng(19)
    recs = []
    while len(recs) < 319:
        root = rng.choice(PROTEIN[:20], int(rng.integers(40, 500)))
        for member in range(int(rng.integers(1, 6))):
            seq = root.copy()
            if member:
                at = rng.random(len(seq)) < 0.1
                seq[at] = rng.choice(PROTEIN, int(at.sum()))
            recs.append((f"sp|P{len(recs):05d}|F{len(recs)}_HUMAN Protein "
                         f"OS=Homo sapiens", seq))
    recs = recs[:319] + [("sp|A2ASS6|TITIN_MOUSE Titin",
                          rng.choice(PROTEIN, 3000))]
    d = tmp_path_factory.mktemp("protein")
    fa, gcz = d / "in.fa", d / "in.gcz"
    write_fasta(fa, recs)
    driver.index_fasta(fa, gcz, backend="native")
    peptides = []
    for _, seq in recs[::7]:
        cuts = np.flatnonzero(np.isin(seq, np.frombuffer(b"KR", np.uint8)))
        for a, b in zip(cuts[:-1], cuts[1:]):
            if 7 <= b - a <= 30:
                peptides.append(seq[a + 1:b + 1].tobytes())
    queries = [(f"pep{i}|x", p) for i, p in enumerate(peptides[:60])]
    queries += [("none", b"WWWWWWWWWWWWWWWWWWWWWWWWW"), ("empty", b""),
                ("one|two", bytes(recs[5][1][3:12]))]
    qf = d / "q.fa"
    qf.write_bytes(b"".join(b">" + h.encode() + b"\n" + s + b"\n"
                            for h, s in queries))
    return recs, gcz, qf, queries


def _search(gcz, qf, **kw):
    out = io.StringIO()
    driver.gff_search(gcz, qf, out=out, **kw)
    return out.getvalue()


def _parent_rows(gcz, queries) -> str:
    """The row loop of the port before its search kept hits as arrays: a
    per-pattern {record: positions} for every block (`find_batched`'s
    per-pattern reading), written query by query, strand by strand, block
    by block, record by record."""
    reader = GecozReader(gcz)
    fwd, rev = driver._strands([s for _, s in queries])
    pats = [p for pair in zip(fwd, rev) for p in pair]
    per_block = [(bheader.headers, list(batch_search.find_batched(
        reader.read(bheader), pats, "cpu"))) for bheader in reader.headers]
    out = io.StringIO()
    for qi, (header, f) in enumerate(zip([h for h, _ in queries], fwd)):
        for si, reverse in ((2 * qi, False), (2 * qi + 1, True)):
            for seq_headers, per in per_block:
                for i, hits in sorted(per[si].items()):
                    for p in hits:
                        driver._gff_row(out, seq_headers[i], int(p), len(f),
                                        reverse, header)
    return out.getvalue()


def test_the_file_has_many_blocks_records_and_symbols(protein):
    recs, gcz, _, queries = protein
    reader = GecozReader(gcz)
    assert len(recs) >= 300 and len(reader.headers) >= 5
    assert max(len(b.headers) for b in reader.headers) >= 10
    text = b"\0".join(s.tobytes() for _, s in recs)
    assert len(set(text)) >= 21
    assert sum(text.count(p) > 1 for _, p in queries if p) >= 5


def test_the_device_tier_writes_the_host_tiers_and_the_parents_rows(protein):
    _, gcz, qf, queries = protein
    got = _search(gcz, qf, device="cpu")
    assert got == _search(gcz, qf, backend="numpy")
    assert got == _parent_rows(gcz, queries)
    rows = got.splitlines()
    assert len(rows) > len(queries)                  # shared peptides
    assert not any("\tID=none" in r or "\tID=empty" in r for r in rows)
    assert any("\tID=one;Note=two" in r for r in rows)


def test_the_rows_are_the_reference_clis(protein, tmp_path):
    """The reference's search, on the queries it serves (it keeps C7's
    fault on an empty one)."""
    _, gcz, _, queries = protein
    qf = tmp_path / "q.fa"
    qf.write_bytes(b"".join(b">" + h.encode() + b"\n" + s + b"\n"
                            for h, s in queries if s))
    want = io.StringIO()
    ref_driver.gff_search(gcz, qf, out=want, backend="numpy")
    assert _search(gcz, qf, device="cpu") == want.getvalue()


@pytest.mark.parametrize("budget", [None, "1"])
def test_record_ends_from_the_device_are_fm_e(protein, monkeypatch, budget):
    """With the locate table, and past the budget with the fused LF walk."""
    if budget:
        monkeypatch.setenv("GECOZ_HBM_BYTES", budget)
    _, gcz, _, _ = protein
    reader = GecozReader(gcz)
    for bheader in reader.headers:
        fm = reader.read(bheader)
        blk = batch_search.search_tables(fm, torch.device("cpu"))
        assert blk.has_loc == (budget is None)
        ends = batch_search.record_ends(blk, fm.nseq)
        assert ends.dtype == np.int64 and np.array_equal(ends, fm.e)


def test_block_hits_read_as_fm_find(protein):
    _, gcz, _, queries = protein
    reader = GecozReader(gcz)
    pats = [s for _, s in queries]
    for bheader in reader.headers[:3]:
        fm = reader.read(bheader)
        hits = batch_search.find_batched(fm, pats, "cpu")
        assert len(hits) == len(pats)
        want = [fm.find(p) for p in pats]
        for g, w in zip(hits, want):
            assert g.keys() == w.keys()
            assert all(np.array_equal(g[k], w[k]) for k in w)
        again = batch_search.BlockHits.of(want, len(pats))
        for name in ("pattern", "record", "position"):
            assert np.array_equal(getattr(again, name), getattr(hits, name))
        assert [h.keys() for h in hits[:2]] == [w.keys() for w in want[:2]]
        assert hits[-1].keys() == want[-1].keys()


def test_one_batch_serves_every_block(protein, monkeypatch):
    """The patterns are packed once a search, not once a block."""
    _, gcz, qf, _ = protein
    packed = []
    orig = batch_search.pack_patterns
    monkeypatch.setattr(batch_search, "pack_patterns",
                        lambda pats: packed.append(len(pats)) or orig(pats))
    _search(gcz, qf, device="cpu")
    assert len(packed) == 1


def _planes_one_at_a_time(bwt, symbols):
    """The symbol planes built one plane at a time, each from `_plane`."""
    words, pres, counts = [], [], np.zeros(256, np.int64)
    for s in symbols:
        w, p = fmq._plane(bwt == s)
        words.append(fmq._u32_as_i32(w))
        pres.append(p)
        counts[s] = int((bwt == s).sum())
    return torch.cat(words), torch.cat(pres), counts


@pytest.mark.parametrize("chunk", [1, 3 * 1000, 1 << 24])
@pytest.mark.parametrize("n", [1, 31, 32, 1000, 4099])
def test_planes_built_together_are_those_built_one_at_a_time(monkeypatch,
                                                              chunk, n):
    """All of a block's planes at once (a short block), a few, or one at a
    time (a long one): the same words, prefixes and counts."""
    monkeypatch.setattr(fmq, "PLANE_CHUNK_CHARS", chunk)
    rng = np.random.default_rng(n)
    bwt = torch.from_numpy(rng.choice(np.append(PROTEIN, 0), n))
    symbols = tuple(int(x) for x in np.unique(bwt.numpy()))
    words, pres, c, _ = fmq._symbol_planes(bwt, symbols)
    want_words, want_pres, counts = _planes_one_at_a_time(bwt, symbols)
    assert torch.equal(words, want_words) and torch.equal(pres, want_pres)
    assert np.array_equal(c.numpy(), np.concatenate([[0], np.cumsum(
        counts)]))


@pytest.mark.parametrize("count", [0, 1, 500])
def test_patterns_pack_one_length_at_a_time(count):
    """`pack_patterns` right-aligns each pattern in its row, empty ones
    included, as a row-by-row copy does."""
    rng = np.random.default_rng(count)
    pats = [rng.choice(PROTEIN, int(n)).tobytes()
            for n in rng.integers(0, 40, count)]
    arr, lens = batch_search.pack_patterns(pats)
    assert arr.shape == (count, max(map(len, pats), default=1))
    assert lens.dtype == np.int32 and lens.tolist() == [len(p) for p in pats]
    for row, p in zip(arr, pats):
        assert row[len(row) - len(p):].tobytes() == p
        assert not row[:len(row) - len(p)].any()
