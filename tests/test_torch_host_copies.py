"""The port's copies of gecoz_tpu's host modules vs the originals.

The port keeps its own copies of the framework-free host code it needs
(`gecoz_tpu_torch/{utils,huffman,index,formats,tools}`, `ops/sa.py`, the
host C++ in `csrc/host/` bound in `native.py`).  Each copy is held equal
to its gecoz_tpu original on the same seeded inputs: bytes written,
arrays returned, rows printed.  `build_port_fm` is the port's counterpart
of tests/test_fm.py::build_fm for the other port tests.
"""

import gzip
import io

import numpy as np
import pytest

from gecoz_tpu import native as ref_native
from gecoz_tpu.cli import parse_args as ref_parse_args
from gecoz_tpu.formats import fasta as ref_fasta
from gecoz_tpu.formats import gcz as ref_gcz
from gecoz_tpu.huffman import core as ref_core
from gecoz_tpu.huffman import deflate_tables as ref_dt
from gecoz_tpu.index import hswt as ref_hswt
from gecoz_tpu.index import iwt as ref_iwt
from gecoz_tpu.index import rankbv as ref_rankbv
from gecoz_tpu.index import shape as ref_shape
from gecoz_tpu.index import ssa as ref_ssa
from gecoz_tpu.ops import sa as ref_sa
from gecoz_tpu.tools import blocks as ref_blocks
from gecoz_tpu.tools import driver as ref_driver
from gecoz_tpu.tools.batch_search import pack_patterns as ref_pack
from gecoz_tpu.utils import bits as ref_bits
from gecoz_tpu_torch import native
from gecoz_tpu_torch.cli import parse_args
from gecoz_tpu_torch.formats import fasta, gcz
from gecoz_tpu_torch.huffman import core, deflate_tables
from gecoz_tpu_torch.index import fm, hswt, iwt, rankbv, shape, ssa
from gecoz_tpu_torch.ops import sa
from gecoz_tpu_torch.tools import blocks, driver
from gecoz_tpu_torch.tools.batch_search import pack_patterns
from gecoz_tpu_torch.utils import bits, hostmem, metrics

from conftest import random_block, random_dna

SEEDS = [0, 1, 2]


def build_port_fm(data, rate=32):
    """The port's host FM-index of one block (as test_fm.build_fm)."""
    data = np.asarray(data, dtype=np.uint8)
    sa_ = sa.suffix_array_numpy(data)
    bwt = sa.bwt_from_sa(data, sa_)
    shp = shape.HSWTShape.from_counts(np.bincount(data, minlength=256))
    return fm.FMIndex(hswt.HSWT.build(bwt, shp),
                      ssa.SampledSAIndex.build(sa_, rate))


def _block(seed, alphabet=b"ACGTN"):
    rng = np.random.default_rng(seed)
    return random_block(rng, nseq=3, minlen=20, maxlen=700,
                        alphabet=alphabet)


def _skewed(seed, n=3000):
    """A 16-symbol block: deeper Huffman codes, more wavelet nodes."""
    rng = np.random.default_rng(seed)
    s = rng.choice(np.frombuffer(b"ABCDEFGHIJKLMNOP", np.uint8), size=n,
                   p=np.r_[np.full(4, 0.2), np.full(12, 0.2 / 12)])
    s[[n // 3, -1]] = 0
    return s


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_copy(seed):
    rng = np.random.default_rng(seed)
    fields = [(int(rng.integers(0, 1 << w)) if w else 0, int(w))
              for w in rng.integers(0, 40, 200)]
    w_ref, w_port = ref_bits.BitWriter(), bits.BitWriter()
    for v, w in fields:
        w_ref.write(v, w)
        w_port.write(v, w)
    buf = w_port.getvalue()
    assert buf == w_ref.getvalue()
    r = bits.BitReader(buf)
    assert [r.read(w) for _, w in fields] == [v for v, _ in fields]
    flat = rng.integers(0, 2, 1001).astype(np.uint8)
    packed = bits.pack_bits_lsb(flat)
    assert np.array_equal(packed, ref_bits.pack_bits_lsb(flat))
    assert np.array_equal(bits.unpack_bits_lsb(packed, 1001),
                          ref_bits.unpack_bits_lsb(packed, 1001))


@pytest.mark.parametrize("seed", SEEDS)
def test_huffman_copy(seed):
    rng = np.random.default_rng(seed)
    counts = np.zeros(256, np.int64)
    used = rng.choice(256, size=int(rng.integers(2, 60)), replace=False)
    counts[used] = rng.geometric(0.02, size=used.size)
    counts[used[0]] = 10 ** 6                      # one dominant symbol
    bl = core.huffman_bit_lengths(counts)
    assert np.array_equal(bl, ref_core.huffman_bit_lengths(counts))
    for max_bits in (7, 15):
        lim = deflate_tables.restrict_lengths(bl, counts, max_bits)
        assert np.array_equal(lim, ref_dt.restrict_lengths(bl, counts,
                                                          max_bits))
        assert np.array_equal(deflate_tables.canonical_codes(lim),
                              ref_dt.canonical_codes(lim))
        a, b = bits.BitWriter(), ref_bits.BitWriter()
        deflate_tables.write_lengths_table(lim, a)
        ref_dt.write_lengths_table(lim, b)
        assert a.getvalue() == b.getvalue()
        assert deflate_tables.lengths_table_bit_length(lim) == \
            ref_dt.lengths_table_bit_length(lim)
        back = deflate_tables.read_lengths_table(bits.BitReader(
            a.getvalue()), 256)
        assert np.array_equal(back, lim)


@pytest.mark.parametrize("n", [1, 511, 513, 65536 + 77, 200_000])
def test_rankbv_copy(n):
    rng = np.random.default_rng(n)
    b = (rng.random(n) < 0.3).astype(np.uint8)
    port = rankbv.RankBitVector.from_bits(b)
    ref = ref_rankbv.RankBitVector.from_bits(b)
    buf = port.serialize()
    assert buf == ref.serialize()
    back = rankbv.RankBitVector.deserialize(np.frombuffer(buf, np.uint8), n)
    idx = rng.integers(0, n, 300)
    assert np.array_equal(back.rank1(idx), ref.rank1(idx))
    assert np.array_equal(back.get(idx), ref.get(idx))
    assert back.total_ones() == ref.total_ones()
    start, ln = int(rng.integers(0, n)), int(rng.integers(0, n))
    assert np.array_equal(rankbv.slice_packed_bits(port.data, start, ln),
                          ref_rankbv.slice_packed_bits(ref.data, start, ln))


@pytest.mark.parametrize("case", ["dna", "skewed", "tiny"])
def test_shape_and_hswt_copy(case):
    data = {"dna": lambda: _block(3)[0], "skewed": lambda: _skewed(3),
            "tiny": lambda: np.frombuffer(b"A\0", np.uint8).copy()}[case]()
    counts = np.bincount(data, minlength=256)
    pshape = shape.HSWTShape.from_counts(counts)
    rshape = ref_shape.HSWTShape.from_counts(counts)
    assert np.array_equal(pshape.bit_lengths, rshape.bit_lengths)
    assert np.array_equal(pshape.codes, rshape.codes)
    assert pshape.nodes == rshape.nodes and pshape.size == rshape.size
    port = hswt.HSWT.build(data, pshape)
    buf = port.serialize()
    assert buf == ref_hswt.HSWT.build(data, rshape).serialize()
    # HSWT decode of the reference's bytes
    raw = np.frombuffer(buf, np.uint8)
    back = hswt.HSWT.read(raw, len(data))
    assert np.array_equal(back.decode_bwt(), data)
    assert np.array_equal(back.decode_bwt(),
                          ref_hswt.HSWT.read(raw, len(data)).decode_bwt())
    pos = np.arange(0, len(data), 7)
    for sym in np.flatnonzero(counts)[:5]:
        assert np.array_equal(back.occ_batch(int(sym), pos),
                              ref_hswt.HSWT.read(raw, len(data)).occ_batch(
                                  int(sym), pos))


@pytest.mark.parametrize("rate", [4, 32])
def test_ssa_and_iwt_copy(rate):
    data, _ = _block(4)
    sa_ = ref_sa.suffix_array_numpy(data)
    port = ssa.SampledSAIndex.build(sa_, rate)
    buf = port.serialize()
    assert buf == ref_ssa.SampledSAIndex.build(sa_, rate).serialize()
    sf = rate.bit_length() - 1
    assert len(buf) == ssa.index_size(len(data), sf) == \
        ref_ssa.index_size(len(data), sf)
    raw = np.frombuffer(buf, np.uint8)
    got = ssa.SampledSAIndex.deserialize(raw, len(data), sf).sampled_rows()
    want = ref_ssa.SampledSAIndex.deserialize(raw, len(data),
                                              sf).sampled_rows()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(got[1], sa_[got[0]])
    perm = np.random.default_rng(rate).permutation(1000)
    assert iwt.serialize_iwt(perm) == ref_iwt.serialize_iwt(perm)
    assert np.array_equal(iwt.deserialize_iwt(np.frombuffer(
        iwt.serialize_iwt(perm), np.uint8), 1000), perm)


@pytest.mark.parametrize("seed", SEEDS)
def test_fm_copy(seed):
    from test_fm import build_fm
    data, seqs = _block(seed)
    port, ref = build_port_fm(data, 8), build_fm(data, 8)
    assert np.array_equal(port.bwt, ref.bwt)
    assert np.array_equal(port.lf, ref.lf)
    assert np.array_equal(port.decode_text(), data)
    assert np.array_equal(port.decode_walks(0, port.n_walks),
                          ref.decode_walks(0, ref.n_walks))
    raw = bytes(seqs[1])
    pats = [raw[3:3 + n] for n in (1, 2, 5, 11)] + [b"ACG", b"Z", b"N\0"]
    for p in pats:
        got, want = port.find(p), ref.find(p)
        assert got.keys() == want.keys(), p
        for k in want:
            assert np.array_equal(got[k], want[k]), (p, k)
        assert port.count_total(p) == ref.count_total(p), p
        assert port.search_range(p) == ref.search_range(p), p
    for i in range(len(seqs)):
        assert port.extract(i) == ref.extract(i) == bytes(seqs[i])
        assert port.extract(i, 3, 17) == ref.extract(i, 3, 17)
    rows = np.arange(0, len(data), 5)
    assert np.array_equal(port.locate(rows), ref.locate(rows))


@pytest.mark.parametrize("seed", SEEDS)
def test_sa_copy(seed):
    data, _ = _block(seed)
    want = ref_sa.suffix_array_numpy(data)
    assert np.array_equal(sa.suffix_array_numpy(data), want)
    assert np.array_equal(sa.suffix_array(data, backend="numpy"), want)
    assert np.array_equal(sa.bwt_from_sa(data, want),
                          ref_sa.bwt_from_sa(data, want))


def test_host_library_loads():
    assert native.available(), native.error()
    assert native.error() is None


@pytest.mark.parametrize("case", ["dna", "skewed", "runs"])
def test_native_copy(case):
    """The port's host library against gecoz_tpu.native, entry by entry:
    SA-IS, BWT, rank-vector layout, LF build, decode walks, wavelet fill
    and partition."""
    if case == "dna":
        data = _block(5)[0]
    elif case == "skewed":
        data = _skewed(5)
    else:
        data = np.frombuffer(b"A" * 3000 + b"\0" + b"AC" * 800 + b"\0",
                             np.uint8).copy()
    want = ref_native.sais(data)
    got = native.sais(data)
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref_sa.suffix_array_numpy(data))
    assert np.array_equal(sa.suffix_array(data, backend="native"), want)
    bwt = native.bwt(data, got)
    assert np.array_equal(bwt, ref_native.bwt(data, want))
    bits_ = (np.random.default_rng(1).random(70000) < 0.5).astype(np.uint8)
    packed = np.packbits(bits_, bitorder="little")
    size = rankbv.rbv_bytes(len(bits_))
    inter = native.interleave_rbv(packed, len(bits_), size)
    assert np.array_equal(inter, ref_native.interleave_rbv(packed,
                                                           len(bits_), size))
    assert np.array_equal(native.deinterleave_rbv(inter, len(bits_)), packed)
    wrap = int(np.flatnonzero(want == 0)[0])
    lf = native.lf_build(bwt, wrap)
    assert np.array_equal(lf, ref_native.lf_build(bwt, wrap))
    pfm = build_port_fm(data, 8)
    seeds = pfm.walk_seeds()
    assert np.array_equal(
        native.fm_decode_walks(bwt, lf, seeds, 0, len(seeds), 8),
        ref_native.fm_decode_walks(bwt, lf, seeds, 0, len(seeds), 8))
    shp = shape.HSWTShape.from_counts(np.bincount(data, minlength=256))
    got_fill = native.hswt_fill(bwt, shp.codes, shp.bit_lengths, shp.nodes,
                                shp.node_lengths)
    want_fill = ref_native.hswt_fill(bwt, shp.codes, shp.bit_lengths,
                                     shp.nodes, shp.node_lengths)
    assert got_fill.keys() == want_fill.keys()
    for k in want_fill:
        assert np.array_equal(got_fill[k], want_fill[k]), k
    node = got_fill[shp.nodes[0]]
    pos = np.arange(len(bwt), dtype=np.int32)
    for g, w in zip(native.wt_partition(node, pos),
                    ref_native.wt_partition(node, pos)):
        assert np.array_equal(g, w)


def _fasta_bytes(records, width=60):
    out = bytearray()
    for h, s in records:
        out += b">" + h.encode() + b"\n"
        for i in range(0, len(s), width):
            out += bytes(s[i:i + width]) + b"\n"
    return bytes(out)


@pytest.mark.parametrize("kind", ["plain", "gzip", "multi_member", "bgzf",
                                  "gzip_golden", "fastq"])
def test_fasta_copy(tmp_path, kind):
    rng = np.random.default_rng(6)
    records = [(f"s{i} note", random_dna(rng, int(rng.integers(1, 400)),
                                         b"ACGTN")) for i in range(5)]
    body = _fasta_bytes(records)
    path = tmp_path / "in"
    if kind == "plain":
        path.write_bytes(body.replace(b"\n", b"\r\n", 3))
    elif kind == "gzip":
        path.write_bytes(gzip.compress(body))
    elif kind == "multi_member":
        cut = len(body) // 3
        path.write_bytes(gzip.compress(body[:cut])
                         + gzip.compress(body[cut:]))
    elif kind == "fastq":
        path.write_bytes(b"".join(b"@%s\n%s\n+\n%s\n" % (
            h.encode(), bytes(s), b"I" * len(s)) for h, s in records))
    else:
        from pathlib import Path
        golden = Path(__file__).parent / "golden"
        path = golden / ("tiny.bgzf" if kind == "bgzf" else "tiny.fa.gz")
    got = list(fasta.iter_fasta(path))
    want = list(ref_fasta.iter_fasta(path))
    assert [(r.header, bytes(r.data), r.length, r.multiline) for r in got] \
        == [(r.header, bytes(r.data), r.length, r.multiline) for r in want]
    with fasta._open_maybe_gzip(path) as a, \
            ref_fasta._open_maybe_gzip(path) as b:
        raw = a.read()
        assert raw == b.read() and len(raw) > 100
    lazy = list(fasta.iter_fasta(path, lazy=True))
    for r, w in zip(lazy, want):
        assert r.position == w.position
        assert bytes(fasta.read_sequence(path, r)) == bytes(w.data)
    for r in got:
        rec = fasta.format_fasta_record(r.header, r.data)
        assert rec == ref_fasta.format_fasta_record(r.header, r.data)
        assert len(rec) == fasta.record_size(r.header, r.length)


def test_fasta_segments_copy():
    """The reflow writer: random segment cuts fill the record exactly."""
    rng = np.random.default_rng(7)
    for n in (1, 49, 50, 51, 100, 997):
        data = random_dna(rng, n)
        size = fasta.record_size("h", n)
        mm = np.zeros(size, np.uint8)
        mm[:3] = np.frombuffer(b">h\n", np.uint8)
        cuts = np.unique(np.r_[0, rng.integers(0, n, 4), n])
        for a, b in zip(cuts[:-1], cuts[1:]):
            fasta.write_fasta_segment(mm, 0, 3, n, a, b, data[a:b])
        assert mm.tobytes() == ref_fasta.format_fasta_record("h", data)


@pytest.mark.parametrize("seed", SEEDS)
def test_gcz_copy(tmp_path, seed):
    """Host encode bytes, header helpers, and the reader on files the
    reference wrote."""
    data, seqs = _block(seed)
    headers = [f"chr{i}" for i in range(len(seqs))]
    for backend in ("native", "numpy"):
        assert gcz.encode_block_host(data, headers, 16, backend) == \
            ref_gcz.encode_block(data, headers, 16, backend=backend)
    assert gcz.header_hash(headers) == ref_gcz.header_hash(headers)
    assert gcz.write_ssa_header(headers, 77) == \
        ref_gcz.write_ssa_header(headers, 77)
    assert gcz.ref_header_length(headers) == \
        ref_gcz.ref_header_length(headers)
    out = tmp_path / "r.gcz"
    with ref_gcz.GecozWriter(out, sampling_rate=8, backend="native") as w:
        w.write(headers, data)
        w.write(["solo"], data[:len(seqs[0]) + 1])
    port, ref = gcz.GecozReader(out), ref_gcz.GecozReader(out)
    assert gcz.check_format(out) and not gcz.check_format(tmp_path / "x")
    assert port.sampling_factor == ref.sampling_factor == 3
    assert port.offsets == ref.offsets
    assert [h.headers for h in port.headers] == \
        [h.headers for h in ref.headers]
    assert [h.write() for h in port.headers] == \
        [h.write() for h in ref.headers]
    for ph, rh in zip(port.headers, ref.headers):
        a, b = port.read(ph), ref.read(rh)
        assert np.array_equal(a.bwt, b.bwt)
        assert np.array_equal(a.decode_text(), b.decode_text())
        for g, w in zip(a.index.sampled_rows(), b.index.sampled_rows()):
            assert np.array_equal(g, w)
    assert port.find_block("solo") is port.headers[1]
    assert gcz.default_gcx_path(out) == ref_gcz.default_gcx_path(out)


@pytest.mark.parametrize("seed", SEEDS)
def test_blocks_copy(seed):
    rng = np.random.default_rng(seed)
    seqs = [fasta.FastaSequence(f"s{i}", int(n), 0, False)
            for i, n in enumerate(rng.integers(1, 5000, 12))]
    rseqs = [ref_fasta.FastaSequence(s.header, s.length, 0, False)
             for s in seqs]
    got = [[s.header for s in b.sequences] for b in blocks.plan_blocks(seqs)]
    want = [[s.header for s in b.sequences]
            for b in ref_blocks.plan_blocks(rseqs)]
    assert got == want


@pytest.mark.parametrize("argv", [
    [], ["-h"], ["-i", "a.fa", "-o", "b.gcz", "-v", "INFO"],
    ["-i", "x.gcz", "-o", "c.seq", "chr1", "10", "90", "-t", "4"],
    ["-i", "x.gcz", "-s", "chr2", "ACGT", "--check", "--deep"],
    ["stray", "-c", "AC", "--backend", "numpy", "--device", "cpu"]])
def test_parse_args_copy(argv):
    assert parse_args(argv) == ref_parse_args(argv)


def test_pack_patterns_and_gff_rows_copy():
    pats = [b"ACGT", b"A", b"GATTACA" * 3, b""]
    for g, w in zip(pack_patterns(pats), ref_pack(pats)):
        assert np.array_equal(g, w)
    a, b = io.StringIO(), io.StringIO()
    for args in (("chr1", 0, 5, False, "q1"), ("chr2 x", 99, 12, True,
                                                "r|note one|two"),
                 ("c", 7, 1, False, "")):
        driver._gff_row(a, *args)
        ref_driver._gff_row(b, *args)
    assert a.getvalue() == b.getvalue()
    assert driver._COMPLEMENT == ref_driver._COMPLEMENT
    assert driver.DECODE_CHUNK == ref_driver.DECODE_CHUNK


@pytest.mark.parametrize("verb", ["count", "locate", "extract", "check",
                                  "resume"])
def test_host_verbs_copy(tmp_path, verb):
    """The host verbs of the port's driver print and write what the
    reference's do, on a file the reference wrote."""
    rng = np.random.default_rng(8)
    records = [("chr1", random_dna(rng, 3000)),
               ("chr2 b", random_dna(rng, 900, b"ACGTN")),
               ("chr3", random_dna(rng, 60))]
    fa = tmp_path / "in.fa"
    fa.write_bytes(_fasta_bytes(records))
    out = tmp_path / "x.gcz"
    ref_driver.index_fasta(fa, out, backend="native")
    pat = bytes(records[0][1][100:104]).decode()

    def both(fn_port, fn_ref, *args, **kw):
        a, b = io.StringIO(), io.StringIO()
        ra = fn_port(*args, out=a, **kw)
        rb = fn_ref(*args, out=b, **kw)
        assert ra == rb and a.getvalue() == b.getvalue()
        return a.getvalue()

    if verb in ("count", "locate"):
        show = verb == "locate"
        assert both(driver.match, ref_driver.match, out, None, pat, show)
        assert both(driver.match, ref_driver.match, out, "chr2 b", pat[:2],
                    show)
    elif verb == "extract":
        for args in (("chr1", 10, 900), ("chr3", 0, None), ("chr2 b", 5, 6)):
            a, b = tmp_path / "a.seq", tmp_path / "b.seq"
            driver.extract_range(out, *args, a)
            ref_driver.extract_range(out, *args, b)
            assert a.read_bytes() == b.read_bytes()
    elif verb == "check":
        assert "ok" in both(driver.check, ref_driver.check, out, deep=True)
        gcx = out.with_suffix(".gcx")
        gcx.write_bytes(gcx.read_bytes()[:-9] + b"\x55" * 9)
        both(driver.check, ref_driver.check, out, deep=True)
    else:
        plan = blocks.plan_blocks(list(fasta.iter_fasta(fa, lazy=True)))
        rplan = ref_blocks.plan_blocks(list(ref_fasta.iter_fasta(fa,
                                                                 lazy=True)))
        gcx = out.with_suffix(".gcx")
        whole = out.read_bytes(), gcx.read_bytes()
        for cut in ref_gcz.GecozReader(out).offsets[1:] + [len(whole[0])]:
            results = []
            for fn, p in ((driver._resume_prefix, plan),
                          (ref_driver._resume_prefix, rplan)):
                out.write_bytes(whole[0][:cut] + b"Gecoz")   # a torn tail
                gcx.write_bytes(whole[1])
                results.append((fn(out, None, p, 32), out.read_bytes(),
                                gcx.read_bytes()))
            assert results[0] == results[1]
            assert results[0][0] >= 1


def test_metrics_and_hostmem_copy():
    metrics.reset()
    with metrics.phase("copy.test", 1000):
        hostmem.warm_for_block(1 << 16)
    st = metrics.stats()["copy.test"]
    assert st.calls == 1 and st.bytes == 1000 and st.seconds >= 0
    assert "copy.test" in metrics.report()
    metrics.reset()
    assert metrics.stats() == {}
