"""The port on the card: CUDA kernels, encode and query paths (marker `gpu`).

These tests need a CUDA card and skip elsewhere, deciding inside a fixture.
They import no JAX, so they also run where JAX is absent (the card's
machine); there `tests/conftest.py`, which imports JAX, is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

The oracles are the port's plain versions and its host tier (the copies
of gecoz_tpu's host modules, held equal to them on the CPU by
tests/test_torch_host_copies.py).
"""

import numpy as np
import pytest
import torch

from gecoz_tpu_torch.index import iwt, rankbv, ssa
from gecoz_tpu_torch.index.hswt import HSWT
from gecoz_tpu_torch.ops import fmq, fmsearch, gcx, hswt_device, lfwalk, scan
from gecoz_tpu_torch.ops.fmq import block_to_numpy
from gecoz_tpu_torch.ops.pipeline import index_block
from gecoz_tpu_torch.ops.sa import bwt_from_sa, suffix_array_numpy
from gecoz_tpu_torch.ops.sa_device import suffix_array_device

from test_torch_hswt_device import BLOCKS, block, read_back

pytestmark = pytest.mark.gpu

ENTRIES = ("cumsum_i32", "cummax_i32", "cummin_rev_i32", "fill_fwd_i32",
           "fill_rev_i32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scan kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _inputs(name, n, gen):
    if name.startswith("fill"):
        x = np.full(n, -1, np.int32)
        marks = gen.choice(n, size=max(1, n // 100), replace=False)
        x[marks] = gen.integers(0, 1 << 30, size=marks.size)
        x[: n // 10] = -1
        return x
    return gen.integers(-2 ** 31, 2 ** 31, size=n,
                        dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("n", [1, 777, 4096, 4097, 65536, 2 * 65536 + 7,
                               (1 << 22) + 3])
def test_kernel_matches_plain(cuda, n, gen):
    for name in ENTRIES:
        x = torch.from_numpy(_inputs(name, n, gen)).to(cuda)
        before = scan.LAUNCHES[name]
        got = getattr(scan, name)(x)
        torch.cuda.synchronize()
        assert scan.LAUNCHES[name] == before + 1
        assert torch.equal(got, getattr(scan, name + "_ref")(x)), (name, n)


# the one-pass scan's tile edges, T the path's tile: one tile and its
# neighbours, a ragged second tile, a look-back past one warp's window of 32
# tiles, and one of 40 such windows
TILE_EDGES = {"T-1": (1, -1), "T": (1, 0), "T+1": (1, 1), "2T+7": (2, 7),
              "33T+1": (33, 1), "1280T+5": (40 * 32, 5)}
# op -> its plain forward scan; the reverse one runs it on the flipped input
PLAIN = {"add": scan.cumsum_i32_ref, "max": scan.cummax_i32_ref,
         "min": lambda x: scan.cummin_rev_i32_ref(x.flip(0)).flip(0),
         "last": scan.fill_fwd_i32_ref}
ENTRY_OF = {"add": "cumsum_i32", "max": "cummax_i32", "min": "cummin_rev_i32",
            "last": "fill_fwd_i32"}


def _plain_scan(op, reverse, x):
    return PLAIN[op](x.flip(0)).flip(0) if reverse else PLAIN[op](x)


@pytest.mark.parametrize("edge", list(TILE_EDGES))
def test_one_pass_scan_at_tile_edges(cuda, gen, edge):
    """Every op in both directions at the tile edges, on views that start
    0, 4 and 12 bytes past a 16-byte boundary (head and tail take the
    scalar path, n % 4 != 0 included); fills on sparse marks, on no mark at
    all and on a single mark at either end (in the last tile of one
    direction, carried through every tile's look-back in the other); int32
    adds that wrap.  One launch counted a call."""
    tiles, extra = TILE_EDGES[edge]
    n = tiles * scan._lib().gecoz_scan_tile() + extra
    full = gen.integers(-2 ** 31, 2 ** 31, size=n + 3,
                        dtype=np.int64).astype(np.int32)
    marks = _inputs("fill_fwd_i32", n + 3, gen)
    none = np.full(n + 3, -1, np.int32)
    for off in (0, 1, 3):
        first, last = none.copy(), none.copy()
        first[off], last[off + n - 1] = 12345, 678
        for op in PLAIN:
            cases = (marks, none, first, last) if op == "last" else (full,)
            for host in cases:
                buf = torch.from_numpy(host).to(cuda)
                x = buf[off:off + n]
                assert x.data_ptr() % 16 == 4 * off
                for reverse in (False, True):
                    name = ENTRY_OF[op]
                    before = scan.LAUNCHES[name]
                    got = scan._scan_cuda(x, op, reverse, name)
                    torch.cuda.synchronize()
                    assert scan.LAUNCHES[name] == before + 1
                    assert torch.equal(got, _plain_scan(op, reverse, x)), (
                        op, reverse, off, n)


def test_scan_sweep_shapes_match_plain(cuda, gen):
    """The add at the three tile shapes chip_smoke.py times."""
    for n in (1, 4095, 8193, 3 * 8192 + 5, 70 * 8192 + 3):
        x = torch.from_numpy(_inputs("cumsum_i32", n + 1, gen)).to(cuda)[1:]
        want = scan.cumsum_i32_ref(x)
        for shape in (0, 1, 2):
            assert torch.equal(scan._sweep_launch(x, shape), want), (n, shape)


def test_scan_kernels_load_before_the_first_launch(cuda):
    scan._lib()
    assert scan.INIT_SECONDS is not None


def _genomic(gen, n=1 << 16):
    s = gen.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    s[500:500 + n // 8] = ord("N")
    s[n // 3] = 0
    s[-1] = 0
    return s


def test_suffix_sort_on_card(cuda, gen):
    s = _genomic(gen)
    want = suffix_array_numpy(s)
    for impl in ("runs", "kmer"):
        sa, bwt = suffix_array_device(s, impl=impl, with_bwt=True,
                                      device=cuda)
        assert sa.is_cuda and sa.dtype == torch.int32
        assert np.array_equal(sa.cpu().numpy(), want), impl
        assert np.array_equal(bwt.cpu().numpy(), bwt_from_sa(s, want))


def test_index_block_card_equals_cpu(cuda, gen):
    s = _genomic(gen)
    for sa_impl in ("runs", "kmer"):
        a = block_to_numpy(index_block(torch.from_numpy(s).to(cuda),
                                       sa_impl=sa_impl))
        b = block_to_numpy(index_block(torch.from_numpy(s),
                                       sa_impl=sa_impl))
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_encode_on_card_equals_host_tier(cuda, gen, tmp_path):
    from gecoz_tpu_torch.formats.gcz import encode_block, encode_block_host
    s = _genomic(gen)
    want = encode_block_host(s, ["a", "b"], backend="native")
    scan.reset_launches()
    assert encode_block(s, ["a", "b"], device=cuda) == want
    for name in ("cumsum_i32", "fill_rev_i32", "fill_fwd_i32"):
        assert scan.LAUNCHES[name] > 0, name


def test_a_compress_on_card_counts_its_sort_peak_once_a_block(
        cuda, gen, tmp_path, monkeypatch):
    """Two blocks compressed on the card: `sa.device_peak_bytes` and
    `sa.sorted_bases` are counted once a block, the first from the
    allocator's peak, which the program never resets, the second the
    blocks' bases; neither block is long enough for the split final sort."""
    from gecoz_tpu_torch.tools import driver
    from gecoz_tpu_torch.utils import metrics
    fa = tmp_path / "g.fa"
    with open(fa, "wb") as f:
        for i, n in enumerate((50000, 20000)):
            q = gen.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
            q[n // 4:n // 4 + n // 8] = ord("N")
            f.write(b">s%d\n" % i + q.tobytes() + b"\n")
    calls = []

    def counting(name, n=1, _orig=metrics.count):
        calls.append(name)
        _orig(name, n)
    monkeypatch.setattr(metrics, "count", counting)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: pytest.fail("the peak was reset"))
    metrics.reset()
    driver.index_fasta(fa, tmp_path / "g.gcz", device=cuda)
    st = metrics.stats()
    assert calls.count("sa.device_peak_bytes") == 2
    assert calls.count("sa.sorted_bases") == 2
    assert st["sa.sorted_bases"].count == 50001 + 20001
    assert 0 < st["sa.device_peak_bytes"].count \
        <= 2 * torch.cuda.max_memory_allocated(cuda)
    assert "sa.split_final_bases" not in st


def _pack(pats):
    L = max(len(p) for p in pats)
    arr = np.zeros((len(pats), L), np.uint8)
    for i, p in enumerate(pats):
        arr[i, L - len(p):] = np.frombuffer(p, np.uint8)
    return arr, np.asarray([len(p) for p in pats], np.int32)


def _card_block(cuda, gen, sf=5):
    s = _genomic(gen)
    return s, index_block(torch.from_numpy(s).to(cuda), sf=sf)


def test_fm_search_kernel_matches_plain(cuda, gen):
    s, blk = _card_block(cuda, gen)
    starts = gen.integers(0, len(s) - 160, size=3000)
    lens = gen.integers(1, 150, size=3000)
    pats = [bytes(s[a:a + n]) for a, n in zip(starts, lens)]
    pats += [b"Z", b"AZ", b"ACGTZ", b"\0", b"N" * 40, b"ACGT" * 30]
    blocks = (blk, fmq.with_kmer_table(blk), fmq.with_kmer_table(blk, 3))
    for block in map(fmq.with_rank_blocks, blocks):
        for sub in (pats, [p[-1:] for p in pats]):         # L = 1 too
            arr, ln = _pack(sub)
            a = torch.from_numpy(arr).to(cuda)
            n = torch.from_numpy(ln).to(cuda)
            before = fmsearch.LAUNCHES["fm_search"]
            got = fmq.search_batch(block, a, n)
            torch.cuda.synchronize()
            assert fmsearch.LAUNCHES["fm_search"] == before + 1
            want = fmsearch.backward_search_ref(block, a, n)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_fm_search_without_rank_blocks_raises(cuda, gen):
    """No silent rebuild and no fallback: a block without its rank table
    is refused before any launch."""
    _, blk = _card_block(cuda, gen)
    a = torch.from_numpy(np.frombuffer(b"ACGTACGT", np.uint8).copy()
                         ).to(cuda).view(1, 8)
    n = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    before = fmsearch.LAUNCHES["fm_search"]
    with pytest.raises(ValueError, match="with_rank_blocks"):
        fmq.search_batch(fmq.with_kmer_table(blk), a, n)
    assert fmsearch.LAUNCHES["fm_search"] == before


def test_fm_kernels_load_before_the_first_launch(cuda):
    fmsearch._lib()
    assert fmsearch.INIT_SECONDS is not None


def test_fm_search_lengths_past_width(cuda, gen):
    """A length greater than the pattern width stops at column 0, as the
    plain version does, and reads nothing left of its own row."""
    s, blk = _card_block(cuda, gen)
    starts = gen.integers(0, len(s) - 40, size=500)
    pats = [bytes(s[a:a + 30]) for a in starts]
    arr, ln = _pack(pats)
    a = torch.from_numpy(arr).to(cuda)
    for block in map(fmq.with_rank_blocks, (blk, fmq.with_kmer_table(blk))):
        exact = fmq.search_batch(block, a, torch.from_numpy(ln).to(cuda))
        for extra in (1, 7, 1 << 20):
            n = torch.from_numpy(ln + extra).to(cuda)
            got = fmq.search_batch(block, a, n)
            want = fmsearch.backward_search_ref(block, a, n)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            assert torch.equal(got[0], exact[0]) and torch.equal(got[1], exact[1])


def test_fm_search_length_one_beside_full_width(cuda, gen):
    """The contract's edge, every length >= 1: rows of one character (the
    seed from c[], or the table's first level) next to rows that fill
    every column and end at column 0, in one launch, against the plain
    version.  A length-0 row is refused before any launch, from the host
    copy of the lengths and, without one, from the lengths read back."""
    s, blk = _card_block(cuda, gen)
    starts = gen.integers(0, len(s) - 40, size=600)
    pats = [bytes(s[a:a + 24]) for a in starts[:300]]
    pats += [bytes(s[a:a + 1]) for a in starts[300:]]
    pats += [b"A", b"C", b"G", b"T", b"N", b"Z", b"\0"]
    pats = [pats[i] for i in gen.permutation(len(pats))]
    arr, ln = _pack(pats)
    assert arr.shape[1] == 24 and ln.min() == 1
    a, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(ln).to(cuda)
    bad = ln.copy()
    bad[len(bad) // 2] = 0
    nbad = torch.from_numpy(bad).to(cuda)
    blocks = (blk, fmq.with_kmer_table(blk), fmq.with_kmer_table(blk, 3))
    for block in map(fmq.with_rank_blocks, blocks):
        before = fmsearch.LAUNCHES["fm_search"]
        got = fmq.search_batch(block, a, n, ln)
        torch.cuda.synchronize()
        assert fmsearch.LAUNCHES["fm_search"] == before + 1
        want = fmsearch.backward_search_ref(block, a, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for host in (bad, None):
            with pytest.raises(ValueError, match="length must be >= 1"):
                fmq.search_batch(block, a, nbad, host)
        with pytest.raises(ValueError, match="length must be >= 1"):
            fmsearch.backward_search_ref(block, a, nbad)
        assert fmsearch.LAUNCHES["fm_search"] == before + 1


@pytest.mark.parametrize("sf,packed", [(5, True), (4, True), (3, True),
                                       (2, True), (1, True), (5, False),
                                       (3, False)])
def test_lf_walk_kernels_match_plain(cuda, gen, monkeypatch, sf, packed):
    """Decode walks in every mode (lfk16/8/4 at rates 32/16/8/4, the
    per-step packed and plain rows) and locate walks, against the plain
    versions on the card and the text and SA on the host."""
    if not packed:
        monkeypatch.setattr(fmq, "_PACK_LIMIT", 16)
    s, blk = _card_block(cuda, gen, sf)
    blk = fmq.with_lf_table(blk)
    rate = 1 << sf
    seeds = torch.from_numpy(gen.integers(0, blk.n, 5000).astype(
        np.int32)).to(cuda)
    modes = ["packed" if packed else "plain"]
    if rate % blk.lfk_k == 0:
        modes.append(f"lfk{blk.lfk_k}")
    for mode in modes:
        tab = blk.lfk_tab if mode.startswith("lfk") else blk.lf_tab
        kw = dict(bwt=blk.bwt, code_map=fmq.code_map(blk))
        before = lfwalk.LAUNCHES["decode"]
        got = lfwalk.decode_walks(tab, seeds, rate, mode, **kw)
        torch.cuda.synchronize()
        assert lfwalk.LAUNCHES["decode"] == before + 1
        assert torch.equal(got, lfwalk.decode_walks_ref(tab, seeds, rate,
                                                        mode, **kw)), mode
    assert np.array_equal(fmq.decode_text(blk).cpu().numpy(), s)
    rows = seeds[:2000]
    args = (blk.lf_tab, rows, blk.mark_words, blk.mark_pre, blk.ssa_perm,
            blk.sf, packed)
    got = lfwalk.locate_walks(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, lfwalk.locate_walks_ref(*args))
    sa = suffix_array_numpy(s)
    assert np.array_equal(got.cpu().numpy(), sa[rows.cpu().numpy()])


@pytest.mark.parametrize("sf", [2, 3, 4, 5, 6, 7])
def test_lf_decode_tiles_at_every_width(cuda, gen, sf):
    """The staged lfk kernel against the plain version: W = 1, W below
    one warp, W not a multiple of a warp tile, and
    rates from 4 (chunks shorter than a 16-byte store) past 32 (chunks of
    whole sectors)."""
    s, blk = _card_block(cuda, gen, sf)
    blk = fmq.with_lf_table(blk)
    rate, mode = 1 << sf, f"lfk{blk.lfk_k}"
    if rate % blk.lfk_k:
        pytest.skip(f"rate {rate} has no lfk table")
    cmap = fmq.code_map(blk)
    for W in (1, 5, 31, 32, 33, 97, 255, 4097):
        seeds = torch.from_numpy(gen.integers(0, blk.n, W).astype(
            np.int32)).to(cuda)
        want = lfwalk.decode_walks_ref(blk.lfk_tab, seeds, rate, mode,
                                       code_map=cmap)
        assert torch.equal(lfwalk.decode_walks(blk.lfk_tab, seeds, rate,
                                               mode, code_map=cmap), want), W


def test_lf_decode_refuses_a_misaligned_table(cuda, gen):
    """An lfk16 table viewed from its second row starts 4 bytes off an
    8-byte boundary: the wrapper raises before the kernel's 8-byte loads
    could fault, and the card goes on working."""
    s, blk = _card_block(cuda, gen, 4)
    blk = fmq.with_lf_table(blk)
    assert blk.lfk_k == 16
    seeds = torch.zeros(64, dtype=torch.int32, device=cuda)
    cmap = fmq.code_map(blk)
    before = lfwalk.LAUNCHES["decode"]
    with pytest.raises(ValueError, match="aligned"):
        lfwalk.decode_walks(blk.lfk_tab[1:], seeds, 16, "lfk16",
                            code_map=cmap)
    assert lfwalk.LAUNCHES["decode"] == before
    got = lfwalk.decode_walks(blk.lfk_tab, seeds, 16, "lfk16", code_map=cmap)
    torch.cuda.synchronize()
    assert torch.equal(got, lfwalk.decode_walks_ref(blk.lfk_tab, seeds, 16,
                                                    "lfk16", code_map=cmap))


def _marked_table(gen, n, sf, p_mark):
    """A synthetic fused LF table: random next rows, a `p_mark` share of
    rows sampled (bit 31), the mark plane and ssa_perm to match.  Walks
    that meet no mark within rate + 1 reads give -1."""
    nxt = gen.integers(0, n, n).astype(np.uint32)
    mark = gen.random(n) < p_mark
    tab = (nxt | (mark.astype(np.uint32) << 31)).view(np.int32)
    words = np.zeros((n + 31) // 32, np.uint32)
    np.bitwise_or.at(words, np.flatnonzero(mark) >> 5,
                     (1 << (np.flatnonzero(mark) & 31)).astype(np.uint32))
    pre = np.concatenate([[0], np.cumsum([bin(w).count("1") for w in words])
                          [:-1]]).astype(np.int32)
    perm = gen.permutation(max(int(mark.sum()), 1)).astype(np.int32)
    return [torch.from_numpy(a) for a in (tab, words.view(np.int32), pre,
                                          perm)], mark


@pytest.mark.parametrize("p_mark", [0.05, 0.3, 1.0])
def test_lf_locate_matches_plain_at_the_limits(cuda, gen, p_mark):
    """Locate walks against the plain version: rows already sampled (0
    steps), walks that reach the rate + 1 limit (-1), B = 1, below and past
    one warp."""
    sf, n = 3, 20000
    (tab, words, pre, perm), mark = _marked_table(gen, n, sf, p_mark)
    tab, words, pre, perm = (t.to(cuda) for t in (tab, words, pre, perm))
    for B in (1, 7, 32, 33, 1000, 70001):
        rows = torch.from_numpy(gen.integers(0, n, B).astype(
            np.int32)).to(cuda)
        args = (tab, rows, words, pre, perm, sf, False)
        want = lfwalk.locate_walks_ref(*args)
        if B == 70001:
            if p_mark < 1.0:
                assert bool((want == -1).any())
            sampled = torch.from_numpy(mark).to(cuda)[rows.long()]
            assert bool(sampled.any())
        before = lfwalk.LAUNCHES["locate"]
        assert torch.equal(lfwalk.locate_walks(*args), want), B
        assert lfwalk.LAUNCHES["locate"] == before + 1


def test_lf_kernels_load_before_the_first_launch(cuda):
    lfwalk._lib()
    assert lfwalk.INIT_SECONDS is not None


def _gcx_index(gen, m, sf):
    """A .gcx of m sampled values written by the port's host serializers:
    m of n = ~m * 2^sf rows marked at random, the values a permutation;
    (the index read back from the bytes, the marked rows, the values)."""
    rate = 1 << sf
    n = int(gen.integers((m - 1) * rate + 1, m * rate + 1))
    rows = np.sort(gen.choice(n, m, replace=False))
    bits = np.zeros(n, np.uint8)
    bits[rows] = 1
    perm = gen.permutation(m)
    buf = np.frombuffer(rankbv.serialize_rbv(rankbv.pack_bits(bits), n)
                        + iwt.serialize_iwt(perm), np.uint8)
    return ssa.SampledSAIndex.deserialize(buf, n, sf), rows, perm


# hg38's chr21 block (46,709,983 rows at rate 32) and a Swiss-Prot block of
# the benchmark's shape (~23,700 residues)
@pytest.mark.parametrize("m", [1_459_687, 742], ids=["hg38", "swissprot"])
def test_gcx_kernels_match_plain(cuda, gen, m):
    index, rows, perm = _gcx_index(gen, m, 5)
    n = index.mark.length
    raw, at = gcx.upload(index, cuda)
    before = dict(gcx.LAUNCHES)
    words, pc = gcx.unpack(raw, n, m, at)
    for g, w in zip((words, pc), gcx.unpack_ref(raw, n, m, at)):
        assert torch.equal(g, w)
    inc = scan.cumsum_i32(pc)
    got = gcx.decode(words, inc, n, m)
    torch.cuda.synchronize()
    assert gcx.LAUNCHES == {k: v + 1 for k, v in before.items()}
    for g, w in zip(got, gcx.decode_ref(words, inc, n, m)):
        assert torch.equal(g, w)
    assert np.array_equal(got[0].cpu().numpy(), perm)
    assert np.array_equal(got[2].cpu().numpy(), rows)
    assert int(got[4][1]) == rows[np.argmin(perm)]
    # the lift of a block: one launch of each, the parts of the CPU's lift
    card = gcx.lift(index, cuda)
    assert gcx.LAUNCHES == {k: v + 2 for k, v in before.items()}
    for a, b in zip(card, gcx.lift(index, "cpu")):
        assert torch.equal(a.cpu(), b)


def test_gcx_entry_points_refuse_what_the_kernels_do_not_take(cuda, gen):
    index, _, _ = _gcx_index(gen, 1000, 5)
    n = index.mark.length
    raw, at = gcx.upload(index, cuda)
    words, pc = gcx.unpack(raw, n, 1000, at)
    inc = scan.cumsum_i32(pc)
    before = dict(gcx.LAUNCHES)
    with pytest.raises(TypeError, match="uint8"):
        gcx.unpack(raw.to(torch.int32), n, 1000, at)
    with pytest.raises(TypeError, match="int32"):
        gcx.decode(words.long(), inc, n, 1000)
    with pytest.raises(TypeError, match="expected"):
        gcx.decode(words, inc.cpu(), n, 1000)
    with pytest.raises(TypeError, match="strided"):
        gcx.decode(torch.stack([words, words], 1)[:, 0], inc, n, 1000)
    assert gcx.LAUNCHES == before


def test_gcx_kernels_load_before_the_first_launch(cuda):
    gcx._lib()
    assert gcx.INIT_SECONDS is not None


@pytest.mark.parametrize("name", BLOCKS)
def test_hswt_kernels_match_plain(cuda, name):
    """The wavelet tree's unpack and walk on the card against their plain
    versions and the host's `decode_bwt`, each launched once; the lift
    launches each once more."""
    bwt, tree = block(name)
    tree = tree if name == "deep_codes" else read_back(tree)
    n = len(bwt)
    raw, nodes, total = hswt_device.upload(tree, cuda)
    before = dict(hswt_device.LAUNCHES)
    words, pc = hswt_device.unpack(raw, nodes, total)
    for g, w in zip((words, pc), hswt_device.unpack_ref(raw, nodes, total)):
        assert torch.equal(g, w)
    inc = scan.cumsum_i32(pc)
    got = hswt_device.decode(raw, words, inc, nodes, n)
    torch.cuda.synchronize()
    assert hswt_device.LAUNCHES == {k: v + 1 for k, v in before.items()}
    assert got.shape == (n,) and got.dtype == torch.uint8
    assert torch.equal(got, hswt_device.decode_ref(raw, words, inc, nodes, n))
    assert np.array_equal(got.cpu().numpy(), tree.decode_bwt())
    assert np.array_equal(got.cpu().numpy(), bwt)
    lifted = hswt_device.lift(tree, cuda)
    assert hswt_device.LAUNCHES == {k: v + 2 for k, v in before.items()}
    assert torch.equal(lifted, got)


def test_hswt_kernels_match_plain_on_a_damaged_stream(cuda):
    """Bits flipped in the stored streams: the kernels' positions are
    clamped as the plain version's are, and the two agree."""
    bwt, tree = block("dna_n_runs")
    streams, table = tree.stored_streams()
    bad = streams.copy()
    bad[np.random.default_rng(4).choice(len(bad), 300, replace=False)] ^= 0x5A
    tree._stored = (bad, table)
    raw, nodes, total = hswt_device.upload(tree, cuda)
    words, pc = hswt_device.unpack(raw, nodes, total)
    inc = scan.cumsum_i32(pc)
    got = hswt_device.decode(raw, words, inc, nodes, len(bwt))
    assert torch.equal(got, hswt_device.decode_ref(raw, words, inc, nodes,
                                                   len(bwt)))


def test_hswt_entry_points_refuse_what_the_kernels_do_not_take(cuda):
    bwt, tree = block("protein22")
    raw, nodes, total = hswt_device.upload(tree, cuda)
    words, pc = hswt_device.unpack(raw, nodes, total)
    inc = scan.cumsum_i32(pc)
    before = dict(hswt_device.LAUNCHES)
    with pytest.raises(TypeError, match="uint8"):
        hswt_device.unpack(raw.to(torch.int32), nodes, total)
    with pytest.raises(TypeError, match="int32"):
        hswt_device.decode(raw, words.long(), inc, nodes, len(bwt))
    with pytest.raises(TypeError, match="expected"):
        hswt_device.decode(raw, words, inc.cpu(), nodes, len(bwt))
    with pytest.raises(ValueError, match="nodes"):
        hswt_device.decode(raw, words, inc, 256, len(bwt))
    assert hswt_device.LAUNCHES == before


def test_hswt_kernels_load_before_the_first_launch(cuda):
    hswt_device._lib()
    assert hswt_device.INIT_SECONDS is not None


def test_decompress_and_search_on_card_decode_the_bwt_there(
        cuda, gen, tmp_path, monkeypatch):
    """A multi-record, multi-block .gcz on the card: the decompress writes
    the host tier's bytes and the GFF3 search gives the host tier's rows,
    each lifting every block's BWT through the hswt kernels, the host's
    decode made to raise."""
    import io

    from gecoz_tpu_torch.formats.gcz import GecozReader
    from gecoz_tpu_torch.tools import driver
    fa = tmp_path / "g.fa"
    seqs = []
    with open(fa, "wb") as f:
        for i, n in enumerate((50000, 8000, 700, 41)):
            q = gen.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
            q[n // 4:n // 4 + n // 8] = ord("N")
            seqs.append(q)
            f.write(b">s%d\n" % i + q.tobytes() + b"\n")
    gcz = tmp_path / "g.gcz"
    driver.index_fasta(fa, gcz, device=cuda)
    nblocks = len(GecozReader(gcz).headers)
    assert nblocks >= 2
    qf = tmp_path / "q.fa"
    with open(qf, "wb") as f:
        for i in range(40):
            a = int(gen.integers(0, 45000))
            f.write(b">q%d\n" % i + seqs[0][a:a + 20 + i].tobytes() + b"\n")
    host_fa, host_gff = tmp_path / "host.fa", io.StringIO()
    driver.decompress(gcz, host_fa, backend="numpy")
    driver.gff_search(gcz, qf, out=host_gff, backend="numpy")

    def refuse(self):
        raise AssertionError("the host decoded the BWT")
    monkeypatch.setattr(HSWT, "decode_bwt", refuse)
    hswt_device.reset_launches()
    port = tmp_path / "port.fa"
    driver.decompress(gcz, port, device=cuda)
    assert port.read_bytes() == host_fa.read_bytes()
    assert hswt_device.LAUNCHES == {"unpack": nblocks, "decode": nblocks}
    got = io.StringIO()
    driver.gff_search(gcz, qf, out=got, device=cuda)
    assert got.getvalue() == host_gff.getvalue() != ""
    assert hswt_device.LAUNCHES == {"unpack": 2 * nblocks,
                                    "decode": 2 * nblocks}


def test_decompress_and_search_on_card_equal_host_tier(cuda, gen, tmp_path):
    import io

    from gecoz_tpu_torch.formats.fasta import format_fasta_record, iter_fasta
    from gecoz_tpu_torch.formats.gcz import GecozReader
    from gecoz_tpu_torch.tools import driver
    seqs = [gen.choice(np.frombuffer(b"ACGTN", np.uint8), size=n)
            for n in (70000, 3000, 51)]
    fa = tmp_path / "g.fa"
    with open(fa, "wb") as f:
        for i, q in enumerate(seqs):
            f.write(b">s%d\n" % i + q.tobytes() + b"\n")
    gcz = tmp_path / "g.gcz"
    driver.index_fasta(fa, gcz, device=cuda)
    qf = tmp_path / "q.fa"
    with open(qf, "wb") as f:
        for i in range(50):
            a = int(gen.integers(0, 60000))
            f.write(b">q%d\n" % i + seqs[0][a:a + 20 + i].tobytes() + b"\n")
    fmsearch.reset_launches()
    lfwalk.reset_launches()
    # the host oracles: the FM-index's own decode and find, block by block
    reader = GecozReader(gcz)
    fms = [(bh.headers, reader.read(bh)) for bh in reader.headers]
    want = []
    for headers, fm in fms:
        text = fm.decode_text()
        for i, h in enumerate(headers):
            b, t = fm.seq_bounds(i)
            want.append(format_fasta_record(h, text[b:t]))
    port = tmp_path / "port.fa"
    driver.decompress(gcz, port, device=cuda)
    assert port.read_bytes() == b"".join(want)
    b = io.StringIO()
    for q in iter_fasta(qf):
        fwd = bytes(q.data)
        for pat, reverse in ((fwd, False),
                             (fwd[::-1].translate(driver._COMPLEMENT), True)):
            for headers, fm in fms:
                for i, hits in sorted(fm.find(pat).items()):
                    for p in hits:
                        driver._gff_row(b, headers[i], int(p), len(fwd),
                                        reverse, q.header)
    a = io.StringIO()
    driver.gff_search(gcz, qf, out=a, device=cuda)
    assert a.getvalue() == b.getvalue() != ""
    assert fmsearch.LAUNCHES["fm_search"] > 0 and lfwalk.LAUNCHES["decode"] > 0


def _wide_block(cuda, gen, sigma, sf):
    """A block of 60,000 bytes over `sigma` symbols (the terminator one of
    them): the 20 amino acids and X, or every byte value."""
    if sigma == 256:
        s = gen.integers(1, 256, 60000).astype(np.uint8)
    else:
        s = gen.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX"[:sigma - 1],
                                     np.uint8), size=60000)
    s[::397] = 0
    s[-1] = 0
    syms = tuple(int(x) for x in np.unique(s))
    assert len(syms) == sigma
    return s, index_block(torch.from_numpy(s).to(cuda), sf=sf, symbols=syms)


@pytest.mark.parametrize("sigma", [21, 256])
@pytest.mark.parametrize("sf", [5, 3, 2])
def test_wide_alphabet_kernels_match_plain(cuda, gen, sigma, sf):
    """Past 16 planes: the byte-row decode walks (lfk4), the decode and
    locate of the path, and K1 on the rank table with and without the
    k-mer table (5 or 8 bits a code), against the plain versions."""
    s, blk = _wide_block(cuda, gen, sigma, sf)
    blk = fmq.with_lf_table(blk)
    assert blk.lfk_k == 4
    rate = 1 << sf
    seeds = torch.from_numpy(gen.integers(0, blk.n, 5000).astype(
        np.int32)).to(cuda)
    before = lfwalk.LAUNCHES["decode"]
    got = lfwalk.decode_walks(blk.lfk_tab, seeds, rate, "lfk4")
    torch.cuda.synchronize()
    assert lfwalk.LAUNCHES["decode"] == before + 1
    assert torch.equal(got, lfwalk.decode_walks_ref(blk.lfk_tab, seeds, rate,
                                                    "lfk4"))
    assert np.array_equal(fmq.decode_text(blk).cpu().numpy(), s)
    sa = suffix_array_numpy(s)
    rows = seeds[:2000]
    assert np.array_equal(fmq.locate_batch(blk, rows).cpu().numpy(),
                          sa[rows.cpu().numpy()])
    starts = gen.integers(0, len(s) - 60, size=3000)
    lens = gen.integers(1, 50, size=3000)
    pats = [bytes(s[a:a + n]) for a, n in zip(starts, lens)]
    pats += [bytes(gen.integers(1, 256, 7).astype(np.uint8)), b"\0"]
    arr, ln = _pack(pats)
    a, n = torch.from_numpy(arr).to(cuda), torch.from_numpy(ln).to(cuda)
    for block in map(fmq.with_rank_blocks, (blk, fmq.with_kmer_table(blk))):
        before = fmsearch.LAUNCHES["fm_search"]
        got = fmq.search_batch(block, a, n)
        torch.cuda.synchronize()
        assert fmsearch.LAUNCHES["fm_search"] == before + 1
        want = fmsearch.backward_search_ref(block, a, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert block.kmer_bits == (5 if sigma == 21 else 8)


def test_protein_decompress_and_search_on_card_equal_host_tier(cuda, gen,
                                                               tmp_path,
                                                               capsys):
    """A protein FASTA (21 symbols) through the port's CLI on the card:
    the files, the decompressed FASTA and the GFF3 rows equal the host
    tier's, and the decode launched the byte-row walks."""
    from gecoz_tpu_torch import cli
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    seqs = [gen.choice(aa, size=n) for n in (40000, 3000, 351)]
    fa, qf = tmp_path / "p.fa", tmp_path / "q.fa"
    with open(fa, "wb") as f:
        for i, q in enumerate(seqs):
            f.write(b">sp|P%05d|X\n" % i + q.tobytes() + b"\n")
    with open(qf, "wb") as f:
        for i in range(50):
            a = int(gen.integers(0, 30000))
            f.write(b">q%d\n" % i + seqs[0][a:a + 8 + i % 43].tobytes()
                    + b"\n")
    outs = {}
    for tier in (["--device", str(cuda)], ["--backend", "native"]):
        gcz = tmp_path / f"{tier[1][:4]}.gcz"
        back = tmp_path / f"{tier[1][:4]}.fa"
        lfwalk.reset_launches()
        fmsearch.reset_launches()
        assert cli.main(["-i", str(fa), "-o", str(gcz)] + tier) == 0
        assert cli.main(["-i", str(gcz), "-o", str(back)] + tier) == 0
        capsys.readouterr()
        assert cli.main(["-i", str(gcz), "-s", str(qf)] + tier) == 0
        outs[tier[0]] = (gcz.read_bytes(), gcz.with_suffix(".gcx")
                         .read_bytes(), back.read_bytes(),
                         capsys.readouterr().out)
        if tier[0] == "--device":
            assert lfwalk.DECODE_LAUNCHES["lfk4"] > 0
            assert fmsearch.LAUNCHES["fm_search"] > 0
    assert outs["--device"] == outs["--backend"]
    assert outs["--device"][3].count("\n") >= 50


@pytest.mark.parametrize("D", [8, 6])
def test_sharded_sa_on_a_virtual_mesh(cuda, gen, D, monkeypatch):
    """The sharded suffix sort over (cuda:0,) * D at 1 MiB, both impls,
    equal to the host library's SA-IS; its shard-local scans launch the
    scan kernel (B1, and B4/B5 on the run-aware variant), and no torch
    scan runs on the path."""
    from gecoz_tpu_torch import native
    from gecoz_tpu_torch.parallel.sharded_sa import (gather_shards,
                                                     suffix_array_sharded)
    s = _genomic(gen, 1 << 20)
    want = native.sais(s)
    for name in ("cumsum", "cummax", "cummin"):
        monkeypatch.setattr(torch, name, lambda *a, name=name, **k: (
            _ for _ in ()).throw(AssertionError(f"torch.{name} ran")))
    for impl in ("runs", "kmer"):
        scan.reset_launches()
        sa, bwt = suffix_array_sharded(s, mesh=(cuda,) * D, impl=impl)
        assert all(x.is_cuda for x in sa + bwt)
        assert np.array_equal(gather_shards(sa).numpy(), want), impl
        assert np.array_equal(gather_shards(bwt).numpy(),
                              bwt_from_sa(s, want)), impl
        assert scan.LAUNCHES["cumsum_i32"] > 0, impl
        if impl == "runs":
            assert scan.LAUNCHES["cummax_i32"] > 0
            assert scan.LAUNCHES["cummin_rev_i32"] == D


@pytest.mark.parametrize("sf", [3, 5])
def test_sa_state_on_card_equals_cpu(cuda, gen, sf):
    from gecoz_tpu_torch.parallel.mesh import sa_state
    s = _genomic(gen)
    s[-1] = ord("C")
    sa, bwt = suffix_array_device(s, with_bwt=True, device=cuda)
    got = sa_state(sa, bwt, int(s[-1]), sf)
    want = sa_state(sa.cpu(), bwt.cpu(), int(s[-1]), sf)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


def test_native_backend_equals_device_backend(cuda, gen, tmp_path, capsys):
    """The CLI's host tier (`--backend native -t 2`) and device tier
    (`--backend device`, on the card) write the same .gcz/.gcx, decompress
    to the same FASTA and print the same GFF3 rows."""
    from gecoz_tpu_torch import cli
    seqs = [gen.choice(np.frombuffer(b"ACGTN", np.uint8), size=n)
            for n in (90000, 7000, 2500, 40)]
    fa = tmp_path / "g.fa"
    with open(fa, "wb") as f:
        for i, q in enumerate(seqs):
            f.write(b">s%d\n" % i + q.tobytes() + b"\n")
    qf = tmp_path / "q.fa"
    with open(qf, "wb") as f:
        for i in range(20):
            a = int(gen.integers(0, 80000))
            f.write(b">q%d\n" % i + seqs[0][a:a + 16 + i].tobytes() + b"\n")
    outs = {}
    for backend in ("native", "device"):
        gcz, back = tmp_path / f"{backend}.gcz", tmp_path / f"{backend}.fa"
        argv = ["--backend", backend, "-t", "2"]
        assert cli.main(["-i", str(fa), "-o", str(gcz)] + argv) == 0
        assert cli.main(["-i", str(gcz), "-o", str(back)] + argv) == 0
        capsys.readouterr()
        assert cli.main(["-i", str(gcz), "-s", str(qf)] + argv) == 0
        outs[backend] = (gcz.read_bytes(), gcz.with_suffix(".gcx").read_bytes(),
                         back.read_bytes(), capsys.readouterr().out)
    assert outs["native"] == outs["device"]
    assert outs["device"][3] != ""


def test_entry_on_card_equals_cpu(cuda):
    from gecoz_tpu_torch.entry import entry
    fn, args = entry()
    assert all(a.is_cuda for a in args)
    got = fn(*args)
    cpu_fn, cpu_args = entry(device="cpu")
    want = cpu_fn(*cpu_args)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
