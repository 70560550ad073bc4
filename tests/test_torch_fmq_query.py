"""Query engine of the PyTorch port vs gecoz_tpu's device query engine.

The cases of tests/test_fmq_device.py carried over: every table the port
builds (lf_tab, lfk_tab for k = 4/8/16, loc_tab, kmer_tab) equals the
reference's, and occ, LF, search, all three locate branches and decode
equal the reference's outputs, on the port's own tables and on tables
carried across from the reference.  Everything compared is an integer or
a byte: tolerance 0.  The port runs its plain versions here (CPU tensors).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops import fmq as ref_fmq
from gecoz_tpu.ops import pipeline as ref_pipeline
from gecoz_tpu.ops.sa import suffix_array_numpy
from gecoz_tpu.tools.batch_search import pack_patterns
from gecoz_tpu_torch.ops import fmq
from gecoz_tpu_torch.ops.pipeline import index_and_query
from gecoz_tpu_torch.tools import driver

from conftest import random_block
from test_fm import build_fm
from test_torch_host_copies import build_port_fm

torch.set_num_threads(1)


def make_pair(rng, nseq=3, rate=8, **kw):
    data, seqs = random_block(rng, nseq=nseq, **kw)
    fm = build_fm(data, rate)
    return (data, seqs, fm, ref_fmq.device_block_from_fm(fm),
            fmq.device_block_from_fm(build_port_fm(data, rate), "cpu"))


def carried(ref_block) -> fmq.DeviceFMBlock:
    """The reference's block, tables included, as the port's block."""
    return fmq.block_from_numpy(
        {k: np.asarray(v) for k, v in ref_block._asdict().items()},
        ref_block.sf)


def assert_blocks_equal(port_block, ref_block):
    a = fmq.block_to_numpy(port_block)
    b = fmq.block_to_numpy(carried(ref_block))
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def test_lift_equals_reference_block(rng):
    """device_block_from_fm (BWT + .gcx parts, built on the device) gives
    the reference's host-built block field by field."""
    *_, ref, port = make_pair(rng, nseq=4, alphabet=b"ACGTN")
    assert port.n == ref.n and not port.has_lf and not port.has_kmer
    assert_blocks_equal(port, ref)


def test_occ_inclusive_matches_reference(rng):
    data, _, fm, ref, port = make_pair(rng)
    pos = rng.integers(-2, len(data), size=64).astype(np.int32)
    for s in [0, 65, 67, 71, 84, 78, 90]:
        want = np.asarray(ref_fmq.occ_inclusive(
            ref, jnp.full(64, s, jnp.int32), jnp.asarray(pos)))
        got = fmq.occ_inclusive(port, torch.full((64,), s), t32(pos))
        assert np.array_equal(got.numpy(), want), s


def test_lf_matches_reference(rng):
    data, _, fm, ref, port = make_pair(rng, nseq=4)
    idx = np.arange(len(data), dtype=np.int32)
    want = np.asarray(ref_fmq.lf_batch(ref, jnp.asarray(idx)))
    assert np.array_equal(want, fm.lf)
    assert np.array_equal(fmq.lf_batch(port, t32(idx)).numpy(), want)
    assert np.array_equal(fmq._corrected_lf(port).numpy(), want)
    with_tab = fmq.with_lf_table(port, decode=False)
    assert np.array_equal(fmq.lf_batch(with_tab, t32(idx)).numpy(), want)


@pytest.mark.parametrize("rate", [1, 2, 4, 8, 16, 32])
def test_lf_tables_equal_reference(rate, rng):
    """lf_tab and the k = 4 (rate 1, 2, 4) / 8 / 16 lfk_tab, bit for bit."""
    *_, ref, port = make_pair(rng, nseq=3, rate=rate, minlen=100,
                              maxlen=300)
    want = ref_fmq.with_lf_table(ref)
    got = fmq.with_lf_table(port)
    assert got.lfk_k == want.lfk_k == {1: 4, 2: 4, 4: 4, 8: 8}.get(rate, 16)
    assert_blocks_equal(got, want)
    # decode=False builds the same lf_tab and no lfk_tab
    only = fmq.with_lf_table(port, decode=False)
    assert not only.has_lfk
    assert torch.equal(only.lf_tab, got.lf_tab)


def test_plain_lf_rows_equal_reference(rng, monkeypatch):
    monkeypatch.setattr(ref_fmq, "_PACK_LIMIT", 16)
    monkeypatch.setattr(fmq, "_PACK_LIMIT", 16)
    *_, ref, port = make_pair(rng, nseq=2, rate=4, minlen=100, maxlen=300)
    want = ref_fmq.with_lf_table(ref)
    got = fmq.with_lf_table(port)
    assert not got.lf_packed and not want.lf_packed
    assert_blocks_equal(got, want)


@pytest.mark.parametrize("rate", [1, 4, 32])
def test_locate_table_equals_reference(rate, rng):
    data, _, fm, ref, port = make_pair(rng, nseq=3, rate=rate, minlen=500,
                                       maxlen=2000)
    want = ref_fmq.with_locate_table(ref)
    got = fmq.with_locate_table(port)
    assert_blocks_equal(got, want)
    sa = suffix_array_numpy(data)
    rows = rng.integers(0, len(data), size=500).astype(np.int32)
    assert np.array_equal(fmq.locate_batch(got, t32(rows)).numpy(), sa[rows])
    assert int(got.loc_tab[:, 1].max()) < rate
    # after an lf_tab, the locate table reuses its corrected LF
    both = fmq.with_locate_table(fmq.with_lf_table(port, decode=False))
    assert torch.equal(both.loc_tab, got.loc_tab)


def test_kmer_tables_equal_reference(rng):
    """Default k (the small cap at this n) and an explicit k standing in
    for the 2^24 cap of blocks >= 4 MiB."""
    *_, ref, port = make_pair(rng, nseq=2, minlen=200, maxlen=500,
                              alphabet=b"ACGTN")
    for k in (None, 5):
        want = ref_fmq.with_kmer_table(ref, k)
        got = fmq.with_kmer_table(port, k)
        assert (got.kmer_bits, got.kmer_k) == (want.kmer_bits, want.kmer_k)
        assert_blocks_equal(got, want)


def _pats(rng, lengths, alphabet=b"ACGTN", per=4):
    return [bytes(rng.choice(np.frombuffer(alphabet, np.uint8), size=n))
            for n in lengths for _ in range(per)]


def _search_both(ref_block, port_block, pats):
    arr, lens = pack_patterns(pats)
    want = ref_fmq.search_batch(ref_block, jnp.asarray(arr),
                                jnp.asarray(lens))
    got = fmq.search_batch(port_block, torch.from_numpy(arr),
                           torch.from_numpy(lens))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    return got


def test_search_batch(rng):
    data, seqs, fm, ref, port = make_pair(rng, nseq=2, minlen=100,
                                          maxlen=400, alphabet=b"ACGT")
    pats = _pats(rng, [1, 3, 5, 9], b"ACGT", per=5)
    sp, ep = _search_both(ref, port, pats)
    for i, p in enumerate(pats):
        assert (int(sp[i]), int(ep[i])) == fm.search_range(p), p


def test_search_batch_with_kmer_table(rng):
    """Seeded search for every length, symbols absent from the block,
    patterns shorter and longer than k, on the port's table and on the
    reference's carried across."""
    data, seqs, fm, ref, port = make_pair(rng, nseq=2, minlen=200,
                                          maxlen=500, alphabet=b"ACGTN")
    ref = ref_fmq.with_kmer_table(ref)
    port = fmq.with_kmer_table(port)
    k = port.kmer_k
    pats = _pats(rng, [1, 2, 3, k, k + 1, 14])
    pats += [b"Z", b"AZ", b"ZA", b"ACGTZ", b"ZACGTACGT", b"ACGTACGTZ"]
    raw = bytes(seqs[0])
    pats += [raw[3:3 + n] for n in (1, 5, 11)]
    _search_both(ref, port, pats)
    _search_both(ref, carried(ref), pats)


def test_kmer_table_tiny_block():
    data = np.frombuffer(b"ACGTACGTAC\0", np.uint8)
    fm = build_fm(data, 4)
    ref = ref_fmq.with_kmer_table(ref_fmq.device_block_from_fm(fm))
    port = fmq.with_kmer_table(fmq.device_block_from_fm(
        build_port_fm(data, 4), "cpu"))
    pats = [b"ACGT", b"GTAC", b"\0"]
    sp, ep = _search_both(ref, port, pats)
    for i, p in enumerate(pats):
        assert (int(sp[i]), int(ep[i])) == fm.search_range(p), p


def test_locate_batch_three_branches(rng, monkeypatch):
    """Table-free walk, fused-table walk (packed and plain rows) and the
    locate table, each equal to the reference and to the true SA."""
    data, _, fm, ref, port = make_pair(rng, nseq=3, minlen=150, maxlen=260)
    sa = suffix_array_numpy(data)
    rows = rng.integers(0, len(data), size=300).astype(np.int32)

    def both(r, p):
        want = np.asarray(ref_fmq.locate_batch(r, jnp.asarray(rows)))
        got = fmq.locate_batch(p, t32(rows)).numpy()
        assert np.array_equal(want, sa[rows])
        assert np.array_equal(got, want)

    both(ref, port)
    both(ref_fmq.with_locate_table(ref), fmq.with_locate_table(port))
    both(ref_fmq.with_lf_table(ref, decode=False),
         fmq.with_lf_table(port, decode=False))
    # plain rows: lf_packed is trace-time static in the reference, so its
    # compile cache is cleared around the patched limit
    monkeypatch.setattr(ref_fmq, "_PACK_LIMIT", 16)
    monkeypatch.setattr(fmq, "_PACK_LIMIT", 16)
    jax.clear_caches()
    try:
        r, p = (ref_fmq.with_lf_table(ref, decode=False),
                fmq.with_lf_table(port, decode=False))
        assert not p.lf_packed
        both(r, p)
        both(r, carried(r))
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("rate", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("packed", [True, False])
def test_decode_text(rate, packed, rng, monkeypatch):
    """Every decode branch: lfk k = 4 (rates 4), 8, 16 (16, 32); the
    per-step fused table at rate 2 (k = 4 built, not usable); packed and
    plain rows; full walks plus a ragged tail."""
    if not packed:
        monkeypatch.setattr(ref_fmq, "_PACK_LIMIT", 16)
        monkeypatch.setattr(fmq, "_PACK_LIMIT", 16)
    jax.clear_caches()
    try:
        data, _, fm, ref, port = make_pair(rng, nseq=2, rate=rate,
                                           minlen=100, maxlen=400)
        want = np.asarray(ref_fmq.decode_text_jit(
            ref_fmq.with_lf_table(ref)))
        got = fmq.decode_text(fmq.with_lf_table(port))
        assert got.dtype == torch.uint8
        assert np.array_equal(want, data)
        assert np.array_equal(got.numpy(), want)
    finally:
        jax.clear_caches()


def test_decode_without_tables_and_edge_sizes(rng):
    """The planes-only walk, the adversarial sequence order, n <= rate and
    tail_len = 0."""
    cases = [np.frombuffer(b"TTTGG\0AAACA\0CCC\0", np.uint8),   # rate 4
             np.frombuffer(b"ACG\0", np.uint8),                 # n = rate
             np.frombuffer(b"AC\0", np.uint8),                  # n < rate
             np.frombuffer(b"ACGTACGT\0", np.uint8)]            # tail 0
    for data in cases:
        fm, pfm = build_fm(data, 4), build_port_fm(data, 4)
        port = fmq.device_block_from_fm(pfm, "cpu")
        assert bytes(fmq.decode_text(port).numpy()) == bytes(data)
        got = driver._device_decode(pfm, torch.device("cpu"))
        assert bytes(got) == bytes(data)
        assert bytes(ref_fmq.decode_text_device(fm)) == bytes(data)


def test_decode_on_carried_tables(rng):
    """The port decodes and locates on the reference's own tables."""
    data, _, fm, ref, _ = make_pair(rng, nseq=2, rate=32, minlen=300,
                                    maxlen=900)
    ref = ref_fmq.with_lf_table(ref)
    blk = carried(ref)
    assert blk.lfk_k == 16 and blk.has_lf
    assert np.array_equal(fmq.decode_text(blk).numpy(), data)
    rows = rng.integers(0, len(data), size=100).astype(np.int32)
    assert np.array_equal(fmq.locate_batch(blk, t32(rows)).numpy(),
                          suffix_array_numpy(data)[rows])


def test_index_and_query_matches_reference(rng):
    data, _ = random_block(rng, nseq=3, minlen=300, maxlen=700,
                           alphabet=b"ACGTN")
    starts = rng.integers(0, len(data) - 12, size=40)
    pats = [bytes(data[s:s + 1 + s % 11]) for s in starts] + [b"ZZ", b"N"]
    arr, lens = pack_patterns(pats)
    want = ref_pipeline.index_and_query(jnp.asarray(data), jnp.asarray(arr),
                                        jnp.asarray(lens))
    got = index_and_query(torch.from_numpy(data.copy()),
                          torch.from_numpy(arr), torch.from_numpy(lens))
    for name, w, g in zip(("sp", "ep", "located", "text"), want, got):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert np.array_equal(got[3].numpy(), data)
