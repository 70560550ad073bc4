"""Kernel K1's plain version (`backward_search_ref`) and rank primitives.

`backward_search_ref` is held equal to a direct numpy loop (one pattern at
a time, occ counted straight off the BWT) and to gecoz_tpu's
`search_batch` on the same block and tables; everything is an integer:
tolerance 0.  The kernel itself runs only on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops import fmq as ref_fmq
from gecoz_tpu.tools.batch_search import pack_patterns
from gecoz_tpu_torch.ops import fmq, fmsearch

from conftest import random_block
from test_fm import build_fm

torch.set_num_threads(1)


def loop_search(bwt, c, sym_plane, kmer_tab, bits, kmer_k, pat, L):
    """search_batch for one right-aligned pattern, as a scalar loop."""
    n_b = len(pat)
    row = np.zeros(L, np.uint8)
    row[L - n_b:] = np.frombuffer(pat, np.uint8)

    def occ(ch, pos):
        if pos < 0 or sym_plane[ch] < 0:
            return 0
        return int(np.count_nonzero(bwt[:pos + 1] == ch))

    k = min(kmer_k, L) if len(kmer_tab) and L > 1 else 0
    if k:
        code, bad = 0, False
        for t in range(k):
            r = int(sym_plane[row[L - 1 - t]])
            code |= max(r, 0) << (bits * t)
            bad |= r < 0 and t < n_b
        j = min(max(n_b, 1), k)
        code &= (1 << (bits * j)) - 1
        off = sum(1 << (bits * i) for i in range(1, j))
        sp, ep = (1, 0) if bad else (int(kmer_tab[off + code, 0]),
                                     int(kmer_tab[off + code, 1]))
        start = L - k
    else:
        sp, ep = int(c[row[L - 1]]), int(c[row[L - 1] + 1]) - 1
        start = L - 1
    for col in range(start - 1, -1, -1):
        if col < L - n_b or sp > ep:
            break
        ch = int(row[col])
        sp, ep = (int(c[ch]) + occ(ch, sp - 1),
                  int(c[ch]) + occ(ch, ep) - 1)
    return sp, ep


def _case(rng, kmer_k):
    data, seqs = random_block(rng, nseq=2, minlen=150, maxlen=400,
                              alphabet=b"ACGTN")
    fm = build_fm(data, 8)
    ref = ref_fmq.device_block_from_fm(fm)
    if kmer_k is not None:
        ref = ref_fmq.with_kmer_table(ref, kmer_k or None)
    port = fmq.block_from_numpy(
        {k: np.asarray(v) for k, v in ref._asdict().items()}, ref.sf)
    raw = bytes(seqs[0])
    pats = [raw[5:5 + n] for n in (1, 2, 4, 7, 12, 20)]
    pats += [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n))
             for n in (1, 3, 6, 9, 15) for _ in range(3)]
    pats += [b"Z", b"AZ", b"ZA", b"ACGTZ", b"ZACGTACGT", b"\0", b"A\0"]
    return fm, ref, port, pats


@pytest.mark.parametrize("kmer_k", [None, 0, 3])
def test_ref_equals_loop_and_reference(rng, kmer_k):
    """No k-mer table, the default table, and an explicit k = 3."""
    fm, ref, port, pats = _case(rng, kmer_k)
    arr, lens = pack_patterns(pats)
    L = arr.shape[1]
    got = fmsearch.backward_search_ref(port, torch.from_numpy(arr),
                                       torch.from_numpy(lens))
    want = ref_fmq.search_batch(ref, jnp.asarray(arr), jnp.asarray(lens))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    kt = np.asarray(ref.kmer_tab)
    for i, p in enumerate(pats):
        loop = loop_search(fm.bwt, np.asarray(ref.c), np.asarray(ref.sym_plane),
                           kt, ref.kmer_bits, ref.kmer_k, p, L)
        assert (int(got[0][i]), int(got[1][i])) == loop, p
        hsp, hep = fm.search_range(p)
        if hep >= hsp:
            assert loop == (hsp, hep), p


def test_single_column_patterns(rng):
    """L = 1: the seed comes from c[] even with a k-mer table."""
    fm, ref, port, _ = _case(rng, 0)
    pats = [b"A", b"C", b"N", b"Z", b"\0"]
    arr, lens = pack_patterns(pats)
    assert arr.shape[1] == 1
    got = fmsearch.backward_search(port, torch.from_numpy(arr),
                                   torch.from_numpy(lens))
    want = ref_fmq.search_batch(ref, jnp.asarray(arr), jnp.asarray(lens))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kmer_k", [None, 0])
def test_lengths_past_width(rng, kmer_k):
    """A length greater than the width L searches the whole row, as the
    reference does: the same ranges as the length L."""
    fm, ref, port, pats = _case(rng, kmer_k)
    arr, lens = pack_patterns(pats)
    full = np.full_like(lens, arr.shape[1])
    exact = fmsearch.backward_search(port, torch.from_numpy(arr),
                                     torch.from_numpy(full))
    for extra in (1, 5, 1 << 20):
        over = full + np.int32(extra)
        got = fmsearch.backward_search(port, torch.from_numpy(arr),
                                       torch.from_numpy(over))
        want = ref_fmq.search_batch(ref, jnp.asarray(arr), jnp.asarray(over))
        for g, w, e in zip(got, want, exact):
            assert np.array_equal(g.numpy(), np.asarray(w))
            assert torch.equal(g, e)


def test_rank_primitives_match_numpy(rng):
    words = rng.integers(0, 1 << 32, size=500, dtype=np.int64)
    words[:3] = [0, 1 << 31, (1 << 32) - 1]
    assert np.array_equal(fmsearch.popcount32(torch.from_numpy(words)).numpy(),
                          np.bitwise_count(words.astype(np.uint32)))
    w32 = words.astype(np.uint32)
    pre = np.concatenate([[0], np.cumsum(np.bitwise_count(w32))[:-1]])
    pos = rng.integers(0, 500 * 32, size=300)
    pos[:2] = [0, 500 * 32 - 1]
    bits = np.unpackbits(w32.view(np.uint8), bitorder="little")
    want = np.cumsum(bits)[pos]
    got = fmsearch.rank_words(torch.from_numpy(w32.view(np.int32)),
                              torch.from_numpy(pre.astype(np.int32)),
                              torch.from_numpy(pos))
    assert np.array_equal(got.numpy(), want)


def test_wrapper_checks_and_cpu_dispatch(rng):
    fm, ref, port, pats = _case(rng, 0)
    arr, lens = pack_patterns(pats)
    a, ln = torch.from_numpy(arr), torch.from_numpy(lens)
    before = fmsearch.LAUNCHES["fm_search"]
    sp, ep = fmsearch.backward_search(port, a, ln)
    assert fmsearch.LAUNCHES["fm_search"] == before      # plain: no count
    ref_sp, ref_ep = fmsearch.backward_search_ref(port, a, ln)
    assert torch.equal(sp, ref_sp) and torch.equal(ep, ref_ep)
    with pytest.raises(TypeError):
        fmsearch.backward_search(port, a.to(torch.int32), ln)
    with pytest.raises(TypeError):
        fmsearch.backward_search(port, a, ln.long())
    with pytest.raises(TypeError):
        fmsearch.backward_search(port, a[:, ::2], ln)
    with pytest.raises(ValueError):
        fmsearch.backward_search(port, a[:, :0].contiguous(), ln)
