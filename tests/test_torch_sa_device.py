"""Run-aware and k-mer suffix sorts of the PyTorch port vs the reference.

The port (gecoz_tpu_torch/ops/sa_device.py, plain versions on the CPU) must
give exactly the (sa, bwt) of gecoz_tpu's `_suffix_array_runs_jit` /
`_suffix_array_jit` and of the host oracle, on the cases of
tests/test_sa_runs.py.  The host helpers copied
into `ops/sa_host.py` must equal the reference helpers.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops import sa_device as ref
from gecoz_tpu.ops.sa import (bwt_from_sa, suffix_array_naive,
                              suffix_array_numpy)
from gecoz_tpu_torch.ops import sa_device as port
from gecoz_tpu_torch.ops import sa_host

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


def port_runs(s, **kw):
    sa, bwt = port._suffix_array_runs(t(s), **kw)
    assert sa.dtype == torch.int32 and bwt.dtype == torch.uint8
    return sa.numpy(), bwt.numpy()


# -- host helpers -----------------------------------------------------------

def _texts(rng):
    out = [np.frombuffer(b"AACCCA", np.uint8), np.zeros(0, np.uint8),
           np.frombuffer(b"A", np.uint8), np.full(1000, 7, np.uint8),
           np.frombuffer(b"AC" * 300 + b"GT\0", np.uint8)]
    for _ in range(6):
        parts = [rng.choice(np.frombuffer(b"ACGT", np.uint8),
                            size=int(rng.integers(50, 300))),
                 np.full(int(rng.integers(1, 5000)), ord("N"), np.uint8),
                 rng.choice(np.frombuffer(b"ACGTN\0", np.uint8),
                            size=int(rng.integers(50, 300))),
                 np.zeros(1, np.uint8)]
        out.append(np.concatenate(parts))
    return out


def test_host_helper_constants():
    for name in ("ELL_BITS_LADDER", "M_PAD_LADDER", "RUN_THRESHOLD",
                 "TOK_TABLE_SIZE"):
        assert getattr(sa_host, name) == getattr(ref, name), name


def test_host_helpers_equal_reference(rng):
    for s in _texts(rng):
        for chunk in (64, 4 << 20):
            assert sa_host.max_run_length(s, _chunk=chunk) == \
                ref.max_run_length(s, _chunk=chunk)
        assert sa_host.runs_m_pad(s) == ref.runs_m_pad(s)
        assert sa_host.runs_ell_bits(s) == ref.runs_ell_bits(s)
        if s.shape[0] == 0:
            continue
        syms = tuple(int(x) for x in np.unique(s))
        for ebs in (None, sa_host.runs_ell_bits(s)):
            for chunk in (64, 4 << 20):
                a = sa_host.runs_token_table(s, syms, ell_bits=ebs,
                                             _chunk=chunk)
                b = ref.runs_token_table(s, syms, ell_bits=ebs, _chunk=chunk)
                assert (a is None) == (b is None)
                if a is not None:
                    assert np.array_equal(a, b)
                assert sa_host.runs_r1_keys(a) == ref.runs_r1_keys(b)
        table, bits = sa_host.dense_table(np.unique(s))
        rtable, rbits = ref.dense_table(np.unique(s))
        assert np.array_equal(table, rtable) and bits == rbits
    for m, n in ((1, 160), (120, 160), (121, 160), (159, 160), (7, 7)):
        assert sa_host.m_pad_bucket(m, n) == ref.m_pad_bucket(m, n)
    assert sa_host.runs_r1_keys(None) is None
    assert sa_host.runs_ell_bits(np.zeros(0, np.uint8), mx=1 << 30) is None


# -- suffix sorts -----------------------------------------------------------

FIXED = [
    b"banana\0", b"mississippi\0", b"AC\0G\0", b"B\0A\0",
    b"\0\0\0", b"aaaaaaaa\0", b"A", b"ab",
    b"aaaabaaa\0", b"baaaabaaaab\0",
    b"NNNNA" b"NNNNT" b"NNNN\0",
    b"ACGTNNNNNNNN",
    b"AAAACCCCGGGGTTTTAAAA\0",
    b"CNNNNAC" b"CNNNNAG" b"CNNNNAA\0",
]


@pytest.mark.parametrize("case", FIXED)
def test_runs_fixed_cases(case):
    s = np.frombuffer(case, dtype=np.uint8)
    want = suffix_array_naive(s)
    rsa, rbwt = ref._suffix_array_runs_jit(jnp.asarray(s))
    assert np.array_equal(np.asarray(rsa), want)
    syms = tuple(int(x) for x in np.unique(s))
    for kw in ({}, {"syms": syms if len(syms) <= 7 else None}):
        sa, bwt = port_runs(s, **kw)
        assert np.array_equal(sa, want), kw
        assert np.array_equal(bwt, np.asarray(rbwt)), kw
    assert np.array_equal(port._suffix_array(t(s)).numpy(), want)


def test_runs_random_small_alphabet(rng):
    for _ in range(15):
        n = int(rng.integers(2, 300))
        s = rng.choice(np.frombuffer(b"AB\0", np.uint8), size=n)
        want = suffix_array_naive(s)
        assert np.array_equal(port_runs(s)[0], want)
        assert np.array_equal(port_runs(s, syms=(0, 65, 66))[0], want)


def test_runs_random_with_runs(rng):
    """Texts stitched from random DNA and long runs (the genomic shape)."""
    for trial in range(10):
        parts = []
        for _ in range(int(rng.integers(2, 6))):
            if rng.integers(0, 3) == 0:
                parts.append(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                        size=int(rng.integers(5, 80))))
            else:
                sym = rng.choice(np.frombuffer(b"ACGTN\0", np.uint8))
                parts.append(np.full(int(rng.integers(20, 200)), sym,
                                     np.uint8))
        parts.append(np.zeros(1, np.uint8))
        s = np.concatenate(parts)
        want = suffix_array_numpy(s)
        syms = tuple(int(x) for x in np.unique(s))
        for kw in ({}, {"syms": syms, "m_pad": sa_host.runs_m_pad(s)}):
            sa, bwt = port_runs(s, **kw)
            assert np.array_equal(sa, want), (trial, kw)
            assert np.array_equal(bwt, bwt_from_sa(s, want))


def test_genomic_block_against_reference(rng):
    """Bench-shaped block (random DNA + one long N run) through the
    reference's host-tabled entry point and the port's."""
    n = 1 << 15
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    s[1000:1000 + (1 << 12)] = ord("N")
    s[n // 2] = 0
    s[n - 1] = 0
    rsa, rbwt = ref.suffix_array_device(s, with_bwt=True)
    assert np.array_equal(np.asarray(rsa), suffix_array_numpy(s))
    sa, bwt = port.suffix_array_device(s, with_bwt=True, device="cpu")
    assert np.array_equal(sa.numpy(), np.asarray(rsa))
    assert np.array_equal(bwt.numpy(), np.asarray(rbwt))


def test_kmer_against_reference(rng):
    s = rng.choice(np.frombuffer(b"ACGTN\0", np.uint8), size=3001)
    table, bits = sa_host.dense_table(np.unique(s))
    want = np.asarray(ref._suffix_array_jit(jnp.asarray(s),
                                            jnp.asarray(table), bits=bits))
    got = port._suffix_array(t(s), t(table), bits=bits)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(port.bwt_device(t(s), got).numpy(),
                          bwt_from_sa(s, want))


def test_device_dispatch_impls(rng):
    s = np.concatenate([
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200),
        np.full(500, ord("N"), np.uint8),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200),
        np.zeros(1, np.uint8)])
    want = suffix_array_numpy(s)
    for impl in ("auto", "runs", "kmer"):
        got = port.suffix_array_device(s, impl=impl, device="cpu")
        assert np.array_equal(got.numpy(), want), impl
    sa, bwt = port.suffix_array_device(np.zeros(0, np.uint8), with_bwt=True,
                                       device="cpu")
    assert sa.shape == (0,) and bwt.dtype == torch.uint8
    with pytest.raises(ValueError):
        port.suffix_array_device(s, impl="nope", device="cpu")


def test_lexsort_orders_like_numpy(rng):
    n = 500
    k = [rng.integers(-3, 3, size=n).astype(np.int32) for _ in range(3)]
    _, perm = port.lexsort([t(x) for x in k])
    assert np.array_equal(perm.numpy(), np.lexsort(k[::-1]))
    edge = np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.int64)
    u = [rng.choice(edge, size=n) for _ in range(5)]
    _, perm = port.lexsort([t(x) for x in u], unsigned=True)
    assert np.array_equal(perm.numpy(), np.lexsort(u[::-1]))


def test_sort_rerank_variants(rng):
    """Dense ranks in position order, the sort order, the distinct flag."""
    k1 = rng.integers(0, 4, size=200).astype(np.int32)
    k2 = rng.integers(-2, 2, size=200).astype(np.int32)
    order = np.lexsort((k2, k1))
    pairs = np.stack([k1, k2], 1)[order]
    grp = np.r_[0, np.cumsum(np.any(pairs[1:] != pairs[:-1], 1))]
    want = np.empty(200, np.int64)
    want[order] = grp
    rank, got_order, done = port._sort_rerank(t(k1), t(k2))
    assert np.array_equal(rank.numpy(), want)
    assert np.array_equal(got_order.numpy(), order) and not done
    rank1, order1, done1 = port._sort_rerank_n(
        (t(np.arange(5)[::-1].astype(np.int32)),))
    assert np.array_equal(rank1.numpy(), [4, 3, 2, 1, 0]) and done1
    assert np.array_equal(order1.numpy(), [4, 3, 2, 1, 0])


def test_apply_perm_inverts_the_permutation(rng):
    dest = rng.permutation(300).astype(np.int32)
    v = rng.integers(-9, 9, size=300).astype(np.int32)
    w = rng.integers(0, 255, size=300).astype(np.uint8)
    want = np.empty_like(v)
    want[dest] = v
    want_w = np.empty_like(w)
    want_w[dest] = w
    assert np.array_equal(port.apply_perm(t(dest), t(v)).numpy(), want)
    got_v, got_w = port.apply_perm(t(dest), t(v), t(w))
    assert np.array_equal(got_v.numpy(), want)
    assert np.array_equal(got_w.numpy(), want_w)


def test_size_guard():
    class Big:
        shape = (1 << 30,)
    with pytest.raises(ValueError):
        port._suffix_array_runs(Big())
