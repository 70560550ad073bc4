"""Every branch of the run-aware suffix sort, port vs reference.

The reference picks its branches by backend (`_scatter_is_cheap`); as in
tests/test_sa_runs.py:105 and :316 it is forced onto its TPU (sort)
branches here, and each result is held against the port's explicit
`strategy`: the tok_table compaction, the fused two-sort compaction, the
scatter compaction, m_pad and ell_bits bounds, the fast delivery and its
slow branch (periodic text), and all three final-sort forms (by lowering
the port's thresholds).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops import sa_device as ref
from gecoz_tpu.ops.sa import bwt_from_sa, suffix_array_numpy
from gecoz_tpu_torch.ops import sa_device as port
from gecoz_tpu_torch.ops import sa_host

torch.set_num_threads(1)


@pytest.fixture
def ref_sorts(monkeypatch):
    """The reference on its sort (TPU) strategy, traces rebuilt."""
    monkeypatch.setattr(ref, "_scatter_is_cheap", lambda: False)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _run_block(rng, run=555, alphabet=b"ACGT"):
    return np.concatenate([
        rng.choice(np.frombuffer(alphabet, np.uint8), size=400),
        np.full(run, ord("N"), np.uint8),
        rng.choice(np.frombuffer(alphabet, np.uint8), size=400),
        np.zeros(1, np.uint8)])


def _both(s, ref_kw, port_kw, strategies=("sort", "scatter")):
    rsa, rbwt = ref._suffix_array_runs_jit(jnp.asarray(s), **ref_kw)
    rsa, rbwt = np.asarray(rsa), np.asarray(rbwt)
    assert np.array_equal(rsa, suffix_array_numpy(s))
    for strategy in strategies:
        sa, bwt = port._suffix_array_runs(torch.from_numpy(s.copy()),
                                          strategy=strategy, **port_kw)
        assert np.array_equal(sa.numpy(), rsa), (strategy, port_kw)
        assert np.array_equal(bwt.numpy(), rbwt), (strategy, port_kw)


def test_sort_branches_and_bounds(rng, ref_sorts):
    """tok_table / m_pad / ell_bits, each with and without the others."""
    s = _run_block(rng)
    syms = tuple(int(x) for x in np.unique(s))
    tight = max(1, int(sa_host.max_run_length(s)).bit_length())
    for ebs in (tight, sa_host.runs_ell_bits(s), None):
        tab = sa_host.runs_token_table(s, syms, ell_bits=ebs)
        assert tab is not None
        for mp in (None, sa_host.runs_m_pad(s)):
            for use_tab in (False, True):
                kw = dict(syms=syms, m_pad=mp, ell_bits=ebs)
                _both(s, dict(kw, tok_table=jnp.asarray(tab)
                              if use_tab else None),
                      dict(kw, tok_table=torch.from_numpy(tab)
                           if use_tab else None))


def test_m_pad_bounds(rng, ref_sorts):
    s = _run_block(rng, run=400)
    n = s.shape[0]
    m = int(np.count_nonzero(s[1:] != s[:-1])) + 1
    syms = tuple(int(x) for x in np.unique(s))
    for mp in (m, n - 1, n):
        _both(s, dict(syms=syms, m_pad=mp), dict(syms=syms, m_pad=mp))


@pytest.mark.parametrize("kind", ["slow", "fast"])
def test_fast_slow_delivery(kind, rng, ref_sorts):
    """Periodic text keeps ties past round one (slow branch); random text
    finishes in round one (fast branch)."""
    if kind == "slow":
        s = np.frombuffer(b"AC" * 3000 + b"GT\0", np.uint8).copy()
    else:
        s = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=4097)
        s[-1] = 0
    syms = tuple(int(x) for x in np.unique(s))
    ebs = sa_host.runs_ell_bits(s)
    tab = sa_host.runs_token_table(s, syms, ell_bits=ebs)
    kw = dict(syms=syms, m_pad=sa_host.runs_m_pad(s), ell_bits=ebs)
    for use_tab in (False, True):
        _both(s, dict(kw, tok_table=jnp.asarray(tab) if use_tab else None),
              dict(kw, tok_table=torch.from_numpy(tab) if use_tab else None,
                   r1_keys=sa_host.runs_r1_keys(tab) if use_tab else None),
              strategies=("sort",))
    # the scatter strategy on the same inputs, the reference on its CPU
    # branch (nr by gather) and with nr_mode="fill"
    jax.clear_caches()
    for nr_mode in ("auto", "fill"):
        sa, bwt = port._suffix_array_runs(torch.from_numpy(s.copy()),
                                          strategy="scatter",
                                          nr_mode=nr_mode, **kw)
        want = suffix_array_numpy(s)
        assert np.array_equal(sa.numpy(), want)
        assert np.array_equal(bwt.numpy(), bwt_from_sa(s, want))


def test_unpacked_seed_branch(rng, ref_sorts):
    """An alphabet wider than 7 symbols: no packed seed, the seed ranks
    come from a 2-key sort, the compaction from the fused two sorts."""
    s = _run_block(rng, run=300, alphabet=b"ABCDEFGHIJ")
    _both(s, {}, {})
    _both(s, dict(m_pad=sa_host.runs_m_pad(s)),
          dict(m_pad=sa_host.runs_m_pad(s)))


@pytest.mark.parametrize("form", ["code", "byte", "plain"])
def test_final_sort_forms(form, rng, monkeypatch):
    """The three final-sort forms give the same (sa, bwt)."""
    if form in ("byte", "plain"):
        monkeypatch.setattr(port, "FINAL_CODE_LIMIT", 0)
    if form == "plain":
        monkeypatch.setattr(port, "FINAL_BYTE_LIMIT", 0)
    s = _run_block(rng, run=200)
    want = suffix_array_numpy(s)
    syms = tuple(int(x) for x in np.unique(s))
    for strategy in ("sort", "scatter"):
        for kw in ({"syms": syms}, {}):
            sa, bwt = port._suffix_array_runs(torch.from_numpy(s.copy()),
                                              strategy=strategy, **kw)
            assert np.array_equal(sa.numpy(), want)
            assert np.array_equal(bwt.numpy(), bwt_from_sa(s, want))
