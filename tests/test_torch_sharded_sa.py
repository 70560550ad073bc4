"""The port's sharded suffix sort against gecoz_tpu's, on the CPU.

The port's mesh is a tuple of devices with repeats, here `(cpu,) * D`; the
reference runs `shard_map` over the conftest's 8 virtual CPU devices (as
tests/test_sharded_sa.py does).  Every comparison is exact: integer
arrays equal element for element.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax
from jax.sharding import Mesh, PartitionSpec as P

from gecoz_tpu.parallel import sharded_sa as ref
from gecoz_tpu_torch.ops import scan
from gecoz_tpu_torch.ops.sa import bwt_from_sa, suffix_array
from gecoz_tpu_torch.parallel import sharded_sa as ss

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mesh(D):
    return (CPU,) * D


def _shards(x, D):
    return [torch.from_numpy(np.ascontiguousarray(c)) for c in
            np.split(np.asarray(x), D)]


def _cat(shards):
    return ss.gather_shards(shards).numpy()


def _dna(rng, n, runs=True):
    s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    if runs:
        s[n // 3:n // 3 + n // 50] = ord("N")     # a long run
    cuts = np.sort(rng.choice(np.arange(1, n - 1), size=3, replace=False))
    s[cuts] = 0
    s[-1] = 0
    return s


def _ref_mesh(D):
    return Mesh(np.array(jax.devices()[:D]), ("seq",))


@pytest.mark.parametrize("D", [8, 6, 1])
def test_sorted_sharded_ties_and_values(rng, D):
    """Bitonic (8), odd-even transposition (6) and one shard: globally
    sorted signed keys with heavy ties and both ends of int32, the
    position as the distinctness key, values riding along, as the
    reference sorts them; the input shards are left as they were."""
    n = 4800
    ends = np.array([-(2 ** 31), -(2 ** 31) + 1, -1, 0, 2 ** 31 - 1],
                    np.int64)
    k = np.where(rng.random(n) < 0.2, rng.choice(ends, n),
                 rng.integers(-18, 19, n)).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)
    val = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    args = [_shards(a, D) for a in (k, pos, val)]
    before = [[t.clone() for t in a] for a in args]
    ks, ps, vs = [_cat(x) for x in ss.sorted_sharded(args, 2, _mesh(D))]
    order = np.argsort(k, kind="stable")
    assert np.array_equal(ks, k[order])
    assert np.array_equal(ps, pos[order])
    assert np.array_equal(vs, val[order])
    for a, b in zip(args, before):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    from jax import shard_map
    f = jax.jit(shard_map(lambda a, p, v: ref.sorted_sharded(
        (a, p, v), 2, "x", D), mesh=Mesh(np.array(jax.devices()[:D]), ("x",)),
        in_specs=(P("x"),) * 3, out_specs=(P("x"),) * 3))
    want = [np.asarray(x) for x in f(k, pos, val)]
    assert all(np.array_equal(a, b) for a, b in zip((ks, ps, vs), want))


def test_sorted_sharded_counts_sorts_and_rounds(rng):
    ss.reset_stats()
    keys = _shards(rng.permutation(64).astype(np.int32), 8)
    ss.sorted_sharded((keys,), 1, _mesh(8))
    ss.sorted_sharded((_shards(np.arange(60, dtype=np.int32), 6),), 1,
                      _mesh(6))
    # bitonic over 8 shards: 3 * 4 / 2 rounds; odd-even over 6: 6
    assert ss.STATS == {"sorts": 2, "rounds": 6 + 6}


@pytest.mark.parametrize("D", [8, 3])
def test_global_scans_match_numpy(rng, D):
    """The three shard-local scans with their carries equal numpy over
    the concatenated array (int32 min/max carries included), and go
    through ops/scan.py's entry points."""
    n = 37 * D
    x = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    small = rng.integers(-1000, 1000, n).astype(np.int32)
    calls = []
    for name in ("cumsum_i32", "cummax_i32", "cummin_rev_i32"):
        fn = getattr(scan, name)
        setattr(ss, name, lambda t, fn=fn, name=name: (calls.append(name),
                                                       fn(t))[1])
    try:
        got_sum = _cat(ss._global_cumsum(_shards(small, D), _mesh(D)))
        got_max = _cat(ss._global_cummax(_shards(x, D), _mesh(D)))
        got_min = _cat(ss._global_cummin_rev(_shards(x, D), _mesh(D)))
    finally:
        for name in ("cumsum_i32", "cummax_i32", "cummin_rev_i32"):
            setattr(ss, name, getattr(scan, name))
    assert np.array_equal(got_sum, np.cumsum(small))
    assert np.array_equal(got_max, np.maximum.accumulate(x))
    assert np.array_equal(got_min, np.minimum.accumulate(x[::-1])[::-1])
    assert sorted(set(calls)) == ["cummax_i32", "cummin_rev_i32",
                                  "cumsum_i32"]
    assert len(calls) == 3 * D


L_SHIFT, D_SHIFT = 40, 6


@pytest.mark.parametrize("k", [0, 1, L_SHIFT - 1, L_SHIFT, L_SHIFT + 1,
                               3 * L_SHIFT + 5, L_SHIFT * D_SHIFT,
                               2 * L_SHIFT * D_SHIFT])
def test_shift_k_matches_numpy(rng, k):
    """rank[i + k], -1 past the end or past a limit, for shifts inside a
    shard, across shard edges, past whole shards and past the array."""
    n = L_SHIFT * D_SHIFT
    rank = rng.integers(0, n, n).astype(np.int32)
    ig = _shards(np.arange(n, dtype=np.int32), D_SHIFT)
    shards = _shards(rank, D_SHIFT)
    for limit in (None, n - 7, 13):
        end = n if limit is None else limit
        want = np.full(n, -1, np.int32)
        if k < end:
            want[:end - k] = rank[k:end]
        got = _cat(ss._shift_k(shards, k, ig, n, _mesh(D_SHIFT), limit))
        assert np.array_equal(got, want), limit
    assert np.array_equal(_cat(shards), rank)          # read-only


# the reference compiles a program per (n, D, impl): it is compared where
# the port could differ from the true suffix array (the tiny-shard quirk of
# the k-mer seed) and at one padded and one unpadded size
@pytest.mark.parametrize("n,D,impl", [
    (5, 3, "kmer"), (5, 8, "kmer"), (777, 1, "kmer"), (777, 1, "runs"),
    (777, 3, "kmer"), (777, 3, "runs"), (777, 8, "kmer"), (777, 8, "runs"),
    (10_007, 8, "kmer"), (10_007, 8, "runs")])
def test_suffix_array_sharded_equals_reference(rng, n, D, impl):
    s = np.array([65, 0, 67, 65, 0], np.uint8) if n == 5 else _dna(rng, n)
    sa, bwt = ss.suffix_array_sharded(s, mesh=_mesh(D), impl=impl)
    want_sa, want_bwt = ref.suffix_array_sharded(s, mesh=_ref_mesh(D),
                                                 impl=impl)
    assert np.array_equal(_cat(sa), np.asarray(want_sa))
    assert np.array_equal(_cat(bwt), np.asarray(want_bwt))
    assert [x.shape[0] for x in sa] == [x.shape[0] for x in bwt]


@pytest.mark.parametrize("D", [1, 3, 8])
@pytest.mark.parametrize("n", [4096, 10_007, 65_536])
def test_suffix_array_sharded_equals_host(rng, n, D):
    """Both impls equal the host suffix array and BWT (ops/sa.py), at an
    unpadded size, one that pads to a multiple of D, and 64 Ki with an N
    run of 1 Ki."""
    s = _dna(rng, n)
    want = suffix_array(s)
    for impl in ("runs", "kmer"):
        sa, bwt = ss.suffix_array_sharded(s, mesh=_mesh(D), impl=impl)
        assert np.array_equal(_cat(sa), want), impl
        assert np.array_equal(_cat(bwt), bwt_from_sa(s, want)), impl


def test_auto_picks_runs_on_long_runs(rng, monkeypatch):
    s = _dna(rng, 30_000)
    picked = []
    for name in ("_suffix_array_sharded", "_suffix_array_sharded_runs"):
        fn = getattr(ss, name)
        monkeypatch.setattr(ss, name, lambda *a, fn=fn, name=name: (
            picked.append(name), fn(*a))[1])
    sa, _ = ss.suffix_array_sharded(s, mesh=_mesh(4))
    assert picked == ["_suffix_array_sharded_runs"]
    assert np.array_equal(_cat(sa), suffix_array(s))
    ss.suffix_array_sharded(_dna(rng, 3000, runs=False), mesh=_mesh(4))
    assert picked[-1] == "_suffix_array_sharded"


class _FakeLen:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __array__(self, dtype=None, copy=None):
        raise AssertionError("should decide before materializing")


def test_block_size_contract_without_allocating():
    """2^31 bytes and up are refused before the array is touched; [2^30,
    2^31) takes 'kmer' (runs packs int31 positions), whatever was asked;
    the run-aware variant itself refuses 2^30 (shards of the meta device
    hold no memory)."""
    with pytest.raises(ValueError, match="2\\^31"):
        ss.suffix_array_sharded(_FakeLen(1 << 31), mesh=_mesh(8))
    for impl in ("auto", "runs", "kmer"):
        assert ss._pick_impl(_FakeLen(1 << 30), impl) == "kmer"
    meta = [torch.empty(1 << 27, dtype=torch.uint8, device="meta")] * 8
    with pytest.raises(ValueError, match="1 GiB"):
        ss._suffix_array_sharded_runs(meta, 1 << 30, 0,
                                      (torch.device("meta"),) * 8, (65,))
    with pytest.raises(ValueError, match="impl"):
        ss._pick_impl(np.zeros(4, np.uint8), "sais")
