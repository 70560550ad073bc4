"""Sharded suffix sort: blocks larger than one card's memory.

Port of gecoz_tpu/parallel/sharded_sa.py (see its docstring for the
algorithm).  The array is block-distributed over a mesh of D devices
(`gecoz_tpu_torch.parallel.Mesh`): a shard list holds D equal tensors,
shard d on `mesh[d]`, global positions [d*L, (d+1)*L).  What the
reference's `shard_map` program does per device, the functions here do per
shard, in a Python loop on one controller:

* a neighbour exchange (`ppermute`) moves a shard's tensor to its
  destination device (`Tensor.to`, the same tensor when it is already
  there: nothing here writes a shard in place, so an exchange within one
  device may alias its sender);
* a [D]-scalar all-gather becomes a carry chained over the D shard totals;
* the shard-local scans are the port's scan entry points (`cumsum_i32`,
  `cummax_i32`, `cummin_rev_i32`), which launch `csrc/scan.cu` on a CUDA
  shard and run the plain versions on a CPU shard;
* the multi-key `lax.sort` is `ops/sa_device.py::lexsort` (stable, signed
  int32 order), its permutation gathering the value operands;
* a pair's exchange-merge-split sorts the pair's 2L elements once, on the
  lower shard's device, and sends the other half back: with the distinct
  keys the callers pass, that is what both sides of the reference compute;
* the loop conditions (`done`, the token count, the group count) are read
  on the host once per round, as the single-card sort reads them.

On a virtual mesh (`(cuda:0,) * D`) every shard lies on one card: the run
measures the algorithm's device work, not an interconnect.
"""

from __future__ import annotations

import numpy as np
import torch

from gecoz_tpu_torch.ops.sa_device import lexsort
from gecoz_tpu_torch.ops.sa_host import RUN_THRESHOLD, max_run_length
from gecoz_tpu_torch.ops.scan import cummax_i32, cummin_rev_i32, cumsum_i32
from gecoz_tpu_torch.parallel import Mesh, local_mesh

_I32 = torch.int32
_I32_MIN = -(2 ** 31)
_I32_MAX = 2 ** 31 - 1

Shards = list[torch.Tensor]

# distributed sorts and their exchange rounds since the last reset
STATS = {"sorts": 0, "rounds": 0}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


# -- collective building blocks ----------------------------------------------

def _prev_last(xs: Shards, mesh: Mesh, fill) -> Shards:
    """[1] per shard: the previous shard's last element (shard 0: `fill`)."""
    return ([torch.full((1,), fill, dtype=xs[0].dtype, device=mesh[0])]
            + [xs[d - 1][-1:].to(mesh[d]) for d in range(1, len(mesh))])


def _next_head(xs: Shards, t: int, mesh: Mesh, fill) -> Shards:
    """[t] per shard: the next shard's first t elements (the last shard:
    `fill`)."""
    D = len(mesh)
    return ([xs[d + 1][:t].to(mesh[d]) for d in range(D - 1)]
            + [torch.full((t,), fill, dtype=xs[0].dtype, device=mesh[-1])])


def _shift_small(xs: Shards, t: int, mesh: Mesh, fill) -> Shards:
    """x[i + t] with `fill` past the global end; t < L."""
    if t == 0:
        return xs
    return [torch.cat([x[t:], h])
            for x, h in zip(xs, _next_head(xs, t, mesh, fill))]


def _carry(tops: Shards, mesh: Mesh, op, unit: int,
           reverse: bool = False) -> Shards:
    """[1] per shard: `op` folded over the [1] values of the shards before
    it (after it with `reverse`), `unit` where there are none."""
    D = len(mesh)
    out: list = [None] * D
    acc = None
    for d in (range(D - 1, -1, -1) if reverse else range(D)):
        out[d] = (torch.full((1,), unit, dtype=_I32, device=mesh[d])
                  if acc is None else acc.to(mesh[d]))
        acc = tops[d] if acc is None else op(acc.to(mesh[d]), tops[d])
    return out


def _global_cumsum(xs: Shards, mesh: Mesh) -> Shards:
    """Inclusive cumsum over the global (concatenated) array."""
    loc = [cumsum_i32(x) for x in xs]
    carry = _carry([x[-1:] for x in loc], mesh, torch.add, 0)
    return [x + c for x, c in zip(loc, carry)]


def _global_cummax(xs: Shards, mesh: Mesh) -> Shards:
    """Inclusive forward cummax over the global array: shard-local scans
    and a carry of the shard tops (int32 min before shard 0)."""
    loc = [cummax_i32(x) for x in xs]
    carry = _carry([x[-1:] for x in loc], mesh, torch.maximum, _I32_MIN)
    return [torch.maximum(x, c) for x, c in zip(loc, carry)]


def _global_cummin_rev(xs: Shards, mesh: Mesh) -> Shards:
    """Inclusive REVERSE cummin over the global array (int32 max past the
    last shard)."""
    loc = [cummin_rev_i32(x) for x in xs]
    carry = _carry([x[:1] for x in loc], mesh, torch.minimum, _I32_MAX,
                   reverse=True)
    return [torch.minimum(x, c) for x, c in zip(loc, carry)]


def sorted_sharded(operands, num_keys: int, mesh: Mesh) -> tuple:
    """Globally sort equally-sharded operands (each a shard list); the
    result is block-distributed (shard d holds global slice [d*L,
    (d+1)*L)).  The first `num_keys` operands are int32 keys, compared in
    signed order, most significant first.

    A block-level sorting network with compare-exchange lifted to
    exchange-merge-split: each shard is sorted locally, then a comparator
    sorts a pair's 2L elements and the designated side keeps the lower
    half.  A power-of-two D takes the bitonic network (log2(D)(log2(D)+1)/2
    rounds over hypercube partners), any other D odd-even transposition
    (D rounds, neighbours only; a shard with no partner keeps its
    operands).

    REQUIREMENT (the reference's): the keys must form a globally DISTINCT
    total order; callers append the position as the last key.
    """
    STATS["sorts"] += 1
    D = len(mesh)
    ops = [list(op) for op in operands]
    for d in range(D):
        _, perm = lexsort([op[d] for op in ops[:num_keys]])
        for op in ops:
            op[d] = op[d][perm]
    if D == 1:
        return tuple(ops)
    L = ops[0][0].shape[0]

    def merge(a: int, b: int, a_low: bool) -> None:
        cat = [torch.cat([op[a], op[b].to(mesh[a])]) for op in ops]
        _, perm = lexsort(cat[:num_keys])
        lo, hi = (perm[:L], perm[L:]) if a_low else (perm[L:], perm[:L])
        for op, c in zip(ops, cat):
            op[a], op[b] = c[lo], c[hi].to(mesh[b])

    if D & (D - 1) == 0:
        # bitonic: phase k builds sorted runs of 2^k shards; stage j pairs
        # shards at hypercube distance 2^j, ascending where bit k is clear
        for k in range(1, D.bit_length()):
            for j in range(k - 1, -1, -1):
                STATS["rounds"] += 1
                for i in range(D):
                    if i & (1 << j) == 0:
                        merge(i, i | (1 << j), (i >> k) & 1 == 0)
        return tuple(ops)
    for rnd in range(D):
        STATS["rounds"] += 1
        for a in range(rnd % 2, D - 1, 2):
            merge(a, a + 1, True)
    return tuple(ops)


# -- suffix-array building blocks ---------------------------------------------

def _shift_k(rank: Shards, k: int, ig: Shards, n: int, mesh: Mesh,
             limit: int | None = None) -> Shards:
    """rank[i + k] with -1 past position `limit` (default the global end).

    A rotation of the block-distributed array: whole shards by k // L, then
    the k % L remainder slid off the next shard.  (The reference rotates by
    the bits of k // L; where the two differ, k >= n and every position is
    masked.)  The mask bound is a host integer: it goes negative for k > n,
    and then every position reads -1."""
    D, L = len(mesh), rank[0].shape[0]
    thr = (n if limit is None else limit) - k
    if thr <= 0:
        return [torch.full_like(r, -1) for r in rank]
    q, r = divmod(k, L)
    out = []
    for d in range(D):
        y = rank[(d + q) % D].to(mesh[d])
        if r:
            y = torch.cat([y[r:], rank[(d + q + 1) % D][:r].to(mesh[d])])
        out.append(torch.where(ig[d] < thr, y, -1))
    return out


def _sort_rerank_n(keys: tuple, pos: Shards, vals: tuple, n: int,
                   mesh: Mesh):
    """Sort by (*keys, pos): pos is the distinctness tiebreaker; the dense
    re-rank ignores it.  `vals` ride the sort.  Returns
    (rank_by_position, pos_in_rank_order, vals_in_rank_order,
    all_distinct), the last read on the host."""
    nk = len(keys)
    ops = sorted_sharded(tuple(keys) + (pos,) + tuple(vals), nk + 1, mesh)
    ks, pos_s, vals_s = ops[:nk], ops[nk], ops[nk + 1:]
    diff = [torch.zeros(k.shape, dtype=torch.bool, device=k.device)
            for k in ks[0]]
    for k in ks:
        prev = _prev_last(k, mesh, -(2 ** 31) + 1)
        diff = [df | (x != torch.cat([p, x[:-1]]))
                for df, x, p in zip(diff, k, prev)]
    ranks_sorted = [r - 1 for r in _global_cumsum(
        [df.to(_I32) for df in diff], mesh)]
    # ranks back to position order: one more value-carrying sort
    _, rank_pos = sorted_sharded((pos_s, ranks_sorted), 1, mesh)
    done = int(ranks_sorted[-1][-1]) == n - 1
    return list(rank_pos), pos_s, vals_s, done


def _bwt_source(s32: Shards, ig: Shards, last_real: int,
                mesh: Mesh) -> Shards:
    """Previous byte, cyclic over the REAL text (the BWT gather operand);
    `last_real` is the text's last byte."""
    prev = _prev_last(s32, mesh, 0)
    return [torch.where(i == 0, last_real, torch.cat([p, x[:-1]]))
            for x, i, p in zip(s32, ig, prev)]


def _symbol_table(symbols) -> np.ndarray:
    """byte -> 1 + its index among the sorted symbols (0 elsewhere)."""
    table = np.zeros(256, dtype=np.int32)
    for i, sym in enumerate(sorted(symbols)):
        table[sym] = i + 1
    return table


def _setup(s: Shards, n_real: int, last_real: int, mesh: Mesh, symbols):
    """(global positions, dense codes with padding 0, BWT source)."""
    L = s[0].shape[0]
    table = torch.from_numpy(_symbol_table(symbols))
    ig = [d * L + torch.arange(L, dtype=_I32, device=dev)
          for d, dev in enumerate(mesh)]
    codes = [torch.where(i < n_real, table.to(x.device)[x.long()], 0)
             for x, i in zip(s, ig)]
    sprev = _bwt_source([x.to(_I32) for x in s], ig, last_real, mesh)
    return ig, codes, sprev


# -- the two sharded suffix arrays -----------------------------------------

def _suffix_array_sharded(s: Shards, n_real: int, last_real: int,
                          mesh: Mesh, symbols: tuple[int, ...]):
    """K-mer-seeded variant (reference `_suffix_array_sharded_jit`).
    Padded input shards (uint8) -> (sa, bwt) shards in suffix-rank order.

    Positions >= n_real are padding and read as code 0 (below every real
    symbol), so they occupy the first n - n_real rank slots;
    `suffix_array_sharded` strips them."""
    D, L = len(mesh), s[0].shape[0]
    n = D * L
    bits = max(1, len(symbols).bit_length())
    chars_per = max(1, 31 // bits)
    ig, codes, sprev = _setup(s, n_real, last_real, mesh, symbols)

    # k-mer seed rank: pack chars_per dense codes into one int31 word (the
    # reference caps the shift at L - 1)
    rank = [torch.zeros(L, dtype=_I32, device=dev) for dev in mesh]
    for t in range(chars_per):
        rank = [(r << bits) | c for r, c in zip(
            rank, _shift_small(codes, min(t, L - 1), mesh, 0))]
    # the reference's all-zero second key changes no order and no group
    rank, sa_k, (bwt_k,), done = _sort_rerank_n((rank,), ig, (sprev,), n,
                                                mesh)
    # k is capped at n: a shift by >= n is already the final round
    k = chars_per
    while not done and k < n:
        r2 = _shift_k(rank, k, ig, n, mesh)
        rank, sa_k, (bwt_k,), done = _sort_rerank_n((rank, r2), ig,
                                                    (sprev,), n, mesh)
        k = n if k > n // 2 else k * 2
    return list(sa_k), [b.to(torch.uint8) for b in bwt_k]


def _suffix_array_sharded_runs(s: Shards, n_real: int, last_real: int,
                               mesh: Mesh, symbols: tuple[int, ...]):
    """Run-aware variant (reference `_suffix_array_sharded_runs_jit`):
    run-key seeding + token-string doubling, so equal-symbol runs cost no
    extra rounds; the next-run rank is broadcast run-wide by `chunks`
    passes of a global cummax; one final 3-key sort carries the BWT."""
    D, L = len(mesh), s[0].shape[0]
    n = D * L
    if n >= 1 << 30:
        raise ValueError("run-aware sharded SA packs (position, side) "
                         "into int31; split blocks above 1 GiB")
    pos_bits = max(1, (n - 1).bit_length())
    cb = 31 - pos_bits                       # value-chunk bits per fill pass
    vbits = max(1, int(n).bit_length())      # fill values in [0, n]
    chunks = -(-vbits // cb)
    ig, codes, sprev = _setup(s, n_real, last_real, mesh, symbols)

    # -- exact run keys (c, side, +/-ell) ---------------------------------
    nxt = _shift_small(codes, 1, mesh, -1)
    is_end = [c != x for c, x in zip(codes, nxt)]    # last of each run
    pe = _prev_last([e.to(_I32) for e in is_end], mesh, 1)
    is_start = [torch.cat([p, e[:-1].to(_I32)]).bool()
                for p, e in zip(pe, is_end)]
    run_id = [r - 1 for r in _global_cumsum(
        [st.to(_I32) for st in is_start], mesh)]
    m = int(run_id[-1][-1]) + 1                      # number of runs
    packed = [torch.where(e, (i << 1) | (x < c).to(_I32), 2 * n)
              for e, i, x, c in zip(is_end, ig, nxt, codes)]
    v = _global_cummin_rev(packed, mesh)
    key1, key2 = [], []
    for vv, i, c in zip(v, ig, codes):
        below = (vv & 1).bool()
        ell = (vv >> 1) - i + 1                      # remaining run length
        key1.append((c << 1) | (~below).to(_I32))
        key2.append(torch.where(below, ell, -ell))
    rank0, _, _, done0 = _sort_rerank_n((key1, key2), ig, (), n, mesh)

    # -- compact to the token string: slot j = rank0 at run j's start ----
    ckey = [torch.where(st, r, n + i) for st, r, i in zip(is_start, run_id,
                                                           ig)]
    _, tok_r, starts_full = sorted_sharded((ckey, rank0, ig), 1, mesh)
    tok = [torch.where(i < m, t, n + i) for i, t in zip(ig, tok_r)]
    pad_key1 = [_I32_MAX - (n - 1 - i) for i in ig]

    def trerank(keys):
        ks = ([[torch.where(i < m, x, p) for i, x, p in zip(ig, keys[0],
                                                            pad_key1)]]
              + [[torch.where(i < m, x, 0) for i, x in zip(ig, kk)]
                 for kk in keys[1:]])
        rank, _, _, done = _sort_rerank_n(tuple(ks), ig, (), n, mesh)
        return rank, done

    # adaptive rank packing: while the group count B fits, 2-3 ranks pack
    # into each int32 key; B is known on the host here, so only the chosen
    # packing is built
    t3 = 1
    while (t3 + 1) ** 3 <= (1 << 31) - n - 2:
        t3 += 1
    t2 = 1
    while (t2 + 1) ** 2 <= (1 << 31) - n - 2:
        t2 += 1

    def packed_round(rank, k: int, nkeys: int = 2):
        """One token-doubling round covering up to 3*nkeys*k tokens."""
        B = int(torch.stack([torch.where(i < m, r, -1).max().to(mesh[0])
                             for i, r in zip(ig, rank)]).max()) + 2
        p = 3 if B <= t3 else 2 if B <= t2 else 1

        def sh(t):
            # shifts saturate at n (a shift past the end reads -1, +1 = 0)
            off = n if k > n // t else t * k
            return [x + 1 for x in _shift_k(rank, off, ig, n, mesh, limit=m)]
        r = [rank] + [sh(t) for t in range(1, p * nkeys)]
        keys = []
        for j in range(nkeys):
            acc = r[p * j]
            for t in range(p * j + 1, p * (j + 1)):
                acc = [a * B + x for a, x in zip(acc, r[t])]
            keys.append(acc)
        rank, done = trerank(keys)
        mult = 2 if k > ((1 << 31) - 1) // (3 * nkeys) else p * nkeys
        return rank, k * mult, done

    rank, k, done = packed_round(tok, 1, nkeys=3)
    done = done or done0
    while not done and k < 2 * n:
        rank, k, done = packed_round(rank, k)

    # -- rank of the NEXT run's start, broadcast over each run ----------
    nrank = _shift_k(rank, 1, ig, n, mesh, limit=m)
    # placement sort: position starts_full[j] receives nrank[j]
    _, placed = sorted_sharded((starts_full, nrank), 1, mesh)
    nr = [torch.zeros(L, dtype=_I32, device=dev) for dev in mesh]
    low = (1 << cb) - 1
    for c in range(chunks):
        pk = [torch.where(st, (i << cb) | (((x + 1) >> (c * cb)) & low), -1)
              for st, i, x in zip(is_start, ig, placed)]
        nr = [a | ((f & low) << (c * cb))
              for a, f in zip(nr, _global_cummax(pk, mesh))]
    nr = [x - 1 for x in nr]

    # -- final order: one sort by (rank0, nr); BWT rides along ----------
    _, _, sa_k, bwt_k = sorted_sharded((rank0, nr, ig, sprev), 3, mesh)
    return list(sa_k), [b.to(torch.uint8) for b in bwt_k]


def _drop_front(xs: Shards, k: int) -> Shards:
    """The global array without its first k elements (shards shorten)."""
    out = []
    for x in xs:
        cut = min(k, x.shape[0])
        out.append(x[cut:])
        k -= cut
    return out


def gather_shards(xs: Shards, device="cpu") -> torch.Tensor:
    """The global array of a shard list, on `device`."""
    return torch.cat([x.to(device) for x in xs])


def _pick_impl(s, impl: str) -> str:
    """'runs' or 'kmer' for the block `s`: 'auto' takes 'runs' past the
    run threshold; blocks of 2^30 bytes and more take 'kmer'."""
    n = len(s)
    if impl == "auto":
        impl = ("runs" if n and n < (1 << 30)
                and max_run_length(s) > RUN_THRESHOLD else "kmer")
    if impl == "runs" and n >= 1 << 30:
        impl = "kmer"                       # runs packs int31 positions
    if impl not in ("runs", "kmer"):
        raise ValueError(f"impl must be auto, runs or kmer, got {impl!r}")
    return impl


def suffix_array_sharded(s, mesh: Mesh | None = None,
                         symbols: tuple[int, ...] | None = None,
                         impl: str = "auto"):
    """Suffix array + BWT of the host uint8 array `s` over a mesh (default:
    every local card, `local_mesh()`).

    Returns (sa, bwt) as shard lists in suffix-rank order: sa int32, bwt
    uint8, shard d on mesh[d], together len(s) long (the first shards are
    shorter by the stripped padding).  `gather_shards` brings either to
    one device, or to the host.

    impl: 'kmer' (dense-packed prefix doubling), 'runs' (run-key seeding
    + token doubling, immune to long equal-symbol runs), or 'auto' (runs
    past the single-card sort's run threshold).  Blocks are capped at 2^31
    bytes (the int32-SA contract, SAIS.java:103); 'runs' packs (position,
    side) into int31, so blocks in [2^30, 2^31) take 'kmer'.  The text is
    padded with (-n) % D zero bytes to a multiple of D; the padding ranks
    first and its slots are stripped.
    """
    if len(s) >= 1 << 31:
        raise ValueError("blocks are capped at 2^31 bytes by the int32-SA "
                         "contract (SAIS.java:103)")
    s = np.ascontiguousarray(s, dtype=np.uint8)
    n = len(s)
    mesh = local_mesh() if mesh is None else tuple(
        torch.device(d) for d in mesh)
    D = len(mesh)
    if symbols is None:
        symbols = tuple(int(x) for x in np.flatnonzero(
            np.bincount(s, minlength=256)))
    impl = _pick_impl(s, impl)
    if n == 0:
        return ([torch.zeros(0, dtype=_I32, device=dev) for dev in mesh],
                [torch.zeros(0, dtype=torch.uint8, device=dev)
                 for dev in mesh])
    pad = (-n) % D
    padded = np.concatenate([s, np.zeros(pad, np.uint8)])
    L = len(padded) // D
    shards = [torch.from_numpy(padded[d * L:(d + 1) * L]).to(dev)
              for d, dev in enumerate(mesh)]
    fn = (_suffix_array_sharded_runs if impl == "runs"
          else _suffix_array_sharded)
    sa, bwt = fn(shards, n, int(s[n - 1]), mesh, symbols)
    return _drop_front(sa, pad), _drop_front(bwt, pad)
