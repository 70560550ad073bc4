"""Suffix-array construction on the card (PyTorch): prefix doubling.

Port of gecoz_tpu/ops/sa_device.py (lines 35-577 and 766-814).  The
algorithms, names and branch structure follow the reference; see its
docstrings for the why of each step.  What changes in PyTorch:

* The reference picks scatters (its CPU branch) or sorts (its TPU branch)
  when the program is traced (`_scatter_is_cheap`).  Here the choice is an
  explicit argument, ``strategy="sort"|"scatter"``, both branches are kept,
  and both give the same (sa, bwt).  ``"sort"`` is the default: it is the
  branch the reference runs on its accelerator and the one that carries
  all three scan kernels.
* `lax.sort` with several keys has no torch counterpart: `lexsort` runs
  LSD passes of a stable `torch.sort`, two 32-bit keys packed per int64.
  Sorting stably everywhere gives the reference's outputs (its tie
  arguments make them independent of tie order).
* uint32 keys are held in int64 (torch has no uint32 shifts or compares
  on the CPU); packing masks to 32 bits after each step, which reproduces
  the reference's wrap.
* `lax.while_loop`/`lax.cond` become Python loops and branches on a
  `.item()` flag: one host sync per doubling round.
* `lax.dynamic_slice` clamps its start; the shifts here clamp the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from gecoz_tpu_torch.ops.sa_host import (RUN_THRESHOLD, dense_table,
                                         max_run_length, runs_ell_bits,
                                         runs_m_pad, runs_r1_keys,
                                         runs_token_table)
from gecoz_tpu_torch.ops.scan import cumsum_i32, fill_fwd_i32, fill_rev_i32

STRATEGIES = ("sort", "scatter")

# final-sort forms of `_suffix_array_runs` (reference lines 551 and 567):
# below FINAL_CODE_LIMIT (with a static alphabet) the value operand packs
# (position << 4 | 4-bit BWT code), below FINAL_BYTE_LIMIT (position << 8 |
# BWT byte); above both, position and BWT byte ride separately.  Module
# constants so a test can lower them and reach every form at small n.
FINAL_CODE_LIMIT = 1 << 27
FINAL_BYTE_LIMIT = 1 << 23

_I32 = torch.int32
_U32_MASK = 0xFFFFFFFF


def check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, "
                         f"got {strategy!r}")


def apply_perm(dest: torch.Tensor, *vals: torch.Tensor,
               strategy: str = "sort"):
    """out[dest[j]] = vals[j] for each value tensor; `dest` a permutation.

    "sort": one sort of `dest` and a gather per value; "scatter": plain
    scatters."""
    if strategy == "scatter":
        idx = dest.long()
        outs = tuple(torch.empty_like(v).index_put_((idx,), v) for v in vals)
    else:
        order = torch.sort(dest, stable=True).indices
        outs = tuple(v[order] for v in vals)
    return outs if len(outs) > 1 else outs[0]


def _as_u32(key: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """Order-preserving map of a 32-bit key into int64 [0, 2^32)."""
    if unsigned:
        return key.long()
    return key.long() + (1 << 31)


def lexsort(keys, unsigned: bool = False):
    """Sort by the key tuple (most significant first), stably.

    `keys` are int32 (signed order) or, with `unsigned`, int64 holding
    uint32 values.  Returns (sorted composite keys, permutation): two
    32-bit keys pack into one int64 composite (high key XOR the sign bit),
    and the composites are sorted LSD, least significant first, carrying
    the permutation.  Two positions are tied exactly when all their
    composites are equal."""
    if len(keys) == 1 and not unsigned:
        ks, perm = torch.sort(keys[0], stable=True)
        return [ks], perm
    ks = [_as_u32(k, unsigned) for k in keys]
    comp = []
    for i in range(0, len(ks), 2):
        if i + 1 < len(ks):
            comp.append((ks[i] - (1 << 31)) * (1 << 32) + ks[i + 1])
        else:
            comp.append(ks[i])
    perm = None
    for key in reversed(comp):
        _, idx = torch.sort(key if perm is None else key[perm], stable=True)
        perm = idx if perm is None else perm[idx]
    return [c[perm] for c in comp], perm


def _group_ranks(sorted_keys) -> torch.Tensor:
    """Dense ranks in sort order: cumsum over key-change flags, minus 1."""
    n = sorted_keys[0].shape[0]
    diff = torch.zeros(n - 1, dtype=torch.bool, device=sorted_keys[0].device)
    for k in sorted_keys:
        diff |= k[1:] != k[:-1]
    new_group = torch.cat([torch.ones(1, dtype=_I32, device=diff.device),
                           diff.to(_I32)])
    return cumsum_i32(new_group) - 1


def _sort_rerank_n(keys, strategy: str = "sort", unsigned: bool = False):
    """Sort positions by the key tuple; return (new dense ranks in
    position order, sort order, all-distinct flag)."""
    n = keys[0].shape[0]
    ks, perm = lexsort(keys, unsigned=unsigned)
    ranks_in_order = _group_ranks(ks)
    order = perm.to(_I32)
    rank = apply_perm(order, ranks_in_order, strategy=strategy)
    done = bool(ranks_in_order[n - 1] == n - 1)
    return rank, order, done


def _sort_rerank(key1, key2, strategy: str = "sort"):
    """2-key variant of `_sort_rerank_n`."""
    return _sort_rerank_n((key1, key2), strategy)


def _sort_rerank1(key, strategy: str = "sort"):
    """1-key variant of `_sort_rerank_n`."""
    return _sort_rerank_n((key,), strategy)


def _shift(r: torch.Tensor, k: int, fill: int = -1) -> torch.Tensor:
    """r[i+k] with `fill` past the end: the reference's dynamic slice of
    [r, fill * len(r)], start clamped to len(r) like `lax.dynamic_slice`."""
    start = min(max(int(k), 0), r.shape[0])
    if start == 0:
        return r
    return torch.cat([r[start:], torch.full((start,), fill, dtype=r.dtype,
                                            device=r.device)])


def _suffix_array(s: torch.Tensor, dense: torch.Tensor | None = None,
                  bits: int = 9, strategy: str = "sort") -> torch.Tensor:
    """Suffix array of `s` (uint8 [n]) by k-mer-seeded prefix doubling
    (reference `_suffix_array_jit`, 112-165).

    `dense` maps byte -> dense code in [1, 2^bits); identity+1 when None.
    """
    check_strategy(strategy)
    n = s.shape[0]
    if dense is None:
        codes = s.to(_I32) + 1
    else:
        codes = dense.to(device=s.device, dtype=_I32)[s.long()]
    # pack chars_per dense codes into one int31 word, big-endian, so
    # integer order == lexicographic order (past-the-end reads 0)
    chars_per = max(1, 31 // bits)
    rank = torch.zeros(n, dtype=_I32, device=s.device)
    for t in range(chars_per):
        rank = (rank << bits) | _shift(codes, min(t, n), fill=0)
    # the packed word is a valid (non-dense) rank; round one starts there
    k = min(chars_per, n)
    rank, order, done = _sort_rerank(rank, _shift(rank, k), strategy)
    k = chars_per * 2
    while not done and k < 2 * n:
        rank, order, done = _sort_rerank(rank, _shift(rank, k), strategy)
        k *= 2
    # once ranks are all distinct, the last sort order IS the suffix array
    return order


def _symbol_luts(syms, device):
    """(byte -> dense code, dense code -> byte) tables of a static alphabet:
    code = number of alphabet symbols <= byte (the reference's compare-sum
    over `syms`, one gather here)."""
    up = np.zeros(256, np.int32)
    for sym in syms:
        up[sym:] += 1
    down = np.zeros(16, np.uint8)
    for i, sym in enumerate(sorted(syms)):
        down[i + 1] = sym
    return (torch.from_numpy(up).to(device),
            torch.from_numpy(down).to(device))


def _suffix_array_runs(s: torch.Tensor, nr_mode: str = "auto",
                       syms: tuple[int, ...] | None = None,
                       r1_keys: int | None = None,
                       m_pad: int | None = None,
                       tok_table: torch.Tensor | None = None,
                       ell_bits: int | None = None,
                       strategy: str = "sort"):
    """Run-aware suffix array + BWT (reference `_suffix_array_runs_jit`,
    171-577): exact run keys seed the ranks, the text is compacted to its
    run-token string, prefix doubling orders the tokens, and one final
    sort by (seed rank, rank of the next run's start) orders every
    position, carrying the BWT.

    `syms`, `m_pad`, `tok_table`, `ell_bits` and `r1_keys` are the host's
    static bounds and run-key table (`ops/sa_host.py`), with the
    reference's contracts.  Returns (sa int32, bwt uint8).
    """
    check_strategy(strategy)
    n = s.shape[0]
    if n >= 1 << 30:
        raise ValueError("run-aware device SA packs (position, side) into "
                         "int31; split blocks above 1 GiB")
    dev = s.device
    M = n if m_pad is None else max(1, min(int(m_pad), n))
    iota = torch.arange(n, dtype=_I32, device=dev)
    iota_m = iota[:M]
    eb = int(n).bit_length() if ell_bits is None \
        else min(int(ell_bits), int(n).bit_length())
    sym_bits = max(len(syms), 1).bit_length() if syms else 0
    pack_seed = bool(syms) and sym_bits + 1 + eb <= 31
    if pack_seed:
        up_lut, down_lut = _symbol_luts(syms, dev)
        codes = up_lut[s.long()]
    else:
        codes = s.to(_I32) + 1
    nxt = _shift(codes, 1)
    is_end = codes != nxt                      # last position of each run
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          is_end[:-1]])
    run_id = cumsum_i32(is_start.to(_I32)) - 1
    m = int(run_id[n - 1]) + 1                 # number of runs
    # one backward segmented fill carries (run end << 1 | below-side bit)
    # to every member of the run
    below_end = nxt < codes
    v = fill_rev_i32(torch.where(is_end, (iota << 1) | below_end.to(_I32),
                                 -1))
    nde = v >> 1                               # inclusive next run end
    below = (v & 1).bool()
    ell = nde - iota + 1                       # remaining run length >= 1
    if pack_seed:
        # the whole run key (c, side, +/-ell) packs into one int31 word,
        # an order-isomorphic key, so it IS the seed rank
        above = (~below).to(_I32)
        rank0 = ((codes << (1 + eb)) | (above << eb)
                 | torch.where(below, ell, (1 << eb) - ell))
        done0 = False
    else:
        key1 = (codes << 1) | (~below).to(_I32)
        key2 = torch.where(below, ell, -ell)
        rank0, _, done0 = _sort_rerank(key1, key2, strategy)

    # compact to the token string: slot j = seed rank at run j's start,
    # re-densified over token values; pad slots m..n-1 sort last
    starts_full = None
    if strategy == "scatter":
        drop = torch.where(is_start, run_id, n).long()
        tok = torch.cat([n + iota, iota[:1]])
        tok.index_put_((drop,), rank0)         # slot n swallows non-starts
        tok = tok[:n]
        pad = (iota >= m).to(_I32)
        tok, _, _ = _sort_rerank(pad, tok, strategy)
        tok = tok[:M]
    elif pack_seed and tok_table is not None:
        # host-tabled densify: dense0 = number of table keys <= rank0 (the
        # reference's compare-sum over the sorted table; INT32_MAX padding
        # never counts), then one sort puts run starts first, ascending
        tab = tok_table.to(device=dev, dtype=_I32)
        dense0 = torch.searchsorted(tab, rank0, right=True, out_int32=True)
        ckey = torch.where(is_start, iota, (1 << 30) + iota)
        skeys, perm = torch.sort(ckey, stable=True)
        starts_full = skeys & ((1 << 30) - 1)
        tok = dense0[perm[:M]]                 # pad slots carry junk
    else:
        # fused compaction + densify in two sorts: (not-a-start, seed
        # rank) groups give dense ranks over start values; a position sort
        # of the first m slots lands them in token-slot order
        nst = (~is_start).to(_I32)
        (vk,), order1 = lexsort((nst, rank0))
        dvr = _group_ranks([vk])
        order1 = order1.to(_I32)
        pkey = torch.where(iota < m, order1, (1 << 30) + iota)
        perm2 = torch.sort(pkey, stable=True).indices
        dense_rank = dvr[perm2]
        starts_full = order1[perm2]
        tok = torch.where(iota < m, dense_rank, n + iota)[:M]

    def shifted(r, k):
        # the token string ends at slot m, not M: past-the-end reads -1
        return torch.where(iota_m >= m - k, -1, _shift(r, k))

    # adaptive rank packing: while the group count B is small, p in 2..5
    # ranks fit one uint32 key below the pad-key band (see the reference)
    lim = (1 << 32) - M - 2
    tp = {}
    for p in (2, 3, 4, 5):
        t = 1
        while (t + 1) ** p <= lim:
            t += 1
        tp[p] = t
    pad_key1 = (1 << 32) - 1 - (M - 1 - iota_m).long()
    real = iota_m < m

    def packed_round(rank, k: int, nkeys: int = 2, carry=None):
        """One doubling round covering nkeys*p tokens per sort; with
        `carry`, returns sort-order results ((ranks_in_order, order,
        carry_sorted), k', done) for the fast delivery."""
        B = int(torch.max(torch.where(real, rank, -1))) + 2
        # the reference selects the deepest fitting p per element with
        # `where`; B is known on the host here, so only that p is built
        p = max((q for q in (2, 3, 4, 5) if B <= tp[q]), default=1)

        def r(t):
            # token t*k ahead (uint32, +1 so past-the-end -1 reads 0),
            # the shift saturating at n
            if t == 0:
                return rank.long() & _U32_MASK
            off = n if k > n // t else t * k
            return (shifted(rank, off) + 1).long()

        def pack(ts):
            acc = r(ts[0])
            for t in ts[1:]:
                acc = (acc * B + r(t)) & _U32_MASK
            return acc
        keys = [pack(range(j * p, (j + 1) * p)) for j in range(nkeys)]
        mult = nkeys * p
        keys[0] = torch.where(real, keys[0], pad_key1)
        keys[1:] = [torch.where(real, kk, 0) for kk in keys[1:]]
        if k > ((1 << 31) - 1) // (5 * nkeys):
            mult = 2
        if carry is None:
            rank, _, done = _sort_rerank_n(keys, strategy, unsigned=True)
            return rank, k * mult, done
        ks, perm = lexsort(keys, unsigned=True)
        rio = _group_ranks(ks)
        done = bool(rio[M - 1] == M - 1)
        return (rio, perm.to(_I32), carry[perm]), k * mult, done

    if r1_keys is None:
        r1_keys = 6          # the reference's default (GECOZ_R1_KEYS)
    # starts_full exists exactly on the sort strategy
    fast_ok = starts_full is not None and nr_mode != "gather"

    def loop(rank, k, done):
        while not done and k < 2 * n:
            rank, k, done = packed_round(rank, k)
        return rank

    def nrank_n(rank):
        # rank of the *next* run's start suffix, back to n slots
        nrank = shifted(rank, 1)
        if M < n:
            nrank = torch.cat([nrank, torch.full((n - M,), -1, dtype=_I32,
                                                 device=dev)])
        return nrank

    if fast_ok:
        # fast-path delivery: round one carries sfm1[j] = starts_full[j-1],
        # so when its ranks come out all distinct one sort delivers
        # rank[j+1] to position starts_full[j]; otherwise the classic
        # rerank + loop + placement chain runs
        sfm1 = torch.roll(starts_full[:M], 1)
        (rio, order1, K), k1, done1 = packed_round(tok, 1, nkeys=r1_keys,
                                                   carry=sfm1)
        if done1 or done0:
            # order1 == 0 wraps to starts_full[M-1]: the last run's next
            # rank is -1; pad tokens (order1 >= m) deliver -1 to masked
            # slots anyway
            vals = torch.where((order1 >= m) | (order1 == 0), -1, rio)
            K_full = torch.cat([K, starts_full[M:]])
            vals_full = torch.cat([vals, torch.full((n - M,), -1,
                                                    dtype=_I32, device=dev)])
            placed = apply_perm(K_full, vals_full, strategy=strategy)
        else:
            rank = loop(apply_perm(order1, rio, strategy=strategy), k1,
                        False)
            placed = apply_perm(starts_full, nrank_n(rank),
                                strategy=strategy)
        nr = fill_fwd_i32(torch.where(is_start, placed + 1, -1)) - 1
    else:
        rank, k1, done1 = packed_round(tok, 1, nkeys=r1_keys)
        rank = loop(rank, k1, done1 or done0)
        nrank = nrank_n(rank)
        if nr_mode == "fill":
            # scatter strategy only (the sort strategy takes the fast path
            # with "fill"): placement lands nrank[j] at the j-th run start;
            # one segmented forward fill broadcasts it run-wide
            starts_full = torch.sort((~is_start).to(_I32),
                                     stable=True).indices.to(_I32)
            placed = apply_perm(starts_full, nrank, strategy=strategy)
            nr = fill_fwd_i32(torch.where(is_start, placed + 1, -1)) - 1
        else:
            nr = nrank[run_id.long()]        # one monotone gather by run id

    # final order: (seed rank, next-run rank), BWT riding along
    s_prev = torch.cat([s[n - 1:], s[:n - 1]])
    (_,), perm = lexsort((rank0, nr))
    if pack_seed and n < FINAL_CODE_LIMIT:
        packed_ib = (iota << 4) | up_lut[s_prev.long()]
        ob = packed_ib[perm]
        order = ob >> 4
        bwt = down_lut[(ob & 15).long()]
    elif n < FINAL_BYTE_LIMIT:
        packed_ib = (iota << 8) | s_prev.to(_I32)
        ob = packed_ib[perm]
        order, bwt = ob >> 8, (ob & 255).to(torch.uint8)
    else:
        order, bwt = perm.to(_I32), s_prev[perm]
    return order, bwt


def bwt_device(s: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """BWT[i] = s[(sa[i] - 1) mod n]."""
    n = s.shape[0]
    idx = torch.where(sa == 0, n - 1, sa - 1)
    return s[idx.long()]


def suffix_array_device(s, impl: str = "auto", with_bwt: bool = False,
                        device: torch.device | str | None = None,
                        strategy: str = "sort"):
    """Suffix array of a host uint8 array, computed on `device` (default:
    the card, `utils.device.device()`).

    impl: 'kmer', 'runs' or 'auto' (pick by the longest equal-symbol run).
    with_bwt=True returns (sa, bwt).  The host array feeds the bound/table
    precomputation; one upload brings it to the device.
    """
    from gecoz_tpu_torch.utils.device import device as default_device
    s = np.ascontiguousarray(s, dtype=np.uint8)
    s_dev = torch.from_numpy(s).to(default_device(device))
    if s.shape[0] == 0:
        empty = torch.zeros(0, dtype=_I32, device=s_dev.device)
        return (empty, torch.zeros(0, dtype=torch.uint8,
                                   device=s_dev.device)) if with_bwt \
            else empty
    mx = None
    if impl == "auto":
        mx = max_run_length(s)           # measured once; threaded below
        impl = "runs" if mx > RUN_THRESHOLD else "kmer"
    if impl == "runs":
        syms = tuple(int(x) for x in np.unique(s))
        if len(syms) > 7:
            syms = None          # packed seed only pays below 3 sym bits
        ebs = runs_ell_bits(s, mx=mx)
        tab = runs_token_table(s, syms, ell_bits=ebs)
        sa, bwt = _suffix_array_runs(
            s_dev, syms=syms, m_pad=runs_m_pad(s),
            tok_table=None if tab is None else torch.from_numpy(tab),
            ell_bits=ebs, r1_keys=runs_r1_keys(tab), strategy=strategy)
        return (sa, bwt) if with_bwt else sa
    if impl != "kmer":
        raise ValueError(f"impl must be auto, runs or kmer, got {impl!r}")
    table, bits = dense_table(np.unique(s))
    sa = _suffix_array(s_dev, torch.from_numpy(table), bits=bits,
                       strategy=strategy)
    if with_bwt:
        return sa, bwt_device(s_dev, sa)
    return sa

