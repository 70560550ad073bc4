"""FM-index query state on the card: bit planes, rank prefixes, sampled SA.

Port of the query-state build of gecoz_tpu/ops/fmq.py (`DeviceFMBlock`
41-131, `_pack_bits_jit` 485, `_plane_jit` 499, `build_device_block_jit`
507-578).  The queries themselves (occ, search, locate, decode) are not
ported yet.

Differences from the reference:

* `DeviceFMBlock` is a dataclass of tensors.  uint32 words are stored as
  int32 tensors with the same bits (`block_to_numpy` views them back as
  uint32).
* The reference splits the plane layout at `_PAIR_LIMIT` into a fused
  (word, prefix) pair table for the TPU's (8, 128) tiling; the port keeps
  only the flat `plane_words`/`plane_pres`.
* torch has no popcount: a SWAR popcount on int64 stands in.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from gecoz_tpu_torch.ops.sa_device import check_strategy
from gecoz_tpu_torch.ops.scan import cumsum_i32

_I32 = torch.int32


@dataclass
class DeviceFMBlock:
    """Query state of one block (the fields this port builds so far)."""

    bwt: torch.Tensor          # uint8 [n] BWT bytes
    plane_words: torch.Tensor  # u32 bits as int32 [sigma*W] bit words
    plane_pres: torch.Tensor   # u32 bits as int32 [sigma*W] exclusive
                               # per-word rank prefixes
    c: torch.Tensor            # int32 [257] cumulative symbol counts
    sym_plane: torch.Tensor    # int32 [256] byte -> plane row (-1 absent)
    wrap_row: torch.Tensor     # int32 [] row with SA value 0
    mark_words: torch.Tensor   # u32 bits as int32 [W] sampled-row plane
    mark_pre: torch.Tensor     # int32 [W]
    mark_rows: torch.Tensor    # int32 [m] sampled rows, ascending
    ssa_perm: torch.Tensor     # int32 [m] sampled SA values >> sf, row order
    ssa_inv: torch.Tensor      # int32 [m] inverse permutation
    sf: int                    # sampling factor

    @property
    def n(self) -> int:
        return self.bwt.shape[0]

    @property
    def W(self) -> int:
        return (self.bwt.shape[0] + 31) // 32


_U32_FIELDS = ("plane_words", "plane_pres", "mark_words")


def block_to_numpy(block: DeviceFMBlock) -> dict[str, np.ndarray]:
    """Fields as host numpy arrays in the reference's dtypes (uint32 words;
    `sf` as an int)."""
    out: dict[str, np.ndarray] = {}
    for f in fields(block):
        v = getattr(block, f.name)
        if f.name == "sf":
            out["sf"] = int(v)
            continue
        a = v.detach().cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in _U32_FIELDS else a
    return out


def block_from_numpy(fields_np: dict, sf: int) -> DeviceFMBlock:
    """The port's block from the reference's `DeviceFMBlock` taken as a
    dict of numpy arrays (e.g. `{k: np.asarray(v) for k, v in
    ref._asdict().items()}`).

    A non-empty `plane_pairs` [sigma*W, 2] maps to the flat
    `plane_words`/`plane_pres`; the reference's optional tables (lf_tab,
    lfk_tab, kmer_tab, loc_tab) are not part of the port's block yet.
    The tensors are on the CPU.
    """
    src = dict(fields_np)
    pairs = src.get("plane_pairs")
    if pairs is not None and np.asarray(pairs).shape[0] > 0:
        pairs = np.asarray(pairs)
        src["plane_words"] = pairs[:, 0]
        src["plane_pres"] = pairs[:, 1]
    kw = {}
    for f in fields(DeviceFMBlock):
        if f.name == "sf":
            continue
        a = np.array(src[f.name])           # a copy, 0-d kept 0-d
        if f.name in _U32_FIELDS or a.dtype == np.uint32:
            a = a.astype(np.uint32).view(np.int32)
        elif f.name != "bwt":
            a = a.astype(np.int32)
        kw[f.name] = torch.from_numpy(a)
    return DeviceFMBlock(sf=int(sf), **kw)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of 32-bit words held in int64 [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(_I32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 (any int/bool dtype) [n] -> uint32 words [ceil(n/32)] held in
    int64, LSB-first."""
    n = bits.shape[0]
    W = (n + 31) // 32
    b = bits.to(torch.int64)
    if W * 32 != n:
        b = torch.cat([b, b.new_zeros(W * 32 - n)])
    weights = torch.ones(32, dtype=torch.int64, device=b.device) \
        << torch.arange(32, dtype=torch.int64, device=b.device)
    return (b.view(W, 32) * weights).sum(1)


def _plane(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(words as int64 uint32 values, exclusive per-word rank prefix)."""
    words = _pack_bits(bits)
    pc = _popcount32(words)
    pre = torch.cat([pc.new_zeros(1), cumsum_i32(pc)[:-1]])
    return words, pre


def _u32_as_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same bits."""
    return (words - ((words >> 31) << 32)).to(_I32)


def build_device_block(bwt: torch.Tensor, sa: torch.Tensor, sf: int,
                       symbols: tuple[int, ...],
                       strategy: str = "sort") -> DeviceFMBlock:
    """Query-state construction on the BWT's device (reference
    `build_device_block_jit`).

    `symbols` is the static alphabet (plane order); symbols outside it must
    not occur in `bwt`.  The sampled-row count is exactly ceil(n/rate).
    "sort" compacts the sampled rows with one partition sort (the
    reference's TPU branch), "scatter" with nonzero + gather (its CPU
    branch); both give the same block.
    """
    check_strategy(strategy)
    dev = bwt.device
    n = bwt.shape[0]
    rate = 1 << sf
    m = (n + rate - 1) // rate

    planes, pres, totals = [], [], []
    sym_plane = np.full(256, -1, dtype=np.int32)
    for row, s in enumerate(symbols):
        sym_plane[s] = row
        w, p = _plane(bwt == s)
        planes.append(w)
        pres.append(p)
        totals.append(p[-1] + _popcount32(w[-1]))

    # symbol counts fall out of the plane popcounts
    counts = torch.zeros(256, dtype=_I32, device=dev)
    counts[torch.tensor(symbols, dtype=torch.int64, device=dev)] = \
        torch.stack(totals)
    c = torch.cat([counts.new_zeros(1), cumsum_i32(counts)])

    marked = (sa & (rate - 1)) == 0
    mark_words, mark_pre = _plane(marked)
    if strategy == "scatter":
        rows = torch.nonzero(marked).flatten()
        perm = (sa[rows] >> sf).to(_I32)
        mark_rows = rows.to(_I32)
    else:
        # sampled values in row order via one stable partition sort (marked
        # rows first); the (not-marked, row) key packs into one int31 word,
        # and its low bits are the select-1 table
        iota = torch.arange(n, dtype=_I32, device=dev)
        pkey = ((~marked).to(_I32) << 30) | iota
        keys_s, order = torch.sort(pkey, stable=True)
        perm = (sa >> sf)[order[:m]]
        mark_rows = keys_s[:m] & ((1 << 30) - 1)
    inv = torch.zeros(m, dtype=_I32, device=dev)
    inv[perm.long()] = torch.arange(m, dtype=_I32, device=dev)
    wrap = torch.argmax((sa == 0).to(_I32)).to(_I32)

    return DeviceFMBlock(
        bwt=bwt,
        plane_words=_u32_as_i32(torch.cat(planes)),
        plane_pres=torch.cat(pres),
        c=c, sym_plane=torch.from_numpy(sym_plane).to(dev), wrap_row=wrap,
        mark_words=_u32_as_i32(mark_words), mark_pre=mark_pre,
        mark_rows=mark_rows, ssa_perm=perm, ssa_inv=inv, sf=sf)
