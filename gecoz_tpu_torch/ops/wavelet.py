"""Huffman-shaped wavelet tree construction on the card.

Port of gecoz_tpu/ops/wavelet.py.  At level L the concatenation of all
level-L node bit vectors is `(code(bwt) >> L) & 1` taken in the order of a
STABLE sort by the code's L-bit prefix (symbols whose code ends above L
sort last), so the build is one stable sort per level; the bits are packed
into 32-bit words on the device and the host slices each node's bit run out
of them.  `node_bits_from_levels` and `_level_bit_counts` are copies of the
reference's host helpers, whose module imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from gecoz_tpu_torch.index.rankbv import slice_packed_bits
from gecoz_tpu_torch.index.shape import HSWTShape
from gecoz_tpu_torch.ops.fmq import _pack_bits, _u32_as_i32

_BIG = 1 << 30


def wavelet_level_words(bwt: torch.Tensor, codes: torch.Tensor,
                        lens: torch.Tensor, maxlen: int) -> torch.Tensor:
    """Per-level node-concatenated bit arrays, packed to words.

    Returns uint32 bits as int32 [maxlen, ceil(n/32)]; row L holds the
    level-L bits of all active elements (grouped by ascending code prefix,
    stable in BWT order) LSB-first in its first `n_L` bit positions.
    """
    sym = bwt.long()
    code = codes.to(bwt.device)[sym]
    ln = lens.to(bwt.device)[sym]
    rows = []
    for L in range(maxlen):
        key = torch.where(ln > L, code & ((1 << L) - 1), _BIG)
        order = torch.sort(key, stable=True).indices
        bits = (code[order] >> L) & 1
        rows.append(_u32_as_i32(_pack_bits(bits)))
    return torch.stack(rows)


def _level_bit_counts(shape: HSWTShape, maxlen: int) -> list[int]:
    """Active bits per level (= sum of that level's node lengths)."""
    counts = [0] * maxlen
    for (L, p), ln in shape.node_lengths.items():
        counts[L] += ln
    return counts


def node_bits_from_levels(levels,
                          shape: HSWTShape) -> dict[tuple[int, int], np.ndarray]:
    """Slice per-node packed bit vectors out of packed level words (host).

    `levels` is the uint32 [maxlen, W] array (or a list of per-level
    word rows) from wavelet_level_words; node boundaries fall at
    arbitrary bit offsets, extracted with one shift pass per node
    (slice_packed_bits)."""
    out: dict[tuple[int, int], np.ndarray] = {}
    by_level: dict[int, list[tuple[int, int]]] = {}
    for (L, p) in shape.nodes:
        by_level.setdefault(L, []).append((L, p))
    for L, keys in by_level.items():
        keys.sort(key=lambda k: k[1])          # ascending prefix integer
        off = 0
        row = np.ascontiguousarray(levels[L]).view(np.uint8)
        for key in keys:
            ln = shape.node_lengths[key]
            out[key] = slice_packed_bits(row, off, ln)
            off += ln
    return out


def build_hswt_device(bwt: torch.Tensor, shape: HSWTShape):
    """BWT bytes (a uint8 tensor, on the card or the CPU) -> {node: packed
    bits}.  Each level row is fetched sliced to its true word count."""
    maxlen = int(shape.bit_lengths.max())
    levels_dev = wavelet_level_words(
        bwt, torch.from_numpy(shape.codes.astype(np.int32)),
        torch.from_numpy(shape.bit_lengths.astype(np.int32)), maxlen)
    rows = []
    for L, nbits in enumerate(_level_bit_counts(shape, maxlen)):
        w = (nbits + 31) // 32
        rows.append(levels_dev[L, :w].cpu().numpy().view(np.uint32))
    return node_bits_from_levels(rows, shape)
