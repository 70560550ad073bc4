"""Huffman code-length assignment, bit-compatible with the reference.

The port's copy of gecoz_tpu/huffman/core.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

The `.gcz` format's wavelet-tree shape is a function of the exact Huffman
code lengths the reference computes, including its tie-breaking behavior, so
this module reproduces the *semantics* of the reference algorithm
(nova-algo huffman/HuffmanEncodeTable.java:48-111): repeated two-minimum
merging with strictly-less scans (first index wins), the merged weight
parked in the second minimum's slot and the first minimum's slot retired.

Alphabets are tiny (<=256 symbols) so this is host-side Python; all bulk
work happens elsewhere.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_REMOVED = -1


def huffman_bit_lengths(counts: Sequence[int]) -> np.ndarray:
    """Return per-symbol Huffman code lengths for `counts`.

    Tie-breaking matches the reference exactly: each round scans the alphabet
    once; the first strictly-smallest live weight becomes min1 and the next
    smallest (first occurrence, strict compare against the running second
    minimum) becomes min2; their groups each gain one bit; the fused weight
    replaces min2's slot while min1's slot dies.
    """
    n = len(counts)
    weights = [int(c) for c in counts]
    lengths = np.zeros(n, dtype=np.int32)
    # group[i] = list of symbols whose subtree is currently rooted at slot i
    groups: list[list[int] | None] = [[i] for i in range(n)]

    for _round in range(1, n):
        idx1 = idx2 = 0
        min1 = min2 = None
        for j in range(n):
            fq = weights[j]
            if fq > 0:
                if min1 is None or fq < min1:
                    idx2, min2 = idx1, min1
                    idx1, min1 = j, fq
                elif min2 is None or fq < min2:
                    idx2, min2 = j, fq

        if min2 is None:
            if _round == 1 and min1 is not None:
                # degenerate alphabet of one symbol still needs one bit
                lengths[idx1] = 1
            break

        for s in groups[idx1]:
            lengths[s] += 1
        for s in groups[idx2]:
            lengths[s] += 1

        groups[idx2] = groups[idx2] + groups[idx1]
        groups[idx1] = None
        weights[idx1] = _REMOVED
        weights[idx2] = min1 + min2

    return lengths
