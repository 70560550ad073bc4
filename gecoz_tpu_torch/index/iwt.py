"""Index wavelet tree over a permutation (sampled-SA storage).

The port's copy of gecoz_tpu/index/iwt.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

Byte-compatible with IndexWaveletTree (nova-algo tree/
IndexWaveletTree.java:41-176): ``ceil(log2(n))+1`` ranked bit vectors of
length n, serialized top level first.  Level ``l``'s bit sequence is the
permutation values stable-sorted by their bits above ``l``, emitting bit
``l`` of each value — the reference reaches the same order through an
in-place bucket scatter (IndexWaveletTree.java:83-112); here it is two
numpy argsorts per level.

In memory we keep the plain permutation and its inverse: O(1) get/find
instead of the reference's O(log n) bit-vector walks.  Only the serialized
bytes match the reference.
"""

from __future__ import annotations

import numpy as np

from gecoz_tpu_torch.index.rankbv import (RankBitVector, deserialize_rbv, pack_bits,
                                    rbv_bytes, serialize_rbv)


def iwt_levels(n: int) -> int:
    """Number of bit-vector levels for an index of size n
    (64 - numberOfLeadingZeros(n))."""
    return int(n).bit_length()


def iwt_size(n: int) -> int:
    """Serialized size in bytes (IndexWaveletTree.size)."""
    return rbv_bytes(n) * iwt_levels(n)


def serialize_iwt(perm: np.ndarray) -> bytes:
    """Serialize a permutation of 0..n-1 in the reference layout."""
    perm = np.asarray(perm, dtype=np.int64)
    n = len(perm)
    out = []
    values = perm
    for lvl in range(iwt_levels(n) - 1, -1, -1):
        bits = (values >> lvl) & 1
        out.append(serialize_rbv(pack_bits(bits), n))
        if lvl > 0:
            # stable sort by bits above the *next* level == bits >= lvl
            order = np.argsort(values >> lvl, kind="stable")
            values = values[order]
    return b"".join(out)


def deserialize_iwt(buf: np.ndarray, n: int) -> np.ndarray:
    """Reconstruct the plain permutation from serialized level planes."""
    buf = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    nlv = iwt_levels(n)
    nb = rbv_bytes(n)
    planes = []
    for i in range(nlv):
        data = deserialize_rbv(buf[i * nb:(i + 1) * nb], n)
        planes.append(np.unpackbits(data, count=n, bitorder="little").astype(np.int64))

    # planes[0] is the top level (original order); walk down re-deriving the
    # stable permutation the writer applied
    pos_orig = np.arange(n, dtype=np.int64)   # level order -> original index
    acc = planes[0].copy()                    # value >> lvl, in level order
    for i in range(1, nlv):
        order = np.argsort(acc, kind="stable")
        pos_orig = pos_orig[order]
        acc = acc[order] * 2 + planes[i]
    perm = np.zeros(n, dtype=np.int64)
    perm[pos_orig] = acc
    return perm


class LazyIWT:
    """Query the serialized level planes IN PLACE — the reference's own
    access pattern (IndexWaveletTree.java get:127-144 / find:152-165):
    each get/find is an O(levels) walk of rank/select queries answered
    straight off the interleaved rank streams (see
    rankbv.RankBitVector's in-place tier), so a freshly opened index
    costs nothing to query — no plane deinterleave, no permutation
    materialization.

    Level plane i (top first) holds bit (levels-1-i) of the values,
    stable-sorted by their higher bits; descent tracks the node interval
    [lo, hi) per query with node-local ranks derived from global ones."""

    def __init__(self, buf: np.ndarray, n: int):
        buf = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
        self.n = int(n)
        self.nlv = iwt_levels(n)
        nb = rbv_bytes(n)
        self.planes = [RankBitVector.from_interleaved(buf[i * nb:(i + 1) * nb], n)
                       for i in range(self.nlv)]

    def get(self, pos):
        """Value at position `pos` of the original array (batched)."""
        pos = np.asarray(pos, dtype=np.int64)
        scalar = pos.ndim == 0
        p = np.atleast_1d(pos).ravel().copy()
        B = len(p)
        lo = np.zeros(B, dtype=np.int64)
        hi = np.full(B, self.n, dtype=np.int64)
        val = np.zeros(B, dtype=np.int64)
        for i in range(self.nlv):
            plane = self.planes[i]
            bit = np.asarray(plane.get(p), dtype=np.int64)
            val = (val << 1) | bit
            if i == self.nlv - 1:
                break
            r1lo = np.asarray(plane.rank1(lo))
            r1hi = np.asarray(plane.rank1(hi))
            r1p = np.asarray(plane.rank1_inclusive(p))
            z = (hi - lo) - (r1hi - r1lo)            # zeros in node
            rank0_in = (p + 1 - r1p) - (lo - r1lo)   # zeros in node, <= p
            rank1_in = r1p - r1lo
            p = np.where(bit == 0, lo + rank0_in - 1, lo + z + rank1_in - 1)
            nlo = np.where(bit == 0, lo, lo + z)
            nhi = np.where(bit == 0, lo + z, hi)
            lo, hi = nlo, nhi
        if scalar:
            return val[0]
        return val.reshape(pos.shape)

    def find(self, value):
        """Position of `value` in the original array (batched inverse):
        descend by the value's own bits tracking node intervals, then
        ascend mapping the position back with select within each parent
        node (IndexWaveletTree.find:152-165)."""
        value = np.asarray(value, dtype=np.int64)
        scalar = value.ndim == 0
        v = np.atleast_1d(value).ravel()
        B = len(v)
        lo = np.zeros(B, dtype=np.int64)
        hi = np.full(B, self.n, dtype=np.int64)
        los = np.zeros((self.nlv - 1, B), dtype=np.int64)
        zs = np.zeros((self.nlv - 1, B), dtype=np.int64)
        bits = np.zeros((self.nlv - 1, B), dtype=np.int64)
        for i in range(self.nlv - 1):
            plane = self.planes[i]
            b = (v >> (self.nlv - 1 - i)) & 1
            r1lo = np.asarray(plane.rank1(lo))
            r1hi = np.asarray(plane.rank1(hi))
            z = (hi - lo) - (r1hi - r1lo)
            los[i], zs[i], bits[i] = lo, z, b
            nlo = np.where(b == 0, lo, lo + z)
            nhi = np.where(b == 0, lo + z, hi)
            lo, hi = nlo, nhi
        # bottom node holds <=2 entries (distinct values differing in bit 0)
        blast = v & 1
        if self.nlv > 1 or self.n > 1:
            lobit = np.asarray(self.planes[self.nlv - 1].get(lo),
                               dtype=np.int64)
            p = np.where((hi - lo == 1) | (lobit == blast), lo, lo + 1)
        else:
            p = lo
        # ascend: position within child node -> select in parent node
        for i in range(self.nlv - 2, -1, -1):
            plane = self.planes[i]
            b = bits[i]
            child_lo = np.where(b == 0, los[i], los[i] + zs[i])
            k = p - child_lo + 1                     # 1-based in child
            r1lo = np.asarray(plane.rank1(los[i]))
            r0lo = los[i] - r1lo
            nxt = np.empty_like(p)
            is0 = b == 0
            if is0.any():
                nxt[is0] = np.asarray(plane.select0((r0lo + k)[is0]))
            if (~is0).any():
                nxt[~is0] = np.asarray(plane.select1((r1lo + k)[~is0]))
            p = nxt
        if scalar:
            return p[0]
        return p.reshape(value.shape)

    def materialize(self) -> "IndexWaveletTree":
        buf = np.concatenate([pl._raw for pl in self.planes])
        return IndexWaveletTree(deserialize_iwt(buf, self.n))


class IndexWaveletTree:
    """Plain-permutation view with reference-compatible serialization."""

    def __init__(self, perm: np.ndarray):
        self.perm = np.asarray(perm, dtype=np.int64)
        self.inv = np.zeros(len(self.perm), dtype=np.int64)
        self.inv[self.perm] = np.arange(len(self.perm), dtype=np.int64)

    def get(self, pos):
        """Value at position `pos` of the original array."""
        return self.perm[pos]

    def find(self, value):
        """Position of `value` in the original array."""
        return self.inv[value]

    def serialize(self) -> bytes:
        return serialize_iwt(self.perm)

    @classmethod
    def deserialize(cls, buf, n: int) -> "IndexWaveletTree":
        return cls(deserialize_iwt(buf, n))
