"""Huffman-shaped wavelet tree: host (numpy) build, serialize, read, query.

The port's copy of gecoz_tpu/index/hswt.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

Byte-compatible with HuffmanShapedWaveletTree (nova-algo tree/
HuffmanShapedWaveletTree.java:38-365): nodes serialized pre-order, each as a
ranked bit vector (see `gecoz_tpu_torch.index.rankbv`).

Unlike the reference's one-symbol-at-a-time streaming fill
(HuffmanShapedWaveletTree.fill:127-146), construction here is vectorized:
each node's bit vector is a masked gather over the code arrays; the device
(torch) build in `gecoz_tpu_torch.ops.wavelet` goes further with level-order
radix refinement.  Queries keep numpy rank structures per node; the query
path on the card uses flattened planes in `gecoz_tpu_torch.ops.fmq`, and
decodes the BWT there from the nodes' stored streams (`stored_streams`,
`gecoz_tpu_torch.ops.hswt_device`).
"""

from __future__ import annotations

import numpy as np

from gecoz_tpu_torch.index.rankbv import RankBitVector, pack_bits, rbv_bytes
from gecoz_tpu_torch.index.shape import HSWTShape
from gecoz_tpu_torch.utils.bits import BitReader, BitWriter


class HSWT:
    """Wavelet tree over one block's BWT."""

    def __init__(self, shape: HSWTShape,
                 nodes: dict[tuple[int, int], RankBitVector],
                 streams: np.ndarray | None = None):
        self.shape = shape
        self.nodes = nodes
        self._streams = streams          # the nodes' bytes as read
        self._stored: tuple[np.ndarray, np.ndarray] | None = None

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, bwt: np.ndarray, shape: HSWTShape) -> "HSWT":
        """Build from a BWT byte array.

        Native path: one C++ pass over the BWT fills every node at once
        (native/hswt_fill.cpp — the profile-dominant host-encode phase,
        ~30x the per-node masked-numpy fallback below)."""
        bwt = np.asarray(bwt, dtype=np.uint8)
        try:
            from gecoz_tpu_torch import native
            use_native = native.available() and len(bwt)
        except Exception:
            use_native = False
        if use_native:
            counts = np.bincount(bwt, minlength=256).astype(np.int64)
            lens64 = shape.bit_lengths.astype(np.int64)
            codes64 = shape.codes.astype(np.int64)
            node_lengths = {}
            for (level, prefix) in shape.nodes:
                mask = (1 << level) - 1
                sel = (lens64 > level) & ((codes64 & mask) == prefix)
                node_lengths[(level, prefix)] = int(counts[sel].sum())
            packed = native.hswt_fill(bwt, codes64, lens64,
                                      shape.nodes, node_lengths)
            nodes = {k: RankBitVector(packed[k], node_lengths[k])
                     for k in shape.nodes}
            return cls(shape, nodes)
        codes = shape.codes[bwt].astype(np.int32)
        lens = shape.bit_lengths[bwt].astype(np.int32)
        nodes: dict[tuple[int, int], RankBitVector] = {}
        for (level, prefix) in shape.nodes:
            mask = (1 << level) - 1
            sel = (lens > level) & ((codes & mask) == prefix)
            bits = (codes[sel] >> level) & 1
            nodes[(level, prefix)] = RankBitVector.from_bits(bits)
        return cls(shape, nodes)

    @classmethod
    def from_packed(cls, shape: HSWTShape,
                    packed: dict[tuple[int, int], np.ndarray]) -> "HSWT":
        """Wrap already-packed per-node bit data (e.g. from the device)."""
        nodes = {k: RankBitVector(packed[k], shape.node_lengths[k])
                 for k in shape.nodes}
        return cls(shape, nodes)

    # -- serialization -----------------------------------------------------

    def serialize(self) -> bytes:
        """Lengths table + pre-order node dump (HSWT.write + shape.write)."""
        w = BitWriter()
        self.shape.write_table(w)
        out = [w.getvalue()]
        for key in self.shape.nodes:
            out.append(self.nodes[key].serialize())
        return b"".join(out)

    @classmethod
    def read(cls, buf: np.ndarray, length: int) -> "HSWT":
        """Parse shape + nodes; node lengths derived from parent ranks
        (HuffmanShapedWaveletTree.mapNodes:197-216)."""
        buf = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
        reader = BitReader(buf.tobytes())
        shape = HSWTShape.from_serialized(reader, length)
        start = offset = reader.bytepos

        nodes: dict[tuple[int, int], RankBitVector] = {}
        node_lengths: dict[tuple[int, int], int] = {}
        node_set = set(shape.nodes)

        def walk(level: int, prefix: int, nlen: int) -> None:
            nonlocal offset
            key = (level, prefix)
            if key not in node_set:
                return
            # lazy: the node keeps the mmap'd interleaved slice; total_ones
            # (needed for child sizing) reads the stream's own counters
            node = RankBitVector.from_interleaved(
                buf[offset:offset + rbv_bytes(nlen)], nlen)
            offset += rbv_bytes(nlen)
            nodes[key] = node
            node_lengths[key] = nlen
            ones = node.total_ones()
            walk(level + 1, prefix, nlen - ones)
            walk(level + 1, prefix | (1 << level), ones)

        if shape.nodes:
            walk(0, 0, length)
        shape.node_lengths = node_lengths
        return cls(shape, nodes, streams=buf[start:offset])

    def stored_streams(self) -> tuple[np.ndarray, np.ndarray]:
        """The internal nodes' serialized streams, interleaved with their
        rank counters as the .gcz stores them, and the node table: the
        bytes and the shape the device tier decodes the BWT from
        (`ops/hswt_device.py`).

        Returns (streams, table): streams one contiguous uint8 array, the
        nodes in pre-order (a view of the bytes read; a tree built in
        memory serializes its own); table int64 [nodes, 4], a row per node
        in the same order: its byte offset in streams, its bit length, and
        for its 0-side and its 1-side the child node's row, or ~symbol at
        a leaf (~0 on a side no code takes, which `decode_bwt` leaves 0).
        No rank tier and no per-position work; computed once a tree."""
        if self._stored is not None:
            return self._stored
        keys = self.shape.nodes
        row = {key: i for i, key in enumerate(keys)}
        leaf = {(int(self.shape.bit_lengths[s]), int(self.shape.codes[s])):
                int(s) for s in np.flatnonzero(self.shape.bit_lengths > 0)}
        table = np.zeros((len(keys), 4), dtype=np.int64)
        offset = 0
        for i, (level, prefix) in enumerate(keys):
            length = self.nodes[(level, prefix)].length
            table[i, :2] = offset, length
            offset += rbv_bytes(length)
            for side in (0, 1):
                child = (level + 1, prefix | (side << level))
                table[i, 2 + side] = (row[child] if child in row
                                      else ~leaf.get(child, 0))
        streams = self._streams
        if streams is None:
            streams = np.frombuffer(b"".join(
                self.nodes[key].serialize() for key in keys), dtype=np.uint8)
        self._stored = (streams, table)
        return self._stored

    # -- queries -----------------------------------------------------------

    def occ(self, symbol: int, pos: int) -> int:
        """Occurrences of `symbol` in BWT[0..pos] minus one; -1 when none.
        (HuffmanShapedWaveletTree.occ:247-267 semantics.)"""
        nlen = int(self.shape.bit_lengths[symbol])
        if nlen == 0:
            return -1
        code = int(self.shape.codes[symbol])
        p = int(pos)
        for lvl in range(nlen):
            if p < 0:
                break
            node = self.nodes[(lvl, code & ((1 << lvl) - 1))]
            bits = int(node.rank1_inclusive(np.int64(p)))
            if (code >> lvl) & 1 == 0:
                p -= bits
            else:
                p = bits - 1
        return p

    def occ_batch(self, symbol: int, pos: np.ndarray) -> np.ndarray:
        """Vectorized occ for one symbol over many positions."""
        nlen = int(self.shape.bit_lengths[symbol])
        pos = np.asarray(pos, dtype=np.int64)
        if nlen == 0:
            return np.full(pos.shape, -1, dtype=np.int64)
        code = int(self.shape.codes[symbol])
        p = pos.copy()
        for lvl in range(nlen):
            node = self.nodes[(lvl, code & ((1 << lvl) - 1))]
            live = p >= 0
            bits = node.rank1_inclusive(np.maximum(p, 0))
            bit = (code >> lvl) & 1
            upd = (p - bits) if bit == 0 else (bits - 1)
            p = np.where(live, upd, p)
        return p

    def decode_bwt(self) -> np.ndarray:
        """Reconstruct the BWT byte array from the node bit vectors."""
        n = self.shape.length
        bwt = np.zeros(n, dtype=np.uint8)
        if not self.shape.nodes:
            return bwt
        # leaf symbol for complete codes
        leaf = {}
        for s in np.flatnonzero(self.shape.bit_lengths > 0):
            leaf[(int(self.shape.bit_lengths[s]), int(self.shape.codes[s]))] = int(s)

        try:
            from gecoz_tpu_torch import native
            use_native = native.available()
        except Exception:
            use_native = False

        def walk(level: int, prefix: int, positions: np.ndarray) -> None:
            sym = leaf.get((level, prefix))
            if sym is not None:
                bwt[positions] = sym
                return
            key = (level, prefix)
            if key not in self.nodes or len(positions) == 0:
                return
            node = self.nodes[key]
            if use_native:
                left, right = native.wt_partition(node.data, positions)
            else:
                bits = np.unpackbits(node.data, count=node.length,
                                     bitorder="little")
                left = positions[bits == 0]
                right = positions[bits == 1]
            walk(level + 1, prefix, left)
            walk(level + 1, prefix | (1 << level), right)

        walk(0, 0, np.arange(n, dtype=np.int32 if use_native else np.int64))
        return bwt

    def symbol_counts(self) -> np.ndarray:
        """Per-symbol counts derived from node sizes alone — no BWT decode
        (symbol s's count = the zero/one population of its leaf slot in
        its last internal node).  Keeps count-only queries lazy."""
        counts = np.zeros(256, dtype=np.int64)
        for s in np.flatnonzero(self.shape.bit_lengths > 0):
            L = int(self.shape.bit_lengths[s])
            code = int(self.shape.codes[s])
            node = self.nodes[(L - 1, code & ((1 << (L - 1)) - 1))]
            ones = int(node.total_ones())
            counts[s] = ones if (code >> (L - 1)) & 1 else node.length - ones
        return counts

    def getrs_batch(self, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched (rank, symbol) at BWT positions `pos` — the locate/
        extract step — via one level-ordered descent shared by the whole
        batch (each position visits code-length nodes, not n work)."""
        pos = np.asarray(pos, dtype=np.int64)
        ranks = np.zeros(len(pos), dtype=np.int64)
        syms = np.zeros(len(pos), dtype=np.int64)
        leaf = {}
        for s in np.flatnonzero(self.shape.bit_lengths > 0):
            leaf[(int(self.shape.bit_lengths[s]),
                  int(self.shape.codes[s]))] = int(s)

        def walk(level, prefix, idx, p):
            sym = leaf.get((level, prefix))
            if sym is not None:
                ranks[idx] = p
                syms[idx] = sym
                return
            key = (level, prefix)
            if key not in self.nodes or len(idx) == 0:
                return
            node = self.nodes[key]
            bit = np.asarray(node.get(p))
            r1 = node.rank1_inclusive(p)
            zero = bit == 0
            walk(level + 1, prefix, idx[zero], (p - r1)[zero])
            walk(level + 1, prefix | (1 << level), idx[~zero],
                 (r1 - 1)[~zero])

        if self.shape.nodes:
            walk(0, 0, np.arange(len(pos), dtype=np.int64), pos.copy())
        return ranks, syms

    def getRS(self, pos: int) -> tuple[int, int]:
        """(rank, symbol) at BWT position `pos` (HSWT.getRS:300-314)."""
        level = 0
        prefix = 0
        p = int(pos)
        while True:
            key = (level, prefix)
            node = self.nodes[key]
            bit = int(node.get(np.int64(p)))
            bits = int(node.rank1_inclusive(np.int64(p)))
            p = (p - bits) if bit == 0 else (bits - 1)
            prefix |= bit << level
            level += 1
            sym = self._leaf_symbol(level, prefix)
            if sym is not None:
                return p, sym

    def _leaf_symbol(self, level: int, prefix: int):
        for s in np.flatnonzero(self.shape.bit_lengths > 0):
            if (int(self.shape.bit_lengths[s]) == level
                    and int(self.shape.codes[s]) == prefix):
                return int(s)
        return None
