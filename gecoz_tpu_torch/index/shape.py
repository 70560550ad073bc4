"""Huffman-shaped wavelet tree *shape*: code table + node structure + sizes.

The port's copy of gecoz_tpu/index/shape.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

Reproduces HSWTShape (nova-algo tree/HSWTShape.java:39-116) and the node
enumeration implicit in HuffmanShapedWaveletTree.java:95-236: a node exists
for every proper prefix of a Huffman code; serialization order is pre-order
(node, then 0-child, then 1-child), codes read LSB-first.

Instead of the reference's 256-slot node table keyed by "augmented prefix"
integers we key nodes by (level, prefix) pairs — the structure and on-disk
bytes are identical, only the in-memory naming differs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gecoz_tpu_torch.huffman.core import huffman_bit_lengths
from gecoz_tpu_torch.huffman.deflate_tables import (
    DeflateCodeTable, lengths_table_bit_length, read_lengths_table,
    restrict_lengths, write_lengths_table)
from gecoz_tpu_torch.index.rankbv import rbv_bytes
from gecoz_tpu_torch.utils.bits import BitReader, BitWriter


@dataclass
class HSWTShape:
    """Shape of a Huffman-shaped wavelet tree for one block."""

    bit_lengths: np.ndarray          # per-symbol code length (256,)
    codes: np.ndarray                # LSB-first canonical codes (256,)
    length: int                      # total number of symbols in the block
    counts: np.ndarray | None = None
    # pre-order list of internal nodes as (level, prefix)
    nodes: list[tuple[int, int]] = field(default_factory=list)
    node_lengths: dict[tuple[int, int], int] = field(default_factory=dict)

    @classmethod
    def from_counts(cls, counts) -> "HSWTShape":
        counts = np.asarray(counts, dtype=np.int64)
        bl = huffman_bit_lengths(counts)
        bl = restrict_lengths(bl, counts, 15)
        table = DeflateCodeTable(bl)
        shape = cls(bit_lengths=table.bit_lengths, codes=table.codes,
                    length=int(counts.sum()), counts=counts)
        shape._build_nodes(counts)
        return shape

    @classmethod
    def from_serialized(cls, reader: BitReader, length: int) -> "HSWTShape":
        """Parse the RFC1951-3.2.7 lengths table (HSWTShape.read)."""
        bl = read_lengths_table(reader, 256)
        reader.align()
        table = DeflateCodeTable(bl)
        shape = cls(bit_lengths=table.bit_lengths, codes=table.codes,
                    length=int(length))
        shape._enumerate_nodes()
        return shape

    # -- structure ---------------------------------------------------------

    def _symbols(self) -> np.ndarray:
        return np.flatnonzero(self.bit_lengths > 0)

    def _build_nodes(self, counts: np.ndarray) -> None:
        self._enumerate_nodes()
        lengths: dict[tuple[int, int], int] = {k: 0 for k in self.nodes}
        for s in self._symbols():
            code = int(self.codes[s])
            for lvl in range(int(self.bit_lengths[s])):
                key = (lvl, code & ((1 << lvl) - 1))
                lengths[key] += int(counts[s])
        self.node_lengths = lengths

    def _enumerate_nodes(self) -> None:
        """Pre-order internal-node enumeration (HSWT.writeNodes order)."""
        syms = self._symbols()
        if len(syms) == 0:
            self.nodes = []
            return
        codes = self.codes[syms].astype(np.int64)
        lens = self.bit_lengths[syms].astype(np.int64)

        nodes: list[tuple[int, int]] = []

        def descend(level: int, prefix: int) -> None:
            mask = (1 << level) - 1
            below = (lens > level) & ((codes & mask) == prefix)
            if not below.any():
                return  # leaf (complete code) or dead branch
            nodes.append((level, prefix))
            descend(level + 1, prefix)              # 0-bit child
            descend(level + 1, prefix | (1 << level))  # 1-bit child

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4000))
        try:
            descend(0, 0)
        finally:
            sys.setrecursionlimit(old)
        self.nodes = nodes

    def node_path(self, symbol: int) -> list[tuple[tuple[int, int], int]]:
        """[(node_key, bit), ...] along `symbol`'s code, root to leaf."""
        code = int(self.codes[symbol])
        path = []
        for lvl in range(int(self.bit_lengths[symbol])):
            key = (lvl, code & ((1 << lvl) - 1))
            path.append((key, (code >> lvl) & 1))
        return path

    # -- sizes -------------------------------------------------------------

    @property
    def table_bytes(self) -> int:
        """Serialized lengths-table size, byte aligned (HSWTShape.java:78)."""
        return (lengths_table_bit_length(self.bit_lengths) + 7) >> 3

    @property
    def size(self) -> int:
        """Total serialized size: lengths table + all node vectors
        (HSWTShape.java:78-86)."""
        sz = self.table_bytes
        for key in self.nodes:
            sz += rbv_bytes(self.node_lengths[key])
        return sz

    def write_table(self, out: BitWriter) -> None:
        write_lengths_table(self.bit_lengths, out)
