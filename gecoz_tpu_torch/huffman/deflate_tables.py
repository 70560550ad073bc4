"""Canonical (RFC 1951) deflate code tables, bit-compatible with the reference.

The port's copy of gecoz_tpu/huffman/deflate_tables.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

Three artifacts are reproduced exactly because the `.gcz` shape header and the
deflate codec both depend on them (reference files under nova-algo deflate/):

* length restriction to <= max_bits with the reference's node-reallocation
  rebalancing (DeflateEncodeTable.java:63-148),
* canonical code assignment + LSB-first bit reversal
  (DeflateEncodeTable.java:150-180),
* the RFC 1951 3.2.7 code-lengths-of-code-lengths table serialization with
  16/17/18 RLE ops (DeflateLengthsTable.java:36-208), including its exact
  size formula used to pre-compute block layouts.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from gecoz_tpu_torch.huffman.core import huffman_bit_lengths
from gecoz_tpu_torch.utils.bits import BitReader, BitWriter

MAX_BITS = 15

# RFC 1951 3.2.7 transmission order of the code-length alphabet
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


def _reverse16(x: int) -> int:
    x = (x & 0x5555) << 1 | (x >> 1) & 0x5555
    x = (x & 0x3333) << 2 | (x >> 2) & 0x3333
    x = (x & 0x0F0F) << 4 | (x >> 4) & 0x0F0F
    return ((x >> 8) | (x << 8)) & 0xFFFF


def restrict_lengths(bit_lengths: np.ndarray, counts: Sequence[int],
                     max_bits: int) -> np.ndarray:
    """Clamp Huffman code lengths to `max_bits`, rebalancing leaves.

    Mirrors the reference's two-phase reallocation (demote shallow leaves to
    free capacity, then promote deep leaves while capacity remains), driven
    by a (length, count, index) sort with in-place updates and no re-sorting
    between phases — the output depends on these details.
    """
    bl = bit_lengths.astype(np.int64).copy()
    n = len(bl)

    total = int(bl[bl > 0].sum())
    if total <= 1:
        return bl.astype(np.int32)

    bl_count = np.zeros(max(MAX_BITS, max_bits) + 64, dtype=np.int64)
    for l in bl[bl > 0]:
        bl_count[min(int(l), len(bl_count) - 1)] += 1

    nodes = 1
    for i in range(1, max_bits + 1):
        if nodes <= 0:
            break
        nodes <<= 1
        nodes -= int(bl_count[i]) if i < len(bl_count) else 0

    if nodes <= 0:
        return bl.astype(np.int32)

    nodes = -nodes
    for i in range(n):
        if bl[i] > max_bits:
            bl[i] = max_bits
            nodes += 1

    # entries sorted by (length, count, index); fields updated in place
    entries = sorted(range(n), key=lambda i: (int(bl[i]), int(counts[i]), i))
    lens = [int(bl[i]) for i in entries]

    while nodes != 0:
        done = False
        for i in range(max_bits - 1, 0, -1):
            if done:
                break
            for level in range(i, max_bits):
                if done:
                    break
                for j in range(len(entries)):
                    if lens[j] == level:
                        lens[j] = level + 1
                        nodes -= 1 << (max_bits - 1 - level)
                        if nodes <= 0:
                            done = True
                            break

        level = max_bits
        while nodes < 0 and level > 0:
            for j in range(len(entries) - 1, -1, -1):
                if nodes >= 0:
                    break
                if lens[j] == level:
                    lens[j] = level - 1
                    nodes += 1 << (max_bits - level)
            level -= 1

    out = np.zeros(n, dtype=np.int32)
    for j, i in enumerate(entries):
        out[i] = lens[j]
    return out


def canonical_codes(bit_lengths: np.ndarray) -> np.ndarray:
    """RFC 1951 canonical codes, bit-reversed to LSB-first order
    (DeflateEncodeTable.remap_codes)."""
    max_bits = int(bit_lengths.max(initial=0))
    bl_count = np.bincount(bit_lengths[bit_lengths > 0],
                           minlength=max_bits + 1)
    next_code = np.zeros(max_bits + 1, dtype=np.int64)
    code = 0
    for bits in range(1, max_bits + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code

    codes = np.zeros(len(bit_lengths), dtype=np.int32)
    for i, l in enumerate(bit_lengths):
        l = int(l)
        if l:
            codes[i] = _reverse16(int(next_code[l])) >> (16 - l)
            next_code[l] += 1
    return codes


class DeflateCodeTable:
    """Encode + decode views of one canonical deflate code set."""

    def __init__(self, bit_lengths: np.ndarray):
        self.bit_lengths = np.asarray(bit_lengths, dtype=np.int32)
        self.codes = canonical_codes(self.bit_lengths)
        # decode map: length -> {lsb-first code: symbol}
        self._by_len: list[dict[int, int]] = [dict() for _ in range(MAX_BITS + 1)]
        for sym, (l, c) in enumerate(zip(self.bit_lengths, self.codes)):
            if l:
                self._by_len[int(l)][int(c)] = sym

    @classmethod
    def from_counts(cls, counts: Sequence[int],
                    max_bits: int = MAX_BITS) -> "DeflateCodeTable":
        bl = huffman_bit_lengths(counts)
        bl = restrict_lengths(bl, counts, max_bits)
        return cls(bl)

    def decode_first(self, value: int) -> int:
        """Decode the first complete code from an LSB-first bit pattern.

        Bits beyond the integer's width read as zero, matching the behavior
        the reference gets from its 512-entry lookup table when handed an
        augmented prefix (DeflateLookupTable.getSymbol(int))."""
        for l in range(1, MAX_BITS + 1):
            sym = self._by_len[l].get(value & ((1 << l) - 1))
            if sym is not None:
                return sym
        raise ValueError(f"bit pattern {value:b} matches no code")

    def decode_stream(self, reader: BitReader) -> int:
        """Decode one symbol from a bit stream."""
        peek = reader.peek(min(MAX_BITS, 32))
        for l in range(1, MAX_BITS + 1):
            sym = self._by_len[l].get(peek & ((1 << l) - 1))
            if sym is not None:
                reader.skip(l)
                return sym
        raise ValueError("invalid code in stream")

    def is_leaf(self, prefix: int, nbits: int) -> bool:
        """True if the LSB-first `prefix` of `nbits` bits is a complete code."""
        for l in range(1, nbits + 1):
            if self._by_len[l].get(prefix & ((1 << l) - 1)) is not None:
                return True
        return False


def _rle_groups(bit_lengths: np.ndarray):
    """Iterate the reference's quirky RLE state machine over a lengths array.

    Yields ('sym', value) for literal code-length symbols and
    ('bits', value, nbits) for extra-bit fields, exactly in the emission
    order of DeflateLengthsTable.write (DeflateLengthsTable.java:82-125).
    """
    n = len(bit_lengths)
    length = 0
    count = 0
    for i in range(n):
        if length != bit_lengths[i] or i == n - 1:
            while count >= 3:
                if length != 0:
                    yield ("sym", 16)
                    count -= 3
                    yield ("bits", min(count, 3), 2)
                    count -= 3
                elif count <= 10:
                    yield ("sym", 17)
                    count -= 3
                    yield ("bits", min(count, 7), 3)
                    count -= 7
                else:
                    yield ("sym", 18)
                    count -= 11
                    yield ("bits", min(count, 127), 7)
                    count -= 127
            while count > 0:
                yield ("sym", int(length))
                count -= 1
            length = int(bit_lengths[i])
            yield ("sym", length)
            count = 0
        else:
            count += 1


def _cl_counts(bit_lengths: np.ndarray):
    """Symbol histogram of the RLE stream + the reference's hclen index."""
    counts = np.zeros(19, dtype=np.int64)
    for op in _rle_groups(bit_lengths):
        if op[0] == "sym":
            counts[op[1]] += 1
    hclen = 18
    while hclen >= 0 and counts[CL_ORDER[hclen]] == 0:
        hclen -= 1
    return counts, hclen


def lengths_table_bit_length(bit_lengths: np.ndarray) -> int:
    """Exact serialized size in bits (DeflateLengthsTable.length).

    NB the reference sizes with a MAX_BITS=15 code-length table but writes
    with a max_bits=7 one; both resolve to the same lengths in every legal
    case because 19-symbol RLE histograms stay within 7-bit codes."""
    counts, hclen = _cl_counts(bit_lengths)
    table = DeflateCodeTable.from_counts(counts, MAX_BITS)
    bits = 7 + hclen * 3
    for op in _rle_groups(bit_lengths):
        if op[0] == "sym":
            bits += int(table.bit_lengths[op[1]])
        else:
            bits += op[2]
    return bits


def write_lengths_table(bit_lengths: np.ndarray, out: BitWriter) -> None:
    """Serialize a code-lengths array (DeflateLengthsTable.write)."""
    counts, hclen = _cl_counts(bit_lengths)
    table = DeflateCodeTable.from_counts(counts, 7)
    out.write(hclen - 3, 4)
    for i in range(hclen + 1):
        out.write(int(table.bit_lengths[CL_ORDER[i]]), 3)
    for op in _rle_groups(bit_lengths):
        if op[0] == "sym":
            s = op[1]
            out.write(int(table.codes[s]), int(table.bit_lengths[s]))
        else:
            out.write(op[1], op[2])


def read_lengths_table(reader: BitReader, n: int) -> np.ndarray:
    """Parse a code-lengths array (DeflateLengthsTable ctor)."""
    hclen = reader.read(4) + 4
    l_tree = np.zeros(19, dtype=np.int32)
    for i in range(hclen):
        l_tree[CL_ORDER[i]] = reader.read(3)
    table = DeflateCodeTable(l_tree)

    out = np.zeros(n, dtype=np.int32)
    symbol = 0
    i = 0
    while i < n:
        code = table.decode_stream(reader)
        if code <= 15:
            out[i] = symbol = code
            i += 1
        elif code == 16:
            rep = reader.read(2) + 3
            out[i:i + rep] = symbol
            i += rep
        elif code == 17:
            i += reader.read(3) + 3
        else:  # 18
            i += reader.read(7) + 11
    return out
