"""LSB-first bit streams (host side).

The port's copy of gecoz_tpu/utils/bits.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package, plus `BitReader.overrun`, which the port's
inflate uses to refuse a stream cut short (ROADMAP C2).

The gecoz on-disk format stores every bit stream LSB-first inside
little-endian 64-bit words (reference: nova-io AbstractBitStream.java:38-194,
BitBuffer.java:35-50).  Semantically that is equivalent to a plain bit string
where the first bit written is the least-significant bit of byte 0.  These
host-side streams are used only for the *small* artifacts (code-length tables,
headers); bulk bit vectors go through the vectorized numpy packers in
`gecoz_tpu_torch.index.rankbv`.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Append-only LSB-first bit writer."""

    __slots__ = ("_acc", "_nbits", "_out")

    def __init__(self) -> None:
        self._acc = 0  # pending bits, LSB = oldest
        self._nbits = 0
        self._out = bytearray()

    def write(self, value: int, nbits: int) -> None:
        """Append the low `nbits` of `value` (callers may pass dirty high bits,
        as in the reference's BitOutputStream contract)."""
        if nbits <= 0:
            return
        self._acc |= (value & ((1 << nbits) - 1)) << self._nbits
        self._nbits += nbits
        while self._nbits >= 8:
            self._out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8

    @property
    def bit_length(self) -> int:
        return len(self._out) * 8 + self._nbits

    def align(self) -> None:
        """Pad with zero bits to the next byte boundary."""
        if self._nbits:
            self._out.append(self._acc & 0xFF)
            self._acc = 0
            self._nbits = 0

    def getvalue(self) -> bytes:
        self.align()
        return bytes(self._out)

    def drain(self) -> bytes:
        """Return and clear the complete bytes emitted so far, keeping any
        partial-byte state (for streaming writers)."""
        out = bytes(self._out)
        self._out.clear()
        return out


class BitReader:
    """LSB-first bit reader over a bytes-like object."""

    __slots__ = ("_data", "_bitpos")

    def __init__(self, data, bitpos: int = 0) -> None:
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        self._data = data
        self._bitpos = bitpos

    def read(self, nbits: int) -> int:
        v = self.peek(nbits)
        self._bitpos += nbits
        return v

    def peek(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        start = self._bitpos >> 3
        end = (self._bitpos + nbits + 7) >> 3
        chunk = int.from_bytes(self._data[start:end], "little")
        return (chunk >> (self._bitpos & 7)) & ((1 << nbits) - 1)

    def skip(self, nbits: int) -> None:
        self._bitpos += nbits

    def align(self) -> None:
        self._bitpos = (self._bitpos + 7) & ~7

    @property
    def bitpos(self) -> int:
        return self._bitpos

    @property
    def overrun(self) -> bool:
        """True once reads went past the end of the data (which `peek`
        pads with zero bits)."""
        return self._bitpos > len(self._data) * 8

    @property
    def bytepos(self) -> int:
        if self._bitpos & 7:
            raise ValueError("stream not byte aligned")
        return self._bitpos >> 3


def pack_bits_lsb(bits: np.ndarray) -> np.ndarray:
    """Pack a 0/1 uint8 array into bytes, LSB-first (vectorized)."""
    return np.packbits(bits.astype(np.uint8), bitorder="little")


def unpack_bits_lsb(data: np.ndarray, nbits: int) -> np.ndarray:
    """Unpack bytes into a 0/1 uint8 array of length `nbits`, LSB-first."""
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8).copy(),
                         count=nbits, bitorder="little")
