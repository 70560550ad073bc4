"""Rank-indexed bit vectors in the gecoz interleaved layout.

The port's copy of gecoz_tpu/index/rankbv.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

On-disk layout (reference: nova-algo tree/RankedWTNode.java:36-246): the bit
vector is packed LSB-first into bytes; in front of every 64-byte (512-bit)
data group except the first, a counter is interleaved:

* at 8192-data-byte (64 Kbit) boundaries: an 8-byte little-endian absolute
  rank (number of ones strictly before the boundary),
* at other 64-byte boundaries: a 2-byte little-endian rank *within the
  current 64 Kbit segment*.

A counter exists only if data follows it, giving the exact size formula
``bytes(len)`` below (RankedWTNode.bytes, line 60-67).  One 8454-byte period
= 8192 data + 127*2 shorts + 8 long.

In memory we keep only the raw packed bits; superblock ranks are recomputed
on load (cheap, vectorized) into query-friendly numpy/JAX arrays instead of
the interleaved stream, which a vector machine cannot gather from
efficiently.
"""

from __future__ import annotations

import numpy as np

_GROUP = 64          # data bytes per counter interval (512 bits)
_SEG_GROUPS = 128    # groups per 64 Kbit segment
_SEG_DATA = _GROUP * _SEG_GROUPS   # 8192
_SEG_BYTES = 8454    # 8192 + 127*2 + 8


def rbv_bytes(length: int) -> int:
    """Serialized size in bytes of a ranked bit vector of `length` bits
    (RankedWTNode.bytes)."""
    if length <= 0:
        raise ValueError("empty bit vector")
    size = ((length - 1) >> 16) * 6 + ((length - 1) >> 9) * 2 + ((length + 7) >> 3)
    if size > 0x7FFFFFFF:
        raise ValueError("ranked bit vector limited to ~15G bits")
    return size


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """0/1 array -> LSB-first packed bytes."""
    return np.packbits(bits.astype(np.uint8), bitorder="little")


def unpack_bits(data: np.ndarray, length: int) -> np.ndarray:
    return np.unpackbits(np.asarray(data, dtype=np.uint8), count=length,
                         bitorder="little")


def slice_packed_bits(buf: np.ndarray, start: int, length: int) -> np.ndarray:
    """Bits [start, start+length) of an LSB-first packed byte buffer,
    re-packed LSB-first (tail bits of the last byte zeroed) — the packed
    equivalent of ``pack_bits(unpack_bits(buf, ...)[start:start+length])``
    without materializing the unpacked bits (one vectorized shift pass)."""
    if length <= 0:
        return np.zeros(0, np.uint8)
    buf = np.asarray(buf, dtype=np.uint8)
    nout = (length + 7) >> 3
    b0, sh = start >> 3, start & 7
    if sh == 0:
        out = buf[b0:b0 + nout].copy()
        if len(out) < nout:
            out = np.concatenate([out, np.zeros(nout - len(out), np.uint8)])
    else:
        src = np.zeros(nout + 1, np.uint8)
        avail = max(0, min(nout + 1, len(buf) - b0))
        src[:avail] = buf[b0:b0 + avail]
        out = (src[:-1] >> sh) | (src[1:] << (8 - sh))
    rem = length & 7
    if rem:
        out[-1] &= (1 << rem) - 1
    return out


def _group_popcounts(data: np.ndarray, ngroups: int) -> np.ndarray:
    """Ones per 64-byte group (padded), as int64."""
    pad = ngroups * _GROUP - len(data)
    if pad:
        data = np.concatenate([data, np.zeros(pad, dtype=np.uint8)])
    pc = np.bitwise_count(data.reshape(ngroups, _GROUP))
    return pc.sum(axis=1, dtype=np.int64)


def serialize_rbv(data: np.ndarray, length: int) -> bytes:
    """Interleave packed bit data with rank counters (write path).

    `data` is the LSB-first packed bit vector ((length+7)//8 bytes).
    """
    data = np.asarray(data, dtype=np.uint8)
    nbytes = (length + 7) >> 3
    assert len(data) == nbytes, (len(data), nbytes)

    try:
        from gecoz_tpu_torch import native
        if native.available():
            return native.interleave_rbv(data, length, rbv_bytes(length)).tobytes()
    except Exception:
        pass

    total = rbv_bytes(length)
    nboundaries = (length - 1) >> 9        # counters 1..nboundaries
    ngroups = nboundaries + 1              # data groups that exist
    nseg = (nboundaries >> 7) + 1          # segments containing data

    # over-allocate to whole cells, trim to `total` at the end
    out = np.zeros(nseg * _SEG_BYTES + _SEG_BYTES, dtype=np.uint8)
    if len(data) < ngroups * _GROUP:
        data = np.concatenate(
            [data, np.zeros(ngroups * _GROUP - len(data), np.uint8)])

    pc = _group_popcounts(data, ngroups)
    cum = np.zeros(ngroups + 1, dtype=np.int64)
    np.cumsum(pc, out=cum[1:])

    # data group k starts at 66k + 6*(k//128) in the output
    for s in range(nseg):
        g0 = s * _SEG_GROUPS               # first group of the segment
        base = s * _SEG_BYTES              # == offset of group g0's data
        if s > 0:
            # absolute 8-byte counter before the segment's first group
            out[base - 8:base] = np.frombuffer(
                np.uint64(cum[g0]).tobytes(), dtype=np.uint8)
        out[base:base + _GROUP] = data[g0 * _GROUP:(g0 + 1) * _GROUP]
        # segment-local short counters + data for groups g0+1 .. glast-1
        glast = min(g0 + _SEG_GROUPS, ngroups)  # exclusive
        ncells = glast - g0 - 1
        if ncells > 0:
            cells = out[base + _GROUP: base + _GROUP + ncells * 66]
            cells = cells.reshape(ncells, 66)
            shorts = (cum[g0 + 1:glast] - cum[g0]).astype(np.uint16)
            cells[:, :2] = shorts[:, None].view(np.uint8)
            cells[:, 2:] = data[(g0 + 1) * _GROUP:
                                (g0 + 1 + ncells) * _GROUP].reshape(ncells, _GROUP)
    return out[:total].tobytes()


def deserialize_rbv(buf: np.ndarray, length: int) -> np.ndarray:
    """Extract the packed bit data from an interleaved stream (read path)."""
    buf = np.frombuffer(bytes(buf), dtype=np.uint8) if not isinstance(buf, np.ndarray) else np.asarray(buf, dtype=np.uint8)
    total = rbv_bytes(length)
    assert len(buf) >= total, (len(buf), total)

    try:
        from gecoz_tpu_torch import native
        if native.available():
            return native.deinterleave_rbv(buf[:total], length)
    except Exception:
        pass

    nbytes = (length + 7) >> 3
    nboundaries = (length - 1) >> 9
    ngroups = nboundaries + 1
    nseg = (nboundaries >> 7) + 1

    if len(buf) < nseg * _SEG_BYTES + _SEG_BYTES:
        buf = np.concatenate(
            [buf[:total], np.zeros(nseg * _SEG_BYTES + _SEG_BYTES - total, np.uint8)])
    out = np.zeros(ngroups * _GROUP, dtype=np.uint8)
    for s in range(nseg):
        g0 = s * _SEG_GROUPS
        base = s * _SEG_BYTES
        glast = min(g0 + _SEG_GROUPS, ngroups)
        ncells = glast - g0 - 1
        out[g0 * _GROUP:(g0 + 1) * _GROUP] = buf[base:base + _GROUP]
        if ncells > 0:
            cells = buf[base + _GROUP: base + _GROUP + ncells * 66]
            cells = cells.reshape(ncells, 66)
            out[(g0 + 1) * _GROUP:(g0 + 1 + ncells) * _GROUP] = \
                cells[:, 2:].reshape(-1)
    return out[:nbytes].copy()


def interleaved_total_ones(buf: np.ndarray, length: int) -> int:
    """Total ones of an interleaved stream from its own rank counters —
    O(last 64-byte group), no deinterleave (the layout exists precisely so
    readers can do this; RankedWTNode keeps the same invariant)."""
    buf = np.asarray(buf, dtype=np.uint8)
    nbytes = (length + 7) >> 3
    g = (length - 1) >> 9                      # last data group
    off = 66 * g + 6 * (g >> 7)                # its offset in the stream
    last = buf[off:off + nbytes - (g << 6)]
    if length & 7:                             # mask bits past `length`
        last = last.copy()
        last[-1] &= (1 << (length & 7)) - 1
    tail = int(np.bitwise_count(last).sum(dtype=np.int64))
    if g == 0:
        return tail
    if g % _SEG_GROUPS == 0:
        base = int(np.frombuffer(buf[off - 8:off].tobytes(), np.uint64)[0])
        return base + tail
    s = g >> 7
    seg_base = 0
    if s > 0:
        boff = 66 * (s * _SEG_GROUPS) + 6 * s
        seg_base = int(np.frombuffer(buf[boff - 8:boff].tobytes(),
                                     np.uint64)[0])
    short = int(np.frombuffer(buf[off - 2:off].tobytes(), np.uint16)[0])
    return seg_base + short + tail


class RankBitVector:
    """In-memory rank/select structure over a packed bit vector.

    Two query tiers:

    * **In-place (lazy) tier** — a vector created with `from_interleaved`
      keeps only the (memory-mapped) raw stream and answers get/rank/select
      straight off the interleaved counters, exactly like the reference
      reads its own serialized nodes (RankedWTNode.count:98-122 /
      findOne:145-194): one 8-byte absolute counter + one 2-byte segment
      short + a <=64-byte popcount per rank query, all vectorized over
      query batches.  Opening a multi-GB block costs O(#nodes) and a count
      query touches O(|P| * codelen * 74 bytes) — never a full node.
    * **Built tier** — flat uint64 words + superblock prefix ranks
      (TPU-style layout), ~3x faster per query but paying a full O(n)
      deinterleave + prefix rebuild first.  Queries switch to it
      automatically when a single batch is large enough to amortize the
      build (decode-heavy paths), or when the vector was built from bits.
    """

    # build the flat tier when one batch has >= this many queries AND the
    # batch is at least 1/8 of the vector's 512-bit group count
    _BUILD_BATCH = 4096

    def __init__(self, data: np.ndarray | None, length: int,
                 raw: np.ndarray | None = None):
        self.length = int(length)
        self._data = None if data is None else np.asarray(data,
                                                          dtype=np.uint8)
        self._raw = raw
        self._built = False
        self._total: int | None = None
        self._seg_abs: np.ndarray | None = None

    @classmethod
    def from_bits(cls, bits: np.ndarray) -> "RankBitVector":
        return cls(pack_bits(bits), len(bits))

    @classmethod
    def from_interleaved(cls, buf: np.ndarray, length: int) -> "RankBitVector":
        """Wrap a serialized stream without deinterleaving it yet."""
        buf = np.asarray(buf, dtype=np.uint8)
        return cls(None, length, raw=buf[:rbv_bytes(length)])

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            self._data = deserialize_rbv(self._raw, self.length)
        return self._data

    def _ensure(self) -> None:
        if self._built:
            return
        data = self.data
        ngroups = ((self.length - 1) >> 9) + 1 if self.length else 0
        pc = _group_popcounts(data, ngroups)
        self.super_ranks = np.zeros(ngroups + 1, dtype=np.int64)
        np.cumsum(pc, out=self.super_ranks[1:])
        words = np.zeros(ngroups * 8, dtype=np.uint64)
        raw = data
        if len(raw) < ngroups * 64:
            raw = np.concatenate(
                [raw, np.zeros(ngroups * 64 - len(raw), np.uint8)])
        words[:] = raw.view(np.uint64)
        self.words = words
        wpc = np.bitwise_count(words).astype(np.int64).reshape(ngroups, 8)
        self.word_prefix = np.zeros((ngroups, 8), dtype=np.int64)
        np.cumsum(wpc[:, :-1], axis=1, out=self.word_prefix[:, 1:])
        self._built = True

    # -- in-place (interleaved-stream) tier ---------------------------------

    def _lazy(self) -> bool:
        return not self._built and self._data is None and self._raw is not None

    def _use_raw(self, batch: int) -> bool:
        """In-place queries unless this one batch justifies the O(n) build."""
        if not self._lazy():
            return False
        ngroups = ((self.length - 1) >> 9) + 1
        return batch < self._BUILD_BATCH or batch < (ngroups >> 3)

    def _seg_pref1(self) -> np.ndarray:
        """Ones before each 64 Kbit segment, gathered from the stream's own
        8-byte absolute counters (O(n/8192) bytes, cached)."""
        if self._seg_abs is None:
            nseg = ((self.length - 1) >> 16) + 1
            seg = np.zeros(nseg, dtype=np.int64)
            if nseg > 1:
                s = np.arange(1, nseg, dtype=np.int64)
                boff = 66 * (s << 7) + 6 * s - 8
                b = self._raw[boff[:, None] + np.arange(8)].astype(np.uint64)
                sh = (np.arange(8, dtype=np.uint64) * np.uint64(8))
                seg[1:] = (b << sh).sum(axis=1).astype(np.int64)
            self._seg_abs = seg
        return self._seg_abs

    def _rank_raw(self, idx: np.ndarray) -> np.ndarray:
        """Inclusive rank straight off the interleaved stream — the exact
        read pattern of RankedWTNode.count (nova-algo tree/
        RankedWTNode.java:98-122), vectorized over the batch."""
        raw = self._raw
        g = idx >> 9
        s = g >> 7
        off = 66 * g + 6 * s
        out = np.zeros(len(idx), dtype=np.int64)
        has_abs = s > 0
        if has_abs.any():
            boff = 66 * (s[has_abs] << 7) + 6 * s[has_abs] - 8
            b = raw[boff[:, None] + np.arange(8)].astype(np.uint64)
            sh = (np.arange(8, dtype=np.uint64) * np.uint64(8))
            out[has_abs] = (b << sh).sum(axis=1).astype(np.int64)
        has_short = (g & 127) != 0
        if has_short.any():
            so = off[has_short] - 2
            out[has_short] += (raw[so].astype(np.int64)
                               | (raw[so + 1].astype(np.int64) << 8))
        # popcount of group bytes up to idx inclusive
        cols = np.arange(_GROUP)
        gb = raw[np.minimum(off[:, None] + cols, len(raw) - 1)]
        b_in = (idx >> 3) & 63
        lastmask = ((np.int16(2) << (idx & 7).astype(np.int16)) - 1).astype(np.uint8)
        m = np.where(cols[None, :] < b_in[:, None], np.uint8(0xFF),
                     np.where(cols[None, :] == b_in[:, None],
                              lastmask[:, None], np.uint8(0)))
        out += np.bitwise_count(gb & m).sum(axis=1, dtype=np.int64)
        return out

    def _select_raw(self, n: np.ndarray, bit: int) -> np.ndarray:
        """Select over the interleaved stream via its inline counters
        (RankedWTNode.findOne/findZero:145-194 semantics): binary search the
        absolute segment counters, then the segment's shorts, then one
        64-byte group."""
        raw = self._raw
        L = self.length
        total1 = self.total_ones()
        total = total1 if bit else L - total1
        ok = (n >= 1) & (n <= total)
        t = np.where(ok, n, 1)
        nseg = ((L - 1) >> 16) + 1
        ngroups = ((L - 1) >> 9) + 1
        seg1 = self._seg_pref1()
        seg_pref = seg1 if bit else (np.arange(nseg, dtype=np.int64) << 16) - seg1
        s = np.searchsorted(seg_pref, t, side="left") - 1
        s = np.clip(s, 0, nseg - 1)
        within = t - seg_pref[s]
        g0 = s << 7
        # segment shorts: ones within the segment before groups g0+1..g0+127
        j = np.arange(1, _SEG_GROUPS)
        gids = g0[:, None] + j
        valid = gids < ngroups
        so = 66 * gids + 6 * s[:, None] - 2
        so = np.minimum(so, len(raw) - 2)
        shorts = (raw[so].astype(np.int64) | (raw[so + 1].astype(np.int64) << 8))
        pref = shorts if bit else (j * 512 - shorts)
        pref = np.where(valid, pref, np.int64(1) << 40)
        gl = (pref < within[:, None]).sum(axis=1)           # local group index
        g = g0 + gl
        base = np.take_along_axis(
            np.concatenate([np.zeros((len(t), 1), np.int64), pref], axis=1),
            gl[:, None], axis=1)[:, 0]
        k = within - base                                    # 1-based in group
        # the k'th `bit` within group g
        goff = 66 * g + 6 * s
        cols = np.arange(_GROUP)
        gb = raw[np.minimum(goff[:, None] + cols, len(raw) - 1)]
        bit_base = g << 9
        vbits = np.clip(L - (bit_base[:, None] + cols * 8), 0, 8)
        bmask = ((np.int16(1) << vbits.astype(np.int16)) - 1).astype(np.uint8)
        ones_b = np.bitwise_count(gb & bmask).astype(np.int64)
        cnt_b = ones_b if bit else (vbits - ones_b)
        cum = np.cumsum(cnt_b, axis=1)
        byte_i = (cum < k[:, None]).sum(axis=1)
        byte_i = np.minimum(byte_i, _GROUP - 1)
        prev = np.take_along_axis(
            np.concatenate([np.zeros((len(t), 1), np.int64), cum], axis=1),
            byte_i[:, None], axis=1)[:, 0]
        kb = k - prev                                        # 1-based in byte
        byte_v = np.take_along_axis(gb, byte_i[:, None], axis=1)[:, 0]
        tb = (byte_v[:, None] >> np.arange(8)) & 1
        if not bit:
            vb = np.take_along_axis(vbits, byte_i[:, None], axis=1)
            tb = np.where(np.arange(8)[None, :] < vb, 1 - tb, 0)
        bcum = np.cumsum(tb.astype(np.int64), axis=1)
        bitpos = np.argmax(bcum == kb[:, None], axis=1)
        res = bit_base + byte_i * 8 + bitpos
        return np.where(ok, res, np.int64(-1))

    # -- public queries ------------------------------------------------------

    def get(self, idx):
        idx = np.asarray(idx)
        if self._lazy():
            b = idx >> 3
            g = b >> 6
            boff = 66 * g + 6 * (g >> 7) + (b & 63)
            return (self._raw[boff] >> (idx & 7)) & 1
        return (self.data[idx >> 3] >> (idx & 7)) & 1

    def rank1_inclusive(self, idx):
        """Number of ones in [0, idx] (vectorized; RankedWTNode.count)."""
        idx = np.asarray(idx, dtype=np.int64)
        scalar = idx.ndim == 0
        if self._use_raw(idx.size):
            res = self._rank_raw(np.atleast_1d(idx).ravel())
            return res[0] if scalar else res.reshape(idx.shape)
        self._ensure()
        g = idx >> 9
        w = (idx >> 6) & 7
        base = self.super_ranks[g] + self.word_prefix[g, w]
        word = self.words[g * 8 + w]
        mask = (~np.uint64(0)) >> np.uint64(63) - (idx.astype(np.uint64) & np.uint64(63))
        return base + np.bitwise_count(word & mask).astype(np.int64)

    def rank1(self, idx):
        """Number of ones in [0, idx) (exclusive convention)."""
        idx = np.asarray(idx, dtype=np.int64)
        return np.where(idx <= 0, 0, self.rank1_inclusive(np.maximum(idx - 1, 0)))

    def total_ones(self) -> int:
        if self._total is None:
            if self._data is None and self._raw is not None and self.length:
                self._total = interleaved_total_ones(self._raw, self.length)
            else:
                self._total = int(self.rank1_inclusive(
                    np.int64(self.length - 1))) if self.length else 0
        return self._total

    def select1(self, n):
        """Position of the n'th one bit (1-based), -1 if out of range
        (RankedWTNode.findOne:145-194 semantics).

        Lazy vectors answer straight off the interleaved stream's inline
        counters; built vectors use the superblock-guided search below —
        both O(log(n/512) + 64B) per query, fully vectorized."""
        return self._select(n, 1)

    def select0(self, n):
        """Position of the n'th zero bit (RankedWTNode.findZero)."""
        return self._select(n, 0)

    def _select(self, n, bit: int):
        n = np.asarray(n, dtype=np.int64)
        scalar = n.ndim == 0
        flat = np.atleast_1d(n).ravel()
        if self._use_raw(flat.size):
            res = self._select_raw(flat, bit)
        else:
            self._ensure()
            res = self._select_built(flat, bit)
        return res[0] if scalar else res.reshape(n.shape)

    def _select_built(self, n: np.ndarray, bit: int) -> np.ndarray:
        ngroups = len(self.super_ranks) - 1
        total1 = self.super_ranks[-1]
        total = total1 if bit else self.length - total1
        ok = (n >= 1) & (n <= total)
        t = np.where(ok, n, 1)
        if bit:
            sup = self.super_ranks
        else:
            # zeros before each group boundary; the final boundary may
            # overcount padding but the target zero is always before it
            sup = (np.arange(ngroups + 1, dtype=np.int64) << 9) - self.super_ranks
        # 512-bit group holding the target
        g = np.searchsorted(sup, t, side="left") - 1
        g = np.clip(g, 0, ngroups - 1)
        within = t - sup[g]                              # 1-based in group
        wpref = self.word_prefix[g]
        if not bit:
            wpref = (np.arange(8, dtype=np.int64)[None, :] << 6) - wpref
        w = (wpref < within[:, None]).sum(axis=1) - 1
        k = within - np.take_along_axis(wpref, w[:, None], axis=1)[:, 0]
        word = self.words[g * 8 + w]
        bits = (word[:, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
        bits = bits.astype(np.int64)
        if not bit:
            bits = 1 - bits
        cum = np.cumsum(bits, axis=1)
        bitpos = np.argmax(cum == k[:, None], axis=1)
        res = np.where(ok, (g << 9) + (w << 6) + bitpos, -1)
        return res

    def serialize(self) -> bytes:
        if self._raw is not None and self._data is None:
            return self._raw.tobytes()       # already the serialized form
        return serialize_rbv(self.data, self.length)

    @classmethod
    def deserialize(cls, buf: np.ndarray, length: int) -> "RankBitVector":
        return cls(deserialize_rbv(buf, length), length)
