"""gzip / BGZF container over the from-scratch deflate codec.

The port's copy of gecoz_tpu/codec/gzip_file.py: imports changed, and a
member cut inside its deflate data raises ValueError("truncated deflate
stream") from the native decoder without a second decode in Python
(ROADMAP C2).

Capabilities of the reference nova-gzip module (GZipFileInputStream.java,
GZipOutputStream.java, GZipFileOutputStream.java, GZipHeader.java):

* multi-member gzip reading with per-member CRC32 + ISIZE verification,
* the BGZF `BC` extra subfield (SI1='B', SI2='C', BSIZE = total member
  size minus one) on both read and write,
* random access by virtual offset (member file offset << 16 | intra-member
  offset) as used by BAM/BAI,
* whole-file and streaming writes; BGZF members capped at 64 KiB of input.

CRC32 comes from the stdlib (`zlib.crc32`) exactly as the reference uses
the JDK's CRC32 class — the deflate bitstream itself is ours.
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

from gecoz_tpu_torch.codec.deflate import TRUNCATED, Deflater, inflate
from gecoz_tpu_torch.utils.bits import BitReader, BitWriter

_MAGIC = b"\x1f\x8b"
FTEXT, FHCRC, FEXTRA, FNAME, FCOMMENT = 1, 2, 4, 8, 16
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class GzipMember:
    __slots__ = ("offset", "header_size", "bsize", "name", "comment")

    def __init__(self, offset, header_size, bsize, name, comment):
        self.offset = offset
        self.header_size = header_size
        self.bsize = bsize          # BGZF total member size (0 if absent)
        self.name = name
        self.comment = comment


def parse_member_header(data: bytes, off: int) -> GzipMember:
    if data[off:off + 2] != _MAGIC:
        raise ValueError("invalid gzip header")
    if data[off + 2] != 8:
        raise ValueError("unknown compression method")
    flg = data[off + 3]
    p = off + 10
    bsize = 0
    if flg & FEXTRA:
        xlen = struct.unpack_from("<H", data, p)[0]
        p += 2
        end = p + xlen
        while p + 4 <= end:
            si1, si2, slen = data[p], data[p + 1], \
                struct.unpack_from("<H", data, p + 2)[0]
            p += 4
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", data, p)[0] + 1
            p += slen
        p = end
    name = comment = None
    if flg & FNAME:
        q = data.find(b"\0", p)
        if q < 0:
            raise ValueError("unterminated gzip FNAME")
        name = bytes(data[p:q]).decode("latin-1")
        p = q + 1
    if flg & FCOMMENT:
        q = data.find(b"\0", p)
        if q < 0:
            raise ValueError("unterminated gzip FCOMMENT")
        comment = bytes(data[p:q]).decode("latin-1")
        p = q + 1
    if flg & FHCRC:
        p += 2
    return GzipMember(off, p - off, bsize, name, comment)


class GzipFileReader:
    """Multi-member gzip/BGZF reader with virtual-offset access.

    The compressed input is memory-mapped, not read into RAM — the analog
    of the reference's 64 MiB mmap windows (FileChannelBitInputStream.java:
    41-243), with the OS paging exactly the ranges touched.  `inflate_to`
    streams the decoded output to a file object through a bounded window,
    so neither side of a large decompression is ever fully resident.
    """

    def __init__(self, path: str | Path):
        import mmap
        self._file = open(path, "rb")
        try:
            self.data: bytes | mmap.mmap = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:          # empty file
            self.data = b""
        if self.data[:2] != _MAGIC:
            raise ValueError("not a gzip file")

    def close(self) -> None:
        if hasattr(self.data, "close"):
            self.data.close()
        if hasattr(self, "_file"):
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read_all(self, verify: bool = True) -> bytes:
        out = bytearray()
        off = 0
        n = len(self.data)
        while off < n:
            off = self._read_member(off, out, verify)
        return bytes(out)

    def inflate_to(self, out, verify: bool = True) -> int:
        """Decode every member into binary file object `out`, streaming
        (native path holds ~1 MiB; whole members never materialize).
        Returns total decoded bytes."""
        total = 0
        off = 0
        n = len(self.data)
        while off < n:
            off, size = self._stream_member(off, out, verify)
            total += size
        return total

    def _stream_member(self, off: int, out, verify: bool) -> tuple[int, int]:
        m = parse_member_header(self.data, off)
        start = off + m.header_size
        try:
            from gecoz_tpu_torch import native
            if native.available() and hasattr(out, "fileno"):
                out.flush()
                size, bits, crc = native.inflate_to_fd(
                    memoryview(self.data)[start:], out.fileno())
                p = start + ((bits + 7) >> 3)
                want_crc, isize = struct.unpack_from("<II", self.data, p)
                if verify:
                    if crc != want_crc:
                        raise ValueError("gzip CRC mismatch")
                    if size & 0xFFFFFFFF != isize:
                        raise ValueError("gzip ISIZE mismatch")
                return p + 8, size
        except (RuntimeError, OSError, io.UnsupportedOperation):
            pass
        buf = bytearray()
        nxt = self._read_member(off, buf, verify)
        out.write(buf)
        return nxt, len(buf)

    def _read_member(self, off: int, out: bytearray, verify: bool) -> int:
        m = parse_member_header(self.data, off)
        start = off + m.header_size
        member, p = self._inflate_member(m, start)
        out += member
        crc, isize = struct.unpack_from("<II", self.data, p)
        if verify:
            if zlib.crc32(member) != crc:
                raise ValueError("gzip CRC mismatch")
            if len(member) & 0xFFFFFFFF != isize:
                raise ValueError("gzip ISIZE mismatch")
        return p + 8

    def _inflate_member(self, m: GzipMember, start: int) -> tuple[bytes, int]:
        try:
            from gecoz_tpu_torch import native
            if native.available():
                if m.bsize:     # BGZF: exact size from the ISIZE footer
                    cap = struct.unpack_from(
                        "<I", self.data, m.offset + m.bsize - 4)[0] or 1
                else:
                    cap = max(len(self.data) * 4, 1 << 20)
                while True:
                    try:
                        member, bits = native.inflate(
                            memoryview(self.data)[start:], cap)
                        return member, start + ((bits + 7) >> 3)
                    except MemoryError:
                        cap *= 4
        except (ValueError, OSError) as ex:
            if ex.args == (TRUNCATED,):
                raise           # the Python decoder stops at the same cut
            # else fall through to the Python decoder
        r = BitReader(self.data, start * 8)
        buf = bytearray()
        inflate(r, buf)
        r.align()
        return bytes(buf), r.bytepos

    # -- BGZF virtual offsets ----------------------------------------------

    def members(self) -> list[GzipMember]:
        res = []
        off = 0
        scratch = bytearray()
        while off < len(self.data):
            m = parse_member_header(self.data, off)
            res.append(m)
            if m.bsize:
                off += m.bsize
            else:
                scratch.clear()
                off = self._read_member(off, scratch, False)
        return res

    def read_from_virtual(self, voffset: int, nbytes: int) -> bytes:
        """BGZF random access: voffset = block_pos << 16 | within
        (BAMFileInputStream.java:69-83 convention)."""
        block_pos = voffset >> 16
        within = voffset & 0xFFFF
        out = bytearray()
        off = block_pos
        while len(out) < within + nbytes and off < len(self.data):
            off = self._read_member(off, out, False)
        return bytes(out[within:within + nbytes])


def _deflate_whole(payload: bytes, matcher: str) -> bytes:
    """One complete deflate stream; native fast path for auto/native/sa.

    'auto' routes whole members through the native SA matcher — the
    reference's production architecture (SA + LCP matching, LZ77.java:
    26-180), measured ~1.5 pp better ratio than the native hash chain on
    genomic text at ~1.5x the time (zlib-9-grade output); 'native' keeps
    the fastest (hash-chain) encoder.  Either falls back to the Python
    codec when the library is unavailable.
    """
    if matcher in ("auto", "native", "sa"):
        try:
            from gecoz_tpu_torch import native
            if native.available():
                return native.deflate(
                    payload, matcher="sa" if matcher in ("auto", "sa")
                    else "hash")
        except Exception:
            pass
        matcher = "sa" if matcher == "sa" else "hash"
    return Deflater(matcher).deflate(payload).getvalue()


def _member_bytes(payload: bytes, deflater: "Deflater | str", bgzf: bool,
                  name: str | None = None) -> bytes:
    if isinstance(deflater, str):
        body = _deflate_whole(payload, deflater)
    else:
        body = deflater.deflate(payload).getvalue()
    flg = (FEXTRA if bgzf else 0) | (FNAME if name else 0)
    head = bytearray()
    head += _MAGIC
    head.append(8)
    head.append(flg)
    head += struct.pack("<I", 0)        # mtime
    head.append(2)                      # xfl: max compression
    head.append(255)                    # os: unknown
    if bgzf:
        total = len(head) + 2 + 6 + len(body) + 8
        if name:
            total += len(name) + 1
        head += struct.pack("<H", 6)    # xlen
        head += b"BC" + struct.pack("<HH", 2, total - 1)
    if name:
        head += name.encode("latin-1") + b"\0"
    tail = struct.pack("<II", zlib.crc32(payload),
                       len(payload) & 0xFFFFFFFF)
    return bytes(head) + body + tail


class GzipFileWriter:
    """gzip (streaming single member) or BGZF (64 KiB members + EOF marker)
    writer — the DeflaterOutputStream/GZipFileOutputStream equivalent."""

    def __init__(self, path: str | Path, bgzf: bool = False,
                 matcher: str = "auto", name: str | None = None):
        self.f = open(path, "wb")
        self.bgzf = bgzf
        # BGZF members are independent whole streams -> native fast path;
        # streaming plain gzip needs bit-level continuation -> python codec
        self.matcher = matcher
        self.deflater = Deflater("hash" if matcher in ("auto", "native")
                                 else matcher)
        self.name = name
        self._buf = bytearray()
        self._bits: BitWriter | None = None
        self._crc = 0
        self._isize = 0

    MEMBER = 64 * 1024 - 256            # BGZF input cap per member
    WINDOW = 32 * 1024                  # plain-gzip streaming window

    def write(self, data: bytes) -> None:
        self._buf += data
        if self.bgzf:
            while len(self._buf) >= self.MEMBER:
                chunk = bytes(self._buf[:self.MEMBER])
                del self._buf[:self.MEMBER]
                self.f.write(_member_bytes(chunk, self.matcher, True))
        else:
            while len(self._buf) >= self.WINDOW:
                chunk = bytes(self._buf[:self.WINDOW])
                del self._buf[:self.WINDOW]
                self._stream_chunk(chunk, bfinal=False)

    def _stream_chunk(self, chunk: bytes, bfinal: bool) -> None:
        if self._bits is None:
            self._bits = BitWriter()
            head = bytearray(_MAGIC)
            head.append(8)
            head.append(FNAME if self.name else 0)
            head += struct.pack("<I", 0) + bytes([2, 255])
            if self.name:
                head += self.name.encode("latin-1") + b"\0"
            self.f.write(bytes(head))
        self.deflater.deflate(chunk, self._bits, bfinal=bfinal)
        self._crc = zlib.crc32(chunk, self._crc)
        self._isize += len(chunk)
        self.f.write(self._bits.drain())

    def close(self) -> None:
        if self.bgzf:
            if self._buf:
                self.f.write(_member_bytes(bytes(self._buf), self.matcher,
                                           True))
            self.f.write(_BGZF_EOF)
        else:
            self._stream_chunk(bytes(self._buf), bfinal=True)
            self.f.write(self._bits.getvalue())
            self.f.write(struct.pack("<II", self._crc,
                                     self._isize & 0xFFFFFFFF))
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def gzip_compress(data: bytes, matcher: str = "auto") -> bytes:
    return _member_bytes(data, matcher, False)


def gzip_decompress(data: bytes) -> bytes:
    out = bytearray()
    off = 0
    # reuse the reader logic without a file
    rd = GzipFileReader.__new__(GzipFileReader)
    rd.data = data
    while off < len(data):
        off = rd._read_member(off, out, True)
    return bytes(out)
