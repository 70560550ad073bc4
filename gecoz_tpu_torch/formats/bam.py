"""BAM binary format: reader, writer, and BAI index (build/load/save/query).

The port's copy of gecoz_tpu/formats/bam.py (imports changed only).

Functional equivalent of the reference nova-formats/bam package
(BAMFileReader.java, BAMFileInputStream.java, BAMRecord.java, BAMHeader.java,
BAI.java) on top of our BGZF container: virtual offsets are
``member_file_offset << 16 | intra_member_offset`` (BAMFileInputStream.java:
69-83), range queries go through the standard UCSC binning scheme
(BAI.reg2bins), and a missing `.bai` is built by scanning the BAM
(BAMFileReader.java:52-76).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

from gecoz_tpu_torch.codec.gzip_file import GzipFileReader, GzipFileWriter
from gecoz_tpu_torch.formats.sam import (CIGAR_OPS, SAMRecord, SAMTag,
                                         reference_span)

_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_SEQ_LOOKUP = {c: i for i, c in enumerate(_SEQ_CODES)}


@dataclass
class BAMHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]


def _decode_record(buf: bytes, off: int) -> tuple[SAMRecord, int, int, int]:
    """Decode one alignment; returns (record, ref_id, next_ref_id, new_off)."""
    block_size = struct.unpack_from("<i", buf, off)[0]
    p = off + 4
    end = p + block_size
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", buf, p)
    p += 32
    qname = buf[p:p + l_read_name - 1].decode()
    p += l_read_name
    ops = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", buf, p)[0]
        p += 4
        ops.append((v >> 4, CIGAR_OPS[v & 0xF]))
    seq_chars = []
    for i in range(l_seq):
        b = buf[p + (i >> 1)]
        seq_chars.append(_SEQ_CODES[(b >> 4) if i % 2 == 0 else (b & 0xF)])
    p += (l_seq + 1) // 2
    qual = buf[p:p + l_seq]
    p += l_seq
    tags = []
    while p < end:
        tag = buf[p:p + 2].decode()
        typ = chr(buf[p + 2])
        p += 3
        val, p = _decode_tag_value(buf, p, typ)
        if typ in "cCsSiI":
            typ = "i"
        tags.append(SAMTag(tag, typ, val))

    rec = SAMRecord(
        qname=qname, flag=flag, pos=pos + 1, mapq=mapq,
        cigar="".join(f"{n}{op}" for n, op in ops) if ops else "*",
        pnext=next_pos + 1, tlen=tlen,
        seq="".join(seq_chars) if l_seq else "*",
        qual="".join(chr(q + 33) for q in qual) if l_seq and qual[0:1] != b"\xff"
             else "*",
        tags=tags)
    return rec, ref_id, next_ref, end


_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I",
            "f": "<f"}


def _decode_tag_value(buf: bytes, p: int, typ: str):
    if typ == "A":
        return chr(buf[p]), p + 1
    if typ in _TAG_FMT:
        fmt = _TAG_FMT[typ]
        return struct.unpack_from(fmt, buf, p)[0], p + struct.calcsize(fmt)
    if typ in "ZH":
        q = buf.index(b"\0", p)
        return buf[p:q].decode(), q + 1
    if typ == "B":
        sub = chr(buf[p])
        n = struct.unpack_from("<i", buf, p + 1)[0]
        fmt = _TAG_FMT[sub]
        sz = struct.calcsize(fmt)
        vals = [struct.unpack_from(fmt, buf, p + 5 + i * sz)[0]
                for i in range(n)]
        return (sub, vals), p + 5 + n * sz
    raise ValueError(f"unknown tag type {typ}")


def _encode_record(rec: SAMRecord, ref_id: int, next_ref: int) -> bytes:
    ops = rec.cigar_ops()
    seq = rec.seq if rec.seq != "*" else ""
    l_seq = len(seq)
    name = rec.qname.encode() + b"\0"
    out = bytearray()
    end_pos = rec.pos - 1 + max(reference_span(ops), 1)
    out += struct.pack("<iiBBHHHiiii", ref_id, rec.pos - 1, len(name),
                       rec.mapq, reg2bin(rec.pos - 1, end_pos), len(ops),
                       rec.flag, l_seq, next_ref, rec.pnext - 1, rec.tlen)
    out += name
    for n, op in ops:
        out += struct.pack("<I", (n << 4) | CIGAR_OPS.index(op))
    for i in range(0, l_seq, 2):
        hi = _SEQ_LOOKUP.get(seq[i], 15) << 4
        lo = _SEQ_LOOKUP.get(seq[i + 1], 15) if i + 1 < l_seq else 0
        out.append(hi | lo)
    if rec.qual == "*" or not l_seq:
        out += b"\xff" * l_seq
    else:
        out += bytes(ord(c) - 33 for c in rec.qual)
    for t in rec.tags:
        out += t.tag.encode()
        if t.type == "i":
            out += b"i" + struct.pack("<i", t.value)
        elif t.type == "A":
            out += b"A" + t.value.encode()
        elif t.type == "f":
            out += b"f" + struct.pack("<f", t.value)
        elif t.type in "ZH":
            out += t.type.encode() + t.value.encode() + b"\0"
        elif t.type == "B":
            sub, vals = t.value
            out += b"B" + sub.encode() + struct.pack("<i", len(vals))
            for v in vals:
                out += struct.pack(_TAG_FMT[sub], v)
    return struct.pack("<i", len(out)) + bytes(out)


class BAMFileReader:
    def __init__(self, path: str | Path, bai_path: str | Path | None = None):
        self.path = Path(path)
        self._gz = GzipFileReader(self.path)
        self.data = self._gz.read_all(verify=False)
        self._voffsets = self._build_voffset_map()
        self.header, self._rec0 = self._parse_header()
        self.bai: "BAI | None" = None
        if bai_path is None:
            # reference convention: x.bam -> x.bai (BAMFileReader.java:63-65);
            # also accept the common x.bam.bai
            for cand in (self.path.with_suffix(".bai"),
                         self.path.with_name(self.path.name + ".bai")):
                if cand.is_file():
                    bai_path = cand
                    break
        if bai_path is not None:
            self.bai = BAI.load(bai_path)

    def _build_voffset_map(self):
        """uncompressed offset <-> (member offset) for virtual offsets."""
        starts = []   # (uncompressed_start, file_offset)
        off = 0
        total = 0
        for m in self._gz.members():
            starts.append((total, m.offset))
            scratch = bytearray()
            nxt = self._gz._read_member(m.offset, scratch, False)
            total += len(scratch)
            off = nxt
        return starts

    def uncompressed_of_virtual(self, voffset: int) -> int:
        block = voffset >> 16
        within = voffset & 0xFFFF
        for total, foff in self._voffsets:
            if foff == block:
                return total + within
        raise ValueError(f"virtual offset {voffset:#x} not at a member start")

    def virtual_of_uncompressed(self, upos: int) -> int:
        best = self._voffsets[0]
        for total, foff in self._voffsets:
            if total <= upos:
                best = (total, foff)
            else:
                break
        return (best[1] << 16) | (upos - best[0])

    def _parse_header(self) -> tuple[BAMHeader, int]:
        buf = self.data
        if buf[:4] != b"BAM\x01":
            raise ValueError("not a BAM file")
        l_text = struct.unpack_from("<i", buf, 4)[0]
        text = buf[8:8 + l_text].split(b"\0")[0].decode()
        p = 8 + l_text
        n_ref = struct.unpack_from("<i", buf, p)[0]
        p += 4
        names, lengths = [], []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", buf, p)[0]
            names.append(buf[p + 4:p + 4 + l_name - 1].decode())
            lengths.append(struct.unpack_from("<i", buf, p + 4 + l_name)[0])
            p += 8 + l_name
        return BAMHeader(text, names, lengths), p

    def records(self):
        """Iterate all alignments (rname/rnext resolved)."""
        p = self._rec0
        n = len(self.data)
        while p < n:
            rec, ref_id, next_ref, p = _decode_record(self.data, p)
            self._resolve(rec, ref_id, next_ref)
            yield rec, ref_id

    def _resolve(self, rec, ref_id, next_ref):
        names = self.header.ref_names
        rec.rname = names[ref_id] if 0 <= ref_id < len(names) else "*"
        rec.rnext = names[next_ref] if 0 <= next_ref < len(names) else "*"

    def make_index(self) -> "BAI":
        bai = BAI(n_ref=len(self.header.ref_names))
        p = self._rec0
        n = len(self.data)
        while p < n:
            start = p
            rec, ref_id, _, p = _decode_record(self.data, start)
            if ref_id < 0 or rec.pos <= 0:
                continue
            beg = rec.pos - 1
            end = rec.position_end()
            bai.add(ref_id, beg, end,
                    self.virtual_of_uncompressed(start),
                    self.virtual_of_uncompressed(p))
        return bai

    def search(self, id_ref: int, start: int, end: int) -> list[SAMRecord]:
        """Range query [start, end) 0-based (BAMFileReader.search:92-125)."""
        if self.bai is None:
            self.bai = self.make_index()
        out = []
        seen = set()
        for chunk_beg, chunk_end in self.bai.chunks(id_ref, start, end):
            p = self.uncompressed_of_virtual(chunk_beg)
            pe = self.uncompressed_of_virtual(chunk_end)
            while p < pe:
                if p in seen:
                    _, _, _, p = _decode_record(self.data, p)
                    continue
                seen.add(p)
                rec, ref_id, next_ref, p = _decode_record(self.data, p)
                if ref_id == id_ref and rec.pos - 1 < end \
                        and rec.position_end() > start:
                    self._resolve(rec, ref_id, next_ref)
                    out.append(rec)
        out.sort(key=lambda r: r.pos)
        return out


class BAMFileWriter:
    def __init__(self, path: str | Path, header: BAMHeader):
        self.w = GzipFileWriter(path, bgzf=True)
        buf = bytearray(b"BAM\x01")
        text = header.text.encode() + b"\0"
        buf += struct.pack("<i", len(text)) + text
        buf += struct.pack("<i", len(header.ref_names))
        for name, ln in zip(header.ref_names, header.ref_lengths):
            nm = name.encode() + b"\0"
            buf += struct.pack("<i", len(nm)) + nm + struct.pack("<i", ln)
        self.w.write(bytes(buf))
        self.names = {n: i for i, n in enumerate(header.ref_names)}

    def write(self, rec: SAMRecord) -> None:
        ref_id = self.names.get(rec.rname, -1)
        next_ref = ref_id if rec.rnext == "=" \
            else self.names.get(rec.rnext, -1)
        self.w.write(_encode_record(rec, ref_id, next_ref))

    def close(self) -> None:
        self.w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- BAI index --------------------------------------------------------------

def reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end) (BAI.reg2bins)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


@dataclass
class BAI:
    n_ref: int
    bins: list[dict[int, list[tuple[int, int]]]] = field(default_factory=list)
    linear: list[list[int]] = field(default_factory=list)

    def __post_init__(self):
        while len(self.bins) < self.n_ref:
            self.bins.append({})
        while len(self.linear) < self.n_ref:
            self.linear.append([])

    def add(self, ref_id, beg, end, voff_beg, voff_end) -> None:
        b = reg2bin(beg, end)
        chunks = self.bins[ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_beg:
            chunks[-1] = (chunks[-1][0], voff_end)   # coalesce adjacent
        else:
            chunks.append((voff_beg, voff_end))
        lin = self.linear[ref_id]
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            while len(lin) <= w:
                lin.append(0)
            if lin[w] == 0 or voff_beg < lin[w]:
                lin[w] = voff_beg

    def chunks(self, ref_id, beg, end):
        out = []
        for b in reg2bins(beg, end):
            out.extend(self.bins[ref_id].get(b, ()))
        return sorted(out)

    def save(self, path) -> None:
        out = bytearray(b"BAI\x01")
        out += struct.pack("<i", self.n_ref)
        for r in range(self.n_ref):
            out += struct.pack("<i", len(self.bins[r]))
            for b, chunks in sorted(self.bins[r].items()):
                out += struct.pack("<Ii", b, len(chunks))
                for beg, end in chunks:
                    out += struct.pack("<QQ", beg, end)
            out += struct.pack("<i", len(self.linear[r]))
            for v in self.linear[r]:
                out += struct.pack("<Q", v)
        Path(path).write_bytes(bytes(out))

    @classmethod
    def load(cls, path) -> "BAI":
        buf = Path(path).read_bytes()
        if buf[:4] != b"BAI\x01":
            raise ValueError("not a BAI file")
        n_ref = struct.unpack_from("<i", buf, 4)[0]
        bai = cls(n_ref=n_ref)
        p = 8
        for r in range(n_ref):
            n_bin = struct.unpack_from("<i", buf, p)[0]
            p += 4
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", buf, p)
                p += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", buf, p)
                    p += 16
                    chunks.append((beg, end))
                bai.bins[r][b] = chunks
            n_intv = struct.unpack_from("<i", buf, p)[0]
            p += 4
            bai.linear[r] = [struct.unpack_from("<Q", buf, p + 8 * i)[0]
                             for i in range(n_intv)]
            p += 8 * n_intv
        return bai


# -- SAM <-> BAM conversion -------------------------------------------------

def bam_to_sam(bam_path, sam_path) -> None:
    """Dump a BAM as SAM text (header + records)."""
    from gecoz_tpu_torch.formats.sam import SAMHeader
    r = BAMFileReader(bam_path)
    with open(sam_path, "w") as f:
        text = r.header.text
        if text and not text.endswith("\n"):
            text += "\n"
        f.write(text)
        for rec, _ in r.records():
            f.write(rec.format() + "\n")


def sam_to_bam(sam_path, bam_path) -> None:
    """Encode SAM text as BAM (reference names/lengths from @SQ lines)."""
    from gecoz_tpu_torch.formats.sam import read_sam
    header, records = read_sam(sam_path)
    names = [sq["SN"] for sq in header.references]
    lengths = [int(sq.get("LN", 0)) for sq in header.references]
    text = Path(sam_path).read_text()
    htext = "".join(l + "\n" for l in text.splitlines() if l.startswith("@"))
    with BAMFileWriter(bam_path, BAMHeader(htext, names, lengths)) as w:
        for rec in records:
            w.write(rec)
