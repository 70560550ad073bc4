"""SAM object model: header lines, records, CIGAR, typed tags.

The port's copy of gecoz_tpu/formats/sam.py (the same code).

Functional equivalent of the reference's nova-formats/sam package
(SAMHeader.java, SAMRecord.java, CIGAR.java/CIGARDecoder.java and the
60+ per-tag classes under sam/tag/), collapsed into a data-driven model:
tags are (tag, type, value) with SAM/BAM type codes instead of one class
per two-letter tag.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

CIGAR_OPS = "MIDNSHP=X"
# ops that consume reference / query
REF_CONSUMING = set("MDN=X")
QUERY_CONSUMING = set("MIS=X")

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def decode_cigar(cigar: str) -> list[tuple[int, str]]:
    """'10M2I5D' -> [(10,'M'),(2,'I'),(5,'D')] (CIGARDecoder.java)."""
    if cigar == "*":
        return []
    ops = _CIGAR_RE.findall(cigar)
    if sum(len(n) + 1 for n, _ in ops) != len(cigar):
        raise ValueError(f"bad CIGAR: {cigar}")
    return [(int(n), op) for n, op in ops]


def encode_cigar(ops: list[tuple[int, str]]) -> str:
    return "".join(f"{n}{op}" for n, op in ops) if ops else "*"


def reference_span(ops: list[tuple[int, str]]) -> int:
    return sum(n for n, op in ops if op in REF_CONSUMING)


def query_length(ops: list[tuple[int, str]]) -> int:
    return sum(n for n, op in ops if op in QUERY_CONSUMING)


# Canonical types of the predefined SAM tags — the data-driven equivalent
# of the reference's SAMTagEnum + 50 per-tag classes (sam/tag/
# SAMTagEnum.java:37-45): 'i' covers every integer width (c/C/s/S/i/I on
# the BAM wire), '?' marks legacy tags the spec reserves without a type.
SAM_TAG_TYPES = {
    "AM": "i", "AS": "i", "BC": "Z", "BQ": "Z", "BZ": "Z", "CB": "Z",
    "CC": "Z", "CG": "B", "CM": "i", "CO": "Z", "CP": "i", "CQ": "Z",
    "CR": "Z", "CS": "Z", "CT": "Z", "CY": "Z", "E2": "Z", "FI": "i",
    "FS": "Z", "FZ": "B", "GC": "?", "GQ": "?", "GS": "?", "H0": "i",
    "H1": "i", "H2": "i", "HI": "i", "IH": "i", "LB": "Z", "MC": "Z",
    "MD": "Z", "MF": "?", "MI": "Z", "MQ": "i", "NH": "i", "NM": "i",
    "OA": "Z", "OC": "Z", "OP": "i", "OQ": "Z", "OX": "Z", "PG": "Z",
    "PQ": "i", "PT": "Z", "PU": "Z", "Q2": "Z", "QT": "Z", "QX": "Z",
    "R2": "Z", "RG": "Z", "RT": "?", "RX": "Z", "S2": "?", "SA": "Z",
    "SM": "i", "SQ": "?", "TC": "i", "U2": "Z", "UQ": "i",
}

_INT_TYPES = set("cCsSiI")


def is_local_tag(tag: str) -> bool:
    """Locally-defined tags (X*, Y*, Z* or lowercase start) are free-form
    per the SAM spec; everything else should match the registry."""
    return len(tag) == 2 and (tag[0] in "XYZ" or tag[0].islower())


def validate_tag(tag: str, typ: str) -> str | None:
    """None when (tag, declared type) is consistent with the registry;
    otherwise a human-readable problem description (the semantic check
    SAMTagEnum's typed decode applies)."""
    want = SAM_TAG_TYPES.get(tag)
    if want is None:
        return None if is_local_tag(tag) else \
            f"unknown predefined-style tag {tag}"
    if want == "?":
        return None                           # reserved, untyped
    got = "i" if typ in _INT_TYPES else typ
    if got != want and not (want == "Z" and got == "H"):
        return f"tag {tag} declared {typ}, registry says {want}"
    return None


@dataclass
class SAMTag:
    tag: str       # two letters
    type: str      # A i f Z H B
    value: object

    def canonical_type(self) -> str | None:
        """Registered type for predefined tags, None for local ones."""
        t = SAM_TAG_TYPES.get(self.tag)
        return None if t in (None, "?") else t

    def validate(self) -> str | None:
        return validate_tag(self.tag, self.type)

    def format(self) -> str:
        if self.type == "B":
            sub, vals = self.value
            return f"{self.tag}:B:{sub}," + ",".join(str(v) for v in vals)
        return f"{self.tag}:{self.type}:{self.value}"

    @classmethod
    def parse(cls, text: str) -> "SAMTag":
        tag, typ, val = text.split(":", 2)
        if typ == "i":
            val = int(val)
        elif typ == "f":
            val = float(val)
        elif typ == "B":
            sub = val[0]
            conv = float if sub in "f" else int
            val = (sub, [conv(x) for x in val[2:].split(",")] if len(val) > 2
                   else [])
        return cls(tag, typ, val)


@dataclass
class SAMRecord:
    qname: str = "*"
    flag: int = 0
    rname: str = "*"
    pos: int = 0               # 1-based, 0 = unmapped
    mapq: int = 255
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: list[SAMTag] = field(default_factory=list)

    # flag bits (SAM spec)
    PAIRED, PROPER_PAIR, UNMAP, MUNMAP = 0x1, 0x2, 0x4, 0x8
    REVERSE, MREVERSE, READ1, READ2 = 0x10, 0x20, 0x40, 0x80
    SECONDARY, QCFAIL, DUP, SUPPLEMENTARY = 0x100, 0x200, 0x400, 0x800

    def cigar_ops(self) -> list[tuple[int, str]]:
        return decode_cigar(self.cigar)

    def position_end(self) -> int:
        """1-based inclusive end on the reference."""
        return self.pos + max(reference_span(self.cigar_ops()), 1) - 1

    def get_tag(self, tag: str) -> SAMTag | None:
        for t in self.tags:
            if t.tag == tag:
                return t
        return None

    def validate_tags(self) -> list[str]:
        """Registry-check every tag (SAMTagEnum semantics); empty = clean."""
        return [p for t in self.tags if (p := t.validate())]

    def format(self) -> str:
        fields = [self.qname, str(self.flag), self.rname, str(self.pos),
                  str(self.mapq), self.cigar, self.rnext, str(self.pnext),
                  str(self.tlen), self.seq, self.qual]
        fields += [t.format() for t in self.tags]
        return "\t".join(fields)

    @classmethod
    def parse(cls, line: str) -> "SAMRecord":
        parts = line.rstrip("\n").split("\t")
        rec = cls(qname=parts[0], flag=int(parts[1]), rname=parts[2],
                  pos=int(parts[3]), mapq=int(parts[4]), cigar=parts[5],
                  rnext=parts[6], pnext=int(parts[7]), tlen=int(parts[8]),
                  seq=parts[9], qual=parts[10])
        rec.tags = [SAMTag.parse(t) for t in parts[11:]]
        return rec


@dataclass
class SAMHeader:
    """Parsed @-lines: version/sort order, reference sequences, read
    groups, programs, comments (sam/header/*.java equivalents)."""

    version: str | None = None
    sort_order: str | None = None
    grouping: str | None = None
    references: list[dict] = field(default_factory=list)   # @SQ
    read_groups: list[dict] = field(default_factory=list)  # @RG
    programs: list[dict] = field(default_factory=list)     # @PG
    comments: list[str] = field(default_factory=list)      # @CO

    @classmethod
    def parse(cls, text: str) -> "SAMHeader":
        h = cls()
        for line in text.splitlines():
            if not line.startswith("@"):
                continue
            kind = line[:3]
            if kind == "@CO":
                h.comments.append(line[4:])
                continue
            attrs = {}
            for fld in line[4:].split("\t"):
                if ":" in fld:
                    k, v = fld.split(":", 1)
                    attrs[k] = v
            if kind == "@HD":
                h.version = attrs.get("VN")
                h.sort_order = attrs.get("SO")
                h.grouping = attrs.get("GO")
            elif kind == "@SQ":
                h.references.append(attrs)
            elif kind == "@RG":
                h.read_groups.append(attrs)
            elif kind == "@PG":
                h.programs.append(attrs)
        return h

    def format(self) -> str:
        out = []
        if self.version:
            hd = f"@HD\tVN:{self.version}"
            if self.sort_order:
                hd += f"\tSO:{self.sort_order}"
            if self.grouping:
                hd += f"\tGO:{self.grouping}"
            out.append(hd)
        for kind, rows in (("@SQ", self.references),
                           ("@RG", self.read_groups),
                           ("@PG", self.programs)):
            for attrs in rows:
                out.append(kind + "".join(f"\t{k}:{v}"
                                          for k, v in attrs.items()))
        out += [f"@CO\t{c}" for c in self.comments]
        return "\n".join(out) + ("\n" if out else "")


def read_sam(path) -> tuple[SAMHeader, list[SAMRecord]]:
    header_text = []
    records = []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                header_text.append(line)
            elif line.strip():
                records.append(SAMRecord.parse(line))
    return SAMHeader.parse("".join(header_text)), records


def write_sam(path, header: SAMHeader, records: list[SAMRecord]) -> None:
    with open(path, "w") as f:
        f.write(header.format())
        for r in records:
            f.write(r.format() + "\n")
