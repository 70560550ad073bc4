"""FASTA / FASTQ reading and FASTA writing.

The port's copy of gecoz_tpu/formats/fasta.py (imports changed only): gzip
and BGZF input is inflated by the port's copy of the reference's codec
(`codec/gzip_file.py::GzipFileReader`, the host library's streaming
inflate), which refuses what the reference refuses, and also a member cut
inside its deflate data, which the reference reads without end (ROADMAP
C2).

Matches the reference's parsing semantics (nova-formats fasta/
FastaIterator.java:28-137): records start at '>' or '@', FASTQ quality
sections ('+') are skipped, CR/LF are stripped, and header text is the full
line after the marker.  Output matches FastaFileWriter.java:30-224:
50-character lines, each newline-terminated — including its quirk of an
extra blank line when the sequence length is an exact multiple of 50 (the
reserved mmap region is ``len + len/50 + 1`` bytes, FastaFileWriter.java:142).

`read_queries`, the GFF3 search's reader of its query file, is the port's
own: it gives `iter_fasta`'s records from one read of the file, and falls
back to `iter_fasta` on a file of neither regular shape.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

LINE_LENGTH = 50


@dataclass
class FastaSequence:
    header: str
    length: int
    position: int            # byte offset of sequence data in the file
    multiline: bool
    data: np.ndarray | None = None

    def sort_key(self):
        """TFastaSequence.compareTo: length desc, then header asc."""
        return (-self.length, self.header)


# gzipped inputs are inflated exactly ONCE per process into a temp file
# shared by every scan / read_sequence call (the reference likewise reads
# gzipped input once, FastaFileReader.java:~70, README.md:39 — our previous
# per-call re-inflation was O(S*n) on an S-sequence file).  Keyed by
# (path, mtime, size); bounded to the most recent few inputs.
_INFLATED_CACHE: dict[tuple, str] = {}
_INFLATE_COUNT = 0              # test hook: total inflations performed
_CACHE_LIMIT = 2


def _cleanup_inflated() -> None:
    import os
    for tmp in _INFLATED_CACHE.values():
        try:
            os.unlink(tmp)
        except OSError:
            pass
    _INFLATED_CACHE.clear()


def _inflated_path(path: Path) -> str:
    """Temp file holding the fully-inflated bytes of a gzipped input."""
    global _INFLATE_COUNT
    import atexit
    import os
    import tempfile
    st = path.stat()
    key = (str(path.resolve()), st.st_mtime_ns, st.st_size)
    tmp = _INFLATED_CACHE.get(key)
    if tmp is not None and Path(tmp).is_file():
        return tmp
    from gecoz_tpu_torch.codec.gzip_file import GzipFileReader
    if not _INFLATED_CACHE:
        atexit.register(_cleanup_inflated)
    while len(_INFLATED_CACHE) >= _CACHE_LIMIT:
        _, old = _INFLATED_CACHE.popitem()
        try:
            os.unlink(old)
        except OSError:
            pass
    f = tempfile.NamedTemporaryFile(prefix="gecoz_inflated_", delete=False)
    try:
        with GzipFileReader(path) as gz:
            gz.inflate_to(f)        # streaming: bounded memory both sides
        f.close()
    except BaseException:
        f.close()
        os.unlink(f.name)
        raise
    _INFLATE_COUNT += 1
    _INFLATED_CACHE[key] = f.name
    return f.name


def _open_maybe_gzip(path: Path):
    """Return a seekable binary stream of the (possibly inflated) input
    (FastaFileReader.java:70-81 trial-open behavior)."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        f.close()
        return open(_inflated_path(path), "rb")
    return f


def iter_fasta(path: str | Path, lazy: bool = False) -> Iterator[FastaSequence]:
    """Stream records; with lazy=True sequence bytes are not materialized
    (headers + positions only), mirroring FastaFileReader's lazy mode.

    Truly streaming: the file is consumed line by line, so peak memory is
    O(longest line) in lazy mode (plus the current record's bytes when not
    lazy) — never the whole file.
    """
    path = Path(path)
    with _open_maybe_gzip(path) as f:
        pos = 0
        header: str | None = None
        seq_start = 0
        chunks: list[bytes] = []
        length = 0
        lines = 0

        def record() -> FastaSequence:
            data = None
            if not lazy:
                data = np.frombuffer(b"".join(chunks), dtype=np.uint8)
            return FastaSequence(header=header, length=length,
                                 position=seq_start, multiline=lines > 1,
                                 data=data)

        line = f.readline()
        while line:
            pos += len(line)
            mark = line[:1]
            if mark in (b">", b"@"):
                if header is not None:
                    yield record()
                header = line[1:].rstrip(b"\r\n").decode()
                seq_start = pos
                chunks, length, lines = [], 0, 0
            elif mark == b"+" and header is not None:
                # FASTQ: skip the quality block (same #bytes as sequence)
                qlen = qlines = 0
                line = f.readline()
                while line and qlen < length and qlines < lines:
                    pos += len(line)
                    qlen += len(line.rstrip(b"\r\n"))
                    qlines += 1
                    line = f.readline()
                continue                  # `line` not yet consumed/counted
            elif header is not None:
                s = line.rstrip(b"\r\n")
                if s:
                    lines += 1
                    length += len(s)
                    if not lazy:
                        chunks.append(s)
            line = f.readline()
        if header is not None:
            yield record()


_TRAILING_CR = re.compile(rb"\r+(?=\n)|\r+\Z")


def read_queries(path: str | Path) -> tuple[list[str], list[bytes], bool]:
    """A query file's `(headers, sequences, bulk)`: what `iter_fasta`
    gives, in one read of the file.

    The lines are split once and classified by their first bytes.  Two
    regular shapes are parsed in bulk (`bulk` is True): FASTA, where no
    line starts with '@' or '+' (a record is a '>' line and the stripped
    lines up to the next; lines before the first are ignored), and FASTQ
    in 4-line records ('@' header, one non-empty sequence line that starts
    with none of '>@+', a '+' line, one quality line).  Any other file,
    and one whose headers are not UTF-8, is read by `iter_fasta`.
    """
    with _open_maybe_gzip(Path(path)) as f:
        data = f.read()
    if b"\r" in data:                 # each line's rstrip(b"\r\n")
        data = _TRAILING_CR.sub(b"", data)
    lines = data.split(b"\n")
    if lines[-1] == b"":              # no line after the last newline
        lines.pop()
    n = len(lines)
    lens = np.fromiter(map(len, lines), np.int64, n)
    starts = np.cumsum(lens + 1) - (lens + 1)
    mark = np.zeros(n, np.uint8)      # each line's first byte, 0 if empty
    full = lens > 0
    mark[full] = np.frombuffer(data, np.uint8)[starts[full]]
    del data
    gt, at, plus = (mark == ord(c) for c in ">@+")
    headers = None
    if not at.any() and not plus.any():
        heads = np.flatnonzero(gt)
        ends = np.append(heads[1:], n)
        # one line a record: slices share the lines, no join a record
        # (10^6 150-bp reads: 234 ms against the join's 630 on an H100 host)
        if len(heads) and (ends - heads == 2).all():
            headers = _headers(lines[heads[0]::2], "\n>")
            seqs = lines[heads[0] + 1::2]
        else:
            headers = _headers([lines[i] for i in heads.tolist()], "\n>")
            seqs = [b"".join(lines[a + 1:b])
                    for a, b in zip(heads.tolist(), ends.tolist())]
    elif (n % 4 == 0 and at[0::4].all() and plus[2::4].all()
          and full[1::4].all()
          and not (gt[1::4] | at[1::4] | plus[1::4]).any()):
        headers, seqs = _headers(lines[0::4], "\n@"), lines[1::4]
    if headers is None:
        records = [(q.header, bytes(q.data)) for q in iter_fasta(path)]
        return [h for h, _ in records], [s for _, s in records], False
    return headers, seqs, True


def _headers(lines: list[bytes], sep: str) -> list[str] | None:
    """Header lines less their marker, decoded in one call; None if they
    are not UTF-8.  `sep` is a newline and the marker: it cuts the joined
    lines exactly where they were joined."""
    if not lines:
        return []
    try:
        text = b"\n".join(lines).decode()
    except UnicodeDecodeError:
        return None
    return text[1:].split(sep)


def read_sequence(path: str | Path, seq: FastaSequence) -> np.ndarray:
    """Materialize a lazily-scanned sequence."""
    if seq.data is not None:
        return seq.data
    with _open_maybe_gzip(Path(path)) as f:
        f.seek(seq.position)
        out = bytearray()
        while len(out) < seq.length:
            line = f.readline()
            if not line:
                break
            out += line.rstrip(b"\r\n")
    return np.frombuffer(bytes(out[:seq.length]), dtype=np.uint8)


def format_fasta_record(header: str, data: np.ndarray | bytes) -> bytes:
    """One output record in the reference's exact byte layout."""
    data = bytes(data)
    n = len(data)
    out = bytearray()
    out += b">" + header.encode() + b"\n"
    for i in range(0, n, LINE_LENGTH):
        out += data[i:i + LINE_LENGTH]
        out += b"\n"
    if n % LINE_LENGTH == 0 and n > 0:
        out += b"\n"   # FastaFileWriter's reserved-size quirk
    return bytes(out)


def record_size(header: str, n: int) -> int:
    """Exact byte size of one output record (the reference pre-reserves
    this region per sequence, FastaFileWriter.java:142 — ``len + len/50 + 1``
    plus the header line)."""
    hlen = len(header.encode()) + 2          # '>' + header + '\n'
    if n == 0:
        return hlen
    nlines = -(-n // LINE_LENGTH)
    return hlen + n + nlines + (1 if n % LINE_LENGTH == 0 else 0)


def write_fasta_segment(mm: np.ndarray, rec_off: int, header_len: int,
                        seqlen: int, p0: int, p1: int,
                        data: np.ndarray) -> None:
    """Write sequence positions [p0, p1) of one record into its reflowed
    50-char-line region of the pre-sized output (mm = uint8 view of the
    file).  Also writes the newline of every line whose LAST character the
    segment covers (incl. the exact-multiple-of-50 quirk's extra blank
    line), so disjoint segments touch disjoint bytes — the concurrency
    contract the reference gets from per-sequence mmap regions
    (FastaFileWriter.java:30-224), here at chunk granularity.
    """
    LL = LINE_LENGTH
    base = rec_off + header_len
    if p1 <= p0:
        return

    def off(p: int) -> int:                 # file offset of position p
        return base + p + p // LL

    pos = p0
    # head partial line
    if p0 % LL:
        stop = min(p1, (p0 // LL + 1) * LL)
        mm[off(p0):off(p0) + (stop - p0)] = data[:stop - p0]
        if stop == (p0 // LL + 1) * LL:      # completed line -> its newline
            mm[off(stop - 1) + 1] = ord("\n")
        pos = stop
    # full lines (strided block copy)
    nfull = (p1 - pos) // LL
    if nfull > 0:
        row = pos // LL
        src = data[pos - p0:pos - p0 + nfull * LL].reshape(nfull, LL)
        view = mm[base + row * (LL + 1):
                  base + (row + nfull) * (LL + 1)].reshape(nfull, LL + 1)
        view[:, :LL] = src
        view[:, LL] = ord("\n")
        pos += nfull * LL
    # tail partial line
    if pos < p1:
        mm[off(pos):off(pos) + (p1 - pos)] = data[pos - p0:]
    # end-of-record newlines
    if p1 == seqlen:
        if seqlen % LL == 0:
            mm[base + seqlen + seqlen // LL] = ord("\n")   # quirk blank line
        else:
            mm[off(seqlen - 1) + 1] = ord("\n")


class FastaWriter:
    def __init__(self, path: str | Path):
        self.f = open(path, "wb")

    def write(self, header: str, data) -> None:
        self.f.write(format_fasta_record(header, data))

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
