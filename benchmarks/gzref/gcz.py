"""The `.gcz` / `.gcx` pair a compress must write, and the judge of a pair.

The format, as gecoz writes it:

* `.gcz`, per block: a header ("GecozBWT", version 1, u64 LE block size,
  u64 LE text length n, each record header `\\0`-terminated, one more
  `\\0`), the Huffman code lengths of the 256 byte values as an RFC 1951
  3.2.7 lengths table (byte aligned), then the nodes of the Huffman-shaped
  wavelet tree of the block's BWT in pre-order (node, 0-child, 1-child),
  each a ranked bit vector.  A block's text is its records, each followed
  by one `\\0`.
* `.gcx`, per block: a header ("GecozSSA", version 1, u64 LE payload
  size, u64 LE Java-style hash of the headers), the ranked bit vector that
  marks the BWT rows whose suffix-array value is a multiple of the sampling
  rate, and an index wavelet tree of those values divided by the rate.
* A ranked bit vector packs its bits LSB-first and puts a counter before
  every 64-byte group but the first: 8 bytes (the ones before the group) at
  each 8192-byte boundary, else 2 bytes (the ones since the last such
  boundary).

The judge works the suffix array, the BWT, the wavelet nodes and the whole
`.gcx` out again from the records and compares bytes.  The only part it
does not rebuild is the lengths table: it parses the program's, and holds
the lengths to a complete prefix code over exactly the bytes present whose
cost equals the Huffman optimum (ties between optimal codes are the
program's choice).
"""

from __future__ import annotations

import heapq
import struct

import numpy as np
import torch

from gzref.suffix import bwt as bwt_of
from gzref.suffix import suffix_array

GCZ_MAGIC = b"GecozBWT"
GCX_MAGIC = b"GecozSSA"
VERSION = 1
GCX_HEADER_BYTES = 25
MAX_CODE_BITS = 15
# RFC 1951 3.2.7: the order in which the code-length code's lengths are sent
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


# -- ranked bit vectors ------------------------------------------------------

def rbv_bytes(nbits: int) -> int:
    """Bytes of a ranked bit vector of `nbits` bits: the packed bits, a
    2-byte counter for each 64-byte group after the first, 6 more for each
    8192-byte boundary."""
    return ((nbits - 1) >> 16) * 6 + ((nbits - 1) >> 9) * 2 + ((nbits + 7) >> 3)


def pack_bits(bits: torch.Tensor) -> np.ndarray:
    """0/1 tensor [m] -> LSB-first packed uint8 bytes (numpy)."""
    m = bits.numel()
    pad = (-m) % 8
    b = bits.to(torch.uint8)
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=b.device)
    packed = (b.view(-1, 8).to(torch.int32) * weights).sum(1)
    return packed.to(torch.uint8).cpu().numpy()


def rbv_serialize(packed: np.ndarray, nbits: int) -> np.ndarray:
    """The ranked bit vector of `nbits` bits packed LSB-first in `packed`."""
    nbytes = (nbits + 7) >> 3
    if len(packed) != nbytes:
        raise ValueError(f"{len(packed)} packed bytes for {nbits} bits")
    ngroups = ((nbits - 1) >> 9) + 1
    padded = np.zeros(ngroups * 64, np.uint8)
    padded[:nbytes] = packed
    ones = np.bitwise_count(padded.reshape(ngroups, 64)).sum(1, dtype=np.int64)
    before = np.concatenate([[0], np.cumsum(ones)[:-1]])   # ones before group
    out = np.zeros(rbv_bytes(nbits), np.uint8)
    i = np.arange(nbytes, dtype=np.int64)
    g = i >> 6                                 # data byte i is in group g
    out[i + 2 * g + 6 * (g >> 7)] = packed
    g = np.arange(1, ngroups, dtype=np.int64)
    start = 66 * g + 6 * (g >> 7)              # where group g's data starts
    wide = g % 128 == 0
    if wide.any():
        vals = before[g[wide]].astype("<u8").view(np.uint8).reshape(-1, 8)
        out[(start[wide] - 8)[:, None] + np.arange(8)] = vals
    narrow = ~wide
    if narrow.any():
        seg = (g[narrow] >> 7) << 7
        vals = (before[g[narrow]] - before[seg]).astype("<u2")
        out[(start[narrow] - 2)[:, None] + np.arange(2)] = \
            vals.view(np.uint8).reshape(-1, 2)
    return out


# -- headers -------------------------------------------------------------------

def header_hash(headers: list[str]) -> int:
    """Java's 31x string hash run over every header, seeded 1125899906842597,
    modulo 2^64."""
    h = 1125899906842597
    for header in headers:
        for ch in header:
            h = (31 * h + ord(ch)) & 0xFFFFFFFFFFFFFFFF
    return h


def gcz_header(headers: list[str], size: int, n: int) -> bytes:
    return (GCZ_MAGIC + bytes([VERSION]) + struct.pack("<QQ", size, n)
            + b"".join(h.encode() + b"\0" for h in headers) + b"\0")


def parse_gcz_header(buf: bytes, pos: int) -> tuple[list[str], int, int, int]:
    """(headers, block size, n, header length) of the block at `pos`;
    ValueError where the bytes are no block header."""
    if buf[pos:pos + 8] != GCZ_MAGIC or buf[pos + 8:pos + 9] != bytes([VERSION]):
        raise ValueError(f"no GecozBWT block header at byte {pos}")
    size, n = struct.unpack_from("<QQ", buf, pos + 9)
    headers = []
    p = pos + 25
    while True:
        q = buf.index(b"\0", p)
        if q == p:
            break
        headers.append(buf[p:q].decode())
        p = q + 1
    return headers, size, n, p + 1 - pos


def block_headers(gcz: bytes) -> list[list[str]]:
    """Each block's record headers, in file order, read from the block
    chain of a `.gcz` (block sizes as written)."""
    out, pos = [], 0
    while pos < len(gcz):
        headers, size, _, _ = parse_gcz_header(gcz, pos)
        out.append(headers)
        pos += size
    return out


# -- Huffman code lengths ----------------------------------------------------------

class _BitReader:
    """LSB-first bits of a byte string."""

    def __init__(self, buf: bytes, bitpos: int):
        self.buf = buf
        self.pos = bitpos

    def read(self, nbits: int) -> int:
        v = 0
        for i in range(nbits):
            byte = self.pos >> 3
            if byte >= len(self.buf):
                raise ValueError("lengths table runs past the end")
            v |= ((self.buf[byte] >> (self.pos & 7)) & 1) << i
            self.pos += 1
        return v


def canonical_codes(lengths) -> dict[int, int]:
    """RFC 1951 3.2.2 canonical codes of the symbols with a length,
    most significant bit first: {symbol: code}."""
    lengths = [int(v) for v in lengths]
    top = max(lengths, default=0)
    count = [0] * (top + 1)
    for v in lengths:
        if v:
            count[v] += 1
    nxt, code = [0] * (top + 1), 0
    for bits in range(1, top + 1):
        code = (code + count[bits - 1]) << 1
        nxt[bits] = code
    out = {}
    for sym, v in enumerate(lengths):
        if v:
            out[sym] = nxt[v]
            nxt[v] += 1
    return out


def lsb_first(code: int, nbits: int) -> int:
    """`code`'s `nbits` bits in reverse order: the first bit read (the most
    significant) becomes bit 0, the branch at the wavelet tree's root."""
    return int(format(code, f"0{nbits}b")[::-1], 2) if nbits else 0


def parse_lengths_table(buf: bytes, offset: int) -> tuple[np.ndarray, int]:
    """The 256 code lengths of the RFC 1951 3.2.7 table at byte `offset`,
    and the table's length in whole bytes.  ValueError where it does not
    parse to exactly 256 lengths."""
    r = _BitReader(buf, offset * 8)
    ncl = r.read(4) + 4
    cl = [0] * 19
    for i in range(ncl):
        cl[CL_ORDER[i]] = r.read(3)
    decode = {(cl[s], c): s for s, c in canonical_codes(cl).items()}
    if not decode:
        raise ValueError("empty code-length code")
    out = np.zeros(256, np.int64)
    i, prev = 0, 0
    while i < 256:
        code = nbits = 0
        while (nbits, code) not in decode:
            code = (code << 1) | r.read(1)
            nbits += 1
            if nbits > 7:
                raise ValueError("bad code in the lengths table")
        sym = decode[(nbits, code)]
        if sym < 16:
            out[i] = prev = sym
            i += 1
            continue
        if sym == 16:
            rep, value = 3 + r.read(2), prev
        elif sym == 17:
            rep, value = 3 + r.read(3), 0
        else:
            rep, value = 11 + r.read(7), 0
        if i + rep > 256:
            raise ValueError("a run in the lengths table passes 256 symbols")
        out[i:i + rep] = prev = value
        i += rep
    return out, ((r.pos + 7) >> 3) - offset


def huffman_lengths(counts: np.ndarray) -> np.ndarray:
    """Optimal (Huffman) code lengths of the symbols with a count; a lone
    symbol gets 1 bit."""
    live = [int(s) for s in np.flatnonzero(counts)]
    lengths = np.zeros(len(counts), np.int64)
    if len(live) == 1:
        lengths[live[0]] = 1
        return lengths
    heap = [(int(counts[s]), k, [s]) for k, s in enumerate(live)]
    heapq.heapify(heap)
    k = len(heap)
    while len(heap) > 1:
        w1, _, a = heapq.heappop(heap)
        w2, _, b = heapq.heappop(heap)
        for s in a + b:
            lengths[s] += 1
        heapq.heappush(heap, (w1 + w2, k, a + b))
        k += 1
    return lengths


def code_table_errors(lengths: np.ndarray, counts: np.ndarray) -> int:
    """Faults of a code-length table for a block of these symbol counts:
    each byte value coded but absent or present but not coded, a length
    past 15, and a code that is not complete (Kraft sum not 1)."""
    present = counts > 0
    coded = lengths > 0
    errors = int((present != coded).sum()) + int((lengths > MAX_CODE_BITS).sum())
    if present.sum() > 1 and coded.any():
        kraft = sum(2.0 ** (MAX_CODE_BITS - int(v)) for v in lengths[coded])
        errors += kraft != 2 ** MAX_CODE_BITS
    return errors


def code_cost(lengths: np.ndarray, counts: np.ndarray) -> int:
    return int((lengths.astype(np.int64) * counts).sum())


# -- the wavelet tree and the sampled suffix array ---------------------------

def wavelet_nodes(bwt: torch.Tensor, lengths: np.ndarray) -> list[np.ndarray]:
    """The ranked bit vectors of the Huffman-shaped wavelet tree of `bwt`
    under the code `lengths`, in pre-order.  Node (level, prefix) holds, in
    BWT order, bit `level` of the LSB-first code of each symbol whose code
    is longer than `level` and begins with `prefix`."""
    codes = canonical_codes(lengths)
    lsb = {s: lsb_first(c, int(lengths[s])) for s, c in codes.items()}
    code_tab = torch.zeros(256, dtype=torch.int32)
    len_tab = torch.zeros(256, dtype=torch.int32)
    for s, c in lsb.items():
        code_tab[s], len_tab[s] = c, int(lengths[s])
    sym = bwt.long()
    code_of = code_tab.to(bwt.device)[sym]
    len_of = len_tab.to(bwt.device)[sym]
    del sym

    nodes: list[tuple[int, int]] = []

    def descend(level: int, prefix: int) -> None:
        mask = (1 << level) - 1
        if not any(int(lengths[s]) > level and c & mask == prefix
                   for s, c in lsb.items()):
            return
        nodes.append((level, prefix))
        descend(level + 1, prefix)
        descend(level + 1, prefix | (1 << level))

    descend(0, 0)
    out = []
    for level, prefix in nodes:
        sel = (len_of > level) & ((code_of & ((1 << level) - 1)) == prefix)
        bits = (code_of[sel] >> level) & 1
        out.append(rbv_serialize(pack_bits(bits), bits.numel()))
        del sel, bits
    return out


def gcx_block(sa: torch.Tensor, headers: list[str], sampling: int) -> bytes:
    """The `.gcx` block of a text whose suffix array is `sa`."""
    sf = sampling.bit_length() - 1
    n = sa.numel()
    marked = (sa & (sampling - 1)) == 0
    values = sa[marked] >> sf
    m = values.numel()
    parts = [rbv_serialize(pack_bits(marked), n)]
    del marked
    for level in range(m.bit_length() - 1, -1, -1):
        # level `level` lists the values stably sorted by their bits above it
        order = torch.sort(values >> (level + 1), stable=True).indices
        parts.append(rbv_serialize(pack_bits((values[order] >> level) & 1), m))
    payload = b"".join(p.tobytes() for p in parts)
    return (GCX_MAGIC + bytes([VERSION])
            + struct.pack("<QQ", len(payload), header_hash(headers)) + payload)


def block_text(headers: list[str], records: dict[str, np.ndarray]) -> np.ndarray:
    return np.concatenate([np.append(records[h], np.uint8(0)) for h in headers])


# -- judging ---------------------------------------------------------------------

def _differing(got: bytes, want: bytes) -> int:
    """Bytes in which `got` differs from `want`, a length gap counted whole."""
    m = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, m)
    b = np.frombuffer(want, np.uint8, m)
    return int((a != b).sum()) + abs(len(got) - len(want))


def judge_pair(gcz: bytes, gcx: bytes, records: dict[str, np.ndarray],
               sampling: int, device) -> dict[str, int]:
    """Hold a written `.gcz`/`.gcx` pair to the records it was made from.

    The blocks may group and order the records as the program planned
    them (each record exactly once); every other byte is worked out again
    here.  Returns the numbers a sound pair reads 0 in:
    `gcz_bytes_wrong`, `gcx_bytes_wrong` (differing bytes, length gaps
    included), `code_table_errors` (`code_table_errors`, or a table that
    does not parse), `huffman_excess_bits` (the code's cost over the
    optimum) and `records_wrong` (records missing, repeated or unknown)."""
    out = dict(gcz_bytes_wrong=0, gcx_bytes_wrong=0, code_table_errors=0,
               huffman_excess_bits=0, records_wrong=0)
    seen: list[str] = []
    pos = xpos = 0
    while pos < len(gcz):
        try:
            headers, _, _, hlen = parse_gcz_header(gcz, pos)
        except (ValueError, struct.error, UnicodeDecodeError):
            out["gcz_bytes_wrong"] += len(gcz) - pos
            break
        seen += headers
        if any(h not in records for h in headers):
            out["gcz_bytes_wrong"] += len(gcz) - pos
            break
        text = torch.from_numpy(block_text(headers, records)).to(device)
        try:
            lengths, tlen = parse_lengths_table(gcz, pos + hlen)
        except ValueError:
            out["code_table_errors"] += 1
            out["gcz_bytes_wrong"] += len(gcz) - pos
            break
        counts = np.bincount(text.cpu().numpy(), minlength=256)
        errors = code_table_errors(lengths, counts)
        out["code_table_errors"] += errors
        sa = suffix_array(text)
        if not errors:
            out["huffman_excess_bits"] += (
                code_cost(lengths, counts)
                - code_cost(huffman_lengths(counts), counts))
            nodes = wavelet_nodes(bwt_of(text, sa), lengths)
            size = hlen + tlen + sum(len(v) for v in nodes)
            want = (gcz_header(headers, size, text.numel())
                    + gcz[pos + hlen:pos + hlen + tlen]
                    + b"".join(v.tobytes() for v in nodes))
            out["gcz_bytes_wrong"] += _differing(gcz[pos:pos + size], want)
            pos += size
        else:
            _, size, _, _ = parse_gcz_header(gcz, pos)
            out["gcz_bytes_wrong"] += size
            pos += size
        want_x = gcx_block(sa, headers, sampling)
        del sa, text
        out["gcx_bytes_wrong"] += _differing(gcx[xpos:xpos + len(want_x)],
                                             want_x)
        xpos += len(want_x)
    out["gcx_bytes_wrong"] += max(0, len(gcx) - xpos)
    out["records_wrong"] = (len(seen) - len(set(seen))
                            + len(set(records) - set(seen)))
    return out
