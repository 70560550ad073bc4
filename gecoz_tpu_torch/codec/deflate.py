"""From-scratch RFC 1951 deflate codec (inflate + deflate).

The port's copy of gecoz_tpu/codec/deflate.py: imports changed, and
`inflate` refuses a stream cut short (ROADMAP C2).

Re-creates the capabilities of the reference codec (nova-algo deflate/
Inflater.java, Deflater.java, LZ77.java, DeflaterOutputStream.java) in this
framework's own shape:

* `inflate` — streaming decoder: stored/fixed/dynamic blocks, table-driven
  Huffman via `DeflateCodeTable`, 32 KiB window.  A C++ fast path lives in
  gecoz_tpu_torch/csrc/host (inflate.cpp); this module is the
  always-available fallback and the semantic reference.
* `Deflater` — dynamic-Huffman encoder whose match finder follows the
  reference's suffix-array approach (LZ77.java: SA over the window + LCP
  scan of SA neighbors with an entropy-cost gain model) built on our own
  SA backends, rather than zlib-style hash chains.

Compressed *bytes* are not required to match the reference encoder —
only losslessness and format validity are contractual (the reference's
own output depends on its private gain heuristics); tests verify round
trips in both directions against an independent decoder.
"""

from __future__ import annotations

import numpy as np

from gecoz_tpu_torch.huffman.deflate_tables import DeflateCodeTable, CL_ORDER
from gecoz_tpu_torch.utils.bits import BitReader, BitWriter

# RFC 1951 3.2.5 length/distance code tables
LEN_BASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
            51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
LEN_EXTRA = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
             4, 4, 4, 4, 5, 5, 5, 5, 0)
DIST_BASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577)
DIST_EXTRA = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8,
              9, 9, 10, 10, 11, 11, 12, 12, 13, 13)

_FIXED_LIT = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8,
                      dtype=np.int32)
_FIXED_DIST = np.array([5] * 30 + [0, 0], dtype=np.int32)


def _fixed_tables():
    return DeflateCodeTable(_FIXED_LIT), DeflateCodeTable(_FIXED_DIST[:30])


def _read_dynamic_tables(r: BitReader):
    hlit = r.read(5) + 257
    hdist = r.read(5) + 1
    hclen = r.read(4) + 4
    cl_lens = np.zeros(19, dtype=np.int32)
    for i in range(hclen):
        cl_lens[CL_ORDER[i]] = r.read(3)
    cl = DeflateCodeTable(cl_lens)

    lens = np.zeros(hlit + hdist, dtype=np.int32)
    i = 0
    prev = 0
    while i < hlit + hdist:
        sym = cl.decode_stream(r)
        if sym <= 15:
            lens[i] = prev = sym
            i += 1
        elif sym == 16:
            rep = r.read(2) + 3
            lens[i:i + rep] = prev
            i += rep
        elif sym == 17:
            i += r.read(3) + 3
            prev = 0
        else:
            i += r.read(7) + 11
            prev = 0
    lit = DeflateCodeTable(lens[:hlit])
    dist = DeflateCodeTable(lens[hlit:])
    return lit, dist


TRUNCATED = "truncated deflate stream"


def inflate(r: BitReader, out: bytearray | None = None) -> bytes:
    """Decode one complete deflate stream (through the BFINAL block).

    Raises ValueError("truncated deflate stream") when the data ends
    before the final block does; the reference's copy reads zero bits past
    the end instead and may never finish (ROADMAP C2)."""
    if out is None:
        out = bytearray()
    try:
        _inflate_blocks(r, out)
    except (ValueError, IndexError):
        if r.overrun:           # an error of the zero bits past the end
            raise ValueError(TRUNCATED) from None
        raise
    if r.overrun:
        raise ValueError(TRUNCATED)
    return bytes(out)


def _inflate_blocks(r: BitReader, out: bytearray) -> None:
    while True:
        bfinal = r.read(1)
        btype = r.read(2)
        if btype == 0:                      # stored
            r.align()
            ln = r.read(16)
            nln = r.read(16)
            if ln ^ 0xFFFF != nln:
                raise ValueError("stored block LEN/NLEN mismatch")
            for _ in range(ln):
                out.append(r.read(8))
        elif btype in (1, 2):
            lit, dist = _fixed_tables() if btype == 1 \
                else _read_dynamic_tables(r)
            while True:
                sym = lit.decode_stream(r)
                if r.overrun:           # zero bits may decode forever
                    raise ValueError(TRUNCATED)
                if sym < 256:
                    out.append(sym)
                elif sym == 256:
                    break
                else:
                    li = sym - 257
                    length = LEN_BASE[li] + r.read(LEN_EXTRA[li])
                    dsym = dist.decode_stream(r)
                    d = DIST_BASE[dsym] + r.read(DIST_EXTRA[dsym])
                    if d > len(out):
                        raise ValueError("distance past window start")
                    start = len(out) - d
                    for k in range(length):
                        out.append(out[start + k])
        else:
            raise ValueError("invalid deflate block type")
        if bfinal:
            break


def inflate_bytes(data: bytes) -> bytes:
    return inflate(BitReader(data))


# -- encoder ----------------------------------------------------------------

_MIN_MATCH = 3
_MAX_MATCH = 258
_WINDOW = 32 * 1024


def _length_code(length: int) -> int:
    for i in range(len(LEN_BASE) - 1, -1, -1):
        if length >= LEN_BASE[i]:
            return i
    raise ValueError(length)


def _dist_code(d: int) -> int:
    for i in range(len(DIST_BASE) - 1, -1, -1):
        if d >= DIST_BASE[i]:
            return i
    raise ValueError(d)


def _lcp_kasai(s: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """LCP array (Kasai), lcp[i] = lcp(suffix sa[i], suffix sa[i-1])."""
    n = len(s)
    rank = np.zeros(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, dtype=np.int64)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            m = n - max(i, j)
            while h < m and s[i + h] == s[j + h]:
                h += 1
            lcp[r] = h
            if h:
                h -= 1
        else:
            h = 0
    return lcp


def _find_matches_sa(window: np.ndarray):
    """Suffix-array match finder over one window.

    Same architecture as the reference (LZ77.java: SAIS over the window +
    Kasai LCP, candidates from SA neighbors), realized as the exact
    longest-previous-factor: for each text position p with SA rank r, the
    longest earlier occurrence is against PSV(r)/NSV(r) — the nearest SA
    neighbors (in either direction) with a smaller text position — with
    match length = range-min of LCP between them (Crochemore-Ilie LPF).

    Windows are <= 32 KiB so every distance is automatically legal.
    Returns (match_len[i], match_dist[i]) per position.

    The native kernel (csrc/host/lpf.cpp) runs the identical pipeline in C —
    the production path; the numpy/python code below is its oracle
    (tests/test_codec.py asserts agreement).
    """
    from gecoz_tpu_torch.ops.sa import suffix_array

    n = len(window)
    sa = np.asarray(suffix_array(window), dtype=np.int64)
    try:
        from gecoz_tpu_torch import native
        if native.available() and n:
            return native.lpf(window, sa, _MIN_MATCH, _MAX_MATCH)
    except RuntimeError:
        pass
    lcp = _lcp_kasai(window, sa)

    # sparse-table RMQ over lcp (vectorized per level)
    logn = max(1, int(np.log2(max(n, 2))) + 1)
    table = [lcp]
    for k in range(1, logn):
        half = 1 << (k - 1)
        prev = table[-1]
        if len(prev) <= half:
            break
        table.append(np.minimum(prev[:-half], prev[half:]))

    def range_min(lo: int, hi: int) -> int:
        """min(lcp[lo..hi]) inclusive; INF when empty."""
        if lo > hi:
            return 1 << 60
        span = hi - lo + 1
        k = span.bit_length() - 1
        t = table[k]
        return int(min(t[lo], t[hi - (1 << k) + 1]))

    best_len = np.zeros(n, dtype=np.int64)
    best_dist = np.zeros(n, dtype=np.int64)

    # PSV/NSV of text positions along SA order via a monotonic stack
    psv = np.full(n, -1, dtype=np.int64)
    nsv = np.full(n, -1, dtype=np.int64)
    stack: list[int] = []
    for r in range(n):
        while stack and sa[stack[-1]] > sa[r]:
            nsv[stack.pop()] = r
        psv[r] = stack[-1] if stack else -1
        stack.append(r)

    for r in range(n):
        p = int(sa[r])
        cand = 0
        dist = 0
        rp = int(psv[r])
        if rp >= 0:
            l = range_min(rp + 1, r)
            if l > cand:
                cand, dist = l, p - int(sa[rp])
        rn = int(nsv[r])
        if rn >= 0:
            l = range_min(r + 1, rn)
            if l > cand:
                cand, dist = l, p - int(sa[rn])
        if cand >= _MIN_MATCH:
            best_len[p] = min(cand, _MAX_MATCH)
            best_dist[p] = dist
    return best_len, best_dist


def _find_matches_hash(window: np.ndarray):
    """Greedy hash-chain match finder (fast path)."""
    data = bytes(window)
    n = len(data)
    best_len = np.zeros(n, dtype=np.int64)
    best_dist = np.zeros(n, dtype=np.int64)
    head: dict[bytes, int] = {}
    i = 0
    while i + _MIN_MATCH <= n:
        key = data[i:i + _MIN_MATCH]
        j = head.get(key, -1)
        if j >= 0 and i - j <= _WINDOW:
            l = _MIN_MATCH
            maxl = min(_MAX_MATCH, n - i)
            while l < maxl and data[j + l] == data[i + l]:
                l += 1
            best_len[i] = l
            best_dist[i] = i - j
        head[key] = i
        i += 1
    return best_len, best_dist


class Deflater:
    """Dynamic-Huffman deflate encoder over whole buffers.

    `lazy` enables one-position lazy matching (zlib-style: defer a match
    when the next position holds a strictly longer one) — with the SA
    matcher the per-position lengths are the exact longest previous
    factor, so the deferral test is exact and measured a net win; the
    single-candidate hash matcher's next-position lengths are too noisy
    for it (measured a net loss), hence the per-matcher default.
    """

    def __init__(self, matcher: str = "hash", lazy: bool | None = None):
        self.matcher = matcher
        self.lazy = matcher == "sa" if lazy is None else lazy

    def deflate(self, data: bytes, out: BitWriter | None = None,
                bfinal: bool = True) -> BitWriter:
        """Encode `data` as a chain of dynamic blocks, one per 32 KiB
        window (matches never cross windows, so distances stay legal)."""
        if out is None:
            out = BitWriter()
        n = len(data)
        if n == 0:
            out.write(1 if bfinal else 0, 1)
            out.write(1, 2)                  # fixed-tables empty block
            lit, _ = _fixed_tables()
            out.write(int(lit.codes[256]), int(lit.bit_lengths[256]))
            return out
        for off in range(0, n, _WINDOW):
            # 64 KiB double window sliding 32 KiB (DeflaterOutputStream.java):
            # the previous window rides along as match history, so matches
            # reach across block boundaries like the reference's (and
            # zlib's) persistent 32 KiB dictionary
            hist = max(0, off - _WINDOW)
            buf = data[hist:off + _WINDOW]
            last = bfinal and off + _WINDOW >= n
            self._deflate_window(buf, off - hist, out, last)
        return out

    def _deflate_window(self, data: bytes, start: int, out: BitWriter,
                        bfinal: bool) -> None:
        """Encode data[start:] as one dynamic block; data[:start] is match
        history only (already emitted by the previous block)."""
        window = np.frombuffer(data, dtype=np.uint8)
        n = len(window)
        if self.matcher == "sa":
            mlen, mdist = _find_matches_sa(window)
            # deflate distances are capped at 32 KiB; the 64 KiB double
            # window can propose farther sources.  The LPF neighbors are
            # nearest-by-position on each SA side, so when both are out of
            # range a legal occurrence may still exist — fall back to the
            # hash matcher's most-recent-occurrence candidate there.
            far = mdist > _WINDOW
            if far.any():
                hlen, hdist = _find_matches_hash(window)
                # short noisy substitutes lose to literals + table pressure
                use = far & (hlen >= 6)
                mlen = np.where(use, hlen, np.where(far, 0, mlen))
                mdist = np.where(use, hdist, mdist)
        else:
            mlen, mdist = _find_matches_hash(window)
            mlen = np.where(mdist > _WINDOW, 0, mlen)

        # tokenize (greedy, or lazy when the next position matches longer)
        toks = []                            # (is_match, a, b)
        i = start
        while i < n:
            l = int(mlen[i])
            if l >= _MIN_MATCH:
                if self.lazy and i + 1 < n and int(mlen[i + 1]) > l:
                    toks.append((False, int(window[i]), 0))
                    i += 1
                    continue
                toks.append((True, l, int(mdist[i])))
                i += l
            else:
                toks.append((False, int(window[i]), 0))
                i += 1

        def tables_of(tokens):
            lit_counts = np.zeros(286, dtype=np.int64)
            dist_counts = np.zeros(30, dtype=np.int64)
            for is_m, a, b in tokens:
                if is_m:
                    lit_counts[257 + _length_code(a)] += 1
                    dist_counts[_dist_code(b)] += 1
                else:
                    lit_counts[a] += 1
            lit_counts[256] += 1
            lit = DeflateCodeTable.from_counts(lit_counts, 15)
            # every dist table needs >= 1 code; RFC allows 1 code of len 1
            if dist_counts.sum() == 0:
                dist_counts[0] = 1
            dist = DeflateCodeTable.from_counts(dist_counts, 15)
            return lit, dist

        lit, dist = tables_of(toks)

        # final-table gain re-check (Deflater.java ~150-190 "check if there
        # is no gain"): with the actual dynamic code lengths known, a match
        # whose emitted bits meet or exceed its bytes spelled as literals is
        # expanded back to literals; tables are then rebuilt from the final
        # token stream so the emitted header matches the emitted symbols.
        def lit_cost(bl, byte):
            c = int(bl[byte])
            return c if c > 0 else 15        # unassigned -> pessimistic
        expanded = []
        changed = False
        pos = start
        litbl = lit.bit_lengths
        for is_m, a, b in toks:
            if is_m:
                lc = _length_code(a)
                dc = _dist_code(b)
                mcost = (int(litbl[257 + lc]) + LEN_EXTRA[lc]
                         + int(dist.bit_lengths[dc]) + DIST_EXTRA[dc])
                lcost = sum(lit_cost(litbl, int(window[pos + k]))
                            for k in range(a))
                if lcost <= mcost:
                    expanded.extend(
                        (False, int(window[pos + k]), 0) for k in range(a))
                    changed = True
                else:
                    expanded.append((True, a, b))
                pos += a
            else:
                expanded.append((False, a, b))
                pos += 1
        if changed:
            toks = expanded
            lit, dist = tables_of(toks)

        sym_seq = []
        for is_m, a, b in toks:
            if is_m:
                lc = _length_code(a)
                dc = _dist_code(b)
                sym_seq.append((257 + lc, a - LEN_BASE[lc], LEN_EXTRA[lc],
                                dc, b - DIST_BASE[dc], DIST_EXTRA[dc]))
            else:
                sym_seq.append((a, 0, 0, -1, 0, 0))

        self._write_dynamic_header(out, lit, dist, bfinal)
        for sym, extra, ebits, dsym, dextra, debits in sym_seq:
            out.write(int(lit.codes[sym]), int(lit.bit_lengths[sym]))
            if sym > 256:
                out.write(extra, ebits)
                out.write(int(dist.codes[dsym]), int(dist.bit_lengths[dsym]))
                out.write(dextra, debits)
        out.write(int(lit.codes[256]), int(lit.bit_lengths[256]))

    @staticmethod
    def _write_dynamic_header(out: BitWriter, lit: DeflateCodeTable,
                              dist: DeflateCodeTable, bfinal: bool) -> None:
        lit_lens = lit.bit_lengths
        dist_lens = dist.bit_lengths
        hlit = max(257, int(np.max(np.flatnonzero(lit_lens > 0),
                                   initial=256)) + 1)
        hdist = max(1, int(np.max(np.flatnonzero(dist_lens > 0),
                                  initial=0)) + 1)
        all_lens = np.concatenate([lit_lens[:hlit], dist_lens[:hdist]])

        # RLE the code-lengths sequence with 16/17/18 ops
        ops = []
        i = 0
        m = len(all_lens)
        while i < m:
            v = int(all_lens[i])
            j = i
            while j < m and int(all_lens[j]) == v:
                j += 1
            run = j - i
            if v == 0:
                while run >= 11:
                    r = min(run, 138)
                    ops.append((18, r - 11, 7))
                    run -= r
                while run >= 3:
                    r = min(run, 10)
                    ops.append((17, r - 3, 3))
                    run -= r
                ops.extend([(0, 0, 0)] * run)
            else:
                ops.append((v, 0, 0))
                run -= 1
                while run >= 3:
                    r = min(run, 6)
                    ops.append((16, r - 3, 2))
                    run -= r
                ops.extend([(v, 0, 0)] * run)
            i = j

        cl_counts = np.zeros(19, dtype=np.int64)
        for sym, _, _ in ops:
            cl_counts[sym] += 1
        cl = DeflateCodeTable.from_counts(cl_counts, 7)
        hclen = 18
        while hclen >= 3 and cl.bit_lengths[CL_ORDER[hclen]] == 0:
            hclen -= 1

        out.write(1 if bfinal else 0, 1)
        out.write(2, 2)
        out.write(hlit - 257, 5)
        out.write(hdist - 1, 5)
        out.write(hclen + 1 - 4, 4)
        for i in range(hclen + 1):
            out.write(int(cl.bit_lengths[CL_ORDER[i]]), 3)
        for sym, extra, ebits in ops:
            out.write(int(cl.codes[sym]), int(cl.bit_lengths[sym]))
            if ebits:
                out.write(extra, ebits)


def deflate_bytes(data: bytes, matcher: str = "hash") -> bytes:
    return Deflater(matcher).deflate(data).getvalue()
