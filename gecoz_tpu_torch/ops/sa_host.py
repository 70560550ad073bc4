"""Host-side (numpy) helpers of the run-aware suffix sort.

A JAX-free copy of the numpy helpers in gecoz_tpu/ops/sa_device.py
(lines 580-763 and TOK_TABLE_SIZE at 168): the reference module imports JAX
when it loads, and the card machine has none.  The functions compute the
static bounds and the run-key table that `ops/sa_device.py` takes from the
host; the tests hold each one equal to the reference helper.
"""

from __future__ import annotations

import numpy as np

TOK_TABLE_SIZE = 128    # fixed table shape: one program for all tables


def dense_table(symbols) -> tuple[np.ndarray, int]:
    """(byte -> dense code) table + static bits for a symbol set."""
    symbols = sorted(int(x) for x in symbols)
    table = np.zeros(256, dtype=np.int32)
    for i, sym in enumerate(symbols):
        table[sym] = i + 1
    bits = max(1, (len(symbols) + 1 - 1).bit_length())
    return table, bits


# ell_bits quantization ladder: few program variants, covers everything
# from clean reads (<=4 Ki runs) to chr1 centromere gaps (~2^25)
ELL_BITS_LADDER = (12, 16, 20, 25, 27)


def runs_ell_bits(s: np.ndarray, mx: int | None = None) -> int | None:
    """Static run-length bit bound for `sa_device._suffix_array_runs`
    (host side): the smallest ladder rung covering the longest run, or
    None when no rung does (then the kernel's bit_length(n) default —
    and its pack_seed gate — apply unchanged).  Callers that already
    measured `max_run_length` pass it as `mx` to skip the host pass."""
    if mx is None:
        mx = max_run_length(s)
    bits = max(1, int(mx).bit_length())
    for rung in ELL_BITS_LADDER:
        if bits <= rung:
            return rung
    return None


def runs_token_table(s: np.ndarray, syms: tuple[int, ...] | None,
                     max_entries: int | None = None,
                     ell_bits: int | None = None,
                     _chunk: int = 4 << 20) -> np.ndarray | None:
    """int32[TOK_TABLE_SIZE] of sorted distinct run keys at run starts,
    INT32_MAX-padded (host side), or None.

    Replicates the device's packed seed-key formula exactly
    (`sa_device._suffix_array_runs` pack_seed branch): codes are the
    compare-sum dense alphabet, eb = bit_length(n), key =
    (c << (1+eb)) | (above << eb) | (below ? ell : 2^eb - ell).
    Returns None when the packed seed won't engage (alphabet too wide)
    or the table would exceed TOK_TABLE_SIZE (genomic text measures a
    few dozen; pathological inputs fall back to the sort compaction).

    Works in bounded chunks so the fresh-page footprint stays small on
    cold-allocator hosts; runs crossing chunk borders are merged.
    """
    if max_entries is None:
        max_entries = TOK_TABLE_SIZE
    s = np.asarray(s, dtype=np.uint8)
    n = int(s.shape[0])
    if n == 0 or not syms:
        return None
    sym_bits = max(len(syms), 1).bit_length()
    eb = int(n).bit_length() if ell_bits is None \
        else min(int(ell_bits), int(n).bit_length())
    if sym_bits + 1 + eb > 31:
        return None                    # pack_seed can't trigger
    keys: set[int] = set()
    chunk = _chunk
    carry_c = carry_len = None         # open run at the chunk border
    pos = 0
    while pos < n:
        part = s[pos:pos + chunk]
        codes = np.zeros(part.shape[0], np.int64)
        for sym in syms:
            codes += part >= np.uint8(sym)
        bounds = np.flatnonzero(codes[1:] != codes[:-1])
        starts = np.concatenate([[0], bounds + 1])
        ends = np.concatenate([bounds, [part.shape[0] - 1]])
        c = codes[starts]
        ell = (ends - starts + 1).astype(np.int64)
        if carry_c is not None:
            if c[0] == carry_c:
                ell[0] += carry_len
            else:
                # carried run closed at the border: next symbol is c[0]
                below = c[0] < carry_c
                keys.add(int((carry_c << (1 + eb))
                             | ((not below) << eb)
                             | (carry_len if below
                                else (1 << eb) - carry_len)))
        # last run stays open (its 'below' side needs the next chunk)
        carry_c, carry_len = int(c[-1]), int(ell[-1])
        if c.shape[0] > 1:
            nxtc = c[1:]
            cc, ll = c[:-1], ell[:-1]
            below = nxtc < cc
            k = ((cc << (1 + eb)) | ((~below).astype(np.int64) << eb)
                 | np.where(below, ll, (1 << eb) - ll))
            keys.update(int(x) for x in np.unique(k))
            if len(keys) > max_entries:
                return None
        pos += chunk
    # final open run: end-of-text counts as below
    keys.add(int((carry_c << (1 + eb)) | carry_len))
    if len(keys) > max_entries:
        return None
    out = np.full(TOK_TABLE_SIZE, (1 << 31) - 1, np.int32)
    out[:len(keys)] = sorted(keys)
    return out


# m_pad quantization ladder (fractions of n, /16): few program variants
# per block length, and prewarm can guess the DNA-typical rungs (3/4 and
# 13/16 — random/genomic DNA has ~0.74-0.76 runs per byte)
M_PAD_LADDER = (8, 10, 12, 13, 14, 16)


def m_pad_bucket(m: int, n: int) -> int:
    """Round a run count UP to the quantization ladder (static m_pad)."""
    for num in M_PAD_LADDER:
        cand = (num * n) // 16
        if m <= cand:
            return cand
    return n


def runs_m_pad(s: np.ndarray) -> int:
    """Static token-array size for `sa_device._suffix_array_runs` (host side).

    One vectorized pass counts the runs of `s`, then rounds UP the
    quantization ladder so only a handful of program variants exist per
    block length (DNA lands on the 3/4 or 13/16 rung).
    """
    s = np.asarray(s)
    n = int(s.shape[0])
    if n == 0:
        return 0
    m = int(np.count_nonzero(s[1:] != s[:-1])) + 1
    return m_pad_bucket(m, n)


def max_run_length(s: np.ndarray, _chunk: int = 4 << 20) -> int:
    """Longest equal-symbol run (host, vectorized).

    Chunked: the obvious one-shot flatnonzero allocates ~8 bytes/run
    (1.5 GB for a chr1 block) — catastrophic on fresh-page-fault-bound
    hosts; bounded chunks keep the working set at a few dozen MB and
    recycle it."""
    s = np.asarray(s)
    n = int(s.shape[0])
    if n == 0:
        return 0
    best = 0
    carry = 0                      # open run length ending at chunk edge
    prev = -1                      # its symbol (-1 = none)
    for pos in range(0, n, _chunk):
        part = s[pos:pos + _chunk]
        m = part.shape[0]
        diff = np.flatnonzero(part[1:] != part[:-1])
        starts = np.concatenate([[0], diff + 1])
        ends = np.concatenate([diff, [m - 1]])
        lens = ends - starts + 1
        if int(part[0]) == prev:
            lens[0] += carry
        else:
            best = max(best, carry)
        if lens.shape[0] > 1:
            best = max(best, int(lens[:-1].max()))
        carry = int(lens[-1])
        prev = int(part[-1])
    return max(best, carry)


def runs_r1_keys(tab: np.ndarray | None) -> int | None:
    """Round-one sort width for `sa_device._suffix_array_runs` (host side).

    With uint32 rank packing, the p=5 rung engages while the token
    alphabet stays below ~82 groups — then 5 keys already order 25
    tokens deep (past the measured ~21-token distinctness depth of
    64 MiB genomic text), so the sixth key is a wasted n-wide sort
    operand.  Wider alphabets keep 6 keys (6x4 = 24 deep via p=4).
    None (unknown table) -> kernel default."""
    if tab is None:
        return None
    entries = int(np.count_nonzero(np.asarray(tab) != (1 << 31) - 1))
    return 5 if entries + 2 <= 80 else 6


# k-mer seeding beats run seeding on run-free text (it starts ~7 symbols
# deep); past this run length the extra doubling rounds always lose
RUN_THRESHOLD = 64
