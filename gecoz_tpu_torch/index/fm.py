"""Generalized FM-index over one block: count / search / locate / extract.

The port's copy of gecoz_tpu/index/fm.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

Host (numpy) engine, semantics matching GSSA (nova-algo ssa/GSSA.java:39-252)
with one deliberate fix: LF steps from rows whose BWT symbol is the ``\\0``
separator are corrected for the wrap-around row (the row with SA value 0,
whose BWT byte is the final terminator rather than a real predecessor).  The
reference's plain ``c[0] + rank`` step is only consistent when the block's
first sequence happens to be lexicographically minimal among all sequence
starts; the corrected step

    LF(i) = 1 + rank0(i) - (wrap_row < i)        for BWT[i] == 0, i != wrap

is exact for every input (the target rows of non-wrap separator sources are
rows 1..nseq-1 in source order; row 0 is the final terminator, the wrap
row's own target).  Searching (`occ`-only) is unaffected.

The card's query engine in `gecoz_tpu_torch.ops.fmq` implements the same
math over device arrays; this class is the exact host reference.
"""

from __future__ import annotations

import numpy as np

from gecoz_tpu_torch.index.hswt import HSWT
from gecoz_tpu_torch.index.ssa import SampledSAIndex


class FMIndex:
    def __init__(self, hswt: HSWT, index: SampledSAIndex,
                 bwt: np.ndarray | None = None):
        self.hswt = hswt
        self.index = index
        self.length = hswt.shape.length
        self._bwt = bwt
        self._lf: np.ndarray | None = None
        self._c: np.ndarray | None = None
        self._e: np.ndarray | None = None
        self._wrap: int | None = None
        self._walk_seeds: np.ndarray | None = None

    # -- lazy derived state ------------------------------------------------

    @property
    def bwt(self) -> np.ndarray:
        if self._bwt is None:
            self._bwt = self.hswt.decode_bwt()
        return self._bwt

    @property
    def c(self) -> np.ndarray:
        """c[ch] = number of BWT symbols < ch (GSSA.index():215-226).

        Derived from the wavelet-node sizes when the BWT has not been
        decoded — counting/searching a freshly opened block must not pay
        an O(n) text reconstruction."""
        if self._c is None:
            if self._bwt is None:
                counts = self.hswt.symbol_counts()
            else:
                counts = np.bincount(self.bwt, minlength=256).astype(np.int64)
            self._c = np.concatenate([[0], np.cumsum(counts)[:-1]])
        return self._c

    @property
    def nseq(self) -> int:
        return int(self.c[1]) if self.length else 0

    @property
    def has_index(self) -> bool:
        return self.index is not None

    def _require_index(self) -> None:
        if self.index is None:
            raise SystemExit(
                "missing .gcx sampled-SA index: locate/extract need it "
                "(only counting works without one)")

    @property
    def wrap_row(self) -> int:
        """Row whose SA value is 0 (always sampled: 0 % rate == 0)."""
        if self._wrap is None:
            self._require_index()
            self._wrap = int(np.asarray(self.index.find(np.int64(0))))
        return self._wrap

    @property
    def lf(self) -> np.ndarray:
        """Full LF-mapping table with the separator correction applied.

        int32 (4 bytes/row): blocks are capped at 2^31 rows by the int32-SA
        contract (SAIS.java:103), so int64 would only double the footprint
        of the decode-path working set."""
        if self._lf is None:
            bwt = self.bwt
            n = self.length
            try:
                from gecoz_tpu_torch import native
                if native.available():
                    self._lf = native.lf_build(bwt, self.wrap_row)
                    return self._lf
            except RuntimeError:
                pass
            lf = np.zeros(n, dtype=np.int32)
            order = np.argsort(bwt, kind="stable")
            lf[order] = np.arange(n, dtype=np.int32)
            zero_rows = np.flatnonzero(bwt == 0)
            if len(zero_rows):
                occ0 = np.arange(len(zero_rows), dtype=np.int64)
                corr = 1 + occ0 - (self.wrap_row < zero_rows)
                lf[zero_rows] = corr
                # the wrap row's cyclic target is row 0 (the final terminator)
                lf[self.wrap_row] = 0
            self._lf = lf
        return self._lf

    @property
    def e(self) -> np.ndarray:
        """Sorted global positions of the sequence terminators
        (GSSA.index():232-238)."""
        if self._e is None:
            rows = np.arange(self.nseq, dtype=np.int64)
            self._e = np.sort(self.locate(rows))
        return self._e

    def seq_bounds(self, nstr: int) -> tuple[int, int]:
        """[start, end) of sequence nstr in the generalized string
        (end = terminator position)."""
        e = self.e
        start = int(e[nstr - 1]) + 1 if nstr > 0 else 0
        return start, int(e[nstr])

    def seq_length(self, nstr: int) -> int:
        b, t = self.seq_bounds(nstr)
        return t - b

    # -- queries -----------------------------------------------------------

    def occ(self, symbol: int, pos) -> np.ndarray:
        return self.hswt.occ_batch(symbol, pos)

    def search_range(self, pattern: bytes) -> tuple[int, int]:
        """Backward search; returns [sp, ep] inclusive (GSSA.search:187-197).
        The pattern is at least one character long."""
        if not pattern:
            raise ValueError("search_range: the pattern is empty")
        c = self.c
        ch = pattern[-1]
        sp = int(c[ch])
        ep = int(c[ch + 1]) - 1 if ch < 255 else self.length - 1
        for i in range(len(pattern) - 2, -1, -1):
            if sp > ep:
                break
            ch = pattern[i]
            sp = int(c[ch]) + int(self.occ(ch, np.int64(sp - 1))) + 1
            ep = int(c[ch]) + int(self.occ(ch, np.int64(ep)))
        return sp, ep

    def lf_batch(self, rows: np.ndarray) -> np.ndarray:
        """Corrected LF for arbitrary rows.

        Uses the materialized LF table when it exists; otherwise steps
        through the wavelet tree (GSSA walks tree.getRS the same way,
        GSSA.extract:119-124) so small queries never pay an O(n) BWT
        decode + table build."""
        rows = np.asarray(rows, dtype=np.int64)
        if self._lf is not None:
            return self._lf[rows]
        rank, sym = self.hswt.getrs_batch(rows)
        plain = self.c[sym] + rank
        corr = 1 + rank - (self.wrap_row < rows)
        out = np.where(sym == 0, corr, plain)
        return np.where(rows == self.wrap_row, 0, out)

    def locate(self, rows: np.ndarray) -> np.ndarray:
        """SA values for `rows`, batched LF walks to the nearest sample
        (GSSA.locate:241-251, corrected LF)."""
        self._require_index()
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        idx = rows.copy()
        steps = np.zeros(len(rows), dtype=np.int64)
        out = np.full(len(rows), -1, dtype=np.int64)
        live = np.ones(len(rows), dtype=bool)
        while live.any():
            sa_val = np.asarray(self.index.get(idx))
            hit = live & (sa_val >= 0)
            out[hit] = sa_val[hit] + steps[hit]
            live &= ~hit
            if not live.any():
                break
            idx[live] = self.lf_batch(idx[live])
            steps[live] += 1
        return out

    def find(self, pattern: bytes) -> dict[int, np.ndarray]:
        """Per-sequence match positions (GSSA.find:160-185).  An empty
        pattern has none, as on the device tier (ROADMAP C7)."""
        if not pattern:
            return {}
        sp, ep = self.search_range(pattern)
        if ep < sp:
            return {}
        hits = np.sort(self.locate(np.arange(sp, ep + 1, dtype=np.int64)))
        res: dict[int, np.ndarray] = {}
        e = self.e
        idx1 = 0
        for i in range(len(e)):
            idx2 = int(np.searchsorted(hits, e[i], side="left"))
            if idx2 > idx1:
                base = int(e[i - 1]) + 1 if i > 0 else 0
                res[i] = hits[idx1:idx2] - base
                idx1 = idx2
        return res

    def count(self, pattern: bytes) -> dict[int, int]:
        return {k: len(v) for k, v in self.find(pattern).items()}

    def count_total(self, pattern: bytes) -> int:
        sp, ep = self.search_range(pattern)
        return max(0, ep - sp + 1)

    # -- extraction --------------------------------------------------------

    def decode_text(self) -> np.ndarray:
        """Reconstruct the whole generalized string (native fast path when
        available; identical output to decode_range(0, n))."""
        n = self.length
        if n == 0:
            return np.zeros(0, dtype=np.uint8)
        try:
            from gecoz_tpu_torch import native
            if self.index is not None and native.available():
                rate = 1 << self.index.sampling_factor
                nwalks = (n - 1 + rate - 1) // rate
                if nwalks:
                    rows, values = self.index.sampled_rows()
                    row_by_chunk = np.zeros(len(values), dtype=np.int64)
                    row_by_chunk[values >> self.index.sampling_factor] = rows
                    ends = np.minimum(
                        (np.arange(nwalks, dtype=np.int64) + 1) * rate, n - 1)
                    full = ends % rate == 0
                    seeds = np.zeros(nwalks, dtype=np.int64)
                    seeds[full] = row_by_chunk[ends[full] >> self.index.sampling_factor]
                    tail_rewind = 0
                    if not full[-1]:
                        # partial tail: C++ rewinds from row 0 (SA = n-1)
                        seeds[-1] = 0
                        tail_rewind = int((n - 1) - ends[-1])
                    text = native.fm_decode(self.bwt, self.wrap_row, seeds,
                                            rate, tail_rewind)
                    text[n - 1] = 0
                    return text
        except RuntimeError:
            pass
        return self.decode_range(0, self.length)

    def _step_emit(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(corrected-LF next rows, emitted BWT symbols) — one decode step.

        Table-driven when the LF table is already materialized, otherwise
        wavelet-tree descent (so small extractions from a big block stay
        O(span · code length), never O(n))."""
        if self._lf is not None:
            return self._lf[rows], self.bwt[rows]
        rank, sym = self.hswt.getrs_batch(rows)
        plain = self.c[sym] + rank
        corr = 1 + rank - (self.wrap_row < rows)
        nxt = np.where(sym == 0, corr, plain)
        nxt = np.where(rows == self.wrap_row, 0, nxt)
        return nxt, sym.astype(np.uint8)

    def decode_range(self, lo: int, hi: int) -> np.ndarray:
        """Decode global positions [lo, hi) only.

        TPU-shaped decode: one independent LF walk per sampling interval,
        all advanced in lockstep (the device version in ops/fmq.py runs the
        identical schedule with on-device gathers).  Work and memory are
        proportional to the sampling-aligned span, not the block size.
        """
        n = self.length
        rate = 1 << self.index.sampling_factor
        if n == 0 or hi <= lo:
            return np.zeros(max(hi - lo, 0), dtype=np.uint8)
        first = lo // rate
        last = min((hi - 1) // rate, (n - 2) // rate if n > 1 else 0)
        walks = np.arange(first, last + 1, dtype=np.int64)
        ends = np.minimum((walks + 1) * rate, n - 1)
        starts = walks * rate
        nwalks = len(walks)
        base = first * rate
        span = int(max(hi, int(ends[-1]) if nwalks else hi)) - base
        # materialize the full LF table only when the span warrants the
        # O(n) build; otherwise steps go through the wavelet tree
        if self._lf is None and span * 4 >= n:
            _ = self.lf
        out = np.zeros(span, dtype=np.uint8)   # span-local scratch
        if hi >= n:
            out[n - 1 - base] = 0   # final terminator, not walk-covered
        # walk w emits positions ends[w]-1 down to starts[w]
        rows, values = self.index.sampled_rows()
        seed = np.zeros(nwalks, dtype=np.int64)
        order = np.argsort(values)
        sval = values[order]
        srow = rows[order]
        # seeds: row with SA value == ends[w] when ends[w] % rate == 0,
        # else (only the last, partial walk) row 0 advanced appropriately
        full = (ends % rate == 0) & (ends < n)
        pos_in = np.searchsorted(sval, ends[full])
        seed[full] = srow[pos_in]
        cur = np.full(nwalks, -1, dtype=np.int64)
        cur[full] = seed[full]
        # partial last walk: start from row 0 (suffix n-1), step to SA=ends[w]
        part = np.flatnonzero(~full)
        for w in part:
            idx = np.zeros(1, dtype=np.int64)  # row of suffix n-1
            v = n - 1
            while v > ends[w]:
                idx, _ = self._step_emit(idx)
                v -= 1
            cur[w] = idx[0]
        pos = ends - 1
        live = pos >= starts
        while live.any():
            nxt, syms = self._step_emit(cur[live])
            out[pos[live] - base] = syms
            cur[live] = nxt
            pos[live] -= 1
            live = pos >= starts
        return out[lo - base:hi - base]

    # -- chunked walk-schedule decode (the parallel-decompress primitive) ----

    @property
    def n_walks(self) -> int:
        """Number of sampling-interval walks covering [0, n-1)."""
        rate = 1 << self.index.sampling_factor
        return (self.length - 1 + rate - 1) // rate if self.length > 1 else 0

    def walk_seeds(self) -> np.ndarray:
        """Seed row per walk: walk w starts at the row whose SA value is
        min((w+1)*rate, n-1); a partial final walk seeds at row 0 (SA value
        n-1).  Computed once per block, O(n/rate)."""
        if self._walk_seeds is None:
            self._require_index()
            n = self.length
            rate = 1 << self.index.sampling_factor
            nwalks = self.n_walks
            rows, values = self.index.sampled_rows()
            row_by_chunk = np.zeros(len(values), dtype=np.int64)
            row_by_chunk[values >> self.index.sampling_factor] = rows
            seeds = np.zeros(nwalks, dtype=np.int64)
            ends = np.minimum(
                (np.arange(nwalks, dtype=np.int64) + 1) * rate, n - 1)
            full = ends % rate == 0
            seeds[full] = row_by_chunk[ends[full] >> self.index.sampling_factor]
            # partial tail: row 0 carries SA value n-1 == ends[-1]
            self._walk_seeds = seeds
        return self._walk_seeds

    def decode_walks(self, w0: int, w1: int) -> np.ndarray:
        """Decode global positions [w0*rate, min(w1*rate, n-1)).

        Thread-safe once `lf` and `walk_seeds` are materialized (read-only
        from then on); the native path releases the GIL, so chunk workers
        scale across threads — the TPU-host analog of GecoRead.java:141-175's
        4 MiB SequenceExtractor chunks."""
        n = self.length
        rate = 1 << self.index.sampling_factor
        seeds = self.walk_seeds()[w0:w1]
        try:
            from gecoz_tpu_torch import native
            if native.available():
                return native.fm_decode_walks(self.bwt, self.lf, seeds,
                                              w0, w1, rate, 0)
        except RuntimeError:
            pass
        return self.decode_range(w0 * rate, min(w1 * rate, n - 1))

    def extract(self, nstr: int, start: int = 0, end: int | None = None) -> bytes:
        """Bytes [start, end) of sequence `nstr` (GSSA.extract:90-126);
        decodes only the covering sampling-aligned span.  `end` past the
        sequence (or None) is its end; `start` >= `end` gives no bytes; a
        negative coordinate, which would read the sequences before it and
        their terminators, is refused (ROADMAP C9)."""
        if start < 0 or (end is not None and end < 0):
            raise ValueError(f"extract: coordinates must be >= 0, got "
                             f"{start}, {end}")
        b, t = self.seq_bounds(nstr)
        if end is None or b + end > t:
            end = t - b
        return bytes(self.decode_range(b + start, b + end))

    def sequence_lengths(self) -> list[int]:
        return [self.seq_length(i) for i in range(self.nseq)]
