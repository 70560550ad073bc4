"""The GFF3 rows a query-file search must write.

Each query record is searched as written (`U` read as `T`) and as its
reverse complement (reversed, A<->T and C<->G swapped, other bytes kept).
Every occurrence in a record, overlapping ones too, gives the row

    target  gecotools  dna  start  end  1.000  strand  .  ID=q0;Note=q1...

with 1-based inclusive coordinates, `+` for the query as written and `-`
for its reverse complement, and the query header split at `|` into the ID
and the notes.  Rows come by query, then strand (+ first), then record in
the `.gcz`'s order, then position.  An empty query record gives no row.

Occurrences are found by two polynomial hashes of every window of the
text, sorted, and each candidate window is then compared byte for byte, so
a hash collision can cost time but never a wrong row.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

_MOD = (1_000_000_007, 998_244_353)
_BASE = (131, 137)
_COMPLEMENT = bytes.maketrans(b"ATCG", b"TAGC")


def strands(seq: bytes) -> tuple[bytes, bytes]:
    fwd = seq.replace(b"U", b"T")
    return fwd, fwd[::-1].translate(_COMPLEMENT)


def _keys(windows: list[torch.Tensor]) -> torch.Tensor:
    """One int64 key per window from two polynomial hashes; `windows` are
    the columns of the windows, first to last."""
    h = [torch.zeros_like(windows[0], dtype=torch.int64) for _ in _MOD]
    for col in windows:
        c = col.to(torch.int64)
        for i, (mod, base) in enumerate(zip(_MOD, _BASE)):
            h[i] = (h[i] * base + c) % mod
    return h[0] * _MOD[1] + h[1]


def occurrences(text: torch.Tensor, patterns: list[bytes]) -> list[np.ndarray]:
    """Start positions (sorted int64) of every occurrence of each pattern
    in `text` (uint8 on any device)."""
    n = text.numel()
    dev = text.device
    out: list[np.ndarray] = [np.zeros(0, np.int64) for _ in patterns]
    by_len: dict[int, list[int]] = {}
    for i, p in enumerate(patterns):
        if 0 < len(p) <= n:
            by_len.setdefault(len(p), []).append(i)
    for length, idx in by_len.items():
        m = n - length + 1
        keys, where = torch.sort(_keys([text[j:j + m]
                                        for j in range(length)]))
        pats = torch.from_numpy(np.frombuffer(
            b"".join(patterns[i] for i in idx), np.uint8).reshape(
                len(idx), length).copy()).to(dev)
        want = _keys([pats[:, j] for j in range(length)])
        lo = torch.searchsorted(keys, want, right=False)
        hi = torch.searchsorted(keys, want, right=True)
        counts = hi - lo
        owner = torch.repeat_interleave(torch.arange(len(idx), device=dev),
                                        counts)
        first = torch.repeat_interleave(lo, counts)
        step = torch.arange(owner.numel(), device=dev) - torch.repeat_interleave(
            torch.cumsum(counts, 0) - counts, counts)
        cand = where[first + step]
        span = cand[:, None] + torch.arange(length, device=dev)
        same = (text[span] == pats[owner]).all(1)
        owner = owner[same].cpu().numpy()
        cand = cand[same].cpu().numpy()
        order = np.lexsort((cand, owner))
        owner, cand = owner[order], cand[order]
        bounds = np.searchsorted(owner, np.arange(len(idx) + 1))
        for k, i in enumerate(idx):
            out[i] = cand[bounds[k]:bounds[k + 1]]
    return out


def _attributes(header: str) -> str:
    parts = header.split("|")
    return ";".join([f"ID={parts[0]}"] + [f"Note={x}" for x in parts[1:]])


def expected_rows(files: list[list[tuple[str, bytes]]], order: list[str],
                  records: dict[str, np.ndarray], device) -> list[list[str]]:
    """The GFF3 rows of a search of each query file in `files` (its
    (header, sequence) records in file order) over `records`, whose `.gcz`
    holds them in header order `order`.  One pass over the text per query
    length serves every file."""
    text = torch.from_numpy(np.concatenate(
        [np.append(records[h], np.uint8(0)) for h in order])).to(device)
    starts = np.cumsum([0] + [len(records[h]) + 1 for h in order])[:-1]
    pats = [s for queries in files for _, q in queries if q
            for s in strands(q)]
    found = iter(occurrences(text, pats))
    out = []
    for queries in files:
        rows = []
        for header, seq in queries:
            if not seq:
                continue
            attrs = _attributes(header)
            plen = len(seq)
            for strand in "+-":
                hits = next(found)
                if not len(hits):
                    continue
                rec = np.searchsorted(starts, hits, side="right") - 1
                for r, p in zip(rec, hits - starts[rec]):
                    rows.append(f"{order[r]}\tgecotools\tdna\t{p + 1}\t"
                                f"{p + plen}\t1.000\t{strand}\t.\t{attrs}")
        out.append(rows)
    return out


def row_faults(got: list[str], want: list[str]) -> dict[str, int]:
    """`rows_missing` and `rows_extra` (as multisets) and `rows_misplaced`:
    of the rows both hold, those out of the wanted order."""
    g, w = Counter(got), Counter(want)

    def shared(rows: list[str]) -> list[str]:
        left = g & w
        kept = []
        for r in rows:
            if left[r] > 0:
                left[r] -= 1
                kept.append(r)
        return kept

    return dict(rows_missing=sum((w - g).values()),
                rows_extra=sum((g - w).values()),
                rows_misplaced=sum(a != b for a, b in zip(shared(got),
                                                          shared(want))))
