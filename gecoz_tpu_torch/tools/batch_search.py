"""Batched multi-pattern FM search on the card: thousands of queries at once.

Port of gecoz_tpu/tools/batch_search.py::find_batched (26-81): all
patterns are right-aligned into one matrix (`pack_patterns`, the
reference's layout), one `search_batch` per block resolves every row range
on the card (kernel K1), one `locate_batch` resolves every hit row, and the
hits are split into the block's records (GSSA.find:160-185) with one
`searchsorted` against the record ends, which the card locates too.

A search of many blocks packs and uploads its patterns once
(`PatternBatch`) and gets from each block only the patterns that hit, as
arrays (`BlockHits`): its host work grows with the hits, not with the
patterns times the blocks.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from gecoz_tpu_torch.ops import fmq
from gecoz_tpu_torch.utils import metrics
from gecoz_tpu_torch.utils.device import device as pick_device
from gecoz_tpu_torch.utils.device import hbm_budget, sync

# bytes per text character the locate table's build keeps in flight; past
# the card's budget the fused-LF walk (kernel K2) locates instead
LOCATE_TABLE_BYTES_PER_CHAR = 40


def pack_patterns(patterns: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Right-align patterns into a uint8 [B, L] matrix + lengths."""
    lens = np.fromiter(map(len, patterns), np.int32, len(patterns))
    L = int(lens.max()) if len(lens) else 1
    arr = np.zeros((len(patterns), L), dtype=np.uint8)
    # one copy a length: the patterns of one length, joined, are a matrix
    order = np.argsort(lens, kind="stable")
    by_len = lens[order]
    for n in np.unique(by_len[by_len > 0]).tolist():
        lo, hi = np.searchsorted(by_len, [n, n + 1])
        rows = order[lo:hi]
        arr[rows, L - n:] = np.frombuffer(b"".join(
            [patterns[i] for i in rows.tolist()]), np.uint8).reshape(-1, n)
    return arr, lens


class PatternBatch(list):
    """The patterns of a search (a list of bytes), with the non-empty ones
    packed (`pack_patterns`) and uploaded once, for every block."""

    def __init__(self, patterns, dev: torch.device):
        super().__init__(patterns)
        with metrics.phase("search.pack"):
            self.live = np.flatnonzero(np.fromiter(map(len, self), bool,
                                                   len(self)))
            arr, self.lengths = pack_patterns([self[i] for i in self.live])
            self.dev = dev
            self.arr = torch.from_numpy(arr).to(dev)
            self.lengths_dev = torch.from_numpy(self.lengths).to(dev)


class BlockHits(Sequence):
    """One block's hits: for each hit, its pattern (an index of the
    batch), its record and its position in the record, ordered by
    pattern, record and position.  Read as a sequence, it is the
    per-pattern {record: positions} that `FMIndex.find` gives, for each
    of `npatterns` patterns."""

    def __init__(self, npatterns: int, pattern=None, record=None,
                 position=None):
        empty = np.zeros(0, np.int64)
        self.npatterns = npatterns
        self.pattern = empty if pattern is None else pattern
        self.record = empty if record is None else record
        self.position = empty if position is None else position

    @classmethod
    def of(cls, per_pattern, npatterns: int) -> "BlockHits":
        """The hits of a per-pattern {record: positions} sequence."""
        parts = [(i, r, np.asarray(pos, np.int64))
                 for i in range(npatterns)
                 for r, pos in sorted(per_pattern[i].items())]
        if not parts:
            return cls(npatterns)
        sizes = [len(pos) for _, _, pos in parts]
        return cls(npatterns,
                   np.repeat([i for i, _, _ in parts], sizes).astype(np.int64),
                   np.repeat([r for _, r, _ in parts], sizes).astype(np.int64),
                   np.concatenate([pos for _, _, pos in parts]))

    def __len__(self) -> int:
        return self.npatterns

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self.npatterns))]
        if not -self.npatterns <= i < self.npatterns:
            raise IndexError(i)
        i %= self.npatterns
        lo, hi = np.searchsorted(self.pattern, [i, i + 1])
        if lo == hi:
            return {}
        rec, pos = self.record[lo:hi], self.position[lo:hi]
        cuts = np.flatnonzero(np.diff(rec)) + 1
        return {int(r[0]): p for r, p in zip(np.split(rec, cuts),
                                              np.split(pos, cuts))}

    def __eq__(self, other):
        return isinstance(other, Sequence) and list(self) == list(other)


def search_tables(fm, dev: torch.device) -> fmq.DeviceFMBlock:
    """The block's query state with the k-mer seed table, the search's rank
    table, and either the locate table or, past the memory budget, the
    fused LF table."""
    budget = hbm_budget(dev)
    base = fmq.with_rank_blocks(fmq.with_kmer_table(
        fmq.device_block_from_fm(fm, dev)))
    if budget is None or fm.length * LOCATE_TABLE_BYTES_PER_CHAR <= budget:
        return fmq.with_locate_table(base)
    return fmq.with_lf_table(base, decode=False)


def record_ends(block: fmq.DeviceFMBlock, nseq: int) -> np.ndarray:
    """Sorted positions of the block's record terminators: the SA values
    of rows 0..nseq-1, located on the block's device (what
    `FMIndex.e` locates on the host)."""
    rows = torch.arange(nseq, dtype=torch.int32, device=block.bwt.device)
    return np.sort(fmq.locate_batch(block, rows).cpu().numpy()
                   .astype(np.int64))


def find_batched(fm, patterns, device=None) -> BlockHits:
    """Per-pattern {sequence: positions} over one block, searched and
    located on `device` (default: the card), as `BlockHits`.  `patterns`
    is a list of bytes, or a `PatternBatch` packed once for many blocks
    (its own device then).  An empty pattern has no hits (`FMIndex.find`'s
    answer): it gets {} without reaching the search, and without a
    non-empty pattern the block's tables are not built (ROADMAP C7)."""
    batch = patterns if isinstance(patterns, PatternBatch) else \
        PatternBatch(patterns, pick_device(device))
    dev = batch.dev
    if not len(batch.live):
        return BlockHits(len(batch))
    with metrics.phase("search.tables", fm.length):
        device_block = search_tables(fm, dev)
        sync(dev)
    with metrics.phase("search.batch", batch.arr.nbytes):
        sp, ep = fmq.search_batch(device_block, batch.arr, batch.lengths_dev,
                                  batch.lengths)
        hit = torch.nonzero(ep >= sp).flatten()
        sp = sp[hit].cpu().numpy().astype(np.int64)
        ep = ep[hit].cpu().numpy().astype(np.int64)
        hit = hit.cpu().numpy()
    if not len(hit):
        return BlockHits(len(batch))

    # expand all hit rows and locate them in one batch
    with metrics.phase("search.expand"):
        counts = ep - sp + 1
        first = np.cumsum(counts) - counts
        owner = np.repeat(batch.live[hit], counts)
        rows = np.repeat(sp - first, counts) + np.arange(int(counts.sum()))
    metrics.count("search.located_rows", len(rows))
    with metrics.phase("search.locate", rows.nbytes):
        values = fmq.locate_batch(
            device_block, torch.from_numpy(rows.astype(np.int32)).to(dev))
        values = values.cpu().numpy().astype(np.int64)
    with metrics.phase("search.ends"):
        # c[1] counts the terminators (`fm.nseq` would count the host BWT)
        ends = record_ends(device_block, int(device_block.c[1]))

    with metrics.phase("search.split"):
        order = np.lexsort((values, owner))
        owner, values = owner[order], values[order]
        # a hit belongs to the first record whose terminator lies past it
        record = np.searchsorted(ends, values, side="right")
        keep = record < len(ends)
        owner, values, record = owner[keep], values[keep], record[keep]
        starts = np.concatenate([[0], ends[:-1] + 1])
        return BlockHits(len(batch), owner, record, values - starts[record])
