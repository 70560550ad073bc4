"""Batched multi-pattern FM search on the card: thousands of queries at once.

Port of gecoz_tpu/tools/batch_search.py::find_batched (26-81): all
patterns are right-aligned into one matrix (`pack_patterns`, a copy of the
reference's), one `search_batch` per block resolves every row range on the
card (kernel K1), one `locate_batch` resolves every hit row, and the
per-sequence split follows GSSA.find:160-185 on the host.
"""

from __future__ import annotations

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
    L = max((len(p) for p in patterns), default=1)
    arr = np.zeros((len(patterns), L), dtype=np.uint8)
    lens = np.zeros(len(patterns), dtype=np.int32)
    for i, p in enumerate(patterns):
        arr[i, L - len(p):] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    return arr, lens


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


def find_batched(fm, patterns: list[bytes],
                 device=None) -> list[dict[int, np.ndarray]]:
    """Per-pattern {sequence: positions} over one block, searched and
    located on `device` (default: the card).  An empty pattern has no
    hits (`FMIndex.find`'s answer): it gets {} without reaching the
    search, and without a non-empty pattern the block's tables are not
    built (ROADMAP C7)."""
    with metrics.phase("search.pack"):
        live = [i for i, p in enumerate(patterns) if p]
        arr, lens = pack_patterns([patterns[i] for i in live])
    if not live:
        return [dict() for _ in patterns]
    dev = pick_device(device)
    with metrics.phase("search.tables", fm.length):
        device_block = search_tables(fm, dev)
        sync(dev)
    with metrics.phase("search.batch", arr.nbytes):
        sp, ep = fmq.search_batch(device_block, torch.from_numpy(arr).to(dev),
                                  torch.from_numpy(lens).to(dev), lens)
        sp = sp.cpu().numpy().astype(np.int64)
        ep = ep.cpu().numpy().astype(np.int64)

    # expand all hit rows and locate them in one batch
    with metrics.phase("search.expand"):
        counts = np.maximum(ep - sp + 1, 0)
        if int(counts.sum()) == 0:
            return [dict() for _ in patterns]
        rows = np.concatenate([np.arange(s, e + 1)
                               for s, e, c in zip(sp, ep, counts) if c > 0])
    metrics.count("search.located_rows", len(rows))
    with metrics.phase("search.locate", rows.nbytes):
        values = fmq.locate_batch(
            device_block, torch.from_numpy(rows.astype(np.int32)).to(dev))
        values = values.cpu().numpy().astype(np.int64)

    with metrics.phase("search.split"):
        out: list[dict[int, np.ndarray]] = [dict() for _ in patterns]
        e_arr = fm.e
        offs = np.concatenate([[0], np.cumsum(counts)])
        for k, (i, c) in enumerate(zip(live, counts)):
            if c == 0:
                continue
            hits = np.sort(values[offs[k]:offs[k + 1]])
            idx1 = 0
            res = {}
            for j in range(len(e_arr)):
                idx2 = int(np.searchsorted(hits, e_arr[j], side="left"))
                if idx2 > idx1:
                    base = int(e_arr[j - 1]) + 1 if j > 0 else 0
                    res[j] = hits[idx1:idx2] - base
                    idx1 = idx2
            out[i] = res
    return out
