"""Suffix array and BWT of a byte string by prefix doubling, in PyTorch.

The suffix array is the true lexicographic order of the suffixes of the raw
bytes: a `\\0` separator is an ordinary small symbol, and a suffix that is a
prefix of a longer one sorts first.  Each round sorts the pairs (rank of
the first 2^k bytes, rank of the next 2^k) with `torch.sort`, so the rounds
are about log2 of the longest repeated substring; on the card a 47 Mbase
chromosome takes seconds.
"""

from __future__ import annotations

import torch


def suffix_array(text: torch.Tensor) -> torch.Tensor:
    """int64 [n] suffix array of uint8 [n] `text`, on its device."""
    n = text.numel()
    dev = text.device
    if n <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    rank = text.to(torch.int64)
    radix = max(n, 256) + 1            # above every rank + 1 of either key
    k = 1
    while True:
        after = torch.zeros_like(rank)          # 0: past the end, sorts first
        if k < n:
            after[:n - k] = rank[k:] + 1
        key, sa = torch.sort(rank * radix + after)
        new_group = torch.ones(n, dtype=torch.int64, device=dev)
        new_group[0] = 0
        new_group[1:] = key[1:] != key[:-1]
        sorted_rank = torch.cumsum(new_group, 0)
        del key, after, new_group
        if int(sorted_rank[-1]) == n - 1:
            return sa
        rank = torch.empty_like(rank)
        rank[sa] = sorted_rank
        del sa, sorted_rank
        k *= 2


def bwt(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """BWT[i] = text[sa[i] - 1], and text[n - 1] where sa[i] = 0."""
    prev = sa - 1
    prev[prev < 0] = text.numel() - 1
    return text[prev]
