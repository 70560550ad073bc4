"""Suffix-array construction on the host.

The port's copy of gecoz_tpu/ops/sa.py, without its JAX backend: the card's
suffix sort is `gecoz_tpu_torch.ops.sa_device.suffix_array_device`.

The reference uses an in-place SA-IS/SACA-K hybrid (nova-algo string/
SAIS.java:103-1314) — a pointer-chasing induced sort that maps poorly onto a
vector machine.  Both backends here compute the *same* array: the true
lexicographic suffix array of the raw bytes (repeated ``\\0`` separators are
ordinary small symbols; shorter suffixes that prefix longer ones sort
first), so any correct algorithm is interchangeable.

Backends:
* `suffix_array_numpy` — prefix-doubling with `np.lexsort` (host oracle).
* `gecoz_tpu_torch.native` — C++ SA-IS for fast host-side encodes (see
  csrc/host/sais.cpp).
"""

from __future__ import annotations

import numpy as np


def suffix_array_naive(s: np.ndarray) -> np.ndarray:
    """O(n^2 log n) sorted-suffix oracle for tests."""
    s = bytes(np.asarray(s, dtype=np.uint8))
    return np.array(sorted(range(len(s)), key=lambda i: s[i:]), dtype=np.int64)


def suffix_array_numpy(s: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array (host)."""
    s = np.asarray(s, dtype=np.uint8)
    n = len(s)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = s.astype(np.int64)
    tmp = np.zeros(n, dtype=np.int64)
    k = 1
    while True:
        # sort by (rank[i], rank[i+k]) — out-of-range reads as -1
        key2 = np.full(n, -1, dtype=np.int64)
        key2[:n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        # re-rank
        r_ord = rank[order]
        k_ord = key2[order]
        new_group = np.ones(n, dtype=np.int64)
        new_group[1:] = (r_ord[1:] != r_ord[:-1]) | (k_ord[1:] != k_ord[:-1])
        tmp[order] = np.cumsum(new_group) - 1
        rank, tmp = tmp, rank
        if rank[order[-1]] == n - 1:
            return order.astype(np.int64)
        k <<= 1
        if k >= n:
            # all ranks distinct at this point necessarily
            return np.argsort(rank, kind="stable").astype(np.int64)


def suffix_array(s: np.ndarray, backend: str = "auto") -> np.ndarray:
    """Dispatch to the best available host backend ("auto", "native",
    "numpy")."""
    s = np.asarray(s, dtype=np.uint8)
    if backend in ("auto", "native"):
        try:
            from gecoz_tpu_torch.native import sais as native_sais
            return native_sais(s)
        except Exception:
            if backend == "native":
                raise
    return suffix_array_numpy(s)


def bwt_from_sa(s: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT[i] = s[sa[i]-1] (s[n-1] when sa[i]==0)
    (GecozFileWriter.BWTDataSource:300-303)."""
    s = np.asarray(s, dtype=np.uint8)
    idx = np.asarray(sa, dtype=np.int64) - 1
    # NB: `% n` here is pathologically slow in numpy 2.0 (scalar modulo
    # fallback); a where-style fixup is ~100x faster
    idx[idx < 0] = len(s) - 1
    return s[idx]
