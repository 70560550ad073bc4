"""Host memory arena management.

The port's copy of gecoz_tpu/utils/hostmem.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

Some virtualized hosts (e.g. snapshot-restored microVMs with
userfaultfd-backed private memory) fault fresh MAP_PRIVATE pages in at
single-digit MB/s, while previously-touched pages run at full speed.
numpy's buffer churn then dominates encode time by 5-10x.

Mitigation: raise glibc's mmap/trim thresholds so large buffers live in
the (reusable) heap instead of fresh mmaps, and pre-fault an arena once.
Steady-state allocation then recycles warm pages.  No-ops quietly where
mallopt is unavailable; harmless on healthy hosts.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_warmed_bytes = 0
_mallopt_done = False


def _mallopt() -> None:
    global _mallopt_done
    if _mallopt_done:
        return
    _mallopt_done = True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        big = 1 << 40
        libc.mallopt(_M_MMAP_THRESHOLD, ctypes.c_int(big & 0x7FFFFFFF))
        libc.mallopt(_M_TRIM_THRESHOLD, ctypes.c_int(big & 0x7FFFFFFF))
    except Exception:
        pass


def ensure_arena(nbytes: int) -> None:
    """Pre-fault at least `nbytes` of reusable heap (idempotent, grows)."""
    global _warmed_bytes
    if os.environ.get("GECOZ_NO_HEAP_WARMUP"):
        return
    _mallopt()
    if nbytes <= _warmed_bytes:
        return
    try:
        arena = np.empty(nbytes, dtype=np.uint8)
        arena[:] = 0
        del arena
        _warmed_bytes = max(_warmed_bytes, nbytes)
    except MemoryError:
        pass


def warm_for_block(block_len: int) -> None:
    """Warm enough arena for one block encode (~14n: SA int64, BWT,
    codes/lens int32, node bits, serialization scratch)."""
    ensure_arena(min(int(block_len) * 14, 12 << 30))
