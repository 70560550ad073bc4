"""Host memory arena management.

The port's copy of gecoz_tpu/utils/hostmem.py, with one deliberate
divergence (ROADMAP C3): `_mallopt`.  The reference passes
`c_int((1 << 40) & 0x7FFFFFFF)`, which is 0, so its first warm-up sets
both thresholds to 0 (every heap extension a fresh mmap, every free
returned to the kernel, the pre-faulted arena unmapped as soon as it is
freed) and undoes the thresholds its CLI's re-exec set.  The port passes
`_THRESHOLD`, the largest C int, leaves a threshold that the environment
sets (`MALLOC_MMAP_THRESHOLD_`, `MALLOC_TRIM_THRESHOLD_`: the CLI's
re-exec or the user's) alone, and logs what each mallopt call returned.

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
import logging
import os

import numpy as np

log = logging.getLogger("gecoz.hostmem")

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_THRESHOLD = (1 << 31) - 1        # mallopt takes a C int

_warmed_bytes = 0
_mallopt_done = False


def _mallopt() -> None:
    global _mallopt_done
    if _mallopt_done:
        return
    _mallopt_done = True
    try:
        mallopt = ctypes.CDLL(None, use_errno=True).mallopt
    except (OSError, AttributeError):
        return
    for param, var in ((_M_MMAP_THRESHOLD, "MALLOC_MMAP_THRESHOLD_"),
                       (_M_TRIM_THRESHOLD, "MALLOC_TRIM_THRESHOLD_")):
        if os.environ.get(var):
            log.debug("hostmem: %s=%s set by the environment; left as it is",
                      var, os.environ[var])
            continue
        rc = mallopt(param, ctypes.c_int(_THRESHOLD))
        log.debug("hostmem: mallopt(%d, %d) returned %d", param, _THRESHOLD,
                  rc)


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
