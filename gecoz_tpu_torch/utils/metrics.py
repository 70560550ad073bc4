"""Phase timing / throughput observability.

The port's copy of gecoz_tpu/utils/metrics.py, its `jax.profiler` hooks
on `torch.profiler`: with GECOZ_TRACE_DIR set, every `phase` is a
`torch.profiler.record_function` span, and `profiler_trace()` records a
region (host and CUDA activity) into a Chrome trace file in that
directory, as the reference records an XLA trace there.

The reference logs ad-hoc nanoTime spans per phase (GecoIndex.java:115-116,
GecoRead.java:71-75, GecoMatch.java:133-134).  Here every pipeline phase
reports wall time and bytes through a process-wide registry, surfaced at
`-v INFO`, plus an optional `torch.profiler` trace via GECOZ_TRACE_DIR.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

log = logging.getLogger("gecoz.metrics")


@dataclass
class PhaseStats:
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0

    @property
    def mbps(self) -> float:
        return self.bytes / 1e6 / self.seconds if self.seconds else 0.0


_REGISTRY: dict[str, PhaseStats] = defaultdict(PhaseStats)


@contextlib.contextmanager
def phase(name: str, nbytes: int = 0):
    trace_dir = os.environ.get("GECOZ_TRACE_DIR")
    ctx = contextlib.nullcontext()
    if trace_dir:
        import torch
        ctx = torch.profiler.record_function(name)
    t0 = time.perf_counter()
    with ctx:
        yield
    dt = time.perf_counter() - t0
    st = _REGISTRY[name]
    st.seconds += dt
    st.bytes += nbytes
    st.calls += 1
    if nbytes:
        log.info("%s: %.1f ms (%.1f MB/s)", name, dt * 1e3,
                 nbytes / 1e6 / dt if dt else 0.0)
    else:
        log.info("%s: %.1f ms", name, dt * 1e3)


def stats() -> dict[str, PhaseStats]:
    return dict(_REGISTRY)


def reset() -> None:
    _REGISTRY.clear()


def report() -> str:
    lines = []
    for name, st in sorted(_REGISTRY.items()):
        line = f"{name}: {st.seconds * 1e3:.1f} ms over {st.calls} calls"
        if st.bytes:
            line += f", {st.bytes / 1e6:.1f} MB ({st.mbps:.1f} MB/s)"
        lines.append(line)
    return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace():
    """Wrap a region in a torch.profiler trace when GECOZ_TRACE_DIR is set:
    host and (with a card) CUDA activity, written as a Chrome trace
    `gecoz_trace_<pid>_<n>.json` into that directory on exit; yields the
    file's path (None without GECOZ_TRACE_DIR)."""
    trace_dir = os.environ.get("GECOZ_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    n = 0
    while True:
        path = os.path.join(trace_dir, f"gecoz_trace_{os.getpid()}_{n}.json")
        if not os.path.exists(path):
            break
        n += 1
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
