"""Phase timing / throughput observability.

The port's copy of gecoz_tpu/utils/metrics.py, its `jax.profiler` hooks
on `torch.profiler`: with GECOZ_TRACE_DIR set, every `phase` is a
`torch.profiler.record_function` span, and `profiler_trace()` records a
region (host and CUDA activity, on every thread where torch can) into a
Chrome trace file in that directory, as the reference records an XLA trace
there.

The reference logs ad-hoc nanoTime spans per phase (GecoIndex.java:115-116,
GecoRead.java:71-75, GecoMatch.java:133-134).  Here every pipeline phase
reports wall time and bytes through a process-wide registry, surfaced at
`-v INFO`, plus an optional `torch.profiler` trace via GECOZ_TRACE_DIR.

Phases nest: each thread keeps a stack of its open phases, so an entry
also holds its self time (its time less its direct children's on the same
thread) and the name of its enclosing phase.  A phase opened on a worker
thread names its parent explicitly and takes nothing from the parent's
self time, since it runs beside it.  `count` adds to a counter held in the
same registry.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass

log = logging.getLogger("gecoz.metrics")


@dataclass
class PhaseStats:
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0
    self_seconds: float = 0.0     # less the direct children on its thread
    parent: str | None = None     # the enclosing phase, last seen
    count: int = 0                # `count`'s total

    @property
    def mbps(self) -> float:
        return self.bytes / 1e6 / self.seconds if self.seconds else 0.0


_REGISTRY: dict[str, PhaseStats] = defaultdict(PhaseStats)
_LOCK = threading.Lock()
_OPEN = threading.local()         # .stack: [name, children's seconds] frames


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def current() -> str | None:
    """The innermost phase open on this thread, or None: the parent to
    hand a phase that runs on a worker thread."""
    stack = _stack()
    return stack[-1][0] if stack else None


@contextlib.contextmanager
def phase(name: str, nbytes: int = 0, parent: str | None = None):
    """Time the block as phase `name`.  `parent`, for a phase on a worker
    thread: the phase it belongs to, from `current()` on the thread that
    handed it the work."""
    trace_dir = os.environ.get("GECOZ_TRACE_DIR")
    ctx = contextlib.nullcontext()
    if trace_dir:
        import torch
        ctx = torch.profiler.record_function(name)
    stack = _stack()
    on_thread = stack[-1] if stack and parent is None else None
    frame = [name, 0.0]
    stack.append(frame)
    t0 = time.perf_counter()
    try:
        with ctx:
            yield
    finally:
        stack.pop()
    dt = time.perf_counter() - t0
    if on_thread is not None:
        on_thread[1] += dt
    with _LOCK:
        st = _REGISTRY[name]
        st.seconds += dt
        st.self_seconds += dt - frame[1]
        st.bytes += nbytes
        st.calls += 1
        st.parent = parent if on_thread is None else on_thread[0]
    if nbytes:
        log.info("%s: %.1f ms (%.1f MB/s)", name, dt * 1e3,
                 nbytes / 1e6 / dt if dt else 0.0)
    else:
        log.info("%s: %.1f ms", name, dt * 1e3)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` (the `count` of its registry entry)."""
    with _LOCK:
        _REGISTRY[name].count += int(n)


def stats() -> dict[str, PhaseStats]:
    with _LOCK:
        return dict(_REGISTRY)


def reset() -> None:
    with _LOCK:
        _REGISTRY.clear()


def report() -> str:
    lines = []
    for name, st in sorted(stats().items()):
        if not st.calls:
            lines.append(f"{name}: {st.count} counted")
            continue
        line = f"{name}: {st.seconds * 1e3:.1f} ms over {st.calls} calls"
        if st.self_seconds < st.seconds:
            line += f", self {st.self_seconds * 1e3:.1f} ms"
        if st.parent:
            line += f", in {st.parent}"
        if st.bytes:
            line += f", {st.bytes / 1e6:.1f} MB ({st.mbps:.1f} MB/s)"
        if st.count:
            line += f", {st.count} counted"
        lines.append(line)
    return "\n".join(lines)


def all_threads_config():
    """torch.profiler's experimental config that records spans on every
    thread (`profile_all_threads`), or None where torch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def profiler_trace():
    """Wrap a region in a torch.profiler trace when GECOZ_TRACE_DIR is set:
    host and (with a card) CUDA activity, spans of worker threads too where
    torch can record them, written as a Chrome trace
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
    config = all_threads_config()
    kw = {} if config is None else {"experimental_config": config}
    prof = profile(activities=activities, **kw)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
