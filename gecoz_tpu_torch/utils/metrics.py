"""Phase timing / throughput observability.

The port's copy of gecoz_tpu/utils/metrics.py, without its `jax.profiler`
hooks (the GECOZ_TRACE_DIR annotation and `profiler_trace`; their
`torch.profiler` counterpart is ROADMAP A8).

The reference logs ad-hoc nanoTime spans per phase (GecoIndex.java:115-116,
GecoRead.java:71-75, GecoMatch.java:133-134).  Here every pipeline phase
reports wall time and bytes through a process-wide registry, surfaced at
`-v INFO`.
"""

from __future__ import annotations

import contextlib
import logging
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
    t0 = time.perf_counter()
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

