"""The device trace of the window: `torch.profiler` over CPU and CUDA
activity, exported as a Chrome trace and read back.

The card is busy where a kernel, a copy or a memset runs: the union of
their intervals, so overlapping ones count once (the method of
`chip_smoke.py::busy_us`).  An idle gap is attributed to the innermost host
span (a program phase, or the harness's span around each operation) that
holds the gap's midpoint.
"""

from __future__ import annotations

import contextlib
import json
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OP_SPAN = "gzbench.op"            # the harness's span around each operation


@contextlib.contextmanager
def profiled(path: Path):
    """Trace the block into a Chrome trace at `path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path))


@dataclass
class Trace:
    device: list[tuple[str, float, float]]     # (name, start, end), us
    spans: list[tuple[str, float, float]]      # host spans, us
    window: tuple[float, float]                # first op start, last op end


def load(path: Path) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts = float(e["ts"])
        iv = (e["name"], ts, ts + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            device.append(iv)
        elif e.get("cat") == "user_annotation":
            spans.append(iv)
    ops = [s for s in spans if s[0].startswith(OP_SPAN)]
    window = ((min(s[1] for s in ops), max(s[2] for s in ops)) if ops
              else (0.0, 0.0))
    return Trace(device, spans, window)


def merged(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(trace: Trace) -> float:
    busy = merged(((a, b) for _, a, b in trace.device), *trace.window)
    return sum(b - a for a, b in busy) / 1e6


def device_seconds(trace: Trace, pattern: str) -> float:
    """Summed device time of the operations whose name matches `pattern`
    (a regular expression), inside the window."""
    rx = re.compile(pattern)
    lo, hi = trace.window
    return sum(min(b, hi) - max(a, lo) for name, a, b in trace.device
               if rx.search(name) and b > lo and a < hi) / 1e6


def short_name(name: str) -> str:
    """A kernel's qualified name without its return type, anonymous
    namespaces, template arguments and parameters ("void ns::k<T>(int*)"
    -> "ns::k"); copies keep their direction ("Memcpy HtoD")."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def device_ops(trace: Trace, top: int = 10) -> list[list]:
    """The device operations that took most time, by short name:
    [[name, s]]."""
    lo, hi = trace.window
    by: dict[str, float] = {}
    for name, a, b in trace.device:
        if b > lo and a < hi:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (min(b, hi) - max(a, lo)) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_by_span(trace: Trace, top: int = 10) -> list[list]:
    """Idle device time summed by the innermost host span it falls in:
    [[span, s]], the largest first; "(no span)" outside every span.  The
    window is cut at every span and busy edge, so a gap across several
    spans is shared among them."""
    lo, hi = trace.window
    if hi <= lo:
        return []
    busy = merged(((a, b) for _, a, b in trace.device), lo, hi)
    spans = sorted(((n, max(a, lo), min(b, hi)) for n, a, b in trace.spans
                    if b > lo and a < hi), key=lambda s: -(s[2] - s[1]))
    cuts = np.unique(np.clip(np.array(
        [lo, hi] + [x for iv in busy for x in iv]
        + [x for _, a, b in spans for x in (a, b)]), lo, hi))
    mids = (cuts[:-1] + cuts[1:]) / 2
    length = np.diff(cuts) / 1e6
    if busy:
        starts = np.array([a for a, _ in busy])
        ends = np.array([b for _, b in busy])
        k = np.searchsorted(starts, mids, side="right") - 1
        idle = (k < 0) | (mids >= ends[np.maximum(k, 0)])
    else:
        idle = np.ones(len(mids), bool)
    label = np.full(len(mids), -1)
    for j, (_, a, b) in enumerate(spans):     # inner spans overwrite outer
        i0, i1 = np.searchsorted(mids, [a, b])
        label[i0:i1] = j
    sums = np.bincount(label[idle] + 1, weights=length[idle],
                       minlength=len(spans) + 1)
    by: dict[str, float] = {}
    for j, v in enumerate(sums):
        if v:
            name = spans[j - 1][0] if j else "(no span)"
            by[name] = by.get(name, 0.0) + float(v)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
