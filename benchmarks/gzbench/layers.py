"""Per-layer metrics: the context their readers get, the loader that finds
each reader by its metric's name, and what readers share.

A reader is `benchmarks/layer_metrics/<metric name>.py` with one function
`read(ctx) -> float | None`; None (nothing to read) leaves the metric out
of the result line.  In a `--trace 1` run the measured window runs as in
any other run, and a short traced window of a few more operations follows
it: "ms" metrics are a phase span's total in the measured window over the
operations completed in it (the profiler's overhead left out), device
metrics come from the traced window.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from gzbench.named import BENCH, load
from gzbench.trace import Trace, busy_seconds, device_seconds

LAYER_METRICS = BENCH / "layer_metrics"

# Published peaks, by the name torch.cuda.get_device_name() gives: HBM
# bytes/s from NVIDIA's H100 SXM data sheet (at its 700 W power limit).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


@dataclass
class Context:
    device_name: str
    ops: int                          # completed in the measured window
    op_seconds: float                 # the measured window's length
    spans: dict                       # program phase -> PhaseStats, in it
    trace: Trace | None               # the traced window
    calls: dict = field(default_factory=dict)    # its gzbench.calls shapes


def span_ms(ctx: Context, *names: str) -> float | None:
    """Summed ms of the named program phases per completed operation."""
    found = [ctx.spans[n].seconds for n in names if n in ctx.spans]
    if not found or not ctx.ops:
        return None
    return sum(found) * 1e3 / ctx.ops


def idle_pct(ctx: Context) -> float | None:
    if ctx.trace is None or ctx.trace.window[1] <= ctx.trace.window[0]:
        return None
    window = (ctx.trace.window[1] - ctx.trace.window[0]) / 1e6
    return 100.0 * (1.0 - busy_seconds(ctx.trace) / window)


def roofline_pct(ctx: Context, nbytes: int, kernel_pattern: str) -> float | None:
    """Share of the bytes bound: `nbytes` at the card's HBM peak over the
    matching kernels' device time."""
    peak = PEAK_BYTES_PER_S.get(ctx.device_name)
    if ctx.trace is None or peak is None or not nbytes:
        return None
    secs = device_seconds(ctx.trace, kernel_pattern)
    if secs <= 0:
        return None
    return 100.0 * nbytes / peak / secs


def reader(name: str):
    """The `read` function of metric `name`, or None without a reader."""
    if not (LAYER_METRICS / f"{name}.py").is_file():
        return None
    return load(LAYER_METRICS, name, "per-layer metric").read
