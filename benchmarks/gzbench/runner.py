"""One run of one cell: set-up, the measured window, the trace, the judge,
and the result line's object.

`run_cell` takes the device to run on, so the tests drive every step of a
run on the CPU at small sizes; `run.py` adds the look for the card, the
check that no JAX was loaded, and the printing.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from gzbench import calls as call_shapes
from gzbench import trace as device_trace
from gzbench.data import rng_for
from gzbench.layers import Context, reader
from gzbench.operations import OPERATIONS
from gzbench.window import run_window

ROOT = Path(__file__).resolve().parent.parent.parent    # the checkout
BENCH = ROOT / "benchmarks"
TRAFFIC = BENCH / "traffic"           # a mix is traffic/<name>.json


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device, setup_started: float,
             config_over: dict | None = None,
             traffic_over: dict | None = None, replace=None) -> dict:
    """Run cell `cell_name` once on `device`; `setup_started` is the
    perf_counter reading that set-up counts from (the process start).
    `config_over`/`traffic_over` replace entries of the cell's configuration
    and traffic files (the tests' small sizes); `replace(op)`, a context
    manager entered once set-up has made the inputs, puts something else in
    the program's place for the warm-up and the window (the control, the
    tests' faults)."""
    cell = cell_of(bench, cell_name)
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = _merge(load_json(ROOT / config_entry["file"]), config_over)
    traffic = _merge(load_json(TRAFFIC / f"{cell['traffic']}.json"),
                     traffic_over)
    device = torch.device(device)
    workdir = Path(tempfile.mkdtemp(prefix="gzbench-"))
    try:
        return _run(bench, cell, config, traffic, seed, seconds, traced,
                    device, setup_started, workdir, replace)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


TRACE_SECONDS = 8.0    # the traced window: operations after the measured one


def _run(bench, cell, config, traffic, seed, seconds, traced, device,
         setup_started, workdir, replace) -> dict:
    from gecoz_tpu_torch.utils import metrics

    kind = traffic["operation"]
    op = OPERATIONS[kind](config, traffic, seed, workdir, device)
    op.prepare()
    with replace(op) if replace else contextlib.nullcontext():
        op.run("warm")
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        metrics.reset()
        setup_s = time.perf_counter() - setup_started
        window = run_window(op.run, seconds)
        # copies: the registry's entries go on counting in the traced window
        spans = {k: copy.copy(v) for k, v in metrics.stats().items()}
        if traced:
            tw, tr, shapes = _traced_window(op, kind, window.attempted,
                                            workdir)
            window.attempted += tw.attempted
            window.failed += tw.failed
            window.done += tw.done
        print("operation seconds: " + " ".join(f"{w:.3f}" for w in
                                               window.walls), file=sys.stderr)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.empty_cache()
        numbers = {"ops_failed": window.failed}
        numbers |= op.judge(window.done, rng_for(seed, "judge"))

    checks = {k: {"value": v, "limit": 0} for k, v in numbers.items()}
    correct = window.attempted > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    name = cell["name"]
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window.attempted,
              "failed": window.failed}
    if not traced:
        values = {"setup_s": setup_s, traffic["rate_metric"]: window.rate}
        result["metrics"] = {
            m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in bench["end_to_end"]
            if applies(m, name) and m["name"] in values}
    else:
        ctx = Context(device_name=dev_info["kind"], ops=len(window.done)
                      - len(tw.done), op_seconds=window.seconds, spans=spans,
                      trace=tr, calls=shapes)
        result["metrics"] = {}
        for m in bench["per_layer"]:
            read = reader(m["name"]) if applies(m, name) else None
            value = read(ctx) if read else None
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        dev_info["busy_s"] = device_trace.busy_seconds(tr)
        dev_info["window_s"] = (tr.window[1] - tr.window[0]) / 1e6
        result["breakdown"] = {"device_ops": device_trace.device_ops(tr),
                               "idle_gaps": device_trace.idle_by_span(tr)}
    result["device"] = dev_info
    result["checks"] = checks           # last: the numbers compared
    return result


def _traced_window(op, kind: str, first: int, workdir: Path):
    """Operations first, first + 1, ... for TRACE_SECONDS (the one in
    flight at the deadline counts) under torch.profiler, each in a span of
    its own and with the program's phases as spans (GECOZ_TRACE_DIR).  A
    trace of the whole measured window was too large to read back: the
    peptide search makes ~900,000 host events an operation."""
    path = workdir / "trace.json"
    span = f"{device_trace.OP_SPAN}.{kind}"

    def timed(i):
        with torch.profiler.record_function(span):
            return op.run(first + i)

    os.environ["GECOZ_TRACE_DIR"] = str(workdir)
    try:
        with call_shapes.recorded() as shapes:
            with device_trace.profiled(path):
                tw = run_window(timed, TRACE_SECONDS)
    finally:
        os.environ.pop("GECOZ_TRACE_DIR", None)
    tw.done = [first + i for i in tw.done]
    return tw, device_trace.load(path), shapes
