"""Capacity-scale run of the sharded suffix sort.

The port's counterpart of gecoz_tpu/tools/probe_sharded_scale.py: runs
`parallel/sharded_sa.py::suffix_array_sharded` on a mesh of `--shards`
copies of `--device` (default `(cuda:0,) * 8`, a virtual mesh of one
card: every shard lies on the one card and no interconnect is measured)
over an hg38-shaped synthetic block (`validate_scale.synth_seq`), asserts
the suffix array and BWT bit-exact against the host library's SA-IS and
BWT gather, and reports the wall time, the peak device memory per char
(`torch.cuda.max_memory_allocated`, reset before the run) and its share
per shard, and the host RSS delta during the sort.

Usage: python -m gecoz_tpu_torch.tools.probe_sharded_scale [--mb 352]
           [--device cuda:0|cpu] [--shards 8]
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


class PeakTracker(threading.Thread):
    def __init__(self):
        super().__init__(daemon=True)
        self.peak = _rss_mb()
        self._halt = threading.Event()

    def run(self):
        while not self._halt.is_set():
            self.peak = max(self.peak, _rss_mb())
            time.sleep(0.25)

    def stop(self) -> float:
        self._halt.set()
        self.join()
        return max(self.peak, _rss_mb())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=352)
    ap.add_argument("--device", default=None,
                    help="device of every shard (default: the card)")
    ap.add_argument("--shards", type=int, default=8)
    a = ap.parse_args(argv)

    import torch

    from gecoz_tpu_torch.utils.device import device as pick_device
    dev = pick_device(a.device)
    mesh = (dev,) * a.shards
    n = a.mb << 20
    print(f"mesh: ({dev},) * {a.shards}, n = {a.mb} MiB ({n} chars)",
          flush=True)
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        print(f"{torch.cuda.get_device_name(dev)}: {free / 2**30:.2f} of "
              f"{total / 2**30:.2f} GiB free", flush=True)

    from gecoz_tpu_torch.tools.validate_scale import synth_seq
    rng = np.random.default_rng(52)
    t0 = time.perf_counter()
    s = synth_seq(rng, n)
    s[-1] = 0                                   # terminated block
    print(f"synthesized in {time.perf_counter() - t0:.1f}s; "
          f"baseline RSS {_rss_mb():.0f} MB", flush=True)

    from gecoz_tpu_torch.ops.sa_host import max_run_length
    from gecoz_tpu_torch.parallel import sharded_sa as ss
    mrl = int(max_run_length(s))
    print(f"longest equal-symbol run: {mrl} -> impl=auto picks "
          f"{ss._pick_impl(s, 'auto')}", flush=True)

    base = _rss_mb()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        dev_base = torch.cuda.memory_allocated(dev)
    ss.reset_stats()
    tracker = PeakTracker()
    tracker.start()
    t0 = time.perf_counter()
    sa_d, bwt_d = ss.suffix_array_sharded(s, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = tracker.stop()
    print(f"sharded SA: {wall:.3f} s = {n / 1e6 / wall:.2f} MB/s, "
          f"{ss.STATS['sorts']} distributed sorts, {ss.STATS['rounds']} "
          "exchange rounds (host preparation included)", flush=True)
    if dev.type == "cuda":
        dpeak = torch.cuda.max_memory_allocated(dev) - dev_base
        print(f"peak device memory: {dpeak / 2**30:.2f} GiB = "
              f"{dpeak / n:.1f} B/char over all {a.shards} shards = "
              f"{dpeak / n / a.shards:.2f} B/char a shard", flush=True)
    else:
        print("peak device memory: not measured (the shards are on the "
              "CPU)", flush=True)
    used = peak - base
    print(f"peak host RSS during the sort: {peak:.0f} MB (delta {used:.0f} "
          f"MB = {used * 2**20 / n:.1f} B/char)", flush=True)
    sa = ss.gather_shards(sa_d).numpy().astype(np.int64)
    bwt = ss.gather_shards(bwt_d).numpy()
    del sa_d, bwt_d

    # oracle: the host library's SA-IS (an independent algorithm, C++)
    from gecoz_tpu_torch import native
    from gecoz_tpu_torch.ops.sa import bwt_from_sa
    t0 = time.perf_counter()
    ref_sa = native.sais(s)
    ref_bwt = bwt_from_sa(s, ref_sa)
    print(f"native SA-IS oracle: {time.perf_counter() - t0:.1f}s", flush=True)

    ok_sa = np.array_equal(sa, ref_sa)
    ok_bwt = np.array_equal(bwt, ref_bwt)
    print(f"SA bit-exact: {ok_sa}; BWT bit-exact: {ok_bwt}", flush=True)
    print("SHARDED-SCALE", "PASSED" if ok_sa and ok_bwt else "FAILED",
          flush=True)
    return 0 if ok_sa and ok_bwt else 1


if __name__ == "__main__":
    sys.exit(main())
