#!/usr/bin/env python3
"""Run the PyTorch port's compress/index path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (any mismatch or exception exits non-zero):

1. environment and build: the card's name and power limit, the CUDA scan
   kernel built from gecoz_tpu_torch/csrc with nvcc (time, -Xptxas -v);
2. every scan entry point against its plain PyTorch version, bit-exact, at
   the sizes the path uses, then both timed with CUDA events;
3. the run-aware suffix sort (sort and scatter strategies, with and
   without the run-key table) against the host tier's C++ SA-IS;
4. the query-state build (`index_block`) against the port's plain path on
   the CPU, field by field, and its time at 4 MiB and 64 MiB;
5. end to end: a seeded FASTA with a 64 MiB chromosome-class block through
   `python -m gecoz_tpu_torch.cli`, the .gcz/.gcx bytes held against
   gecoz_tpu's host tier, the file decompressed by gecoz_tpu and checked
   by md5 per record;
6. the scan launches the end-to-end run made;
7. two blocks of hg38's chr1 and chr2 lengths in a row through the CLI,
   decompressed by gecoz_tpu and checked by md5 per record.

The oracles are gecoz_tpu's framework-free host modules; JAX is blocked
from being imported.  The last line is {"ok": true, "device": {...}}; the
line before it lists the kernels of the path with their launches in the
end-to-end run.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time


class _NoJax:
    """Import hook: this run must not import JAX (the card has none)."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"chip_smoke must not import {name}")
        return None


MiB = 1 << 20
SCAN_SIZES = (1, 777, 65536, 2 * 65536 + 7, 4 * MiB, 64 * MiB + 12345)
TIMED_SIZES = (4 * MiB, 64 * MiB)
PATH_KERNELS = ("cumsum_i32", "fill_rev_i32", "fill_fwd_i32")
KERNELS = ("cumsum_i32", "cummax_i32", "cummin_rev_i32", "fill_fwd_i32",
           "fill_rev_i32")
REPLACES = "gecoz_tpu/ops/scan_pallas.py:114"     # _scan_pallas


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_build(scan, build):
    t0 = time.perf_counter()
    scan._lib()
    info = build.BUILDS["scan"]
    print(f"# build: {info.path.name} in {info.seconds:.3f} s "
          f"(load {time.perf_counter() - t0:.3f} s)")
    print(info.ptxas)


def scan_inputs(rng, n, dev):
    import numpy as np
    import torch
    full = rng.integers(-2 ** 31, 2 ** 31, size=n, dtype=np.int64)
    fill = np.full(n, -1, np.int32)
    marks = rng.choice(n, size=max(1, n // 100), replace=False)
    fill[marks] = rng.integers(0, 1 << 30, size=marks.size)
    fill[: n // 10] = -1                       # leading unmarked region
    return (torch.from_numpy(full.astype(np.int32)).to(dev),
            torch.from_numpy(fill).to(dev))


def phase_kernels(scan, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    err = {k: 0 for k in KERNELS}
    times = {}
    for n in SCAN_SIZES:
        full, fill = scan_inputs(rng, n, dev)
        for name in KERNELS:
            x = fill if name.startswith("fill") else full
            got = getattr(scan, name)(x)
            want = getattr(scan, name + "_ref")(x)
            torch.cuda.synchronize()
            e = int((got.long() - want.long()).abs().max())
            err[name] = max(err[name], e)
            check(torch.equal(got, want), f"{name} n={n} differs from plain "
                  f"(max abs err {e})")
        print(f"# scan n={n}: 5 entry points bit-exact against plain")
        if n in TIMED_SIZES or n - 12345 in TIMED_SIZES:
            reps = 200 if n < 16 * MiB else 30
            for name in KERNELS:
                x = fill if name.startswith("fill") else full
                k = getattr(scan, name)
                p = getattr(scan, name + "_ref")
                t = [cuda_ms(lambda: p(x), reps), cuda_ms(lambda: k(x), reps),
                     cuda_ms(lambda: k(x), reps), cuda_ms(lambda: p(x), reps)]
                ms, plain = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                times[(name, n if n in TIMED_SIZES else n - 12345)] = (
                    ms, plain)
                print(f"# time {name} n={n}: kernel {ms:.4f} ms, plain "
                      f"{plain:.4f} ms (turns plain/kernel/kernel/plain "
                      f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f} {t[3]:.4f})")
        del full, fill
    return err, times


def host_bounds(s):
    """The host helpers `suffix_array_device` runs before the sort, each
    timed; returns (syms, ell_bits, tok_table, m_pad, r1_keys)."""
    import numpy as np
    from gecoz_tpu_torch.ops import sa_host
    parts = []

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        parts.append(f"{name} {(time.perf_counter() - t0) * 1e3:.0f} ms")
        return out
    mx = timed("max_run_length", lambda: sa_host.max_run_length(s))
    syms = timed("np.unique", lambda: tuple(int(x) for x in np.unique(s)))
    syms = syms if len(syms) <= 7 else None
    ebs = sa_host.runs_ell_bits(s, mx=mx)     # no pass over s: mx is known
    tab = timed("runs_token_table",
                lambda: sa_host.runs_token_table(s, syms, ell_bits=ebs))
    mp = timed("runs_m_pad", lambda: sa_host.runs_m_pad(s))
    print(f"# host bounds {len(s) >> 20} MiB: " + ", ".join(parts)
          + f" (table entries {int(np.count_nonzero(tab != 2**31 - 1))})")
    return syms, ebs, tab, mp, sa_host.runs_r1_keys(tab)


def phase_suffix_sort(dev):
    import numpy as np
    import torch
    from gecoz_tpu import native
    from gecoz_tpu.ops.sa import bwt_from_sa
    from gecoz_tpu_torch.ops.sa_device import (_suffix_array_runs,
                                               suffix_array_device)
    from bench import synth_dna
    warm = synth_dna(1 << 16, seed=3)
    suffix_array_device(warm, with_bwt=True, device=dev)
    results = {}
    for n, seed in ((4 * MiB, 7), (64 * MiB, 11)):
        s = synth_dna(n, seed=seed)
        t0 = time.perf_counter()
        want = native.sais(s)
        want_bwt = bwt_from_sa(s, want)
        print(f"# native SA-IS {n >> 20} MiB: "
              f"{time.perf_counter() - t0:.2f} s (host)")
        syms, ebs, tab, mp, rk = host_bounds(s)
        s_dev = torch.from_numpy(s).to(dev)
        tab_dev = torch.from_numpy(tab).to(dev)
        variants = {
            "sort+tok_table": dict(strategy="sort", tok_table=tab_dev,
                                   r1_keys=rk),
            "sort": dict(strategy="sort", tok_table=None, r1_keys=None),
            "scatter": dict(strategy="scatter", tok_table=tab_dev,
                            r1_keys=rk),
        }
        for name, kw in variants.items():
            def run():
                return _suffix_array_runs(s_dev, syms=syms, m_pad=mp,
                                          ell_bits=ebs, **kw)
            torch.cuda.reset_peak_memory_stats(dev)
            (sa, bwt), first = wall(run)
            peak = torch.cuda.max_memory_allocated(dev)
            secs = min(wall(run)[1] for _ in range(2))
            check(sa.dtype == torch.int32 and bwt.dtype == torch.uint8,
                  "suffix sort output dtypes")
            check(np.array_equal(sa.cpu().numpy(), want),
                  f"SA {name} {n >> 20} MiB != native SA-IS")
            check(np.array_equal(bwt.cpu().numpy(), want_bwt),
                  f"BWT {name} {n >> 20} MiB != host BWT")
            results[(name, n)] = secs
            print(f"# suffix sort {name} {n >> 20} MiB: {secs * 1e3:.1f} ms "
                  f"({n / 1e6 / secs:.1f} MB/s; first run {first * 1e3:.1f} "
                  f"ms), peak {peak / 2**20:.0f} MiB = {peak / n:.1f} "
                  "B/char; equal to native SA-IS")
            del sa, bwt
        _, secs = wall(lambda: suffix_array_device(s, with_bwt=True,
                                                   device=dev))
        print(f"# suffix_array_device {n >> 20} MiB (upload + host bounds "
              f"+ sort): {secs * 1e3:.1f} ms")
    return results


def phase_query_state(dev):
    import numpy as np
    import torch
    from gecoz_tpu_torch.ops.fmq import block_to_numpy
    from gecoz_tpu_torch.ops.pipeline import DNA_SYMBOLS, index_block
    from gecoz_tpu_torch.ops.sa_host import (runs_ell_bits, runs_m_pad,
                                             runs_r1_keys, runs_token_table)
    from bench import synth_dna
    out = {}
    for n, seed in ((4 * MiB, 7), (64 * MiB, 11)):
        s = synth_dna(n, seed=seed)
        ebs = runs_ell_bits(s)
        tab = runs_token_table(s, DNA_SYMBOLS, ell_bits=ebs)
        kw = dict(m_pad=runs_m_pad(s), ell_bits=ebs, r1_keys=runs_r1_keys(tab))
        s_dev = torch.from_numpy(s).to(dev)
        tab_dev = torch.from_numpy(tab).to(dev)
        block, _ = wall(lambda: index_block(s_dev, tok_table=tab_dev, **kw))
        if n == 4 * MiB:
            t0 = time.perf_counter()
            cpu = index_block(torch.from_numpy(s), tok_table=torch.from_numpy(
                tab), **kw)
            print(f"# index_block 4 MiB on the CPU (plain path): "
                  f"{time.perf_counter() - t0:.1f} s")
            a, b = block_to_numpy(block), block_to_numpy(cpu)
            check(a.keys() == b.keys(), "block fields")
            for k in a:
                check(np.array_equal(np.asarray(a[k]), np.asarray(b[k])),
                      f"index_block field {k}: card != CPU plain path")
            print("# index_block 4 MiB: every field equal to the CPU plain "
                  "path")
        del block
        best = min(wall(lambda: index_block(s_dev, tok_table=tab_dev,
                                            **kw))[1] for _ in range(3))
        out[n] = best
        print(f"# index_block {n >> 20} MiB: {best * 1e3:.1f} ms -> "
              f"{n / 1e6 / best:.1f} MB/s (best of 3, device-resident input)")
    profile_busy(lambda: index_block(s_dev, tok_table=tab_dev, **kw),
                 f"index_block {n >> 20} MiB")
    from gecoz_tpu_torch.formats.gcz import encode_block
    profile_busy(lambda: encode_block(s, ["chrS"], device=dev),
                 f"encode_block {n >> 20} MiB (host bounds and serialize "
                 "included)")
    return out


def profile_busy(fn, what: str) -> None:
    """Device kernel time by kernel name under torch.profiler, and its sum
    against the wall time of the same (profiled) run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    if not by_name:
        print(f"# profile {what}: no device time recorded (not measured)")
        return
    busy = sum(r[0] for r in by_name.values())
    scans = [r for k, r in by_name.items()
             if any(f in k for f in ("tile_reduce", "agg_scan", "tile_scan"))]
    print(f"# profile {what}: kernels busy {busy:.1f} ms of "
          f"{secs * 1e3:.1f} ms wall under the profiler "
          f"({100 * busy / secs / 1e3:.0f}%), "
          f"{sum(r[1] for r in by_name.values())} kernel launches; the "
          f"scan kernels {sum(r[0] for r in scans):.2f} ms in "
          f"{sum(r[1] for r in scans)} launches")
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        print(f"#   {ms:8.2f} ms {count:5d}x {name[:100]}")


def write_fasta(path, records):
    import numpy as np
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n")
            full = len(seq) // 80 * 80
            body = np.empty((full // 80, 81), np.uint8)
            body[:, :80] = seq[:full].reshape(-1, 80)
            body[:, 80] = 10
            f.write(body.tobytes())
            if full < len(seq):
                f.write(seq[full:].tobytes() + b"\n")


def chrom(rng, n: int, nruns: int):
    """A DNA sequence of n bases with a leading N region and nruns N runs."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    s = rng.choice(acgt, size=n, p=[0.29, 0.21, 0.21, 0.29])
    s[: n // 100] = ord("N")
    for _ in range(nruns):
        ln = int(rng.integers(1000, min(1 << 20, n // 8)))
        at = int(rng.integers(0, n - ln))
        s[at:at + ln] = ord("N")
    return s.astype(np.uint8)


def make_genome(seed: int = 5):
    """One 64 MiB chromosome with N runs, two of 8-16 MiB, a few short."""
    import numpy as np
    rng = np.random.default_rng(seed)
    recs = [("chr1 synthetic", chrom(rng, 64 * MiB, 4)),
            ("chr2", chrom(rng, int(rng.integers(8, 16)) * MiB + 777, 2)),
            ("chr3", chrom(rng, int(rng.integers(8, 16)) * MiB + 3, 2))]
    for i in range(4):
        recs.append((f"contig{i}", chrom(rng, int(rng.integers(2000, 60000)),
                                         0)))
    return recs


def phase_end_to_end(dev, scan, workdir):
    import numpy as np
    import torch
    from gecoz_tpu.formats.fasta import iter_fasta
    from gecoz_tpu.tools import driver as host_driver
    from gecoz_tpu.utils import metrics
    from gecoz_tpu_torch import cli

    fa = os.path.join(workdir, "genome.fa")
    recs = make_genome()
    write_fasta(fa, recs)
    want_md5 = {h.split()[0]: hashlib.md5(s.tobytes()).hexdigest()
                for h, s in recs}
    total = sum(len(s) for _, s in recs)
    del recs
    print(f"# FASTA: {os.path.getsize(fa)} bytes, {total} bases")

    port_gcz = os.path.join(workdir, "port.gcz")
    metrics.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    scan.reset_launches()                     # the main path starts here
    t0 = time.perf_counter()
    rc = cli.main(["-i", fa, "-o", port_gcz, "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(scan.LAUNCHES)            # ... and ends here
    check(rc == 0, f"port CLI exit code {rc}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"# port CLI compress: {secs:.2f} s -> {total / 1e6 / secs:.2f} "
          f"MB/s end to end; peak device memory {peak / 2**30:.2f} GiB")
    for name, st in sorted(metrics.stats().items()):
        print(f"#   phase {name}: {st.seconds * 1e3:.1f} ms over {st.calls} "
              f"calls" + (f", {st.mbps:.1f} MB/s" if st.bytes else ""))

    host_gcz = os.path.join(workdir, "host.gcz")
    t0 = time.perf_counter()
    host_driver.index_fasta(fa, host_gcz, backend="native")
    print(f"# host tier (native) compress: {time.perf_counter() - t0:.2f} s")
    for ext in ("gcz", "gcx"):
        a = open(port_gcz[:-3] + ext, "rb").read()
        b = open(host_gcz[:-3] + ext, "rb").read()
        check(a == b, f".{ext} bytes differ from the host tier's "
              f"({len(a)} vs {len(b)} bytes)")
        print(f"# .{ext}: {len(a)} bytes, byte-identical to the host tier "
              f"(md5 {hashlib.md5(a).hexdigest()})")

    back = os.path.join(workdir, "back.fa")
    t0 = time.perf_counter()
    host_driver.decompress(port_gcz, back, backend="numpy", threads=4)
    got_md5 = {r.header.split()[0]: hashlib.md5(bytes(r.data)).hexdigest()
               for r in iter_fasta(back)}
    check(got_md5 == want_md5, "decompressed records differ from the input")
    print(f"# decompress (gecoz_tpu, numpy): {time.perf_counter() - t0:.2f} "
          f"s; md5 equal for all {len(want_md5)} records")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the path")
    print(f"# launches during the end-to-end run: {json.dumps(launches)}")
    return launches


def phase_two_large_blocks(dev, workdir):
    """hg38's two largest chromosomes by length, one block each, encoded one
    after the other through the CLI: the second block's suffix sort must be
    served from what the first left in torch's allocator cache."""
    import numpy as np
    import torch
    from gecoz_tpu.formats.fasta import iter_fasta
    from gecoz_tpu.tools import driver as host_driver
    from gecoz_tpu.utils import metrics
    from gecoz_tpu_torch import cli

    rng = np.random.default_rng(17)
    recs = [("chr1", chrom(rng, 248_956_422, 8)),
            ("chr2", chrom(rng, 242_193_529, 8))]
    fa = os.path.join(workdir, "large.fa")
    write_fasta(fa, recs)
    want_md5 = {h.split()[0]: hashlib.md5(s.tobytes()).hexdigest()
                for h, s in recs}
    total = sum(len(s) for _, s in recs)
    del recs
    gcz = os.path.join(workdir, "large.gcz")
    metrics.reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rc = cli.main(["-i", fa, "-o", gcz, "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(rc == 0, f"port CLI exit code {rc} on two large blocks")
    free, cap = torch.cuda.mem_get_info(dev)
    print(f"# two large blocks (chr1 248,956,422 + chr2 242,193,529 bases): "
          f"{secs:.2f} s -> {total / 1e6 / secs:.2f} MB/s end to end; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
          f"GiB; after the run {torch.cuda.memory_reserved(dev) / 2**30:.2f} "
          f"GiB reserved by torch, {free / 2**30:.2f} of {cap / 2**30:.2f} "
          "GiB free on the card")
    for name, st in sorted(metrics.stats().items()):
        print(f"#   phase {name}: {st.seconds * 1e3:.1f} ms over {st.calls} "
              f"calls" + (f", {st.mbps:.1f} MB/s" if st.bytes else ""))
    os.unlink(fa)
    back = os.path.join(workdir, "large_back.fa")
    t0 = time.perf_counter()
    host_driver.decompress(gcz, back, backend="numpy", threads=4)
    got_md5 = {r.header.split()[0]: hashlib.md5(bytes(r.data)).hexdigest()
               for r in iter_fasta(back)}
    check(got_md5 == want_md5, "two large blocks: decompressed records "
          "differ from the input")
    print(f"# decompress (gecoz_tpu, numpy): {time.perf_counter() - t0:.2f} "
          "s; md5 equal for both records")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gecoz_tpu_torch  # noqa: F401 - sets up the gecoz_tpu import
    from gecoz_tpu_torch.kernels import _build
    from gecoz_tpu_torch.ops import scan

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; device {kind}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    t_all = time.perf_counter()
    phase_build(scan, _build)
    err, times = phase_kernels(scan, dev)
    phase_suffix_sort(dev)
    phase_query_state(dev)
    with tempfile.TemporaryDirectory() as work:
        launches = phase_end_to_end(dev, scan, work)
    with tempfile.TemporaryDirectory() as work:
        phase_two_large_blocks(dev, work)
    check("jax" not in sys.modules, "jax was imported")
    print(f"# all phases passed in {time.perf_counter() - t_all:.1f} s")

    def entry(name):
        ms, plain = times[(name, 64 * MiB)]
        return {"name": name, "route": "cuda",
                "source": "gecoz_tpu_torch/csrc/scan.cu",
                "replaces": REPLACES, "launches": launches[name],
                "max_abs_err": err[name], "ms": ms, "plain_ms": plain}
    # cummax_i32 and cummin_rev_i32 share the kernel template but have no
    # caller on the path: checked and timed above, listed apart
    off_path = [entry(k) for k in KERNELS if k not in PATH_KERNELS]
    print(f"# ported, not on the path: {json.dumps(off_path)}")
    print(json.dumps({"kernels": [entry(k) for k in PATH_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
