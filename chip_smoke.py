#!/usr/bin/env python3
"""Run the PyTorch port's compress, decompress and search paths once on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any mismatch or exception exits non-zero):

1. environment and build: the card's name and power limit, the five CUDA
   kernels (scan, fm_search, lf_walk, gcx, hswt) built from
   gecoz_tpu_torch/csrc, one nvcc each, and the host library (g++,
   csrc/host), all started together
   (time, -Xptxas -v); each kernel library's load time;
2. every scan entry point against its plain PyTorch version, bit-exact, at
   the sizes the path uses and at the one-pass scan's tile edges (and on
   views 4 and 12 bytes off a 16-byte boundary), then both timed with CUDA
   events, and beside them the one PyTorch call that computes the same
   function where there is one (torch.cumsum in int32, torch.cummax); the
   tile-shape sweep of the add and the look-back scratch's bytes;
3. the run-aware suffix sort (with and without the run-key table) against
   the host library's C++ SA-IS;
4. the query-state build (`index_block`) against the port's plain path on
   the CPU, field by field, and its time at 4 MiB and 64 MiB;
5. end to end (each run through the CLI on the card with this process's
   getrusage deltas beside its wall: user and system time, minor faults,
   max RSS, as in phases 7 and 9): a seeded FASTA with a 64 MiB chromosome-class block through
   `python -m gecoz_tpu_torch.cli` (the device tier, `--backend auto`: the
   mesh route, `encode_blocks`, its phase walls and the bytes the host
   fetched per block), the .gcz/.gcx bytes held against the CLI's host
   tier (`--backend native -t 4`: SA-IS, BWT and wavelet fill on the host,
   blocks on a pool), then decompressed by the port's CLI on the card and
   held byte for byte against the CLI's host tier (`--backend native -t
   4`, the host FM-index's walks) and by md5 per record against the input;
   the first decode launch timed apart; the card's busy share of one
   64 MiB block's decompress under torch.profiler; the same FASTA written
   as BGZF by the port's `GzipFileWriter` and as one gzip member by its
   `gzip_compress` (both through the host library's deflate), each
   compressed by the CLI to the same files; a gzip input with trailing
   zero bytes, and one cut inside its deflate data, refused by the CLI
   (exit code non-zero, no .gcz);
6. the scan launches the compress run made, the LF-walk launches of the
   decompress run;
7. two blocks of hg38's chr1 and chr2 lengths in a row through the CLI,
   decompressed by the port's CLI on the card and checked by md5 per
   record;
8. the query kernels at full width against their plain versions on the
   card, bit-exact, then timed: K2's decode walks (k = 16 rows and
   per-step plain rows of a 64 MiB block; packed rows at the probe's 2048
   walks x 32 steps over a 2 Mi block) and locate
   walks (2^20 rows), both beside the card's random-read rate (a library
   gather of random rows), the locate walks' reads (a plain replay of the
   walks) at the card's random 4-byte row rate giving their random-read
   bound; K1's search (2^20 16-mers, 20,000 reads of
   16-150 bases on both strands) on the rank table (`with_rank_blocks`,
   timed), with the distinct 32-byte sectors each search reads on the
   rank table and on the flat planes (a plain replay of
   the search) and the random-read bound those sectors give at the card's
   rate for random 32-byte rows; each beside its bytes bound;
9. GFF3 search of 1,000 reads through the port's CLI on the card, byte for
   byte against the CLI's host tier (`--backend numpy`: `FMIndex.find` per
   read and strand; the two share the row emission, which the CPU tests
   hold against the reference CLI), at the default memory budget (locate
   table) and at a budget forced low (LF walks); count and locate against what a plain
   byte search of the genome gives, written as the verbs write it (byte
   for byte), range extract against the genome's bytes; the card's busy
   share of one 64 MiB block's search under torch.profiler;
10. (run after phase 3) the sharded suffix sort and the mesh encode on
    virtual meshes of the card: a 64 MiB chromosome-like block with N runs
    over (cuda:0,) * 8 (auto: the run-aware variant; the path of the scan's max and reverse-min
    entry points, whose launches this run gives the kernels line), 16 MiB
    of N-free DNA by the k-mer variant over (cuda:0,) * 6 (odd-even
    transposition), each against the host library's SA-IS and BWT gather;
    a one-shard mesh at 4 MiB against `suffix_array_device`; a 4 MiB block
    encoded through `encode_blocks` with the sharded route forced, against
    the host tier; the dry run (`dryrun_multichip`) over (cuda:0,) * 8.
    Wall time, peak device memory per char, the distributed sorts and
    exchange rounds, and the scan launches of each;
11. the tools: a compress of a 4 MiB FASTA through the CLI in process
    inside `metrics.profiler_trace()` (GECOZ_TRACE_DIR set), the trace
    file holding the `mesh.sa` phase and the scan kernel, its size and
    the card's busy share over the traced window; `entry()` on the card
    against `entry("cpu")`; `tools.validate_scale --cli --profile genome
    --mb 32` and `tools.probe_sharded_scale --mb 16` as processes of their
    own, each printing its PASSED line;
12. (run after phase 9) blocks past 16 symbols, which the reference's
    plane engine refuses and the port serves on the card: the block
    planner's time on 1,000-4,000 Swiss-Prot-shaped records; a FASTA of
    4,000 such records (lognormal lengths of mean ~360, one of titin's
    35,213 residues, Swiss-Prot's amino-acid composition plus X: 22
    symbols) through the port's CLI on the card, its .gcz/.gcx and
    decompressed FASTA against the CLI's host tier (`--backend native -t
    4`), md5 per record, GFF3 rows of 1,000 peptides of 8-50 residues
    against a plain byte search of the records and those of the first 50
    against `--backend numpy`; one 64 MiB protein record through the CLI
    (compress, decompress with md5, search of 100 peptides against a
    plain byte search); at block level its decode with and without the
    bit planes (peak B/char), K2's byte-row walk (lfk4) against its plain
    version at 64 MiB, timed, beside its bytes bound and its random-read
    bound (a library gather of random 8-byte rows), and its search
    tables' peak; a 4 MiB block of all 256 byte values encoded on the
    card, decoded by the decompress path and searched (K1 against its
    plain version, located hits at their pattern's bytes), with the
    decode and search peaks.  The launches of each run are printed;
13. (run after phase 11) files of short blocks, whose sampling factor the
    reference's reader derives wrong (ROADMAP C5) and whose suffix array
    its SA-IS can get wrong (C6): one-record files of every block length
    from 1 to 120 at rate 32 and files of 50 x 40-mers, 100 x 36, 100 x
    100 and 100 x 101 bases (each record a block of its own) through the
    port's CLI on the card: the .gcz/.gcx against the CLI's host tier
    (`--backend native`), the decompressed records against the input,
    GFF3 rows at the default budget and at 1 B against a plain byte
    search, `--check --deep`; then K2's decode (fused and per-step rows)
    and locate and K1 on eight of these blocks against their plain
    versions, bit-exact, and timed;
14. (run last) inputs the port refuses or answers on purpose (ROADMAP
    C7-C9), through the port's CLI on the card: a query FASTA with empty
    records (GFF3 rows equal to the `--backend numpy` tier's, none
    malformed, none for the empty records, K1 launched) and one of empty
    records only (no rows, no launch); `-c ""`, `--sampling 10`,
    `--sampling 0` and a range extract from -5 exit 1 and write nothing.
    The total time is printed last;
15. (run after phase 8) the .gcx decode kernels (`csrc/gcx.cu`: unpack,
    decode) at the two shapes the benchmark lifts, hg38's chr21 block (m
    = 1,459,687 at rate 32) and a Swiss-Prot block (m = 742), on a .gcx
    written by the host serializers: against their plain versions,
    bit-exact, then timed beside their bytes bounds; `gcx.lift` on the
    host clock (the stored bytes up, unpack, scan, decode, the one sync)
    beside the host decode it replaced (`sampled_rows`, the sort,
    `wsa.perm`, the wrap row);
16. (run after phase 15) the wavelet tree's decode kernels
    (`csrc/hswt.cu`: unpack, decode) at the two shapes the benchmark
    lifts, hg38's chr21 block (46,709,983 bases with N runs) and a
    Swiss-Prot block (61 records, 23,726 residues), the BWT from the
    card's suffix sort and the tree read back from its bytes: against
    their plain versions and `decode_bwt`, bit-exact, then timed beside
    their bytes bounds; `hswt_device.lift` on the host clock (the streams
    up, unpack, scan, decode, the one sync) beside the host's
    `decode_bwt` it replaced.

The port stands alone: an import hook refuses JAX and gecoz_tpu, and the
oracles are the port's host copies (tests/test_torch_host_copies.py holds
them equal to gecoz_tpu's on the CPU) or plain computations on the
genome.  The last line is {"ok": true, "device": {...}}; the line before
it lists the kernels of the paths with their launches in the runs through
the CLI (the scan's max and reverse min: in phase 10's 64 MiB sharded
sort; K2's byte rows: in phase 12's 64 MiB protein decompress; each
kernel's count adds phase 13's runs), their times, bounds and library
calls.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time


REFUSED = ("jax", "jaxlib", "gecoz_tpu")


class _Refuse:
    """Import hook: this run imports neither JAX (the card's machine has
    none) nor the JAX package: the port stands alone."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"chip_smoke must not import {name}")
        return None


MiB = 1 << 20
SCAN_SIZES = (1, 777, 65536, 2 * 65536 + 7, 4 * MiB, 64 * MiB + 12345)
TIMED_SIZES = (4 * MiB, 64 * MiB)
PATH_KERNELS = ("cumsum_i32", "fill_rev_i32", "fill_fwd_i32")
SHARDED_KERNELS = ("cummax_i32", "cummin_rev_i32")   # phase 10's path
KERNELS = ("cumsum_i32", "cummax_i32", "cummin_rev_i32", "fill_fwd_i32",
           "fill_rev_i32")
REPLACES = "gecoz_tpu/ops/scan_pallas.py:114"     # _scan_pallas
LIBS = ("scan", "fmsearch", "lfwalk", "gcx", "hswt")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet: the bytes bound
# the query kernels' entry points: (name, source, TPU kernel replaced)
QUERY_KERNELS = (
    ("fm_search", "gecoz_tpu_torch/csrc/fmsearch.cu",
     "tools/probe_pallas.py:29"),                  # step1_vmem_gather
    ("lf_walk.decode", "gecoz_tpu_torch/csrc/lfwalk.cu",
     "tools/probe_gather2d.py:18"),                # main: k_walk
    ("lf_walk.locate", "gecoz_tpu_torch/csrc/lfwalk.cu",
     "tools/probe_gather2d.py:18"),
    # the decode walks' byte rows (k = 4), the path of blocks past 16
    # symbols (phase 12)
    ("lf_walk.decode.lfk4", "gecoz_tpu_torch/csrc/lfwalk.cu",
     "tools/probe_gather2d.py:18"),
    # the .gcx decode of the lift (phase 15); they replace no TPU kernel
    ("gcx.unpack", "gecoz_tpu_torch/csrc/gcx.cu", None),
    ("gcx.decode", "gecoz_tpu_torch/csrc/gcx.cu", None),
    # the BWT's decode out of the wavelet tree in the lift (phase 16); they
    # replace no TPU kernel
    ("hswt.unpack", "gecoz_tpu_torch/csrc/hswt.cu", None),
    ("hswt.decode", "gecoz_tpu_torch/csrc/hswt.cu", None))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def reset_counts() -> None:
    from gecoz_tpu_torch.ops import fmsearch, gcx, hswt_device, lfwalk, scan
    for mod in (scan, fmsearch, lfwalk, gcx, hswt_device):
        mod.reset_launches()


def counts() -> dict[str, int]:
    """Launches of every kernel entry point since the last reset."""
    from gecoz_tpu_torch.ops import fmsearch, gcx, hswt_device, lfwalk, scan
    out = dict(scan.LAUNCHES)
    out["fm_search"] = fmsearch.LAUNCHES["fm_search"]
    out.update({f"lf_walk.{k}": v for k, v in lfwalk.LAUNCHES.items()})
    out["lf_walk.decode.lfk4"] = lfwalk.DECODE_LAUNCHES["lfk4"]
    out.update({f"gcx.{k}": v for k, v in gcx.LAUNCHES.items()})
    out.update({f"hswt.{k}": v for k, v in hswt_device.LAUNCHES.items()})
    return out


def print_phases(prefix: str = "") -> None:
    from gecoz_tpu_torch.utils import metrics
    for name, st in sorted(metrics.stats().items()):
        if name.startswith(prefix):
            print(f"#   phase {name}: {st.seconds * 1e3:.1f} ms over "
                  f"{st.calls} calls"
                  + (f", {st.mbps:.1f} MB/s" if st.bytes else ""))


def bound_ms(nbytes: float) -> float:
    """The least time the card could take to move `nbytes` (each input
    byte read once, each output byte written once) at its HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def print_fetched() -> None:
    """The bytes the host fetched in the compress run (the mesh route: mark
    bits, sampled values, wavelet node bits; the `mesh.fetched_bytes`
    counter) per character encoded (`mesh.wavelet`'s bytes), beside the 4
    bytes a character of the int32 suffix array that the per-block route
    fetched on top of the node bits."""
    from gecoz_tpu_torch.utils import metrics
    st = metrics.stats()
    got = st["mesh.fetched_bytes"].count if "mesh.fetched_bytes" in st else 0
    n = st["mesh.wavelet"].bytes if "mesh.wavelet" in st else 0
    print(f"#   fetched: {got} bytes for {n} characters = "
          f"{got / max(n, 1):.3f} B/char (a full int32 SA alone: 4 B/char)")


def rusage():
    import resource
    return resource.getrusage(resource.RUSAGE_SELF)


def print_rusage(what: str, r0, r=None) -> None:
    """This process's getrusage deltas from `r0` to `r` (default: now),
    beside a run's wall: the host-memory policy (utils/hostmem.py) shows in
    system time and minor faults.  Max RSS is the process's high-water
    mark."""
    r = r or rusage()
    print(f"# rusage {what}: user {r.ru_utime - r0.ru_utime:.2f} s, system "
          f"{r.ru_stime - r0.ru_stime:.2f} s, {r.ru_minflt - r0.ru_minflt} "
          f"minor faults; max RSS {r.ru_maxrss / 2**20:.2f} GiB "
          f"({(r.ru_maxrss - r0.ru_maxrss) / 2**20:+.2f} over the run)")


def md5_records(path) -> dict[str, str]:
    from gecoz_tpu_torch.formats.fasta import iter_fasta
    return {r.header.split()[0]: hashlib.md5(bytes(r.data)).hexdigest()
            for r in iter_fasta(path)}


def timed_pair(name, kern, plain, reps, err, times, key=None):
    """Kernel against its plain version on the same inputs (every output
    tensor bit-exact), then both timed in turns plain, kernel, kernel,
    plain."""
    import torch
    got, want = kern(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    e = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
            for g, w in zip(got, want))
    err[name] = max(err.get(name, 0), e)
    for g, w in zip(got, want):
        check(torch.equal(g, w), f"{key or name}: kernel differs from plain "
              f"(max abs err {e})")
    t = [cuda_ms(plain, reps), cuda_ms(kern, reps), cuda_ms(kern, reps),
         cuda_ms(plain, reps)]
    ms, pl = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    times[key or name] = (ms, pl)
    print(f"# time {key or name}: kernel {ms:.4f} ms, plain {pl:.4f} ms "
          f"(turns plain/kernel/kernel/plain {t[0]:.4f} {t[1]:.4f} "
          f"{t[2]:.4f} {t[3]:.4f}); bit-exact")
    return got


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


def phase_build(build):
    import concurrent.futures as cf
    from gecoz_tpu_torch import native
    from gecoz_tpu_torch.ops import fmsearch, gcx, hswt_device, lfwalk, scan
    t0 = time.perf_counter()
    # one nvcc per source and g++ for the host library, all started
    # together; _lib() also declares the C signatures (and lfwalk's loads
    # its kernels)
    with cf.ThreadPoolExecutor(max_workers=len(LIBS) + 1) as pool:
        futs = [pool.submit(mod._lib)
                for mod in (scan, fmsearch, lfwalk, gcx, hswt_device)]
        futs.append(pool.submit(native.available))
        for fut in futs:
            fut.result()
    print(f"# build: {len(LIBS)} kernel libraries and the host library in "
          f"{time.perf_counter() - t0:.3f} s wall (one compiler each, "
          "together)")
    for name in LIBS + ("gecoz_host",):
        info = build.BUILDS.get(name)
        if info is not None:
            print(f"# build: {info.path.name} in {info.seconds:.3f} s")
            if name != "gecoz_host":
                print(info.ptxas)
    check(native.available(), f"the host library did not load: "
          f"{native.error()}")
    print(f"# host library loaded: {build.BUILDS['gecoz_host'].path.name} "
          "(SA-IS, BWT, rank vectors, LF walks, wavelet fill, inflate, "
          "deflate, LPF)")
    for name, mod in (("scan", scan), ("fm_search", fmsearch),
                      ("lf_walk", lfwalk), ("gcx", gcx),
                      ("hswt", hswt_device)):
        print(f"# {name} kernels loaded in {mod.INIT_SECONDS * 1e3:.1f} ms "
              "(the library's CUDA runtime set up, every path kernel's "
              "attributes read), before any launch")


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
    # the one PyTorch call that computes an entry point, where there is one
    library = {"cumsum_i32": lambda x: torch.cumsum(x, 0, dtype=torch.int32),
               "cummax_i32": lambda x: torch.cummax(x, 0).values}
    rng = np.random.default_rng(0)
    err = {k: 0 for k in KERNELS}
    times, lib_times = {}, {}
    T = scan._lib().gecoz_scan_tile()
    # the one-pass scan's tile edges: a look-back past one warp's window of
    # 32 tiles and through 40 windows
    edges = (T - 1, T, T + 1, 2 * T + 7, 33 * T + 1, 40 * 32 * T + 5)
    for n in sorted(set(SCAN_SIZES + edges)):
        full, fill = scan_inputs(rng, n + 3, dev)
        # views 0, 4 and 12 bytes past a 16-byte boundary (the head and tail
        # of every tile take the scalar path); offset views at the last edge
        for off in (0, 1, 3) if n == edges[-1] else (0,):
            for name in KERNELS:
                x = (fill if name.startswith("fill") else full)[off:off + n]
                got = getattr(scan, name)(x)
                want = getattr(scan, name + "_ref")(x)
                torch.cuda.synchronize()
                e = int((got.long() - want.long()).abs().max())
                err[name] = max(err[name], e)
                check(torch.equal(got, want), f"{name} n={n} view +{off} "
                      f"differs from plain (max abs err {e})")
        full, fill = full[:n], fill[:n]
        print(f"# scan n={n}{' (tile edge)' if n in edges else ''}: 5 entry "
              "points bit-exact against plain"
              + (" at views +0, +4 and +12 bytes" if n == edges[-1] else ""))
        if n in TIMED_SIZES or n - 12345 in TIMED_SIZES:
            reps = 200 if n < 16 * MiB else 30
            for name in KERNELS:
                x = fill if name.startswith("fill") else full
                k = getattr(scan, name)
                p = getattr(scan, name + "_ref")
                t = [cuda_ms(lambda: p(x), reps), cuda_ms(lambda: k(x), reps),
                     cuda_ms(lambda: k(x), reps), cuda_ms(lambda: p(x), reps)]
                ms, plain = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                times[times_key(name, n)] = (ms, plain)
                print(f"# time {name} n={n}: kernel {ms:.4f} ms, plain "
                      f"{plain:.4f} ms (turns plain/kernel/kernel/plain "
                      f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f} {t[3]:.4f})")
                if name in library:
                    call = library[name]
                    same = torch.equal(call(x), k(x))
                    lt = [cuda_ms(lambda: call(x), reps),
                          cuda_ms(lambda: k(x), reps),
                          cuda_ms(lambda: call(x), reps)]
                    lib_times[times_key(name, n)] = (lt[0] + lt[2]) / 2
                    print(f"# time {name} n={n}: library call "
                          f"{(lt[0] + lt[2]) / 2:.4f} ms, kernel {lt[1]:.4f} "
                          f"ms (turns library/kernel/library {lt[0]:.4f} "
                          f"{lt[1]:.4f} {lt[2]:.4f}); same result: {same}")
        if n == 64 * MiB + 12345:
            scan_sweep(scan, full, n)
        del full, fill
    return err, times, lib_times


def scan_sweep(scan, x, n):
    """The add at three tile shapes and occupancies (the path's first), and
    the look-back scratch the path's shape needs."""
    lib = scan._lib()
    design_sweep(f"cumsum_i32 n={n}", {
        f"{label} ({lib.gecoz_scan_sweep_tile(i)} a tile)":
            (lambda i=i: scan._sweep_launch(x, i))
        for i, label in enumerate((
            "256 threads x 32, 5 blocks an SM", "256 threads x 32, 4 blocks "
            "an SM", "256 threads x 16, 6 blocks an SM"))},
        scan.cumsum_i32_ref(x), 30, 8 * n)
    tiles = -(-n // lib.gecoz_scan_tile())         # out starts aligned
    print(f"# scan scratch at n={n}: {tiles} tiles, {8 * (tiles + 1)} bytes "
          f"zeroed (torch.zeros, one memset) = {8 * (tiles + 1) / (8 * n):.2%}"
          " of the scan's bytes")


def times_key(name, n):
    return (name, n if n in TIMED_SIZES else n - 12345)


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
    from gecoz_tpu_torch import native
    from gecoz_tpu_torch.ops.sa import bwt_from_sa
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
            "sort+tok_table": dict(tok_table=tab_dev, r1_keys=rk),
            "sort": dict(tok_table=None, r1_keys=None),
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


def busy_us(intervals) -> float:
    """The card's busy time: the length of the union of the kernels'
    (start, end) intervals, so kernels that overlap count once.  Every
    busy share the smoke prints is this over a wall time."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_busy(fn, what: str, ours=("scan_onepass",)) -> None:
    """Device kernel time by kernel name under torch.profiler, and the
    card's busy time (`busy_us`) against the wall time of the same
    (profiled) run; `ours` names the hand-written kernels to total apart."""
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
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
            spans.append((e.time_range.start, e.time_range.end))
    if not by_name:
        print(f"# profile {what}: no device time recorded (not measured)")
        return
    busy = busy_us(spans) / 1e3
    mine = [r for k, r in by_name.items() if any(f in k for f in ours)]
    print(f"# profile {what}: kernels busy {busy:.1f} ms of "
          f"{secs * 1e3:.1f} ms wall under the profiler "
          f"({100 * busy / secs / 1e3:.0f}%), "
          f"{sum(r[1] for r in by_name.values())} kernel launches; "
          f"{'/'.join(ours)} {sum(r[0] for r in mine):.2f} ms in "
          f"{sum(r[1] for r in mine)} launches")
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


@contextlib.contextmanager
def first_launch_timed(mod, name: str, store: dict):
    """Time the first call of `mod.name` in the block: CUDA events around
    the call (the device's time from its enqueue to its end) and the host
    clock (the call, its set-up included)."""
    import torch
    orig = getattr(mod, name)

    def timed(*args, **kw):
        if name in store:
            return orig(*args, **kw)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = orig(*args, **kw)
        e1.record()
        e1.synchronize()
        store[name] = (e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3)
        return out
    setattr(mod, name, timed)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def phase_end_to_end(dev, workdir):
    import torch
    from gecoz_tpu_torch import cli
    from gecoz_tpu_torch.ops import lfwalk
    from gecoz_tpu_torch.utils import metrics

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
    r0 = rusage()
    reset_counts()                            # the compress path starts
    t0 = time.perf_counter()
    rc = cli.main(["-i", fa, "-o", port_gcz, "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counts()                       # ... and ends here
    check(rc == 0, f"port CLI exit code {rc}")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"# port CLI compress: {secs:.2f} s -> {total / 1e6 / secs:.2f} "
          f"MB/s end to end; peak device memory {peak / 2**30:.2f} GiB")
    print_rusage("port CLI compress", r0)
    print_phases()
    print_fetched()

    host_gcz = os.path.join(workdir, "host.gcz")
    t0 = time.perf_counter()
    rc = cli.main(["-i", fa, "-o", host_gcz, "--backend", "native", "-t",
                   "4"])
    check(rc == 0, f"port CLI --backend native compress exit code {rc}")
    print(f"# port CLI --backend native -t 4 compress (the host tier: "
          f"encode_block_host on 4 workers): {time.perf_counter() - t0:.2f} s")
    for ext in ("gcz", "gcx"):
        a = open(port_gcz[:-3] + ext, "rb").read()
        b = open(host_gcz[:-3] + ext, "rb").read()
        check(a == b, f".{ext} bytes differ from the host tier's "
              f"({len(a)} vs {len(b)} bytes)")
        print(f"# .{ext}: {len(a)} bytes, byte-identical to the host tier "
              f"(md5 {hashlib.md5(a).hexdigest()})")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the path")
    print(f"# launches during the compress run: {json.dumps(launches)}")

    # the decompress path: the port's CLI on the card
    back_port = os.path.join(workdir, "back_port.fa")
    metrics.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    first = {}
    r0 = rusage()
    reset_counts()                            # the decompress path starts
    t0 = time.perf_counter()
    with first_launch_timed(lfwalk, "decode_walks", first):
        rc = cli.main(["-i", port_gcz, "-o", back_port, "-t", "4",
                       "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dlaunches = counts()                      # ... and ends here
    check(rc == 0, f"port CLI decompress exit code {rc}")
    r_dec = rusage()
    back_host = os.path.join(workdir, "back_host.fa")
    t0 = time.perf_counter()
    rc = cli.main(["-i", port_gcz, "-o", back_host, "--backend", "native",
                   "-t", "4"])
    check(rc == 0, f"port CLI --backend native decompress exit code {rc}")
    print(f"# port CLI --backend native -t 4 decompress (the host tier: the "
          f"host FM-index's walks on 4 workers): "
          f"{time.perf_counter() - t0:.2f} s")
    a = open(back_port, "rb").read()
    check(a == open(back_host, "rb").read(), "the port's decompress on the "
          "card differs from its host tier's")
    os.unlink(back_host)
    check(md5_records(back_port) == want_md5, "decompressed records differ "
          "from the input")
    check(dlaunches["lf_walk.decode"] > 0, "lf_walk.decode was not "
          "launched by the decompress path")
    check(dlaunches["gcx.decode"] > 0, "gcx.decode was not launched by the "
          "decompress path")
    check(dlaunches["hswt.decode"] > 0, "hswt.decode was not launched by "
          "the decompress path")
    print(f"# port CLI decompress: {secs:.2f} s -> {total / 1e6 / secs:.2f} "
          f"MB/s end to end, {len(a)} bytes byte-identical to the host "
          f"tier's (md5 {hashlib.md5(a).hexdigest()}), md5 equal to the "
          f"input for all {len(want_md5)} records; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print_rusage("port CLI decompress", r0, r_dec)
    print_phases("decode.")
    dev_ms, host_ms = first["decode_walks"]
    print(f"# first K2 decode call of the run: {dev_ms:.3f} ms on the card "
          f"(CUDA events), {host_ms:.3f} ms on the host clock, inside "
          f"decode.walk {metrics.stats()['decode.walk'].seconds * 1e3:.1f} ms "
          f"over {metrics.stats()['decode.walk'].calls} blocks")
    print(f"# launches during the decompress run: {json.dumps(dlaunches)}")
    del a

    from gecoz_tpu_torch.formats.gcz import GecozReader
    from gecoz_tpu_torch.tools import driver
    reader = GecozReader(port_gcz)
    big = max(reader.headers, key=lambda h: h.len)
    fm = reader.read(big)
    one = os.path.join(workdir, "one_block.fa")
    open(one, "wb").close()
    profile_busy(lambda: driver._decompress_block(fm, big.headers, one, 0, 4,
                                                  dev),
                 f"decompress of the {big.len / MiB:.1f} MiB block (the lift, "
                 "its BWT decoded on the card, tables, walks, fetch and "
                 "reflow)",
                 ours=("lf_decode", "scan_onepass"))
    del fm
    return launches, dlaunches


def phase_two_large_blocks(dev, workdir):
    """hg38's two largest chromosomes by length, one block each, encoded one
    after the other through the CLI: the second block's suffix sort must be
    served from what the first left in torch's allocator cache."""
    import numpy as np
    import torch
    from gecoz_tpu_torch import cli
    from gecoz_tpu_torch.utils import metrics

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
    r0 = rusage()
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
    print_rusage("two large blocks, compress", r0)
    print_phases()
    print_fetched()
    os.unlink(fa)
    back = os.path.join(workdir, "large_back.fa")
    metrics.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    r0 = rusage()
    t0 = time.perf_counter()
    rc = cli.main(["-i", gcz, "-o", back, "-t", "4", "--device", str(dev)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    r1 = rusage()
    check(rc == 0, f"port CLI decompress exit code {rc} on two large blocks")
    peak = torch.cuda.max_memory_allocated(dev)
    check(md5_records(back) == want_md5, "two large blocks: decompressed "
          "records differ from the input")
    print(f"# port CLI decompress of the two large blocks: {secs:.2f} s -> "
          f"{total / 1e6 / secs:.2f} MB/s end to end; md5 equal for both "
          f"records; peak device memory {peak / 2**30:.2f} GiB = "
          f"{peak / 248_956_423:.1f} B/char of the chr1 block")
    print_rusage("two large blocks, decompress", r0, r1)
    print_phases("decode.")


ROOT = os.path.dirname(os.path.abspath(__file__))


def run_module(argv, timeout: int):
    """`python -m <argv>` from the checkout's root, waited for; returns
    (exit code, standard output, standard error)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def phase_gzip(dev, workdir, fa, port_gcz):
    """Phase 5's FASTA as BGZF (`GzipFileWriter`) and as one gzip member
    (`gzip_compress`), both by the port's codec with the host library's
    hash-chain deflate, each compressed by the CLI on the card to the
    plain FASTA's files; a gzip input with trailing zero bytes, and one
    cut inside its deflate data, refused."""
    import concurrent.futures as cf
    from gecoz_tpu_torch import cli
    from gecoz_tpu_torch.codec.gzip_file import GzipFileWriter, gzip_compress
    from gecoz_tpu_torch.formats import fasta
    raw = open(fa, "rb").read()
    bgzf, gz = fa + ".bgzf.gz", fa + ".gz"

    def write_bgzf():
        with GzipFileWriter(bgzf, bgzf=True, matcher="native") as w:
            for i in range(0, len(raw), MiB):
                w.write(raw[i:i + MiB])

    def write_gz():
        with open(gz, "wb") as f:
            f.write(gzip_compress(raw, matcher="native"))
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=2) as pool:
        for fut in [pool.submit(write_bgzf), pool.submit(write_gz)]:
            fut.result()
    print(f"# gzip: the {len(raw)}-byte FASTA written as BGZF "
          f"({os.path.getsize(bgzf)} bytes, GzipFileWriter) and as one gzip "
          f"member ({os.path.getsize(gz)} bytes, gzip_compress) on two "
          f"threads: {time.perf_counter() - t0:.2f} s")
    del raw
    want = {ext: open(port_gcz[:-3] + ext, "rb").read()
            for ext in ("gcz", "gcx")}
    for label, path in (("BGZF", bgzf), ("gzip", gz)):
        out = os.path.join(workdir, f"from_{label.lower()}.gcz")
        t0 = time.perf_counter()
        rc = cli.main(["-i", path, "-o", out, "--device", str(dev)])
        check(rc == 0, f"port CLI compress of the {label} FASTA: exit code "
              f"{rc}")
        for ext in ("gcz", "gcx"):
            check(open(out[:-3] + ext, "rb").read() == want[ext],
                  f"the {label} FASTA's .{ext} differs from the plain "
                  "FASTA's")
            os.unlink(out[:-3] + ext)
        print(f"# port CLI compress of the {label} FASTA (inflated by the "
              f"port's GzipFileReader): {time.perf_counter() - t0:.2f} s, "
              ".gcz/.gcx byte-identical to the plain FASTA's")
        os.unlink(path)
    fasta._cleanup_inflated()
    with open(fa, "rb") as f:
        head = gzip_compress(f.read(MiB), matcher="native")
    bad = {"16 trailing zero bytes": (gzip_compress(
        b">chrA\nACGTACGTNNACGT\n>chrB\nTTGGCCAA\n") + b"\0" * 16,
        "invalid gzip header"),
        "its one member cut inside the deflate data": (
            head[:len(head) // 2], "truncated deflate stream")}
    for i, (what, (blob, why)) in enumerate(bad.items()):
        src, out = (os.path.join(workdir, f"bad{i}.fa.gz"),
                    os.path.join(workdir, f"bad{i}.gcz"))
        with open(src, "wb") as f:
            f.write(blob)
        rc, _, err = run_module(["gecoz_tpu_torch.cli", "-i", src, "-o", out,
                                 "--device", str(dev)], 120)
        check(rc != 0 and not os.path.exists(out), f"the CLI took a gzip "
              f"input with {what}")
        check(why in err, f"the CLI refused the gzip input with {what} for "
              f"another reason: {err[-300:]}")
        print(f"# a gzipped FASTA with {what}: the CLI exits {rc} with "
              f"'{why}', no .gcz written")


def trace_report(path) -> None:
    """The Chrome trace of `metrics.profiler_trace`: its size, the phase
    spans it holds, and the card's busy share (`busy_us`) over the traced
    window."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    names = {e["name"] for e in events}
    check("mesh.sa" in names, "the trace holds no mesh.sa span")
    kernels = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") == "kernel"]
    check(any("scan_onepass" in e["name"] for e in events
              if e.get("cat") == "kernel"), "the trace holds no scan kernel")
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy = busy_us(kernels)
    print(f"# trace {os.path.basename(path)}: {os.path.getsize(path)} bytes,"
          f" {len(events)} spans, {len(kernels)} kernels; the card busy "
          f"{busy / 1e3:.1f} ms of the {(hi - lo) / 1e3:.1f} ms traced "
          f"({100 * busy / (hi - lo):.1f}%)")
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and "." in e["name"]:
            spans[e["name"]] = spans.get(e["name"], 0.0) + float(e["dur"])
    for name, us in sorted(spans.items(), key=lambda kv: -kv[1]):
        print(f"#   span {name}: {us / 1e3:.1f} ms")


def phase_tools(dev, workdir):
    """Phase 11: a traced CLI compress, entry() on the card, and the two
    scale tools at a small size as processes of their own."""
    import numpy as np
    import torch
    from gecoz_tpu_torch import cli
    from gecoz_tpu_torch.entry import entry
    from gecoz_tpu_torch.utils import metrics
    t_phase = time.perf_counter()
    fa = os.path.join(workdir, "trace.fa")
    write_fasta(fa, [("chrT", chrom(np.random.default_rng(37), 4 * MiB, 2))])
    os.environ["GECOZ_TRACE_DIR"] = os.path.join(workdir, "trace")
    try:
        t0 = time.perf_counter()
        with metrics.profiler_trace() as path:
            rc = cli.main(["-i", fa, "-o", os.path.join(workdir, "trace.gcz"),
                           "--device", str(dev)])
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        os.environ.pop("GECOZ_TRACE_DIR", None)
    check(rc == 0, f"traced CLI compress exit code {rc}")
    check(os.path.isfile(path), "profiler_trace wrote no trace")
    print(f"# traced port CLI compress of 4 MiB: {secs:.2f} s with the "
          "profiler (trace written on exit)")
    trace_report(path)

    fn, args = entry()
    check(all(a.device == dev for a in args), "entry() is not on the card")
    got, secs = wall(lambda: fn(*args))
    cpu_fn, cpu_args = entry(device="cpu")
    want = cpu_fn(*cpu_args)
    for name, g, w in zip(("sp", "ep", "located", "text"), got, want):
        check(g.is_cuda and torch.equal(g.cpu(), w), f"entry() {name} on "
              "the card differs from the CPU")
    print(f"# entry(): index_and_query of the example block on the card in "
          f"{secs * 1e3:.1f} ms, every output equal to entry('cpu')'s")

    torch.cuda.empty_cache()
    for argv, passed, timeout in (
            (["gecoz_tpu_torch.tools.validate_scale", "--cli", "--profile",
              "genome", "--mb", "32", "--out", os.path.join(workdir,
                                                             "scale")],
             "LARGE-SCALE CHECK PASSED", 600),
            (["gecoz_tpu_torch.tools.probe_sharded_scale", "--mb", "16"],
             "SHARDED-SCALE PASSED", 300)):
        t0 = time.perf_counter()
        rc, out, err = run_module(argv, timeout)
        secs = time.perf_counter() - t0
        for line in out.splitlines():
            if not line.startswith(("+", "block [")):
                print(f"#   {line}")
        check(rc == 0 and passed in out, f"{' '.join(argv)}: exit code {rc}"
              f"\n{err[-2000:]}")
        print(f"# python -m {' '.join(argv[:1] + argv[1:4])}...: {passed} "
              f"in {secs:.1f} s")
    print(f"# phase 11 (trace, entry, scale tools): "
          f"{time.perf_counter() - t_phase:.1f} s")


def design_sweep(key, variants, want, reps, nbytes):
    """Designs of one kernel on the same inputs: each held bit-exact
    against `want`, then timed in turns (forward, then backward through the
    list; the mean of the two), each beside the bytes bound."""
    import torch
    for label, fn in variants.items():
        check(torch.equal(fn(), want), f"{key} ({label}) differs from plain")
    names = list(variants)
    t = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            t[k].append(cuda_ms(variants[k], reps))
    b = bound_ms(nbytes)
    for k in names:
        ms = sum(t[k]) / 2
        print(f"# sweep {key}: {k}: {ms:.4f} ms ({t[k][0]:.4f} {t[k][1]:.4f})"
              f", {100 * b / ms:.0f}% of the {b:.4f} ms bytes bound; "
              "bit-exact")


def phase_query_kernels(dev):
    """Phase 8: K1 and K2 at full width against their plain versions."""
    import numpy as np
    import torch
    from gecoz_tpu_torch.ops import fmq, fmsearch, lfwalk
    from gecoz_tpu_torch.ops.pipeline import index_block
    from gecoz_tpu_torch.tools.batch_search import pack_patterns
    from bench import synth_dna
    err, times, bounds, rr_bounds = {}, {}, {}, {}
    rng = np.random.default_rng(23)

    n = 64 * MiB
    s = synth_dna(n, seed=11)
    blk, secs = wall(lambda: index_block(torch.from_numpy(s).to(dev)))
    blk, tsecs = wall(lambda: fmq.with_lf_table(blk))
    print(f"# 64 MiB block: index_block {secs * 1e3:.1f} ms, with_lf_table "
          f"{tsecs * 1e3:.1f} ms (lfk_k {blk.lfk_k}, packed rows "
          f"{blk.lf_packed})")
    check(blk.lfk_k == 16 and not blk.lf_packed, "64 MiB block tables")
    rate = 1 << blk.sf
    W = (n - 1) // rate
    seeds = fmq._row_with_sa(blk, (torch.arange(W, dtype=torch.int32,
                                                device=dev) + 1) * rate)
    cmap = fmq.code_map(blk)
    key = "lf_walk.decode lfk16 64 MiB"
    timed_pair(
        "lf_walk.decode",
        lambda: lfwalk.decode_walks(blk.lfk_tab, seeds, rate, "lfk16",
                                    code_map=cmap),
        lambda: lfwalk.decode_walks_ref(blk.lfk_tab, seeds, rate, "lfk16",
                                        code_map=cmap),
        10, err, times, key)
    # seeds in, 12-byte rows read (rate / 16 a walk), the text out
    bounds[key] = 4 * W + 12 * W * (rate // 16) + W * rate
    print(f"# lfk16 table {blk.lfk_tab.numel() * 4 / n:.0f} B/char")
    timed_pair("lf_walk.decode",
               lambda: lfwalk.decode_walks(blk.lf_tab, seeds, rate, "plain",
                                           bwt=blk.bwt),
               lambda: lfwalk.decode_walks_ref(blk.lf_tab, seeds, rate,
                                               "plain", bwt=blk.bwt),
               5, err, times, "lf_walk.decode plain 64 MiB")
    # seeds in; a 4-byte row and a bwt byte a step; the text out
    bounds["lf_walk.decode plain 64 MiB"] = 4 * W + 6 * W * rate
    text, secs = wall(lambda: fmq.decode_text(blk))
    check(np.array_equal(text.cpu().numpy(), s), "decode_text 64 MiB != "
          "the block")
    print(f"# decode_text 64 MiB: {secs * 1e3:.1f} ms -> {n / 1e6 / secs:.1f} "
          "MB/s (tables built, text on the card); equal to the block")
    del text, seeds

    rows = torch.from_numpy(rng.integers(0, n, 1 << 20).astype(
        np.int32)).to(dev)
    args = (blk.lf_tab, rows, blk.mark_words, blk.mark_pre, blk.ssa_perm,
            blk.sf, blk.lf_packed)
    key = "lf_walk.locate 2^20 rows 64 MiB"
    (vals,) = timed_pair("lf_walk.locate", lambda: lfwalk.locate_walks(*args),
                         lambda: lfwalk.locate_walks_ref(*args), 10, err,
                         times, key)
    # BWT[row] = T[SA[row] - 1]: the located values agree with the text
    v = vals.cpu().numpy().astype(np.int64)
    check(bool((v >= 0).all()) and np.array_equal(
        blk.bwt[rows.long()].cpu().numpy(), s[(v - 1) % n]),
        "located values disagree with the text")
    # a walk from a row with SA value v reads v % rate + 1 rows, then the
    # mark word, its prefix and ssa_perm; the row in, the value out
    bounds[key] = 4 * int((v % rate + 1).sum()) + 20 * len(v)
    print(f"# locate walks: {(v % rate + 1).mean():.2f} row reads a row on "
          f"average, {int((v % rate + 1).max())} at most")
    reads = locate_reads(blk, rows)
    check(reads == int((v % rate + 1).sum()) + 3 * len(v), "the locate "
          "replay's reads disagree with the located values")

    # the card's random-read rate: one library gather of random rows
    def gather(t, count):
        idx = torch.randint(0, t.shape[0], (count,), device=dev,
                            generator=torch.Generator(dev).manual_seed(5))
        ms = cuda_ms(lambda: torch.index_select(t, 0, idx), 10)
        print(f"# random reads: torch.index_select of {count} random "
              f"{t[0].numel() * 4}-byte rows of a {t.numel() * 4 >> 20} MiB "
              f"table: {ms:.4f} ms = {count / ms / 1e6:.2f} G rows/s")
        return count / ms

    def sector_gather(t, count):
        """Random rows of a 2-D table with one 4-byte word read in each: a
        random row costs its whole sector whatever is read of it, and a 2-D
        torch.index_select of 32-byte rows measures the library's gather
        (far slower than rows of 4 or 12 bytes), not the card."""
        idx = torch.randint(0, t.shape[0], (count,), device=dev,
                            generator=torch.Generator(dev).manual_seed(5))
        flat, first = t.view(-1), idx * t.shape[1]
        ms = cuda_ms(lambda: torch.index_select(flat, 0, first), 10)
        print(f"# random reads: torch.index_select of the first word of "
              f"{count} random {t[0].numel() * 4}-byte rows of a "
              f"{t.numel() * 4 >> 20} MiB table: {ms:.4f} ms = "
              f"{count / ms / 1e6:.2f} G rows/s")
        return count / ms
    per_ms4 = gather(blk.lf_tab, 1 << 24)
    rr_bounds[key] = reads / per_ms4
    per_ms12 = gather(blk.lfk_tab, 1 << 22)
    dec_ms = times["lf_walk.decode lfk16 64 MiB"][0]
    print(f"# at those rates: decode's {2 * W} row reads take "
          f"{2 * W / per_ms12:.4f} ms (the kernel {dec_ms:.4f} ms), locate's "
          f"{reads} reads {reads / per_ms4:.4f} ms (the kernel "
          f"{times[key][0]:.4f} ms)")

    k_blk = fmq.with_kmer_table(blk)
    print(f"# k-mer table: k {k_blk.kmer_k}, {k_blk.kmer_bits} bits, "
          f"{k_blk.kmer_tab.shape[0]} rows")
    k_blk, secs = wall(lambda: fmq.with_rank_blocks(k_blk))
    rb_bytes = k_blk.rank_blocks.numel() * 4
    flat_bytes = (k_blk.plane_words.numel() + k_blk.plane_pres.numel()) * 4
    print(f"# rank table (with_rank_blocks): {secs * 1e3:.1f} ms, "
          f"{k_blk.rank_blocks.shape[0]} blocks of 32 bytes = "
          f"{rb_bytes / MiB:.1f} MiB = {rb_bytes / n:.3f} B/char (flat planes "
          f"{flat_bytes / n:.3f} B/char)")
    gather(k_blk.rank_blocks, 1 << 22)
    per_ms32 = sector_gather(k_blk.rank_blocks, 1 << 22)

    def k1_shape(key, pats, lens, host, reps, nbytes):
        """K1 at one shape: bit-exact, timed in turns with its plain
        version, beside its sectors and its bounds.
        `host` is the lengths' host copy, which the wrapper checks (as
        `find_batched` passes it) without reading `lens` back."""
        got = timed_pair("fm_search",
                         lambda: fmsearch.backward_search(k_blk, pats, lens,
                                                          host),
                         lambda: fmsearch.backward_search_ref(k_blk, pats,
                                                              lens),
                         reps, err, times, key)
        (flat, blocks), (uflat, ublocks) = search_sectors(k_blk, pats, lens)
        B = pats.shape[0]
        bounds[key] = nbytes
        rr_bounds[key] = blocks / per_ms32
        print(f"# sectors {key}: {flat / B:.2f} distinct 32-byte sectors a "
              f"pattern on the flat planes, {blocks / B:.2f} on the rank "
              f"blocks (occ lookups; the k-mer seed's one read excluded); "
              f"at {per_ms32 / 1e6:.2f} G random 32-byte rows/s: "
              f"{blocks / per_ms32:.4f} ms random-read bound "
              f"({flat / per_ms32:.4f} ms for the flat sectors; kernel "
              f"{times[key][0]:.4f} ms); distinct over the whole batch: "
              f"{uflat} flat, {ublocks} rank-block sectors "
              f"({ublocks / per_ms32:.4f} ms at that rate)")
        return got

    L, B = 16, 1 << 20
    starts = np.random.default_rng(3).integers(0, n - L, size=B)
    pats = torch.from_numpy(s[starts[:, None] + np.arange(L)]).to(dev)
    lens = torch.full((B,), L, dtype=torch.int32, device=dev)
    # a pattern in, its 8-byte k-mer seed, then L - k steps of two occ
    # lookups (an 8-byte word and prefix each), sp and ep out
    sp, ep = k1_shape("fm_search 2^20 16-mers", pats, lens,
                      np.full(B, L, np.int32), 10,
                      B * (L + 4 + 8 + 8 + 16 * (L - k_blk.kmer_k)))
    # every 16-mer drawn from the text occurs (those across a separator
    # excepted: backward search steps through '\0' uncorrected)
    whole = (pats != 0).all(1)
    check(bool((ep >= sp)[whole].all()), "a 16-mer drawn from the block "
          "was not found")
    ms = times["fm_search 2^20 16-mers"][0]
    print(f"# fm_search 2^20 16-mers: {B / ms / 1e3:.1f} Mq/s (kernel only)")
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    reads = []
    for a, ln in zip(rng.integers(0, n - 150, 20000),
                     rng.integers(16, 151, 20000)):
        r = s[a:a + ln].tobytes()
        reads += [r, r[::-1].translate(comp)]
    arr, ln = pack_patterns(reads)
    pats, lens = (torch.from_numpy(arr).to(dev),
                  torch.from_numpy(ln).to(dev))
    # every step counted: a reverse strand absent from the text stops
    # early, so this bound is an upper one
    steps = np.maximum(ln.astype(np.int64) - k_blk.kmer_k, 0)
    sp, ep = k1_shape("fm_search 20,000 reads x 2 strands", pats, lens,
                      ln, 5,
                      int((ln.astype(np.int64) + 20 + 16 * steps).sum()))
    whole = (pats[0::2] != 0).all(1)
    check(bool((ep[0::2] >= sp[0::2])[whole].all()), "a read drawn from the "
          "block was not found")
    del blk, k_blk, pats, lens, rows, vals

    # the probe's shape: 2048 walks x 32 steps over a 2 Mi block's rows
    n2 = 2 * MiB
    s2 = synth_dna(n2, seed=7)
    b2 = fmq.with_lf_table(index_block(torch.from_numpy(s2).to(dev)),
                           decode=False)
    check(b2.lf_packed, "2 Mi block rows are packed")
    seeds2 = torch.from_numpy(rng.integers(0, n2, 2048).astype(
        np.int32)).to(dev)
    timed_pair("lf_walk.decode",
               lambda: lfwalk.decode_walks(b2.lf_tab, seeds2, 32, "packed"),
               lambda: lfwalk.decode_walks_ref(b2.lf_tab, seeds2, 32,
                                               "packed"),
               50, err, times, "lf_walk.decode packed probe 2048x32")
    bounds["lf_walk.decode packed probe 2048x32"] = 2048 * (4 + 5 * 32)
    del b2
    torch.cuda.empty_cache()
    for key, nbytes in bounds.items():
        ms, plain = times[key]
        most = " at most" if key.endswith("strands") else ""
        print(f"# bound {key}:{most} {bound_ms(nbytes):.4f} ms for {nbytes} "
              f"bytes (kernel {ms:.4f} ms = {100 * bound_ms(nbytes) / ms:.1f}"
              f"% of it; plain {plain:.4f} ms)")
    for key, ms_bound in rr_bounds.items():
        print(f"# random-read bound {key}: {ms_bound:.4f} ms (kernel "
              f"{times[key][0]:.4f} ms = {100 * ms_bound / times[key][0]:.1f}"
              "% of it)")
    return err, times, bounds, rr_bounds


def phase_gcx(dev):
    """Phase 15: the .gcx decode kernels against their plain versions at
    the benchmark's two lift shapes, timed; the lift beside the host
    decode."""
    import numpy as np
    from gecoz_tpu_torch.index import iwt, rankbv, ssa
    from gecoz_tpu_torch.ops import gcx, scan
    err, times, bounds = {}, {}, {}
    rng = np.random.default_rng(29)
    for label, m in (("hg38", 1_459_687), ("swissprot", 742)):
        n = 32 * m - int(rng.integers(0, 32))
        rows = np.sort(rng.choice(n, m, replace=False))
        bits = np.zeros(n, np.uint8)
        bits[rows] = 1
        perm = rng.permutation(m)
        buf = np.frombuffer(rankbv.serialize_rbv(rankbv.pack_bits(bits), n)
                            + iwt.serialize_iwt(perm), np.uint8)
        index = ssa.SampledSAIndex.deserialize(buf, n, 5)
        raw, at = gcx.upload(index, dev)
        words, pc = timed_pair(
            "gcx.unpack", lambda: gcx.unpack(raw, n, m, at),
            lambda: gcx.unpack_ref(raw, n, m, at), 10, err, times,
            f"gcx.unpack {label}")
        inc = scan.cumsum_i32(pc)
        key = f"gcx.decode {label}"
        got = timed_pair(
            "gcx.decode", lambda: gcx.decode(words, inc, n, m),
            lambda: gcx.decode_ref(words, inc, n, m), 10, err, times, key)
        check(np.array_equal(got[0].cpu().numpy(), perm)
              and np.array_equal(got[2].cpu().numpy(), rows),
              f"{key}: the decode differs from the values and rows written")
        # unpack: the streams read once, words and popcounts written; decode:
        # the words and ranks read once, 12 bytes a value and the mark's
        # prefixes written
        bounds[f"gcx.unpack {label}"] = raw.numel() + 8 * words.numel()
        bounds[key] = 8 * words.numel() + 12 * m + 4 * ((n + 31) // 32)
        lifts, hosts = [], []
        for _ in range(5):
            fresh = ssa.SampledSAIndex.deserialize(buf, n, 5)
            lifts.append(wall(lambda: gcx.lift(fresh, dev))[1])
            fresh = ssa.SampledSAIndex.deserialize(buf, n, 5)
            t0 = time.perf_counter()
            np.sort(fresh.sampled_rows()[0])
            _ = fresh.wsa.perm, fresh.find(np.int64(0))
            hosts.append(time.perf_counter() - t0)
        print(f"# {key}: m {m}, n {n}, {int(m).bit_length()} levels; bytes "
              f"bounds unpack {bound_ms(bounds[f'gcx.unpack {label}']):.4f} "
              f"ms, decode {bound_ms(bounds[key]):.4f} ms; lift (the stored "
              f"bytes up, unpack, scan, decode, one sync) "
              f"{1e3 * min(lifts):.3f}-{1e3 * max(lifts):.3f} ms on the host "
              f"clock, the host decode it replaced (sampled_rows, the sort, "
              f"wsa.perm, the wrap row) {1e3 * min(hosts):.3f}-"
              f"{1e3 * max(hosts):.3f} ms")
    return err, times, bounds


def hswt_blocks(dev):
    """(label, BWT, tree read back from its bytes) at the benchmark's two
    lift shapes: hg38's chr21 block (46,709,983 bases, 14% N: `chrom`) and
    a Swiss-Prot block (61 records of ~389 residues); the BWT by the
    card's suffix sort, the tree by the host's build."""
    import numpy as np
    from gecoz_tpu_torch.index.hswt import HSWT
    from gecoz_tpu_torch.index.shape import HSWTShape
    from gecoz_tpu_torch.ops.sa_device import suffix_array_device
    rng = np.random.default_rng(31)
    dna = chrom(rng, 46_709_982, 40)
    prot = residues(rng, 23_725)
    prot[rng.choice(23_724, 60, replace=False)] = 0   # 61 records
    for label, text in (("hg38", np.append(dna, 0).astype(np.uint8)),
                        ("swissprot", np.append(prot, 0).astype(np.uint8))):
        _, bwt = suffix_array_device(text, with_bwt=True, device=dev)
        bwt = bwt.cpu().numpy()
        tree = HSWT.build(bwt, HSWTShape.from_counts(
            np.bincount(bwt, minlength=256)))
        yield label, bwt, HSWT.read(np.frombuffer(tree.serialize(),
                                                  np.uint8), len(bwt))


def phase_hswt(dev):
    """Phase 16: the wavelet tree's decode kernels against their plain
    versions at the benchmark's two lift shapes, timed; the lift beside the
    host decode it replaced."""
    import numpy as np
    from gecoz_tpu_torch.ops import hswt_device, scan
    err, times, bounds = {}, {}, {}
    for label, bwt, tree in hswt_blocks(dev):
        n = len(bwt)
        raw, nodes, total = hswt_device.upload(tree, dev)
        words, pc = timed_pair(
            "hswt.unpack", lambda: hswt_device.unpack(raw, nodes, total),
            lambda: hswt_device.unpack_ref(raw, nodes, total), 10, err,
            times, f"hswt.unpack {label}")
        inc = scan.cumsum_i32(pc)
        key = f"hswt.decode {label}"
        got = timed_pair(
            "hswt.decode",
            lambda: hswt_device.decode(raw, words, inc, nodes, n),
            lambda: hswt_device.decode_ref(raw, words, inc, nodes, n), 10,
            err, times, key)
        check(np.array_equal(got[0].cpu().numpy(), bwt),
              f"{key}: the decode differs from the BWT")
        # unpack: the streams read once, words and popcounts written;
        # decode: the words and their ranks read once, a byte a position
        # written
        streams = len(tree.stored_streams()[0])
        bounds[f"hswt.unpack {label}"] = streams + 8 * total
        bounds[key] = 8 * total + n
        lifts, hosts = [], []
        for _ in range(5 if label == "hg38" else 20):
            lifts.append(wall(lambda: hswt_device.lift(tree, dev))[1])
        for _ in range(2 if label == "hg38" else 20):
            t0 = time.perf_counter()
            host = tree.decode_bwt()
            hosts.append(time.perf_counter() - t0)
        check(np.array_equal(host, bwt), f"{key}: decode_bwt differs")
        print(f"# {key}: n {n}, {nodes} nodes, {streams} stream bytes, "
              f"{total} words, deepest code "
              f"{int(tree.shape.bit_lengths.max())} bits; bytes bounds unpack "
              f"{bound_ms(bounds[f'hswt.unpack {label}']):.4f} ms, decode "
              f"{bound_ms(bounds[key]):.4f} ms, the lift's (streams in, a "
              f"byte a position out) {bound_ms(streams + n):.4f} ms; lift "
              f"(the streams up, unpack, scan, decode, one sync) "
              f"{1e3 * min(lifts):.3f}-{1e3 * max(lifts):.3f} ms on the host "
              f"clock, the host's decode_bwt it replaced "
              f"{1e3 * min(hosts):.3f}-{1e3 * max(hosts):.3f} ms")
    return err, times, bounds


def locate_reads(blk, rows) -> int:
    """Random 4-byte reads the locate walks from `rows` make: a plain replay
    of `lfwalk.locate_walks_ref` on the card counting, at every step, the
    walks still live (one lf_tab row each), then for each walk that reached
    a sampled row its mark word, its prefix and its ssa_perm entry."""
    import torch
    tab, idx = blk.lf_tab, rows.long()
    live = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    reads = 0
    for _ in range((1 << blk.sf) + 1):
        reads += int(live.sum())
        v = tab[idx]
        live = live & (v >= 0)                 # bit 31: a sampled row
        nxt = ((v >> 8) & 0x7FFFFF) if blk.lf_packed else (v & 0x7FFFFFFF)
        idx = torch.where(live, nxt.long(), idx)
    return reads + 3 * int((~live).sum())


def search_sectors(blk, pats, lens):
    """Distinct 32-byte sectors the searches' occ lookups read, in the two
    layouts: the flat planes (a word and its prefix, one sector in each of
    two arrays) and the rank blocks (one block).  Returns ((flat, blocks)
    summed over the patterns of each pattern's distinct sectors, (flat,
    blocks) distinct over the whole batch).  A plain replay of the search on
    the card: the seed from the plain version on the last k columns, then
    every live step's (sp, ep) recorded, as the kernel runs it."""
    import torch
    from gecoz_tpu_torch.ops import fmsearch
    B, L = pats.shape
    k = fmsearch._seed_k(blk, L)
    if k:
        sp, ep = fmsearch.backward_search_ref(
            blk, pats[:, L - k:].contiguous(), lens.clamp(max=k))
        start = L - k
    else:
        last = pats[:, L - 1].long()
        sp, ep = blk.c[last], blk.c[last + 1] - 1
        start = L - 1
    wb = -(-blk.n // fmsearch.BLOCK_CHARS)
    flat, blocks = [], []
    for col in range(start - 1, -1, -1):
        ch = pats[:, col].long()
        row = blk.sym_plane[ch].long()
        live = (col >= L - lens) & (sp <= ep) & (row >= 0)
        for pos in (sp - 1, ep):
            use = live & (pos >= 0)
            p = pos.clamp(min=0).long()
            flat.append(torch.where(use, (row * blk.W + (p >> 5)) >> 3, -1))
            blk_id = row * wb + p // fmsearch.BLOCK_CHARS
            blocks.append(torch.where(use, blk_id, -1))
        cs = blk.c[ch]
        act = (col >= L - lens) & (sp <= ep)
        nsp = cs + fmsearch.occ_inclusive(blk, ch, sp - 1)
        nep = cs + fmsearch.occ_inclusive(blk, ch, ep) - 1
        sp, ep = torch.where(act, nsp, sp), torch.where(act, nep, ep)

    def distinct(ids):
        if not ids:
            return 0, 0
        v = torch.stack(ids, 1).sort(1).values
        new = (v[:, 1:] != v[:, :-1]) & (v[:, 1:] >= 0)
        every = torch.unique(v)
        return (int(new.sum() + (v[:, 0] >= 0).sum()),
                int((every >= 0).sum()))
    # the flat layout reads the same sector index in both arrays
    (f, uf), (b, ub) = distinct(flat), distinct(blocks)
    return (2 * f, b), (2 * uf, ub)


def make_queries(rng, path, count=1000):
    """`count` reads of 16-150 bases from the N-free stretches of the smoke
    genome (a read inside an N run would match up to a million places): a
    quarter with one base changed, a quarter with an N.  Returns a 12-mer
    of chr1 for the single-pattern verbs."""
    recs = make_genome()

    def window(seq, ln):
        while True:
            a = int(rng.integers(0, len(seq) - ln))
            r = seq[a:a + ln].copy()
            if not (r == ord("N")).any():
                return r
    with open(path, "wb") as f:
        for i in range(count):
            name, seq = recs[int(rng.integers(0, len(recs)))]
            ln = int(rng.integers(16, 151))
            r = window(seq, ln)
            if i % 4 == 1:
                j = int(rng.integers(0, ln))
                r[j] = b"ACGT"[(b"ACGT".find(bytes(r[j:j + 1])) + 1) % 4]
            elif i % 4 == 2:
                r[int(rng.integers(0, ln))] = ord("N")
            f.write(b">read%d|%s\n" % (i, name.split()[0].encode())
                    + r.tobytes() + b"\n")
    return window(recs[0][1], 12).tobytes().decode()


def cli_out(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"{argv}: exit code {rc}")
    return buf.getvalue()


def occurrences(seq: bytes, pat: bytes) -> list[int]:
    """Every start of `pat` in `seq`, overlapping ones included."""
    out, i = [], seq.find(pat)
    while i >= 0:
        out.append(i)
        i = seq.find(pat, i + 1)
    return out


def match_text(gcz, hits, header=None, positions=True) -> str:
    """What the count (`-c`) and locate (`-s [header] PATTERN`) verbs must
    write for a pattern whose starts are `hits` ({sequence header: starts,
    ascending}, from a plain search of the genome): blocks in file order,
    sequences in block order, `>header found : N`, then with `positions`
    one start a line."""
    from gecoz_tpu_torch.formats.gcz import GecozReader
    out = []
    for bh in GecozReader(gcz).headers:
        for h in bh.headers:
            if hits.get(h) and header in (None, h):
                out.append(f">{h} found : {len(hits[h])}\n")
                if positions:
                    out += [f"{p}\n" for p in hits[h]]
    return "".join(out)


def phase_search(dev, workdir, port_gcz):
    """Phase 9: GFF3 search through the port's CLI on the card against its
    host tier; count, locate and extract against the genome itself.

    Both tiers share `driver.gff_search`'s query parsing, reverse
    complement, row order and `_gff_row`; only the per-block find differs.
    So the host tier checks the card's search and locate results; the rows
    as emitted are held against the reference CLI's on the CPU
    (tests/test_torch_backend.py)."""
    import numpy as np
    import torch
    from gecoz_tpu_torch import cli
    from gecoz_tpu_torch.formats.gcz import GecozReader
    from gecoz_tpu_torch.utils import metrics

    qf = os.path.join(workdir, "queries.fa")
    pat = make_queries(np.random.default_rng(29), qf)
    nblocks = len(GecozReader(port_gcz).headers)
    t0 = time.perf_counter()
    want = cli_out(cli.main, ["-i", port_gcz, "-s", qf, "--backend", "numpy"])
    print(f"# port CLI -s queries.fa --backend numpy (the host tier: "
          f"FMIndex.find, 2000 patterns x {nblocks} blocks): "
          f"{time.perf_counter() - t0:.2f} s, {want.count(chr(10))} rows")
    launches = {}
    for label, budget in (("default budget", None), ("budget 1 B", "1")):
        if budget:
            os.environ["GECOZ_HBM_BYTES"] = budget
        metrics.reset()
        r0 = rusage()
        reset_counts()                        # the search path starts
        t0 = time.perf_counter()
        got = cli_out(cli.main, ["-i", port_gcz, "-s", qf, "--device",
                                 str(dev)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[label] = counts()            # ... and ends here
        os.environ.pop("GECOZ_HBM_BYTES", None)
        check(got == want, f"GFF3 rows ({label}) differ from the host "
              "tier's")
        st = metrics.stats()
        q = 2000 * nblocks
        card = st["search.batch"].seconds + st["search.locate"].seconds
        print(f"# port CLI -s queries.fa ({label}): {secs:.2f} s, "
              f"{len(got)} bytes byte-identical to the host tier's; "
              f"{q} pattern-block searches, {q / card:.0f} queries/s over "
              f"search.batch + search.locate")
        print_rusage(f"port CLI -s queries.fa ({label})", r0)
        print_phases("search.")
        print(f"# launches during the search run ({label}): "
              f"{json.dumps(launches[label])}")
    check(launches["default budget"]["fm_search"] > 0, "fm_search was not "
          "launched by the search path")
    check(launches["budget 1 B"]["lf_walk.locate"] > 0, "lf_walk.locate was "
          "not launched by the search path past the budget")

    from gecoz_tpu_torch.formats.fasta import iter_fasta
    from gecoz_tpu_torch.tools.batch_search import find_batched
    from gecoz_tpu_torch.tools.driver import _COMPLEMENT
    pats = []
    for q in iter_fasta(qf):
        seq = bytes(q.data)
        pats += [seq, seq[::-1].translate(_COMPLEMENT)]
    reader = GecozReader(port_gcz)
    big = max(reader.headers, key=lambda h: h.len)
    fm = reader.read(big)
    profile_busy(lambda: find_batched(fm, pats, dev),
                 f"GFF3 search of the {big.len / MiB:.1f} MiB block (the "
                 "lift, its BWT decoded on the card, k-mer and locate "
                 "tables, search, locate)",
                 ours=("fm_search", "lf_locate", "scan_onepass"))
    del fm

    # count, locate and extract: the host verbs against the genome's bytes
    genome = {name: seq.tobytes() for name, seq in make_genome()}
    p = pat.encode()
    hits = {h: occurrences(g, p) for h, g in genome.items()}
    for argv, want_text in (
            (["-c", pat], match_text(port_gcz, hits, positions=False)),
            (["-s", pat], match_text(port_gcz, hits)),
            (["-s", "chr2", pat], match_text(port_gcz, hits, "chr2"))):
        got = cli_out(cli.main, ["-i", port_gcz] + argv)
        check(got == want_text, f"{argv}: the output differs from the "
              "genome's occurrences written as the verbs write them")
    a = os.path.join(workdir, "a.seq")
    cli_out(cli.main, ["-i", port_gcz, "-o", a, "chr2", "1000", "50000"])
    check(open(a, "rb").read() == genome["chr2"][1000:50000],
          "range extract differs from the genome")
    print(f"# -c, -s PATTERN, -s chr2 PATTERN ({sum(map(len, hits.values()))}"
          " occurrences of a 12-mer) and range extract: byte for byte equal "
          "to a plain search and slice of the genome")
    return launches


# Swiss-Prot's amino-acid composition (%; UniProtKB/Swiss-Prot release
# statistics) in AA's order; X (an unknown residue) at 0.01%
AA = b"ACDEFGHIKLMNPQRSTVWY"
AA_PERCENT = (8.25, 1.37, 5.45, 6.75, 3.86, 7.07, 2.27, 5.96, 5.84, 9.66,
              2.42, 4.06, 4.70, 3.93, 5.53, 6.56, 5.34, 6.87, 1.08, 2.92)
TITIN = 35213           # Swiss-Prot's longest entry (Q8WZ42) caps a block
SP_RECORDS = 4000       # records of the Swiss-Prot-shaped FASTA (PERF.md:
                        # the block planner is superlinear in records)
SP_NUMPY_PEPTIDES = 50  # peptides also held against the host tier's find


def residues(rng, n: int):
    """n residues at Swiss-Prot's composition, X included."""
    import numpy as np
    p = np.array(AA_PERCENT + (0.01,))
    return rng.choice(np.frombuffer(AA + b"X", np.uint8), size=n,
                      p=p / p.sum())


def swissprot_records(rng, count: int):
    """`count` records shaped like Swiss-Prot's: lognormal lengths of mean
    ~360 residues (Swiss-Prot's mean length), one of titin's length, each
    starting with M."""
    import numpy as np
    lens = np.clip(rng.lognormal(5.69, 0.62, count).astype(np.int64), 2,
                   TITIN)
    lens[int(rng.integers(0, count))] = TITIN
    res = residues(rng, int(lens.sum()))
    offs = np.concatenate([[0], np.cumsum(lens)])
    res[offs[:-1]] = ord("M")
    return [(f"sp|Q{i:05d}|PRT{i}_SYNTH", res[offs[i]:offs[i + 1]])
            for i in range(count)]


def make_peptides(rng, recs, path, count: int) -> None:
    """`count` peptides of 8-50 residues drawn from records of 8 or more:
    a quarter with one residue changed, a quarter with an X."""
    with open(path, "wb") as f:
        i = 0
        while i < count:
            name, seq = recs[int(rng.integers(0, len(recs)))]
            if len(seq) < 8:
                continue
            ln = int(rng.integers(8, min(51, len(seq) + 1)))
            a = int(rng.integers(0, len(seq) - ln + 1))
            q = seq[a:a + ln].copy()
            if i % 4 == 1:
                q[int(rng.integers(0, ln))] = AA[int(rng.integers(0, 20))]
            elif i % 4 == 2:
                q[int(rng.integers(0, ln))] = ord("X")
            f.write(b">pep%d|%s\n" % (i, name.encode()) + q.tobytes()
                    + b"\n")
            i += 1


def gff_plain(gcz, recs, qf) -> str:
    """The GFF3 rows a plain byte search of the records gives, in the
    verbs' row order (query, strand, block, sequence, position), written
    by the verbs' row writer."""
    import numpy as np
    from gecoz_tpu_torch.formats.fasta import iter_fasta
    from gecoz_tpu_torch.formats.gcz import GecozReader
    from gecoz_tpu_torch.tools.driver import _COMPLEMENT, _gff_row
    text = b"\n".join(s.tobytes() for _, s in recs)
    starts = np.cumsum([0] + [len(s) + 1 for _, s in recs])
    blocks = [bh.headers for bh in GecozReader(gcz).headers]
    out = io.StringIO()
    for q in iter_fasta(qf):
        fwd = bytes(q.data).replace(b"U", b"T")
        for pat, reverse in ((fwd, False),
                             (fwd[::-1].translate(_COMPLEMENT), True)):
            hits: dict[str, list[int]] = {}
            for at in occurrences(text, pat):
                r = int(np.searchsorted(starts, at, side="right")) - 1
                hits.setdefault(recs[r][0], []).append(at - int(starts[r]))
            for headers in blocks:
                for h in headers:
                    for p in hits.get(h, ()):
                        _gff_row(out, h, p, len(fwd), reverse, q.header)
    return out.getvalue()


def peak_of(dev, fn):
    """(fn's result, its peak device bytes above what was allocated
    before it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(dev) - base


def cli_round_trip(dev, workdir, label, fa, recs, qf, host_tier: bool,
                   numpy_qf=None):
    """A FASTA through the port's CLI on the card: compress, decompress
    (md5 per record against `recs`), GFF3 search of `qf` (rows against a
    plain byte search); with `host_tier` the files and the decompress
    held against the CLI's host tier (`--backend native -t 4`) and the
    rows of `numpy_qf` against its `--backend numpy`.  Returns the
    launches of the decompress and search runs."""
    import torch
    from gecoz_tpu_torch import cli
    from gecoz_tpu_torch.utils import metrics
    total = sum(len(s) for _, s in recs)
    gcz = os.path.join(workdir, f"{label}.gcz")
    runs = {}

    def run(what, argv, stdout=False):
        metrics.reset()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        r0 = rusage()
        reset_counts()                        # the path starts
        t0 = time.perf_counter()
        out = (cli_out(cli.main, argv + ["--device", str(dev)]) if stdout
               else cli.main(argv + ["--device", str(dev)]))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs[what] = counts()                 # ... and ends here
        check(stdout or out == 0, f"{label}: port CLI {what} exit code {out}")
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"# {label}: port CLI {what} on the card: {secs:.2f} s, "
              f"{total / 1e6 / secs:.2f} MB/s; peak device memory "
              f"{peak / 2**30:.3f} GiB = {peak / total:.1f} B/char")
        print_rusage(f"{label}, {what}", r0)
        print_phases()
        print(f"# launches during the {label} {what} run: "
              f"{json.dumps(runs[what])}")
        return out

    run("compress", ["-i", fa, "-o", gcz])
    back = os.path.join(workdir, f"{label}.back.fa")
    run("decompress", ["-i", gcz, "-o", back, "-t", "4"])
    want = {h.split()[0]: hashlib.md5(s.tobytes()).hexdigest()
            for h, s in recs}
    check(md5_records(back) == want, f"{label}: decompressed records differ "
          "from the input")
    check(runs["decompress"]["lf_walk.decode.lfk4"] > 0, f"{label}: the "
          "decompress path launched no lfk4 decode walk")
    print(f"# {label}: md5 equal to the input for all {len(want)} records")
    if host_tier:
        host = os.path.join(workdir, f"{label}.host.gcz")
        t0 = time.perf_counter()
        check(cli.main(["-i", fa, "-o", host, "--backend", "native", "-t",
                        "4"]) == 0, f"{label}: host tier compress failed")
        for ext in ("gcz", "gcx"):
            a = open(gcz[:-3] + ext, "rb").read()
            check(a == open(host[:-3] + ext, "rb").read(), f"{label}: .{ext} "
                  "differs from the host tier's")
        hback = os.path.join(workdir, f"{label}.host.fa")
        check(cli.main(["-i", gcz, "-o", hback, "--backend", "native", "-t",
                        "4"]) == 0, f"{label}: host tier decompress failed")
        check(open(back, "rb").read() == open(hback, "rb").read(),
              f"{label}: the card's decompress differs from the host tier's")
        print(f"# {label}: .gcz/.gcx and the decompressed FASTA "
              "byte-identical to the host tier's (--backend native -t 4: "
              f"{time.perf_counter() - t0:.2f} s for both)")
    rows = run("search", ["-i", gcz, "-s", qf], stdout=True)
    check(rows == gff_plain(gcz, recs, qf), f"{label}: GFF3 rows differ from "
          "a plain byte search of the records")
    check(runs["search"]["fm_search"] > 0, f"{label}: fm_search was not "
          "launched by the search path")
    print(f"# {label}: {rows.count(chr(10))} GFF3 rows equal to a plain byte "
          "search of the records, written as the verbs write them")
    if numpy_qf:
        t0 = time.perf_counter()
        want_rows = cli_out(cli.main, ["-i", gcz, "-s", numpy_qf,
                                       "--backend", "numpy"])
        secs = time.perf_counter() - t0
        got = cli_out(cli.main, ["-i", gcz, "-s", numpy_qf, "--device",
                                 str(dev)])
        check(got == want_rows, f"{label}: GFF3 rows differ from the host "
              "tier's (--backend numpy)")
        print(f"# {label}: GFF3 rows of {numpy_qf.rsplit('/', 1)[-1]} "
              f"({want_rows.count(chr(10))} rows) byte-identical to "
              f"--backend numpy's (FMIndex.find: {secs:.2f} s)")
    return runs


def phase_wide_alphabets(dev, workdir):
    """Phase 12: blocks of more than 16 symbols, which the reference's
    plane engine refuses and the port serves on the card."""
    import numpy as np
    import torch
    from gecoz_tpu_torch.formats.gcz import GecozReader, encode_block
    from gecoz_tpu_torch.ops import fmq, fmsearch, lfwalk
    from gecoz_tpu_torch.tools import batch_search, driver
    t_phase = time.perf_counter()
    rng = np.random.default_rng(41)
    err, times, bounds, rr_bounds = {}, {}, {}, {}

    # Swiss-Prot-shaped records through the CLI, against the host tier
    recs = swissprot_records(rng, SP_RECORDS)
    fa = os.path.join(workdir, "swissprot.fa")
    write_fasta(fa, recs)
    qf, qn = (os.path.join(workdir, n) for n in ("pep.fa", "pep_numpy.fa"))
    make_peptides(rng, recs, qf, 1000)
    with open(qf, "rb") as f:
        lines = f.read().split(b"\n")
    with open(qn, "wb") as f:
        f.write(b"\n".join(lines[:2 * SP_NUMPY_PEPTIDES]) + b"\n")
    print(f"# Swiss-Prot-shaped FASTA: {len(recs)} records, "
          f"{sum(len(s) for _, s in recs)} residues (mean "
          f"{np.mean([len(s) for _, s in recs]):.1f}, longest {TITIN}), 21 "
          "letters + the terminator")
    # the block planner (the reference's merge policy) is what bounds the
    # records a FASTA here may hold
    from gecoz_tpu_torch.formats.fasta import FastaSequence
    from gecoz_tpu_torch.tools.blocks import plan_blocks
    for count in (1000, 2000, SP_RECORDS):
        seqs = [FastaSequence(h, len(s), 0, False) for h, s in recs[:count]]
        t0 = time.perf_counter()
        planned = plan_blocks(seqs)
        print(f"# plan_blocks of {count} Swiss-Prot-shaped records: "
              f"{time.perf_counter() - t0:.2f} s on the host, "
              f"{len(planned)} blocks")
    sp_runs = cli_round_trip(dev, workdir, "swissprot", fa, recs, qf, True,
                             qn)
    reader = GecozReader(os.path.join(workdir, "swissprot.gcz"))
    t0 = time.perf_counter()
    nrec = sum(len(reader.read(h).e) for h in reader.headers)
    print(f"# swissprot: {len(reader.headers)} blocks (the planner caps a "
          "block at the longest record); the host FM-index's record ends "
          f"(`fm.e`, which the decompress reads for each record's bounds) of "
          f"all {nrec} records: {time.perf_counter() - t0:.2f} s on the host")
    del reader
    del recs

    # one 64 MiB protein record: the decompress path's lfk4 walk at size
    n = 64 * MiB
    big = residues(rng, n)
    recs = [("prot64m", big)]
    fa = os.path.join(workdir, "protein64.fa")
    write_fasta(fa, recs)
    qf = os.path.join(workdir, "pep64.fa")
    make_peptides(rng, recs, qf, 100)
    big_runs = cli_round_trip(dev, workdir, "protein64", fa, recs, qf, False)
    os.unlink(fa)
    reader = GecozReader(os.path.join(workdir, "protein64.gcz"))
    fm = reader.read(reader.headers[0])
    fm.hswt.stored_streams()                  # the tree's streams, once
    nb = fm.length
    for planes in (False, True):
        blk, peak = peak_of(dev, lambda: fmq.with_lf_table(
            fmq.device_block_from_fm(fm, dev, planes=planes)))
        text, peak2 = peak_of(dev, lambda: fmq.decode_text(blk))
        check(np.array_equal(text[:n].cpu().numpy(), big),
              "protein64: decode_text differs from the record")
        print(f"# protein64 decode at block level, planes={planes}: lift + "
              f"tables peak {peak / nb:.1f} B/char above the inputs, walk "
              f"{peak2 / nb:.1f} B/char; lfk_k {blk.lfk_k}")
        del text
    check(blk.lfk_k == 4, "protein64 decode rows")
    rate = 1 << blk.sf
    W = (nb - 1) // rate
    seeds = fmq._row_with_sa(blk, (torch.arange(W, dtype=torch.int32,
                                                device=dev) + 1) * rate)
    key = "lf_walk.decode lfk4 64 MiB"
    (want,) = timed_pair(
        "lf_walk.decode.lfk4",
        lambda: lfwalk.decode_walks(blk.lfk_tab, seeds, rate, "lfk4"),
        lambda: lfwalk.decode_walks_ref(blk.lfk_tab, seeds, rate, "lfk4"),
        10, err, times, key)
    check(np.array_equal(want.view(-1).cpu().numpy(), big[:W * rate]),
          "lfk4 walks differ from the record")
    del want
    # seeds in, 8-byte rows read (rate / 4 a walk), the text out
    reads = W * (rate // 4)
    bounds[key] = 4 * W + 8 * reads + W * rate
    rows8 = blk.lfk_tab.view(torch.int64).view(-1)
    idx = torch.randint(0, rows8.shape[0], (1 << 24,), device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
    ms = cuda_ms(lambda: torch.index_select(rows8, 0, idx), 10)
    per_ms8 = (1 << 24) / ms
    rr_bounds[key] = reads / per_ms8
    print(f"# random reads: torch.index_select of {1 << 24} random 8-byte "
          f"rows of a {rows8.numel() * 8 >> 20} MiB table: {ms:.4f} ms = "
          f"{per_ms8 / 1e6:.2f} G rows/s; lfk4's {reads} row reads take "
          f"{rr_bounds[key]:.4f} ms at that rate (kernel "
          f"{times[key][0]:.4f} ms), bytes bound {bound_ms(bounds[key]):.4f}"
          f" ms; lfk4 table {blk.lfk_tab.numel() * 4 / nb:.0f} B/char")
    del blk, seeds, rows8, idx
    sblk, peak = peak_of(dev, lambda: batch_search.search_tables(fm, dev))
    planes = (sblk.plane_words.numel() + sblk.plane_pres.numel()) * 4
    print(f"# protein64 search tables at block level: peak {peak / nb:.1f} "
          f"B/char above the inputs; planes {planes / nb:.2f}"
          f", rank table {sblk.rank_blocks.numel() * 4 / nb:.2f} B/char; "
          f"k-mer table k {sblk.kmer_k}, {sblk.kmer_bits} bits, "
          f"{sblk.kmer_tab.shape[0]} rows")
    del sblk, fm, reader, big, recs

    # a 4 MiB block of all 256 byte values at block level
    n4 = 4 * MiB
    data = rng.integers(1, 256, n4).astype(np.uint8)
    cuts = np.sort(rng.choice(np.arange(1000, n4 - 1000), 3, replace=False))
    data[cuts] = 0
    data[-1] = 0
    heads = [f"bytes{i}" for i in range(4)]
    (gz, gx), secs = wall(lambda: encode_block(data, heads, device=dev))
    p256 = os.path.join(workdir, "all256.gcz")
    with open(p256, "wb") as f:
        f.write(gz)
    with open(p256[:-3] + "gcx", "wb") as f:
        f.write(gx)
    reader = GecozReader(p256)
    fm = reader.read(reader.headers[0])
    fm.hswt.stored_streams()
    print(f"# all256: a {n4}-byte block of 256 symbols encoded on the card "
          f"in {secs:.2f} s")
    reset_counts()
    text, peak = peak_of(dev, lambda: driver._device_decode(fm, dev))
    check(np.array_equal(text, data), "all256: the decode path differs from "
          "the block")
    check(lfwalk.DECODE_LAUNCHES["lfk4"] > 0, "all256: no lfk4 launch")
    print(f"# all256: driver._device_decode equal to the block; peak "
          f"{peak / n4:.1f} B/char; launches {json.dumps(counts())}")
    blk, peak = peak_of(dev, lambda: fmq.with_lf_table(
        fmq.device_block_from_fm(fm, dev, planes=True)))
    print(f"# all256: the decode lift with the planes: lift + tables peak "
          f"{peak / n4:.1f} B/char (planes "
          f"{(blk.plane_words.numel() + blk.plane_pres.numel()) * 4 / n4:.1f}"
          " B/char)")
    del blk
    sblk, peak = peak_of(dev, lambda: batch_search.search_tables(fm, dev))
    check(fmq.n_planes(sblk) == 256 and sblk.kmer_bits == 8, "all256 tables")
    print(f"# all256: search tables peak {peak / n4:.1f} B/char; rank table "
          f"{sblk.rank_blocks.numel() * 4 / n4:.1f} B/char; k-mer table k "
          f"{sblk.kmer_k}, {sblk.kmer_bits} bits, {sblk.kmer_tab.shape[0]} "
          "rows")
    pats = []
    for a, ln in zip(rng.integers(0, n4 - 64, 20000),
                     rng.integers(1, 40, 20000)):
        p = data[a:a + ln].tobytes()
        if 0 not in p:
            pats.append(p)
    pats += [rng.integers(1, 256, 6).astype(np.uint8).tobytes()
             for _ in range(1000)]
    arr, ln = batch_search.pack_patterns(pats)
    a, lens = torch.from_numpy(arr).to(dev), torch.from_numpy(ln).to(dev)
    sp, ep = timed_pair(
        "fm_search", lambda: fmq.search_batch(sblk, a, lens, ln),
        lambda: fmsearch.backward_search_ref(sblk, a, lens), 5, err, times,
        "fm_search all256 4 MiB")
    cnt = (ep - sp + 1).clamp(min=0)
    check(bool((cnt[:len(pats) - 1000] > 0).all()), "all256: a pattern "
          "drawn from the block was not found")
    rows = torch.cat([torch.arange(int(s), int(e) + 1, device=dev)
                      for s, e in zip(sp[:200].tolist(), ep[:200].tolist())
                      if e >= s]).to(torch.int32)
    vals = fmq.locate_batch(sblk, rows).cpu().numpy()
    owner = np.repeat(np.arange(200), np.maximum(
        (ep[:200] - sp[:200] + 1).cpu().numpy(), 0))
    check(all(data[v:v + len(pats[o])].tobytes() == pats[o]
              for v, o in zip(vals, owner)), "all256: a located hit differs "
          "from its pattern")
    print(f"# all256: {len(pats)} patterns searched (K1 bit-exact against "
          f"plain), {int(cnt.sum())} hits; the first 200 patterns' "
          f"{len(vals)} hits located at their pattern's bytes")
    del sblk, a, lens, sp, ep
    torch.cuda.empty_cache()
    print(f"# phase 12 (blocks past 16 symbols): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return sp_runs, big_runs, err, times, bounds, rr_bounds


# phase 13: files of short blocks (ROADMAP C5, C6)
SHORT_BAND = range(1, 121)     # one-record block lengths (the terminator
                               # included) at the default rate, 32
SHORT_FILES = (("probes_50x40", 50, 40), ("reads_100x36", 100, 36),
               ("reads_100x100", 100, 100), ("reads_100x101", 100, 101))
SHORT_KERNEL_BLOCKS = ("band2", "band33", "band41", "band64", "band65",
                       "band97", "band120", "reads_100x101")
SHORT_KERNELS = ("fm_search", "lf_walk.decode", "lf_walk.locate")


def short_queries(rng, recs, path) -> None:
    """Queries of a short-block file: a homopolymer, a pattern longer than
    any block (K1 past the block), and six substrings of the records of
    1-24 bases."""
    seqs = [s for _, s in recs if len(s)]
    longest = max((len(s) for s in seqs), default=0)
    out = [(b"homo", b"AAAAAAAA"), (b"long", b"ACGT" * (longest // 4 + 2))]
    for i in range(6 if seqs else 0):
        s = seqs[int(rng.integers(0, len(seqs)))]
        ln = int(rng.integers(1, min(24, len(s)) + 1))
        a = int(rng.integers(0, len(s) - ln + 1))
        out.append((b"q%d" % i, s[a:a + ln].tobytes()))
    with open(path, "wb") as f:
        f.write(b"".join(b">" + h + b"\n" + q + b"\n" for h, q in out))


def short_file(dev, workdir, label, recs, rng, runs) -> str:
    """One short-block file through the port's CLI on the card: its
    .gcz/.gcx against the CLI's host tier (`--backend native`, the host
    library's SA-IS), its decompress against the records, GFF3 rows at the
    default budget (locate table) and at 1 B (LF walks) against a plain
    byte search, and `--check --deep`.  Each card run's launches (counts
    set to 0 just before it, read just after) are added to `runs`."""
    import torch
    from gecoz_tpu_torch import cli
    from gecoz_tpu_torch.formats.fasta import iter_fasta
    fa, qf, gcz, host, back = (os.path.join(workdir, f"{label}.{e}") for e in
                               ("fa", "q.fa", "gcz", "host.gcz", "back.fa"))
    write_fasta(fa, recs)
    short_queries(rng, recs, qf)

    def on_card(argv, stdout=False, budget=None):
        if budget:
            os.environ["GECOZ_HBM_BYTES"] = budget
        reset_counts()                        # the path starts
        try:
            argv = argv + ["--device", str(dev)]
            out = cli_out(cli.main, argv) if stdout else cli.main(argv)
            torch.cuda.synchronize()
        finally:
            os.environ.pop("GECOZ_HBM_BYTES", None)
        for k, v in counts().items():         # ... and ends here
            runs[k] = runs.get(k, 0) + v
        check(stdout or out == 0, f"{label}: port CLI {argv} exit code {out}")
        return out

    on_card(["-i", fa, "-o", gcz])
    check(cli.main(["-i", fa, "-o", host, "--backend", "native"]) == 0,
          f"{label}: host tier compress failed")
    for ext in ("gcz", "gcx"):
        check(open(gcz[:-3] + ext, "rb").read()
              == open(host[:-3] + ext, "rb").read(),
              f"{label}: .{ext} differs from the host tier's")
    on_card(["-i", gcz, "-o", back])
    got = sorted((r.header, bytes(r.data)) for r in iter_fasta(back))
    check(got == sorted((h, s.tobytes()) for h, s in recs),
          f"{label}: decompressed records differ from the input")
    want = gff_plain(gcz, recs, qf)
    for budget in (None, "1"):
        check(on_card(["-i", gcz, "-s", qf], True, budget) == want,
              f"{label}: GFF3 rows (budget {budget}) differ from a plain "
              "byte search")
    lines = cli_out(cli.main, ["-i", gcz, "--check", "--deep"]).splitlines()
    check(bool(lines) and all(x.endswith(": ok") for x in lines),
          f"{label}: --check --deep: {lines}")
    return gcz


def short_kernels(dev, gcz, label, err, times) -> None:
    """K2's decode (fused rows, and the per-step rows of the tail walk)
    and locate (every row of the block) and K1 (the file's queries on
    both strands) on the first block of `gcz`, each against its plain
    version, bit-exact, and timed."""
    import torch
    from gecoz_tpu_torch.formats.fasta import iter_fasta
    from gecoz_tpu_torch.formats.gcz import GecozReader
    from gecoz_tpu_torch.ops import fmq, fmsearch, lfwalk
    from gecoz_tpu_torch.tools import batch_search
    from gecoz_tpu_torch.tools.driver import _COMPLEMENT
    reader = GecozReader(gcz)
    fm = reader.read(reader.headers[0])
    n = fm.length
    blk = fmq.with_lf_table(fmq.device_block_from_fm(fm, dev, planes=False))
    rate = 1 << blk.sf
    W, tail = (n - 1) // rate, (n - 1) % rate
    tag = f"short {label} n={n}"
    if W:
        seeds = fmq._row_with_sa(blk, (torch.arange(
            W, dtype=torch.int32, device=dev) + 1) * rate)
        mode, cmap = f"lfk{blk.lfk_k}", fmq.code_map(blk)
        timed_pair("lf_walk.decode",
                   lambda: lfwalk.decode_walks(blk.lfk_tab, seeds, rate, mode,
                                               code_map=cmap),
                   lambda: lfwalk.decode_walks_ref(blk.lfk_tab, seeds, rate,
                                                   mode, code_map=cmap),
                   5, err, times, f"lf_walk.decode {mode} {tag}")
    if tail:
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        mode = "packed" if blk.lf_packed else "plain"
        timed_pair("lf_walk.decode",
                   lambda: lfwalk.decode_walks(blk.lf_tab, zero, tail, mode,
                                               bwt=blk.bwt),
                   lambda: lfwalk.decode_walks_ref(blk.lf_tab, zero, tail,
                                                   mode, bwt=blk.bwt),
                   5, err, times, f"lf_walk.decode {mode} tail {tag}")
    sblk = fmq.with_rank_blocks(fmq.with_kmer_table(
        fmq.device_block_from_fm(fm, dev)))
    lblk = fmq.with_lf_table(sblk, decode=False)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    args = (lblk.lf_tab, rows, lblk.mark_words, lblk.mark_pre, lblk.ssa_perm,
            lblk.sf, lblk.lf_packed)
    vals = timed_pair("lf_walk.locate", lambda: lfwalk.locate_walks(*args),
                      lambda: lfwalk.locate_walks_ref(*args), 5, err, times,
                      f"lf_walk.locate {tag}")[0]
    check(sorted(vals.tolist()) == list(range(n)), f"{tag}: located rows are "
          "not a permutation of the block")
    pats = []
    for q in iter_fasta(gcz[:-3] + "q.fa"):
        seq = bytes(q.data)
        pats += [seq, seq[::-1].translate(_COMPLEMENT)]
    arr, ln = batch_search.pack_patterns(pats)
    a, lens = torch.from_numpy(arr).to(dev), torch.from_numpy(ln).to(dev)
    timed_pair("fm_search", lambda: fmq.search_batch(sblk, a, lens, ln),
               lambda: fmsearch.backward_search_ref(sblk, a, lens), 5, err,
               times, f"fm_search {len(pats)}x{arr.shape[1]} {tag}")


def phase_short_blocks(dev, workdir):
    """Phase 13: files of short blocks (reads, probes, primers), whose
    sampling factor the reference's reader derives wrong (ROADMAP C5) and
    whose suffix arrays its SA-IS gets wrong (C6): one-record files of
    every block length in SHORT_BAND and four files of short reads and
    probes, each record a block of its own, through the port's CLI on the
    card against ground truth; then the query kernels at these shapes
    against their plain versions.  Returns the launches of the CLI runs
    and the kernels' errors."""
    import numpy as np
    t_phase = time.perf_counter()
    rng = np.random.default_rng(43)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    files = [(f"band{n}", [("r1", rng.choice(acgt, n - 1))])
             for n in SHORT_BAND]
    files += [(label, [(f"{label[:5]}{i}", rng.choice(acgt, ln))
                       for i in range(count)])
              for label, count, ln in SHORT_FILES]
    runs, err, times, paths = {}, {}, {}, {}
    for label, recs in files:
        t0 = time.perf_counter()
        paths[label] = short_file(dev, workdir, label, recs, rng, runs)
        if not label.startswith("band"):
            print(f"# {label}: compress, decompress, GFF3 at two budgets and "
                  f"--check --deep in {time.perf_counter() - t0:.2f} s")
    print(f"# short blocks: {len(files)} files ({len(SHORT_BAND)} one-record "
          f"files of block lengths {SHORT_BAND[0]}-{SHORT_BAND[-1]} at rate "
          "32, four files of short reads and probes) through the port's CLI "
          "on the card: .gcz/.gcx equal to the host tier's, decompressed "
          "records equal to the input, GFF3 rows at both budgets equal to a "
          "plain byte search, --check --deep ok; "
          f"{time.perf_counter() - t_phase:.1f} s")
    print(f"# launches during the short-block runs: {json.dumps(runs)}")
    for name in SHORT_KERNELS:
        check(runs.get(name, 0) > 0, f"{name} was not launched by the "
              "short-block runs")
    for label in SHORT_KERNEL_BLOCKS:
        short_kernels(dev, paths[label], label, err, times)
    print(f"# phase 13 (short blocks): {time.perf_counter() - t_phase:.1f} s")
    return runs, err


# phase 14: inputs the CLI refuses or answers on purpose (ROADMAP C7-C9)
def phase_cli_inputs(dev, workdir):
    """Phase 14: empty query patterns through the port's CLI on the card
    (C7: no row for them, the other rows the host tier's, an all-empty
    file searching nothing), and the refusals: an empty `-c` pattern, a
    `--sampling` that is no power of 2 (C8) and a negative range extract
    coordinate (C9) exit 1 and write nothing."""
    import numpy as np
    import torch
    from gecoz_tpu_torch import cli
    from gecoz_tpu_torch.formats.gcz import GecozReader
    t_phase = time.perf_counter()
    rng = np.random.default_rng(47)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    recs = [("c1|x", rng.choice(acgt, 4000)), ("c2", rng.choice(acgt, 1500)),
            ("c3|x", rng.choice(acgt, 1200))]
    fa, gcz, mixed, empty = (os.path.join(workdir, f"inputs.{e}") for e in
                             ("fa", "gcz", "q.fa", "empty.fa"))
    write_fasta(fa, recs)
    check(cli.main(["-i", fa, "-o", gcz, "--device", str(dev)]) == 0,
          "inputs: compress failed")
    blocks = [h.headers for h in GecozReader(gcz).headers]
    check(["c2", "c3|x"] in blocks, f"inputs: blocks {blocks}: no block "
          "of two records, whose record ends an empty pattern used to hit")
    q, r = recs[1][1][10:15].tobytes(), recs[0][1][50:60].tobytes()
    with open(mixed, "wb") as f:
        f.write(b">e\n\n>q\n" + q + b"\n>f\n\n>r|note\n" + r + b"\n")
    with open(empty, "wb") as f:
        f.write(b">e\n\n>f\n\n")

    def on_card(qf):
        reset_counts()                        # the search starts
        rows = cli_out(cli.main, ["-i", gcz, "-s", qf, "--device", str(dev)])
        torch.cuda.synchronize()
        return rows, counts()                 # ... and ends here
    rows, launches = on_card(mixed)
    want = cli_out(cli.main, ["-i", gcz, "-s", mixed, "--backend", "numpy"])
    check(rows == want, "inputs: GFF3 rows of the mixed query file differ "
          "from the host tier's")
    for row in rows.splitlines():
        start, end = map(int, row.split("\t")[3:5])
        check(1 <= start <= end, f"inputs: malformed GFF3 row {row!r}")
    check("\tID=q\n" in rows and "ID=e" not in rows and "ID=f" not in rows,
          "inputs: rows for the empty records, or none for q")
    check(launches["fm_search"] > 0, "inputs: fm_search was not launched")
    rows_e, none = on_card(empty)
    check(rows_e == "" and not any(none.values()), f"inputs: the all-empty "
          f"query file gave {rows_e.count(chr(10))} rows and launches {none}")

    def refused(argv, path):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(argv + ["--device", str(dev)])
        check(rc == 1 and out.getvalue() == "" and not os.path.exists(path),
              f"inputs: {argv}: exit code {rc}, {len(out.getvalue())} bytes "
              f"out, {path} written: {os.path.exists(path)}")
    bad = os.path.join(workdir, "inputs.bad.gcz")
    refused(["-i", gcz, "-c", ""], bad)
    for rate in ("10", "0"):
        refused(["-i", fa, "-o", bad, "--sampling", rate], bad)
        check(not os.path.exists(bad[:-3] + "gcx"), "inputs: --sampling "
              f"{rate} left a .gcx")
    seq = os.path.join(workdir, "inputs.seq")
    refused(["-i", gcz, "-o", seq, "c2", "-5", "10"], seq)
    print(f"# inputs (ROADMAP C7-C9): GFF3 rows of a query file with empty "
          f"records equal to the host tier's ({rows.count(chr(10))} rows, "
          f"none malformed, none for the empty records), an all-empty file "
          f"no rows and no launch; -c \"\", --sampling 10, --sampling 0 and "
          f"extract c2 -5 10 exit 1 and write nothing; "
          f"{time.perf_counter() - t_phase:.1f} s")
    print(f"# launches during the mixed query file's search: "
          f"{json.dumps(launches)}")


def sharded_run(label, s, mesh, impl, want=None, again=False):
    """One sharded suffix sort of `s` over `mesh`, timed, with its peak
    device memory, distributed sorts and exchange rounds, and the scan
    launches it made; sa and bwt held against the host library's SA-IS
    and BWT gather (or `want`, a (sa, bwt) pair); with `again`, a second
    run timed after it.  Returns the first run's launches."""
    import numpy as np
    import torch
    from gecoz_tpu_torch import native
    from gecoz_tpu_torch.ops.sa import bwt_from_sa
    from gecoz_tpu_torch.parallel import sharded_sa as ss
    dev, n = mesh[0], len(s)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    free, cap = torch.cuda.mem_get_info(dev)
    retries = torch.cuda.memory_stats(dev)["num_alloc_retries"]
    ss.reset_stats()
    reset_counts()                             # the sharded path starts
    t0 = time.perf_counter()
    sa, bwt = ss.suffix_array_sharded(s, mesh=mesh, impl=impl)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counts()                        # ... and ends here
    peak = torch.cuda.max_memory_allocated(dev) - base
    retries = torch.cuda.memory_stats(dev)["num_alloc_retries"] - retries
    stats = dict(ss.STATS)
    check(all(x.device == dev for x in sa + bwt), f"{label}: shards left "
          "the card")
    sa, bwt = ss.gather_shards(sa).numpy(), ss.gather_shards(bwt).numpy()
    if want is None:
        t1 = time.perf_counter()
        want_sa = native.sais(s)
        want = (want_sa, bwt_from_sa(s, want_sa))
        oracle = f"native SA-IS ({time.perf_counter() - t1:.2f} s host)"
    else:
        oracle = "suffix_array_device"
    check(np.array_equal(sa, want[0]), f"{label}: SA differs from {oracle}")
    check(np.array_equal(bwt, want[1]), f"{label}: BWT differs from "
          f"{oracle}")
    scans = {k: launches[k] for k in ("cumsum_i32",) + SHARDED_KERNELS}
    print(f"# sharded SA {label}: {secs:.3f} s wall ({n / 1e6 / secs:.1f} "
          f"MB/s), peak {peak / 2**20:.0f} MiB = {peak / n:.1f} B/char, "
          f"{stats['sorts']} distributed sorts, {stats['rounds']} exchange "
          f"rounds; scan launches {json.dumps(scans)}; sa and bwt bit-exact "
          f"against {oracle}; before it {base / 2**30:.2f} GiB allocated, "
          f"{free / 2**30:.2f} of {cap / 2**30:.2f} GiB free, "
          f"{retries} allocator retries")
    if again:
        _, secs = wall(lambda: ss.suffix_array_sharded(s, mesh=mesh,
                                                       impl=impl))
        print(f"# sharded SA {label}, second run: {secs:.3f} s wall")
    return launches


def phase_sharded(dev):
    """Phase 10: the sharded suffix sort and the mesh encode on virtual
    meshes of the card, and the dry run."""
    import numpy as np
    import torch
    from gecoz_tpu_torch.formats.gcz import encode_block_host
    from gecoz_tpu_torch.ops.sa_device import suffix_array_device
    from gecoz_tpu_torch.parallel import mesh, sharded_sa as ss
    from gecoz_tpu_torch.parallel.dryrun import dryrun_multichip
    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    nul = np.zeros(1, np.uint8)
    block = np.concatenate([chrom(rng, 64 * MiB - 1, 4), nul])
    check(ss._pick_impl(block, "auto") == "runs", "64 MiB block: auto does "
          "not pick the run-aware variant")
    launches = sharded_run("runs 64 MiB over (cuda:0,) * 8 (auto)", block,
                           (dev,) * 8, "auto", again=True)
    for name in ("cumsum_i32",) + SHARDED_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the sharded "
              "path")
    del block
    acgt = np.frombuffer(b"ACGT", np.uint8)
    dna = np.concatenate([rng.choice(acgt, size=16 * MiB - 1), nul])
    sharded_run("kmer 16 MiB N-free over (cuda:0,) * 6 (odd-even)", dna,
                (dev,) * 6, "kmer")
    del dna
    small = np.concatenate([chrom(rng, 4 * MiB - 1, 1), nul])
    sa, bwt = suffix_array_device(small, with_bwt=True, device=dev)
    sharded_run("4 MiB over one shard (cuda:0,)", small, (dev,), "auto",
                want=(sa.cpu().numpy(), bwt.cpu().numpy()))
    del sa, bwt
    # the mesh encode with the sharded route forced (a 1-byte budget)
    os.environ["GECOZ_HBM_BYTES"] = "1"
    try:
        ss.reset_stats()
        got, secs = wall(lambda: mesh.encode_blocks(
            [small], [["chrS"]], device=dev, mesh=(dev,) * 8))
    finally:
        os.environ.pop("GECOZ_HBM_BYTES", None)
    check(ss.STATS["sorts"] > 0, "the forced mesh encode did not sort "
          "sharded")
    check(got == [encode_block_host(small, ["chrS"], backend="native")],
          "the mesh encode with the sharded route differs from the host "
          "tier")
    print(f"# encode_blocks 4 MiB, sharded route forced over (cuda:0,) * 8: "
          f"{secs:.3f} s, .gcz/.gcx byte-identical to the host tier")
    _, secs = wall(lambda: dryrun_multichip((dev,) * 8))
    print(f"# dryrun_multichip((cuda:0,) * 8): {secs:.2f} s")
    print(f"# phase 10 (sharded suffix sort and mesh encode): "
          f"{time.perf_counter() - t_phase:.1f} s; a virtual mesh runs every "
          "shard on one card: no interconnect is measured")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.meta_path.insert(0, _Refuse())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    print(f"# torch's CUDA context: {time.perf_counter() - t_all:.3f} s")
    phase_build(_build)
    err, times, lib_times = phase_kernels(scan, dev)
    phase_suffix_sort(dev)
    # the sharded sort runs before the phases that profile and encode large
    # blocks: after them its first run took several times as long (PERF.md)
    shlaunches = phase_sharded(dev)
    phase_query_state(dev)
    with tempfile.TemporaryDirectory() as work:
        launches, dlaunches = phase_end_to_end(dev, work)
        with tempfile.TemporaryDirectory() as large:
            phase_two_large_blocks(dev, large)
        phase_gzip(dev, work, os.path.join(work, "genome.fa"),
                   os.path.join(work, "port.gcz"))
        qerr, qtimes, qbounds, qrr = phase_query_kernels(dev)
        for got, into in zip(phase_gcx(dev), (qerr, qtimes, qbounds)):
            into.update(got)
        for got, into in zip(phase_hswt(dev), (qerr, qtimes, qbounds)):
            into.update(got)
        slaunches = phase_search(dev, work, os.path.join(work, "port.gcz"))
        _, wruns, werr, wtimes, wbounds, wrr = phase_wide_alphabets(dev, work)
        phase_tools(dev, work)
        short_runs, serr = phase_short_blocks(dev, work)
        phase_cli_inputs(dev, work)
    loaded = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    check(not loaded, f"{loaded} were imported")
    print(f"# all phases passed; total time {time.perf_counter() - t_all:.1f}"
          " s (the build included)")

    def entry(name, run):
        # 4 bytes a value in and out at the timed 64 Mi + 12,345 values
        ms, plain = times[(name, 64 * MiB)]
        return {"name": name, "route": "cuda",
                "source": "gecoz_tpu_torch/csrc/scan.cu",
                "replaces": REPLACES,
                "launches": run[name] + short_runs.get(name, 0),
                "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
                "bound_ms": bound_ms(8 * (64 * MiB + 12345)),
                "bound_by": "bytes",
                "library_ms": lib_times.get((name, 64 * MiB))}
    # the query kernels: launches from the run of the path that takes
    # them, times at the path's shapes on the 64 MiB block (phase 8)
    runs = {"fm_search": (slaunches["default budget"],
                          "fm_search 2^20 16-mers"),
            "lf_walk.decode": (dlaunches, "lf_walk.decode lfk16 64 MiB"),
            "lf_walk.locate": (slaunches["budget 1 B"],
                               "lf_walk.locate 2^20 rows 64 MiB"),
            "lf_walk.decode.lfk4": (wruns["decompress"],
                                    "lf_walk.decode lfk4 64 MiB"),
            "gcx.unpack": (dlaunches, "gcx.unpack hg38"),
            "gcx.decode": (dlaunches, "gcx.decode hg38"),
            "hswt.unpack": (dlaunches, "hswt.unpack hg38"),
            "hswt.decode": (dlaunches, "hswt.decode hg38")}
    for k, e in list(werr.items()) + list(serr.items()):
        qerr[k] = max(qerr.get(k, 0), e)
    qtimes.update(wtimes)
    qbounds.update(wbounds)
    qrr.update(wrr)

    def query_entry(name, source, replaces):
        run, key = runs[name]
        ms, plain = qtimes[key]
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": run[name] + short_runs.get(name, 0),
               "max_abs_err": qerr[name], "ms": ms, "plain_ms": plain,
               "bound_ms": bound_ms(qbounds[key]), "bound_by": "bytes",
               "library_ms": None}
        if key in qrr:
            # K1: its distinct sectors at the card's random 32-byte row
            # rate; K2's locate: its walks' reads at the random 4-byte rate
            out["random_read_bound_ms"] = qrr[key]
        return out
    # the scan's add and fills: launches from the CLI compress; its max and
    # reverse min: from the sharded sort of phase 10
    print(json.dumps({"kernels": [entry(k, launches) for k in PATH_KERNELS]
                      + [entry(k, shlaunches) for k in SHARDED_KERNELS]
                      + [query_entry(*q) for q in QUERY_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
