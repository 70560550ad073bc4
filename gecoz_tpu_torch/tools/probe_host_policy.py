"""The host-memory policy on the card's host: the same runs on two or more
checkouts of the repo, alternated, each in a process of its own.

For each round (the checkouts in turn, in reverse order every other
round), and for each checkout (`PYTHONPATH` pointing at it):

* the CLI as a process, `python -m gecoz_tpu_torch.cli` (`--backend
  auto`): compress of `chip_smoke.py`'s genome (96.6 Mbases, 2 blocks),
  its decompress (`-t 4`, as the smoke runs it) and the GFF3 search of
  the smoke's 1,000 reads;
* in one process, a 64 MiB `formats.gcz.encode_block` and then the 64 MiB
  sharded suffix sort over `(device,) * 8`, twice (`chip_smoke.py`'s
  phase 10 block).

Each run gives its wall and, from `os.wait4`, its user and system time,
minor faults (0 where the host's kernel does not count them) and peak RSS
(the process and the children it waited for).
Every checkout must write the same bytes: .gcz/.gcx, the decompressed
FASTA, the GFF3 rows and the sorted suffix array's md5.  With `--hg38 MB`,
`tools.validate_scale --profile hg38 --mb MB --cli` runs once on the last
checkout, measured the same way.  One JSON line per run and a summary go
to standard output, and all of it to `--out`.

Usage: python -m gecoz_tpu_torch.tools.probe_host_policy --trees A B
           [--rounds 3] [--device cuda:0|cpu] [--mb N] [--sort-mb 64]
           [--hg38 MB] [--out FILE]

`--mb N` swaps the genome for two chromosomes of N and N/2 MiB (a small
rehearsal on the CPU with `--device cpu`).  Run it from the root of the
checkout that holds it: the genome and reads are `chip_smoke.py`'s.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import resource
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

TIMEOUT = 1800
ROOT = Path(__file__).resolve().parents[2]      # the checkout holding this

# a 64 MiB block encoded, then sorted over a virtual mesh twice, in one
# process; argv: device, MiB
SORT_AFTER_ENCODE = r"""
import hashlib, json, sys, time
import numpy as np, torch
from chip_smoke import chrom
from gecoz_tpu_torch.formats.gcz import encode_block
from gecoz_tpu_torch.parallel import sharded_sa as ss
dev, n = torch.device(sys.argv[1]), int(sys.argv[2]) << 20


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


block = np.concatenate([chrom(np.random.default_rng(31), n - 1, 4),
                        np.zeros(1, np.uint8)])
_, enc = timed(lambda: encode_block(block, ["chrS"], device=dev))
(sa, _), first = timed(lambda: ss.suffix_array_sharded(block,
                                                       mesh=(dev,) * 8))
md5 = hashlib.md5(ss.gather_shards(sa).numpy().tobytes()).hexdigest()
del sa
_, second = timed(lambda: ss.suffix_array_sharded(block, mesh=(dev,) * 8))
print(json.dumps({"encode_s": enc, "sort_s": first, "sort2_s": second,
                  "sa_md5": md5}))
"""

# the smoke's genome (or two chromosomes of argv[2] and half as many MiB)
# and its 1,000 reads, written in a process of their own: a child's peak
# RSS starts from its parent's, so this process stays small
INPUTS = r"""
import sys
import numpy as np
from chip_smoke import chrom, make_genome, make_queries, write_fasta
work, mb = sys.argv[1], int(sys.argv[2])
if mb:
    rng = np.random.default_rng(5)
    recs = [("chr1 synthetic", chrom(rng, mb << 20, 4)),
            ("chr2", chrom(rng, (mb << 20) // 2 + 777, 2))]
else:
    recs = make_genome()
write_fasta(work + "/genome.fa", recs)
make_queries(np.random.default_rng(29), work + "/queries.fa")
"""

# what this checkout's warm-up asks of mallopt, logged at DEBUG
MALLOPT = r"""
import logging
logging.basicConfig(level=logging.DEBUG, format="%(message)s")
from gecoz_tpu_torch.utils import hostmem
hostmem._mallopt()
"""


def run(argv, tree: Path, work: Path, tag: str, log) -> dict:
    """`argv` as a process with `tree` on PYTHONPATH, waited for with
    os.wait4: its wall and resource use.  Standard output is kept in
    work/tag.out; standard error goes to the log."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    out = work / f"{tag}.out"
    with open(out, "wb") as fo, open(work / f"{tag}.err", "wb") as fe:
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=work, env=env, stdout=fo,
                                stderr=fe)
        timer = threading.Timer(TIMEOUT, proc.kill)
        timer.start()
        try:
            _, status, ru = os.wait4(proc.pid, 0)
        finally:
            timer.cancel()
        wall = time.perf_counter() - t0
    proc.returncode = os.waitstatus_to_exitcode(status)
    err = (work / f"{tag}.err").read_text(errors="replace")
    log(f"## {tag}: exit {proc.returncode}, {wall:.3f} s\n{err[-4000:]}")
    if proc.returncode:
        raise SystemExit(f"{tag}: exit code {proc.returncode}\n{err[-2000:]}")
    return {"wall_s": wall, "user_s": ru.ru_utime, "sys_s": ru.ru_stime,
            "minflt": ru.ru_minflt, "maxrss_mib": ru.ru_maxrss / 1024,
            "stdout": out}


def md5(path: Path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def machine() -> str:
    with open("/proc/meminfo") as f:
        ram = int(f.readline().split()[1]) / 2**20
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "no nvidia-smi"
    return (f"{smi}; host {os.cpu_count()} CPUs, {ram:.1f} GiB RAM, "
            f"{' '.join(platform.libc_ver())}, Python "
            f"{platform.python_version()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", type=Path, nargs="+", required=True)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None)
    ap.add_argument("--mb", type=int, default=None)
    ap.add_argument("--sort-mb", type=int, default=64)
    ap.add_argument("--hg38", type=int, default=None)
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args(argv)
    with open(a.out or os.devnull, "w") as sink:
        def log(line: str) -> None:
            sink.write(line + "\n")
            sink.flush()

        def say(line: str) -> None:
            print(line, flush=True)
            log(line)
        measure(a, log, say)
    return 0


def measure(a, log, say) -> None:
    trees = [t.resolve() for t in a.trees]
    dev = ["--device", a.device] if a.device else []
    sort_dev = a.device or "cuda:0"
    say(f"# {machine()}")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        fa, qf = work / "genome.fa", work / "queries.fa"
        r = run([sys.executable, "-c", INPUTS, str(work), str(a.mb or 0)],
                ROOT, work, "inputs", log)
        say(f"# inputs: {fa.stat().st_size} bytes of FASTA, 1,000 reads, "
            f"in {r['wall_s']:.1f} s")
        cli = [sys.executable, "-m", "gecoz_tpu_torch.cli"]
        # a small round trip a checkout builds its kernels and host library
        # in, not timed; and what its mallopt calls return
        small = work / "small.fa"
        with open(fa, "rb") as f:
            small.write_bytes(f.read(1 << 20))
        for i, tree in enumerate(trees):
            for k, args in enumerate((
                    ["-i", str(small), "-o", f"w{i}.gcz", *dev],
                    ["-i", f"w{i}.gcz", "-o", f"w{i}.fa", *dev],
                    ["-i", f"w{i}.gcz", "-s", str(qf), *dev])):
                run(cli + args, tree, work, f"warm{i}.{k}", log)
            run([sys.executable, "-c", MALLOPT], tree, work, f"mallopt{i}",
                log)
            got = "; ".join((work / f"mallopt{i}.err").read_text().split(
                "\n")).strip("; ")
            say(f"# {tree.name}: mallopt at the warm-up: "
                f"{got or 'nothing logged'}")
        rows, outs = [], {}
        for rnd in range(a.rounds):
            order = list(enumerate(trees))
            for i, tree in (order if rnd % 2 == 0 else order[::-1]):
                tag = f"t{i}r{rnd}"
                runs = {
                    "compress": run(cli + ["-i", str(fa), "-o",
                                           f"{tag}.gcz", *dev],
                                    tree, work, f"{tag}.compress", log),
                    "decompress": run(cli + ["-i", f"{tag}.gcz", "-o",
                                             f"{tag}.fa", "-t", "4", *dev],
                                      tree, work, f"{tag}.decompress", log),
                    "search": run(cli + ["-i", f"{tag}.gcz", "-s", str(qf),
                                         *dev],
                                  tree, work, f"{tag}.search", log),
                    "sort_after_encode": run(
                        [sys.executable, "-c", SORT_AFTER_ENCODE, sort_dev,
                         str(a.sort_mb)], tree, work, f"{tag}.sort", log)}
                sort = json.loads(runs["sort_after_encode"]["stdout"]
                                  .read_text().strip().splitlines()[-1])
                digest = {"gcz": md5(work / f"{tag}.gcz"),
                          "gcx": md5(work / f"{tag}.gcx"),
                          "fa": md5(work / f"{tag}.fa"),
                          "gff": md5(runs["search"]["stdout"]),
                          "sa": sort.pop("sa_md5")}
                outs.setdefault("want", digest)
                if digest != outs["want"]:
                    raise SystemExit(f"{tag} ({tree}): outputs differ: "
                                     f"{digest} vs {outs['want']}")
                for ext in ("gcz", "gcx", "fa"):
                    (work / f"{tag}.{ext}").unlink()
                for path, r in runs.items():
                    r.pop("stdout")
                    if path == "sort_after_encode":
                        r.update(sort)
                    row = {"tree": tree.name, "round": rnd, "path": path,
                           **r}
                    rows.append(row)
                    say(json.dumps(row))
        say("# every run of every checkout wrote the same bytes: "
            + json.dumps(outs["want"]))
        for path in ("compress", "decompress", "search",
                     "sort_after_encode"):
            for tree in trees:
                rs = [r for r in rows if r["tree"] == tree.name
                      and r["path"] == path]
                keys = ["wall_s", "user_s", "sys_s", "minflt", "maxrss_mib"]
                if path == "sort_after_encode":
                    keys += ["encode_s", "sort_s", "sort2_s"]
                say(f"# {path} {tree.name}: " + "; ".join(
                    f"{k} " + " ".join(f"{r[k]:.3f}" if isinstance(r[k],
                                       float) else str(r[k]) for r in rs)
                    + f" (median {statistics.median(r[k] for r in rs):.3f})"
                    for k in keys))
        if a.hg38:
            out = work / "hg38"
            r = run([sys.executable, "-m",
                     "gecoz_tpu_torch.tools.validate_scale", "--profile",
                     "hg38", "--mb", str(a.hg38), "--cli", "--out", str(out),
                     *dev], trees[-1], work, "hg38", log)
            text = r.pop("stdout").read_text()
            log(text)
            keep = [ln for ln in text.splitlines() if ln.startswith(
                ("INDEX", "DECODE", "peak device", "count", "round trip",
                 "LARGE-SCALE"))]
            say(json.dumps({"tree": trees[-1].name, "path": "hg38", **r}))
            say("\n".join(f"# hg38: {ln}" for ln in keep))
    hwm = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    say(f"# this process's peak RSS: {hwm / 1024:.1f} MiB (a floor under "
        "each child's maxrss)")


if __name__ == "__main__":
    sys.exit(main())
