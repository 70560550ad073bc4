"""The benchmark of gecoz_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 benchmarks/run.py --workload hg38.compress --seed 7 --seconds 51 --trace 0

Run from the root of a checkout, on a machine with the card(s) the cell
asks for.  Set-up makes the cell's inputs from the seed and warms the
operation once; the window runs the operation back to back for --seconds
(the operation in flight at the deadline counts); then every answer of the
window is judged against the plain reference in `gzref`.  With --trace 1
the window runs under torch.profiler and the cell's per-layer metrics are
reported instead of its end-to-end ones.  The last line of standard output
is the result's JSON object; the numbers compared, each beside its limit,
are the last lines of standard error.  Exits 2 without the card(s), 1 if
the program or JAX cannot be imported or JAX was loaded.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (/proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


SETUP_STARTED = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))            # gecoz_tpu_torch, beside benchmarks/

REFUSED = ("jax", "jaxlib", "flax", "gecoz_tpu")


def loaded_refused() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark refuses
    (whole names: gecoz_tpu_torch is not gecoz_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(REFUSED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gzbench.runner import cell_of, load_json, run_cell
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = cell_of(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import gecoz_tpu_torch.tools.driver  # noqa: F401
    except ImportError as ex:
        print(f"run.py: the program does not import: {ex}", file=sys.stderr)
        return 1

    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", SETUP_STARTED)

    refused = loaded_refused()
    if refused:
        print(f"run.py: refused modules were loaded: {', '.join(refused)}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
