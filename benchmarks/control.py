"""Run a control (gzbench/control.py) in a cell's place, at the cell's
own size, on the card, and print what the judge reads for each seed:

    python3 benchmarks/control.py --workload hg38.compress --seconds 5 --seeds 11 12 13

The cell's own control, or with `--control NAME` the one in
`controls/NAME.py`.  One line of JSON per seed: the seed, the control,
`correct` and the numbers compared.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default=None,
                    help="a file of controls/ (default: the cell's own)")
    args = ap.parse_args(argv)

    import torch

    from gzbench.control import replaced
    from gzbench.runner import load_json, run_cell
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    bench = load_json(ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        r = run_cell(bench, args.workload, seed, args.seconds, False,
                     "cuda:0", time.perf_counter(),
                     replace=functools.partial(replaced, name=args.control))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control or "default",
                          "correct": r["correct"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
