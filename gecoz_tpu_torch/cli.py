"""gecotools-compatible command line of the port: compress/index.

    python -m gecoz_tpu_torch.cli -i in.fa -o out.gcz [-idx out.gcx]
                                  [-v LEVEL] [--resume] [--sampling N]
                                  [--device cuda:0|cpu]

Flags are parsed as the reference CLI parses them (gecoz_tpu/cli.py,
Gecotools.java:209-243).  Only the compress verb is ported; it encodes on
the card (`--device` names another device, e.g. `cpu` for the plain
PyTorch versions).  The other verbs exit non-zero with the ROADMAP item
that will bring them: decompress, range extract, count, locate, GFF3
search and --check.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from gecoz_tpu.cli import parse_args

HELP = __doc__

_NOT_PORTED = {
    "decompress and range extract": "ROADMAP A8",
    "count (-c), locate and GFF3 search (-s)": "ROADMAP A7/A8",
    "--check": "ROADMAP A8",
}


def _not_ported(what: str) -> int:
    print(f"gecoz_tpu_torch: {what} is not ported yet ({_NOT_PORTED[what]}); "
          "use python -m gecoz_tpu.cli", file=sys.stderr)
    return 2


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # the port's own flag joins the reference's multimap parser
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("--device needs a value (cuda:0, cpu)", file=sys.stderr)
            return 1
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    params = parse_args(argv)

    if not params or "-h" in params or "--help" in params:
        print(HELP)
        return 0

    level = (params.get("-v") or params.get("--verbose") or ["WARNING"])
    name = (level[0].upper() if level else "WARNING")
    java_levels = {"SEVERE": "ERROR", "FINE": "DEBUG", "FINER": "DEBUG",
                   "FINEST": "DEBUG", "ALL": "DEBUG", "OFF": "CRITICAL",
                   "CONFIG": "INFO"}
    name = java_levels.get(name, name)
    logging.basicConfig(level=getattr(logging, name, logging.WARNING),
                        format="%(message)s")

    for flag in ("--backend", "-t", "--threads"):
        if flag in params:
            print(f"gecoz_tpu_torch: {flag} is not taken; the port encodes "
                  "one block at a time on --device", file=sys.stderr)
            return 1

    inp = params.get("-i") or params.get("--input")
    if not inp:
        print("no input file specified", file=sys.stderr)
        return 1
    ipath = Path(inp[0])
    if not ipath.is_file():
        print(f"no input file found: {ipath}", file=sys.stderr)
        return 1
    svals = params.get("--sampling") or []
    sampling = int(svals[0]) if svals else 32

    from gecoz_tpu.formats.gcz import check_format

    if "--check" in params:
        return _not_ported("--check")
    if "-o" in params or "--output" in params:
        out = params.get("-o") or params.get("--output")
        if not out:
            print("no output file specified.", file=sys.stderr)
            return 1
        if check_format(ipath):
            return _not_ported("decompress and range extract")
        from gecoz_tpu_torch.tools import driver
        idx = params.get("-idx") or params.get("--index")
        driver.index_fasta(ipath, Path(out[0]), Path(idx[0]) if idx else None,
                           sampling=sampling, resume="--resume" in params,
                           device=device)
        return 0
    if any(f in params for f in ("-s", "--search", "-c", "--count")):
        return _not_ported("count (-c), locate and GFF3 search (-s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
