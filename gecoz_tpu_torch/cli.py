"""gecotools-compatible command line of the port.

    python -m gecoz_tpu_torch.cli -i file [-o out [header [from [to]]]]
                                  [-c [header] PATTERN]
                                  [-s [header] PATTERN | -s query.fa]
                                  [-t N] [-v LEVEL] [-idx path.gcx]
                                  [--resume] [--sampling N] [--check [--deep]]
                                  [--device cuda:0|cpu]

Flags are parsed as the reference CLI parses them (`parse_args`, a copy of
gecoz_tpu/cli.py's, Gecotools.java:209-243), and every verb of the
reference is served:

* on the card (`--device` names another device, e.g. `cpu` for the plain
  PyTorch versions; without a card and without `--device` these exit
  non-zero): compress/index (`-i x.fa -o x.gcz`), decompress (`-i x.gcz
  -o x.fa`, `-t N` reflow threads) and GFF3 batch search (`-i x.gcz -s
  queries.fa`);
* on the host, as the reference runs them with every backend (the port's
  copies in `tools/driver.py`: `FMIndex.find`/`extract` on the wavelet
  tree): count (`-c [header] PATTERN`), locate (`-s header PATTERN` or
  `-s PATTERN`), range extract (`-o chr.seq chrN [from [to]]`) and
  `--check [--deep]`.

`--backend` is the reference's tier switch and is refused here.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

HELP = __doc__


def parse_args(argv: list[str]) -> dict[str, list[str]]:
    """Multimap parser (Gecotools.parameters:209-243)."""
    known = {"-h", "--help", "-i", "--input", "-idx", "--index", "-s",
             "--search", "-c", "--count", "-a", "--align", "-t", "--threads",
             "-v", "--verbose", "-o", "--output", "--backend", "--resume",
             "--sampling", "--check", "--deep"}
    params: dict[str, list[str]] = {}
    values = None
    for arg in argv:
        if arg in known:
            values = params.setdefault(arg, [])
        elif values is not None:
            values.append(arg)
    return params


def _device(name: str | None):
    """The device of the card verbs, or None (reported) when there is no
    card and none was named."""
    from gecoz_tpu_torch.utils.device import device
    try:
        return device(name)
    except RuntimeError as ex:
        print(f"gecoz_tpu_torch: {ex}", file=sys.stderr)
        return None


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

    if "--backend" in params:
        print("gecoz_tpu_torch: --backend is not taken; the port runs on "
              "--device", file=sys.stderr)
        return 1

    inp = params.get("-i") or params.get("--input")
    if not inp:
        print("no input file specified", file=sys.stderr)
        return 1
    ipath = Path(inp[0])
    if not ipath.is_file():
        print(f"no input file found: {ipath}", file=sys.stderr)
        return 1
    tvals = params.get("-t") or params.get("--threads") or []
    threads = int(tvals[0]) if tvals else 1
    svals = params.get("--sampling") or []
    sampling = int(svals[0]) if svals else 32

    from gecoz_tpu_torch.formats.gcz import check_format
    from gecoz_tpu_torch.tools import driver

    if "--check" in params:
        ok = driver.check(ipath, deep="--deep" in params)
        return 0 if ok else 1
    if "-o" in params or "--output" in params:
        out = params.get("-o") or params.get("--output")
        if not out:
            print("no output file specified.", file=sys.stderr)
            return 1
        opath = Path(out[0])
        if check_format(ipath) and len(out) > 1:
            start = int(out[2]) if len(out) > 2 else 0
            end = int(out[3]) if len(out) > 3 else None
            driver.extract_range(ipath, out[1], start, end, opath)
            return 0
        dev = _device(device)
        if dev is None:
            return 1
        if check_format(ipath):
            driver.decompress(ipath, opath, threads=threads, device=dev)
        else:
            idx = params.get("-idx") or params.get("--index")
            driver.index_fasta(ipath, opath, Path(idx[0]) if idx else None,
                               sampling=sampling,
                               resume="--resume" in params, device=dev)
    elif "-s" in params or "--search" in params:
        search = params.get("-s") or params.get("--search")
        if not search:
            print("no search string/filename specified.", file=sys.stderr)
            return 1
        if len(search) == 1 and Path(search[0]).is_file():
            dev = _device(device)
            if dev is None:
                return 1
            driver.gff_search(ipath, Path(search[0]), device=dev)
        else:
            header = search[0] if len(search) > 1 else None
            pattern = search[1] if len(search) > 1 else search[0]
            driver.match(ipath, header, pattern, show_positions=True)
    elif "-c" in params or "--count" in params:
        count = params.get("-c") or params.get("--count")
        if not count:
            print("no search string specified.", file=sys.stderr)
            return 1
        header = count[0] if len(count) > 1 else None
        pattern = count[1] if len(count) > 1 else count[0]
        driver.match(ipath, header, pattern, show_positions=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
