"""gecotools-compatible command line of the port.

    python -m gecoz_tpu_torch.cli -i file [-o out [header [from [to]]]]
                                  [-c [header] PATTERN]
                                  [-s [header] PATTERN | -s query.fa]
                                  [-t N] [-v LEVEL] [-idx path.gcx]
                                  [--resume] [--sampling N] [--check [--deep]]
                                  [--backend auto|numpy|native|device]
                                  [--device cuda:0|cpu]

Flags are parsed as the reference CLI parses them (`parse_args`, a copy of
gecoz_tpu/cli.py's, Gecotools.java:209-243), and every verb of the
reference is served.  `--backend` picks the tier of the three card verbs,
compress/index (`-i x.fa -o x.gcz`), decompress (`-i x.gcz -o x.fa`) and
GFF3 batch search (`-i x.gcz -s queries.fa`), as the reference passes it
(`utils/device.py::resolve_backend`):

* `auto` (the default) and `device`: the device tier, on the card
  (`--device` names another device, e.g. `cpu` for the plain PyTorch
  versions).  Without a card and without `--device` these exit non-zero;
  there is no host fallback.  The reference's `auto` weighs the device
  against the host with a relay cost model the port does not carry.
* `numpy` and `native`: the reference's host tier (host suffix array,
  FM-index decode and find, on `-t N` threads for compress and
  decompress); nothing runs on a device.

Count (`-c [header] PATTERN`), locate (`-s header PATTERN` or `-s
PATTERN`), range extract (`-o chr.seq chrN [from [to]]`) and `--check
[--deep]` run on the host whatever the backend, as the reference runs them
(the port's copies in `tools/driver.py`).  Run as a process, the CLI
re-executes itself once with glibc's malloc tuned for heap reuse, as the
reference's does (`_retune_malloc`, gecoz_tpu/cli.py:26-46); opt out with
GECOZ_NO_MALLOC_TUNING=1 (GECOZ_NO_HEAP_WARMUP=1 skips the in-process
warm-up of `utils/hostmem.py`).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

HELP = __doc__


def _retune_malloc(argv: list[str]) -> None:
    """Re-exec once with glibc malloc tuned for heap reuse.

    Hosts with on-demand-faulted VM memory serve fresh private pages
    extremely slowly; keeping large buffers in the reusable heap (instead
    of fresh mmaps trimmed back to the OS) makes steady-state encode an
    order of magnitude faster.  Harmless elsewhere.  Opt out with
    GECOZ_NO_MALLOC_TUNING=1.
    """
    import os
    if os.environ.get("GECOZ_NO_MALLOC_TUNING") or \
            os.environ.get("MALLOC_MMAP_THRESHOLD_"):
        return
    env = dict(os.environ)
    env["MALLOC_MMAP_THRESHOLD_"] = str(1 << 34)
    env["MALLOC_TRIM_THRESHOLD_"] = str(1 << 34)
    try:
        os.execve(sys.executable,
                  [sys.executable, "-m", "gecoz_tpu_torch.cli"] + argv, env)
    except OSError:
        pass


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

    from gecoz_tpu_torch.utils.device import NoDeviceError, resolve_backend
    backend = (params.get("--backend") or ["auto"])[0]
    try:
        resolve_backend(backend)    # tools/driver.py resolves it again
    except ValueError as ex:
        print(f"gecoz_tpu_torch: {ex}", file=sys.stderr)
        return 1
    try:
        return _run(params, backend, device)
    except NoDeviceError as ex:
        print(f"gecoz_tpu_torch: {ex}.  --backend auto and device run on "
              "the card; --backend native (or numpy) runs the host tier, "
              "--device cpu the plain PyTorch versions", file=sys.stderr)
        return 1


def _run(params: dict[str, list[str]], backend: str,
         device: str | None) -> int:
    """One verb; `tools/driver.py` picks the tier and the device (and
    raises NoDeviceError before it opens any file)."""
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
            try:
                coords = [int(v) for v in out[2:4]]
                bad = min(coords, default=0) < 0
            except ValueError:
                bad = True
            if bad:
                return _refuse("range extract: from and to must be "
                               f"integers >= 0, got {' '.join(out[2:4])}")
            start = coords[0] if coords else 0
            end = coords[1] if len(coords) > 1 else None
            driver.extract_range(ipath, out[1], start, end, opath)
            return 0
        if check_format(ipath):
            driver.decompress(ipath, opath, backend=backend, threads=threads,
                              device=device)
        else:
            svals = params.get("--sampling") or []
            try:
                sampling = int(svals[0]) if svals else 32
                driver.check_sampling(sampling)
            except ValueError:
                return _refuse(f"--sampling must be a power of 2, got "
                               f"{svals[0]}")
            idx = params.get("-idx") or params.get("--index")
            driver.index_fasta(ipath, opath, Path(idx[0]) if idx else None,
                               sampling=sampling, backend=backend,
                               threads=threads, resume="--resume" in params,
                               device=device)
    elif "-s" in params or "--search" in params:
        search = params.get("-s") or params.get("--search")
        if not search:
            print("no search string/filename specified.", file=sys.stderr)
            return 1
        if len(search) == 1 and Path(search[0]).is_file():
            driver.gff_search(ipath, Path(search[0]), backend=backend,
                              device=device)
        else:
            header = search[0] if len(search) > 1 else None
            pattern = search[1] if len(search) > 1 else search[0]
            if not pattern:
                return _refuse("the search pattern is empty")
            driver.match(ipath, header, pattern, show_positions=True)
    elif "-c" in params or "--count" in params:
        count = params.get("-c") or params.get("--count")
        if not count:
            print("no search string specified.", file=sys.stderr)
            return 1
        header = count[0] if len(count) > 1 else None
        pattern = count[1] if len(count) > 1 else count[0]
        if not pattern:
            return _refuse("the search pattern is empty")
        driver.match(ipath, header, pattern, show_positions=False)
    return 0


def _refuse(msg: str) -> int:
    """An argument the port refuses (ROADMAP C7-C9): one line, exit 1,
    before any file is opened or written."""
    print(f"gecoz_tpu_torch: {msg}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    _retune_malloc(sys.argv[1:])   # re-exec only as a real CLI process
    sys.exit(main())
