"""Large-scale synthetic-genome validation harness.

The port's copy of gecoz_tpu/tools/validate_scale.py: the same genome
profiles and checks, driving the port (`python -m gecoz_tpu_torch.cli`
with `--cli`, `gecoz_tpu_torch.tools.driver` in process) on `--device`
(default: the card), and reporting the peak device memory in use.

No genomic corpora ship in this image, so this generates an hg38-shaped
synthetic genome and validates the full production path at scale (the
reference's de-facto validation is an hg38 round trip, README.md:31-36):

  fasta -> .gcz/.gcx -> fasta   bit-exact per header (md5)
  count/search spot checks vs naive scans of the source
  range extraction across N-run boundaries
  --check integrity verification

Two genome profiles:

* ``genome``  — many chromosomes with telomere/centromere N runs, Alu-like
  interspersed repeats, tandem repeats, CpG-skewed composition (rich
  structure, exercises the block merge policy on a size spectrum).
* ``hg38``    — the reference's headline shape (README.md:31-44): one
  chr1-sized sequence (--mb, default 248) plus proportionally smaller ones,
  so the largest block matches the reference's worst case.

``--cli`` drives the real CLI in a subprocess (the exact user path; the
reference's CLI also re-executes itself with glibc's malloc tuned, the
port's does not); default runs the drivers in-process.  `--device` is
passed to both; on a card the peak device memory in use is sampled
card-wide (`torch.cuda.mem_get_info`, every 0.25 s), so the CLI's
subprocess is seen too.  Without `--out` the files go to a temporary
directory that is removed at the end.

Usage: python -m gecoz_tpu_torch.tools.validate_scale [--profile hg38]
           [--mb 248] [--out DIR] [--cli]
           [--backend auto|native|numpy|device] [-t N] [--device cuda:0|cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np


def synth_chromosome(rng: np.random.Generator, n: int) -> np.ndarray:
    """One chromosome: telomeric/centromeric N runs + repeats + unique."""
    out = np.empty(n, dtype=np.uint8)
    syms = np.frombuffer(b"ACGT", np.uint8)
    out[:] = rng.choice(syms, size=n, p=[0.295, 0.205, 0.205, 0.295])

    # telomeres: N runs at both ends (0.1-1% each)
    tel = max(100, int(n * rng.uniform(0.001, 0.01)))
    out[:tel] = ord("N")
    out[n - tel:] = ord("N")
    # centromere: one large N run near the middle
    cen = max(1000, int(n * rng.uniform(0.01, 0.03)))
    mid = n // 2 + int(rng.integers(-n // 10, n // 10))
    out[mid:mid + cen] = ord("N")

    # Alu-like interspersed repeat: one ~300bp unit pasted with small
    # mutations over ~10% of the chromosome
    alu = rng.choice(syms, size=300)
    n_copies = max(1, int(n * 0.1) // 300)
    starts = rng.integers(tel, n - tel - 301, size=n_copies)
    for s in starts:
        unit = alu.copy()
        nmut = rng.poisson(9)
        if nmut:
            pos = rng.integers(0, 300, size=nmut)
            unit[pos] = rng.choice(syms, size=nmut)
        out[s:s + 300] = unit

    # a few tandem repeats (microsatellite-like)
    for _ in range(max(1, n // (1 << 21))):
        motif = rng.choice(syms, size=int(rng.integers(2, 7)))
        reps = int(rng.integers(50, 400))
        tr = np.tile(motif, reps)
        s = int(rng.integers(tel, max(tel + 1, n - tel - len(tr))))
        out[s:s + len(tr)] = tr[:max(0, min(len(tr), n - s))]
    return out


def synth_seq(rng: np.random.Generator, n: int) -> np.ndarray:
    """Fast flat synthesis for the hg38 profile (vectorized, few N runs)."""
    syms = np.frombuffer(b"ACGTN", np.uint8)
    out = rng.choice(syms, size=n, p=[0.29, 0.205, 0.205, 0.29, 0.01])
    for _ in range(3):      # megabase-scale N runs like real centromeres
        start = int(rng.integers(0, max(1, n - n // 50)))
        out[start:start + n // 100] = ord("N")
    return out.astype(np.uint8)


def write_fasta(path: Path, chroms: dict[str, np.ndarray],
                width: int = 60) -> None:
    """60-char-line FASTA, reflowed without a per-line python loop."""
    with open(path, "wb", buffering=1 << 22) as f:
        for name, s in chroms.items():
            f.write(b">" + name.encode() + b"\n")
            n = len(s)
            rows = -(-n // width)
            buf = np.full((rows, width + 1), ord("\n"), np.uint8)
            pad = rows * width - n
            flat = np.concatenate([s, np.zeros(pad, np.uint8)])
            buf[:, :width] = flat.reshape(rows, width)
            raw = buf.tobytes()
            if pad:
                raw = raw[: -(pad + 1)] + b"\n"
            f.write(raw)


def md5s_of_fasta(path: Path) -> dict[str, str]:
    """Per-header md5 of sequence bytes (streaming, O(line) memory)."""
    out: dict[str, str] = {}
    cur, h = None, None
    with open(path, "rb", buffering=1 << 22) as f:
        for line in f:
            if line.startswith(b">"):
                if cur is not None:
                    out[cur] = h.hexdigest()
                cur = line[1:].split()[0].decode()
                h = hashlib.md5()
            else:
                h.update(line.rstrip(b"\r\n"))
    if cur is not None:
        out[cur] = h.hexdigest()
    return out


def overlap_count(hay: bytes, pat: bytes) -> int:
    want, at = 0, hay.find(pat)
    while at >= 0:
        want += 1
        at = hay.find(pat, at + 1)
    return want


class DeviceMemory(threading.Thread):
    """Peak device memory in use on `dev`'s card, sampled card-wide every
    0.25 s (so a CLI subprocess is seen too); `stop()` returns the peak
    above what was in use when the sampler started, in bytes."""

    def __init__(self, dev):
        super().__init__(daemon=True)
        self.dev = dev
        self.base = self._used()
        self.peak = self.base
        self._halt = threading.Event()

    def _used(self) -> int:
        import torch
        free, total = torch.cuda.mem_get_info(self.dev)
        return total - free

    def run(self):
        while not self._halt.is_set():
            self.peak = max(self.peak, self._used())
            time.sleep(0.25)

    def stop(self) -> int:
        self._halt.set()
        self.join()
        return max(self.peak, self._used()) - self.base


def run_cli(args: list[str]) -> float:
    cmd = [sys.executable, "-m", "gecoz_tpu_torch.cli", *args]
    print("+", " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True)
    return time.perf_counter() - t0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--profile", choices=("genome", "hg38"), default="genome")
    ap.add_argument("--mb", type=int, default=None,
                    help="total MB (genome) or chr1 MB (hg38)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--cli", action="store_true",
                    help="drive the CLI in a subprocess")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("-t", "--threads", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="device of the device tier (default: the card)")
    a = ap.parse_args(argv)
    # surface the gecoz INFO stream (phase timings and the tier --backend
    # chose) in scale artifacts
    import logging
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(name)s: %(message)s")
    logging.getLogger("gecoz").setLevel(logging.INFO)
    mb = a.mb if a.mb is not None else (248 if a.profile == "hg38" else 192)
    if a.out is None:
        with tempfile.TemporaryDirectory(prefix="gcz_scale_") as tmp:
            return _validate(a, mb, Path(tmp))
    a.out.mkdir(parents=True, exist_ok=True)
    return _validate(a, mb, a.out)


def _validate(a, mb: int, outdir: Path) -> int:
    from gecoz_tpu_torch.utils.device import device as pick_device
    from gecoz_tpu_torch.utils.device import resolve_backend
    dev = (pick_device(a.device) if resolve_backend(a.backend) == "device"
           else None)
    dev_args = ["--device", str(dev)] if dev is not None else []
    mem = (DeviceMemory(dev) if dev is not None and dev.type == "cuda"
           else None)
    rng = np.random.default_rng(2024)

    # -- synthesize ---------------------------------------------------------
    t0 = time.perf_counter()
    if a.profile == "hg38":
        sizes = {"chr1": mb << 20, "chr9": int(mb * 0.56) << 20,
                 "chr17": int(mb * 0.33) << 20, "chr21": int(mb * 0.19) << 20,
                 "chrM": 16_569}
        chroms = {k: synth_seq(rng, n) for k, n in sizes.items()}
    else:
        # chromosome size spectrum roughly hg38-shaped (largest ~12.5%)
        total = mb << 20
        sizes_l, remaining, frac = [], total, 0.125
        while remaining > (1 << 20) and len(sizes_l) < 24:
            sz = min(max(1 << 20, int(total * frac)), remaining)
            sizes_l.append(sz)
            remaining -= sz
            frac *= 0.82
        if remaining > 0:
            sizes_l.append(remaining)
        chroms = {f"chr{i + 1}": synth_chromosome(rng, sz)
                  for i, sz in enumerate(sizes_l)}
    total = sum(len(v) for v in chroms.values())
    largest = max(len(v) for v in chroms.values())
    fa = outdir / "genome.fa"
    write_fasta(fa, chroms)
    print(f"wrote {fa} ({total >> 20} MiB, {len(chroms)} sequences) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    # record expectations, then free the source (big profiles)
    want_md5 = {k: hashlib.md5(v.tobytes()).hexdigest()
                for k, v in chroms.items()}
    first = next(iter(chroms))
    checks = []      # (pattern, expected overlapping count)
    for plen in (12, 20, 40):
        src = chroms[first]
        s = int(rng.integers(0, len(src) - plen))
        pat = src[s:s + plen].tobytes()
        if b"N" in pat or b"\0" in pat:
            continue
        checks.append((pat, sum(overlap_count(v.tobytes(), pat)
                                for v in chroms.values())))
    # range extraction probe across an N boundary
    rkey = "chr2" if "chr2" in chroms else first
    rsrc = chroms[rkey]
    npos_arr = np.flatnonzero(rsrc == ord("N"))
    rlo = max(0, (int(npos_arr[0]) if len(npos_arr) else 100) - 30)
    rwant = rsrc[rlo:rlo + 60].tobytes()
    big = total > (1 << 28)
    if big:
        del chroms, src, rsrc

    # -- index --------------------------------------------------------------
    from gecoz_tpu_torch.tools import driver
    gcz = outdir / "genome.gcz"
    gcx = gcz.with_suffix(".gcx")
    if mem is not None:
        mem.start()
    if a.cli:
        t_idx = run_cli(["-i", str(fa), "-o", str(gcz), "-t", str(a.threads),
                         "--backend", a.backend, "-v", "INFO", *dev_args])
    else:
        t0 = time.perf_counter()
        driver.index_fasta(str(fa), str(gcz), backend=a.backend,
                           threads=a.threads, device=dev)
        t_idx = time.perf_counter() - t0
    csize = gcz.stat().st_size + gcx.stat().st_size
    print(f"INDEX {total / 1e6 / t_idx:.1f} MB/s | .gcz "
          f"{gcz.stat().st_size / 1e6:.0f} MB + .gcx "
          f"{gcx.stat().st_size / 1e6:.0f} MB "
          f"({gcz.stat().st_size * 8 / total:.3f} bit/sym)", flush=True)

    # -- decompress + md5 compare -------------------------------------------
    back = outdir / "back.fa"
    if a.cli:
        t_dec = run_cli(["-i", str(gcz), "-o", str(back), "-t",
                         str(a.threads), "--backend", a.backend, *dev_args])
    else:
        t0 = time.perf_counter()
        driver.decompress(str(gcz), str(back), backend=a.backend,
                          threads=a.threads, device=dev)
        t_dec = time.perf_counter() - t0
    print(f"DECODE {total / 1e6 / t_dec:.1f} MB/s", flush=True)
    if mem is not None:
        peak = mem.stop()
        print(f"peak device memory in use over index + decode: "
              f"{peak / 2**30:.2f} GiB above the {mem.base / 2**30:.2f} GiB "
              f"in use before ({peak / largest:.1f} B/char of the "
              f"largest sequence; card-wide, sampled every 0.25 s)",
              flush=True)
    got = md5s_of_fasta(back)
    ok = got == want_md5
    if not ok:
        for k in set(want_md5) | set(got):
            if want_md5.get(k) != got.get(k):
                print(f"MISMATCH {k}: want {want_md5.get(k)} got {got.get(k)}")
    print("round trip:", "OK" if ok else "FAILED", flush=True)

    # -- count spot checks ---------------------------------------------------
    import io
    for pat, want in checks:
        t0 = time.perf_counter()
        if a.cli:
            r = subprocess.run(
                [sys.executable, "-m", "gecoz_tpu_torch.cli", "-i", str(gcz),
                 "-c", pat.decode()], capture_output=True, text=True,
                check=True)
            n_hits = sum(int(line.rsplit(" ", 1)[-1].split()[0])
                         for line in r.stdout.splitlines()
                         if " found : " in line)
        else:
            n_hits = driver.match(str(gcz), None, pat.decode(), False,
                                  out=io.StringIO())
        dt = time.perf_counter() - t0
        status = "OK" if n_hits == want else f"FAIL want {want}"
        print(f"count {len(pat)}-mer: {n_hits} ({dt * 1e3:.0f} ms) {status}",
              flush=True)
        ok = ok and n_hits == want

    # -- ranged extraction across an N boundary ------------------------------
    seqf = outdir / "range.seq"
    driver.extract_range(str(gcz), rkey, rlo, rlo + 60, str(seqf))
    text = open(seqf, "rb").read()
    if text != rwant:
        print("range extract FAILED")
        ok = False
    else:
        print("range extract OK")

    check_ok = driver.check(str(gcz), deep=False)
    print("--check:", "OK" if check_ok else "FAILED")
    from gecoz_tpu_torch.utils import metrics
    rep = metrics.report()
    if rep and not a.cli:
        print("--- phase breakdown (in-process) ---")
        print(rep, flush=True)
    print("LARGE-SCALE CHECK", "PASSED" if ok and check_ok else "FAILED",
          flush=True)
    return 0 if ok and check_ok else 1


if __name__ == "__main__":
    sys.exit(main())
