"""Build and load the hand-written CUDA kernels of `gecoz_tpu_torch/csrc`.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a) into a
shared library with a plain C interface and loaded with ctypes.  The build
happens on first use, never at import: a machine without `nvcc` can import
every module and run the plain PyTorch versions.

The library lands in `gecoz_tpu_torch/build/` under a name keyed by the
hash of the source, the nvcc flags and `nvcc --version`, compiled to a
private temporary name and renamed into place, so concurrent processes see
either no library or a whole one (the scheme of `gecoz_tpu/native`'s g++
build).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildInfo:
    """What the last build of one library did (for reports)."""

    path: Path
    seconds: float          # 0.0 when an up-to-date library was reused
    ptxas: str              # nvcc's -Xptxas -v report ("" when reused)


_LIBS: dict[str, ctypes.CDLL] = {}
BUILDS: dict[str, BuildInfo] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of gecoz_tpu_torch are built at first use")


def _digest(nvcc: str, src: Path) -> str:
    """Key of one build: a change of source, flags or compiler rebuilds."""
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join((*NVCC_FLAGS, version)).encode())
    return h.hexdigest()[:16]


def _build(nvcc: str, src: Path, so: Path) -> BuildInfo:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return BuildInfo(so, time.perf_counter() - t0, proc.stderr.strip())


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        nvcc = _nvcc()
        so = BUILD / f"lib{name}-{_digest(nvcc, src)}.so"
        if so.is_file():
            BUILDS[name] = BuildInfo(so, 0.0, "")
        else:
            BUILDS[name] = _build(nvcc, src, so)
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
        return lib
