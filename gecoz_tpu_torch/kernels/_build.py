"""Build and load the port's native libraries: the hand-written CUDA kernels
of `gecoz_tpu_torch/csrc` and the host C++ of `csrc/host`.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a) into a
shared library with a plain C interface and loaded with ctypes (`load`).
The host sources `csrc/host/*.cpp` (SA-IS, BWT, rank-vector layout, LF
build and walks, wavelet fill, inflate, deflate and the longest previous
factor) are compiled by `g++` into one library
(`load_host`, bound in `gecoz_tpu_torch/native.py`).  Builds happen on
first use, never at import: a machine without `nvcc` can import every
module and run the plain PyTorch versions.

A library lands in `gecoz_tpu_torch/build/` under a name keyed by the hash
of its sources, the compiler flags and the compiler's `--version`,
compiled to a private temporary name and renamed into place, so concurrent
processes see either no library or a whole one.  The host library is built
without `-march=native`: the build directory may travel between machines.
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
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


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


def _digest(compiler: str, flags: tuple, srcs: list[Path]) -> str:
    """Key of one build: a change of source, flags or compiler rebuilds."""
    version = subprocess.run([compiler, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256()
    for src in srcs:
        h.update(src.read_bytes())
    h.update("\0".join((*flags, version)).encode())
    return h.hexdigest()[:16]


def _build(cmd: list[str], srcs: list[Path], so: Path) -> BuildInfo:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(
        f".{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "-o", str(tmp), *map(str, srcs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed on "
                           f"{', '.join(p.name for p in srcs)}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return BuildInfo(so, time.perf_counter() - t0, proc.stderr.strip())


def _load(name: str, compiler: str, flags: tuple,
          srcs: list[Path]) -> ctypes.CDLL:
    """Library `name` from `srcs`, built if needed.  The compiler runs
    outside the lock, so threads build different libraries at once; a
    library two threads build twice is renamed into place whole."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
    so = BUILD / f"lib{name}-{_digest(compiler, flags, srcs)}.so"
    info = (BuildInfo(so, 0.0, "") if so.is_file()
            else _build([compiler, *flags], srcs, so))
    with _LOCK:
        if name not in _LIBS:
            BUILDS[name] = info
            _LIBS[name] = ctypes.CDLL(str(so))
        return _LIBS[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (built if needed)."""
    return _load(name, _nvcc(), NVCC_FLAGS, [CSRC / f"{name}.cu"])


def load_host() -> ctypes.CDLL:
    """The loaded host library built from `csrc/host/*.cpp` by g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host library of "
                           "gecoz_tpu_torch is built at first use")
    return _load("gecoz_host", gxx, HOST_FLAGS,
                 sorted((CSRC / "host").glob("*.cpp")))
