"""Streaming int32 scans: cumsum, cummax, reverse cummin, segmented fills.

Port of gecoz_tpu/ops/scan_pallas.py.  Every entry point takes a 1-D
contiguous int32 tensor:

* on a CUDA tensor it launches the hand-written Hopper kernel
  (`csrc/scan.cu`, built at first use) whatever n is, and adds one to its
  count in `LAUNCHES`; a failed build or launch raises;
* on a CPU tensor it runs the plain PyTorch version, which is also exported
  under its own name (`*_ref`) so the card can be checked against it.

Combine-order convention as in the reference: `closer` is the element
nearer the output position in scan direction; op "last" (nearest
non-negative wins, unit -1) needs it.
"""

from __future__ import annotations

import ctypes

import torch

_OPS = {"add": 0, "max": 1, "min": 2, "last": 3}

# launches of the CUDA kernel per entry point; plain versions never count
LAUNCHES: dict[str, int] = {"cumsum_i32": 0, "cummax_i32": 0,
                            "cummin_rev_i32": 0, "fill_fwd_i32": 0,
                            "fill_rev_i32": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared (first use)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from gecoz_tpu_torch.kernels import _build
    lib = _build.load("scan")
    lib.gecoz_scan_tile.argtypes = []
    lib.gecoz_scan_tile.restype = ctypes.c_int64
    lib.gecoz_scan_i32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gecoz_scan_i32.restype = ctypes.c_int
    lib.gecoz_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gecoz_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise TypeError(f"scan wants a 1-D contiguous int32 tensor, got "
                        f"{x.dtype} of shape {tuple(x.shape)}"
                        f"{'' if x.is_contiguous() else ' (strided)'}")


def _scan_cuda(x: torch.Tensor, op: str, reverse: bool,
               name: str) -> torch.Tensor:
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _lib()
    tiles = -(-n // lib.gecoz_scan_tile())
    agg = torch.empty(tiles if tiles > 1 else 0, dtype=torch.int32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gecoz_scan_i32(x.data_ptr(), out.data_ptr(),
                                agg.data_ptr() if tiles > 1 else None, n,
                                _OPS[op], int(reverse), stream)
    if rc != 0:
        msg = lib.gecoz_cuda_error_string(rc).decode()
        raise RuntimeError(f"scan kernel ({op}, reverse={reverse}, n={n}) "
                           f"was not launched: CUDA error {rc}: {msg}")
    LAUNCHES[name] += 1
    return out


def _dispatch(x, op, reverse, name, plain):
    _check(x)
    if x.is_cuda:
        return _scan_cuda(x, op, reverse, name)
    if x.device.type != "cpu":
        raise TypeError(f"scan: unsupported device {x.device}")
    return plain(x)


# -- plain versions ---------------------------------------------------------

def cumsum_i32_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum wrapping like int32 (summed in int64, cut back)."""
    return torch.cumsum(x, 0, dtype=torch.int64).to(torch.int32)


def cummax_i32_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def cummin_rev_i32_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(0), 0).values.flip(0)


def _fill_ref(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """cummax/cummin over marked positions + one gather
    (scan_pallas._fill_fallback)."""
    n = x.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=x.device)
    if reverse:
        idx = cummin_rev_i32_ref(torch.where(x >= 0, iota, n))
        safe = torch.clamp(idx, max=n - 1)
    else:
        idx = cummax_i32_ref(torch.where(x >= 0, iota, -1))
        safe = torch.clamp(idx, min=0)
    return torch.where((idx < 0) | (idx >= n), -1, x[safe.long()])


def fill_fwd_i32_ref(x: torch.Tensor) -> torch.Tensor:
    return _fill_ref(x, reverse=False)


def fill_rev_i32_ref(x: torch.Tensor) -> torch.Tensor:
    return _fill_ref(x, reverse=True)


# -- entry points -----------------------------------------------------------

def cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum, int32, wrapping on overflow."""
    return _dispatch(x, "add", False, "cumsum_i32", cumsum_i32_ref)


def cummax_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cummax, int32."""
    return _dispatch(x, "max", False, "cummax_i32", cummax_i32_ref)


def cummin_rev_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive REVERSE cummin, int32."""
    return _dispatch(x, "min", True, "cummin_rev_i32", cummin_rev_i32_ref)


def fill_fwd_i32(x: torch.Tensor) -> torch.Tensor:
    """Segmented forward fill: out[i] = x[j] for the largest j <= i with
    x[j] >= 0, else -1."""
    return _dispatch(x, "last", False, "fill_fwd_i32", fill_fwd_i32_ref)


def fill_rev_i32(x: torch.Tensor) -> torch.Tensor:
    """Segmented backward fill: out[i] = x[j] for the smallest j >= i with
    x[j] >= 0, else -1."""
    return _dispatch(x, "last", True, "fill_rev_i32", fill_rev_i32_ref)
