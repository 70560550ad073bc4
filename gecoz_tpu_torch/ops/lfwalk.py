"""LF walks of decode and locate (kernel K2, `lf_walk`).

Port of the walks of gecoz_tpu/ops/fmq.py: the decode walks of
`decode_text_jit` (842-892) and the fused-table locate walk of
`locate_batch` (774-792).  Two entry points, each with a plain PyTorch
version beside it:

* `decode_walks(tab, seeds, rate, mode, bwt=, code_map=)` -> uint8
  [W, rate], step j of walk w in column rate-1-j;
* `locate_walks(tab, rows, mark_words, mark_pre, ssa_perm, sf, packed)`
  -> int32 [B], -1 where no sampled row was reached in rate+1 reads.

On CUDA tensors they launch the hand-written Hopper kernel
(`csrc/lfwalk.cu`, built at first use, its kernels loaded by `_lib()`) and
add one to their count in `LAUNCHES` (a decode launch also to its row
mode's in `DECODE_LAUNCHES`); a failed build or launch raises.
On CPU tensors they run the plain versions (`decode_walks_ref`,
`locate_walks_ref`), which the card is also checked against.  uint32 rows
are held in int32 tensors with the same bits; bit 31 of an `lf_tab` row
marks a sampled row.
"""

from __future__ import annotations

import ctypes
import time

import torch

from gecoz_tpu_torch.ops.fmsearch import rank_words

_I32 = torch.int32

# mode -> (steps per row read, row width in uint32 words; 0 = 1-D table)
MODES = {"lfk16": (16, 3), "lfk8": (8, 2), "lfk4": (4, 2),
         "packed": (1, 0), "plain": (1, 0)}
_MODE_ID = {"lfk16": 0, "lfk8": 1, "lfk4": 2, "packed": 3, "plain": 4}
_CHUNK = 32             # bytes a walk the lfk kernel stages at a time

# launches of the CUDA kernel per entry point, and the decode launches per
# row mode; plain versions never count
LAUNCHES: dict[str, int] = {"decode": 0, "locate": 0}
DECODE_LAUNCHES: dict[str, int] = {mode: 0 for mode in MODES}


def reset_launches() -> None:
    for counts in (LAUNCHES, DECODE_LAUNCHES):
        for name in counts:
            counts[name] = 0


_LIB: ctypes.CDLL | None = None
INIT_SECONDS: float | None = None       # the kernels' load time (_lib())


def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared and its kernels
    loaded (first use): the first CUDA call of the library's own runtime
    and each kernel's module load happen here, not in the first launch."""
    global _LIB, INIT_SECONDS
    if _LIB is not None:
        return _LIB
    from gecoz_tpu_torch.kernels import _build
    lib = _build.load("lfwalk")
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gecoz_lf_decode.argtypes = [P, P, P, I64, I, I, P, P, P]
    lib.gecoz_lf_locate.argtypes = [P, P, I64, P, P, P, I, I, P, P]
    for fn in (lib.gecoz_lf_decode, lib.gecoz_lf_locate, lib.gecoz_lf_init):
        fn.restype = ctypes.c_int
    lib.gecoz_lf_init.argtypes = []
    lib.gecoz_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gecoz_cuda_error_string.restype = ctypes.c_char_p
    t0 = time.perf_counter()
    rc = lib.gecoz_lf_init()
    if rc != 0:
        msg = lib.gecoz_cuda_error_string(rc).decode()
        raise RuntimeError(f"lf_walk kernels did not load: CUDA error {rc}: "
                           f"{msg}")
    INIT_SECONDS = time.perf_counter() - t0
    _LIB = lib
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().gecoz_cuda_error_string(rc).decode()
        raise RuntimeError(f"lf_walk {what} kernel was not launched: CUDA "
                           f"error {rc}: {msg}")


def _want(t: torch.Tensor, name: str, dtype, dim: int, dev) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise TypeError(f"lf_walk: {name} must be a contiguous {dim}-D "
                        f"{dtype}, got {t.dtype} {tuple(t.shape)}")
    if t.device != dev:
        raise TypeError(f"lf_walk: {name} on {t.device}, expected {dev}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# -- decode -------------------------------------------------------------------

def decode_walks_ref(tab: torch.Tensor, seeds: torch.Tensor, rate: int,
                     mode: str, bwt: torch.Tensor | None = None,
                     code_map: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch decode walks: all walks in lockstep, one row read a
    round."""
    k, _ = MODES[mode]
    W = seeds.shape[0]
    out = torch.empty((W, rate), dtype=torch.uint8, device=seeds.device)
    idx = seeds.long()
    if k == 1:
        for j in range(rate):
            v = tab[idx]
            if mode == "packed":
                out[:, rate - 1 - j] = (v & 255).to(torch.uint8)
                idx = ((v >> 8) & 0x7FFFFF).long()
            else:
                out[:, rate - 1 - j] = bwt[idx]
                idx = (v & 0x7FFFFFFF).long()
        return out
    cmap = code_map.long() if code_map is not None else None
    for r in range(rate // k):
        row = tab[idx]
        for s in range(k):
            if mode == "lfk4":
                sym = ((row[:, 1] >> (8 * s)) & 255).to(torch.uint8)
            else:
                word = row[:, 1 + s // 8]
                sym = cmap[(word >> (4 * (s % 8))) & 15].to(torch.uint8)
            out[:, rate - 1 - (r * k + s)] = sym
        idx = row[:, 0].long()
    return out


def _check_decode(tab, seeds, rate, mode, bwt, code_map) -> None:
    if mode not in MODES:
        raise ValueError(f"decode_walks: mode must be one of {list(MODES)}, "
                         f"got {mode!r}")
    k, width = MODES[mode]
    dev = seeds.device
    _want(seeds, "seeds", _I32, 1, dev)
    _want(tab, "tab", _I32, 2 if width else 1, dev)
    if width and tab.shape[1] != width:
        raise TypeError(f"decode_walks: {mode} rows are {width} words, got "
                        f"{tab.shape[1]}")
    if rate < 1 or rate % k:
        raise ValueError(f"decode_walks: rate {rate} is not a positive "
                         f"multiple of {k} ({mode})")
    if width:
        # the kernel stages min(rate, 32) bytes a walk and reads rows in
        # 8-byte loads
        if rate > _CHUNK and rate % _CHUNK:
            raise ValueError(f"decode_walks: rate {rate} is above {_CHUNK} "
                             f"and not a multiple of it ({mode})")
        if tab.data_ptr() % 8:
            raise ValueError(f"decode_walks: {mode} tab must be 8-byte "
                             "aligned")
    if mode == "plain":
        if bwt is None:
            raise TypeError("decode_walks: mode plain reads bwt")
        _want(bwt, "bwt", torch.uint8, 1, dev)
    if mode in ("lfk16", "lfk8"):
        if code_map is None or code_map.shape != (16,):
            raise TypeError("decode_walks: lfk16/lfk8 need a uint8 [16] "
                            "code_map")
        _want(code_map, "code_map", torch.uint8, 1, dev)


def decode_walks(tab: torch.Tensor, seeds: torch.Tensor, rate: int,
                 mode: str, bwt: torch.Tensor | None = None,
                 code_map: torch.Tensor | None = None) -> torch.Tensor:
    """W LF walks of `rate` text positions each, from rows `seeds` (int32
    [W]); returns uint8 [W, rate], step j of walk w in column rate-1-j.

    `mode` names the rows of `tab`: "lfk16"/"lfk8"/"lfk4" read the fused
    k-step `lfk_tab` (int32 [n, 3] or [n, 2]; rate % k == 0; the plane
    codes of lfk16/lfk8 map back to bytes through `code_map`, uint8 [16];
    lfk4 rows hold the bytes, any alphabet, and read no map),
    "packed" and "plain" the per-step `lf_tab` (int32 [n]; plain reads the
    symbol from `bwt`)."""
    _check_decode(tab, seeds, rate, mode, bwt, code_map)
    if not seeds.is_cuda:
        if seeds.device.type != "cpu":
            raise TypeError(f"decode_walks: unsupported device {seeds.device}")
        return decode_walks_ref(tab, seeds, rate, mode, bwt, code_map)
    out = _decode_launch(tab, seeds, rate, mode, bwt, code_map)
    if seeds.shape[0]:
        LAUNCHES["decode"] += 1
        DECODE_LAUNCHES[mode] += 1
    return out


def _decode_launch(tab, seeds, rate, mode, bwt, code_map) -> torch.Tensor:
    """One launch of the decode kernel on checked CUDA tensors."""
    W = seeds.shape[0]
    out = torch.empty((W, rate), dtype=torch.uint8, device=seeds.device)
    if W == 0:
        return out
    lib = _lib()
    cmap = code_map.data_ptr() if mode in ("lfk16", "lfk8") else None
    with torch.cuda.device(seeds.device):
        rc = lib.gecoz_lf_decode(
            tab.data_ptr(), bwt.data_ptr() if mode == "plain" else None,
            seeds.data_ptr(), W, rate, _MODE_ID[mode], cmap, out.data_ptr(),
            _stream(seeds.device))
    _raise_on(rc, f"decode ({mode}, W={W}, rate={rate})")
    return out


# -- locate -------------------------------------------------------------------

def sampled_value(mark_words: torch.Tensor, mark_pre: torch.Tensor,
                  ssa_perm: torch.Tensor, sf: int, idx: torch.Tensor):
    """(is_sampled, sa_value) for rows `idx` (reference `_sampled_value`):
    the row's rank among the sampled rows picks its value."""
    p = idx.long()
    bit = ((mark_words[p >> 5] >> (p & 31).to(_I32)) & 1) != 0
    rank = rank_words(mark_words, mark_pre, p)
    val = ssa_perm[(rank - 1).clamp(min=0).long()] << sf
    return bit, val


def locate_walks_ref(tab: torch.Tensor, rows: torch.Tensor,
                     mark_words: torch.Tensor, mark_pre: torch.Tensor,
                     ssa_perm: torch.Tensor, sf: int,
                     packed: bool) -> torch.Tensor:
    """Plain PyTorch locate walks: all rows in lockstep, rate+1 reads."""
    idx = rows.long()
    steps = torch.zeros_like(rows)
    hit_idx = torch.zeros_like(idx)
    live = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    for _ in range((1 << sf) + 1):
        v = tab[idx]
        sampled = v < 0                       # bit 31 set
        hit_idx = torch.where(live & sampled, idx, hit_idx)
        live = live & ~sampled
        nxt = ((v >> 8) & 0x7FFFFF) if packed else (v & 0x7FFFFFFF)
        idx = torch.where(live, nxt.long(), idx)
        steps = steps + live.to(_I32)
    _, val = sampled_value(mark_words, mark_pre, ssa_perm, sf, hit_idx)
    return torch.where(live, -1, val + steps)


def locate_walks(tab: torch.Tensor, rows: torch.Tensor,
                 mark_words: torch.Tensor, mark_pre: torch.Tensor,
                 ssa_perm: torch.Tensor, sf: int,
                 packed: bool) -> torch.Tensor:
    """SA values of `rows` (int32 [B], each in [0, n)) by LF walks over
    the fused `lf_tab` (int32 [n], bit 31 = sampled row) to the nearest
    sampled row, then its value from the mark plane and `ssa_perm`.
    Returns int32 [B]; -1 where no sampled row was reached."""
    dev = rows.device
    _want(rows, "rows", _I32, 1, dev)
    _want(tab, "tab", _I32, 1, dev)
    for name, t in (("mark_words", mark_words), ("mark_pre", mark_pre),
                    ("ssa_perm", ssa_perm)):
        _want(t, name, _I32, 1, dev)
    B = rows.shape[0]
    if B:
        lo, hi = torch.stack(torch.aminmax(rows)).tolist()   # one sync
        if lo < 0 or hi >= tab.shape[0]:
            raise IndexError(f"locate_walks: rows outside [0, "
                             f"{tab.shape[0]})")
    if not rows.is_cuda:
        if dev.type != "cpu":
            raise TypeError(f"locate_walks: unsupported device {dev}")
        return locate_walks_ref(tab, rows, mark_words, mark_pre, ssa_perm,
                                sf, packed)
    out = torch.empty_like(rows)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.gecoz_lf_locate(
            tab.data_ptr(), rows.data_ptr(), B, mark_words.data_ptr(),
            mark_pre.data_ptr(), ssa_perm.data_ptr(), sf, int(packed),
            out.data_ptr(), _stream(dev))
    _raise_on(rc, f"locate (B={B})")
    LAUNCHES["locate"] += 1
    return out
