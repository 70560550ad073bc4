"""The .gcx sampled suffix array decoded on the block's device.

The lift of a block (`fmq.device_block_from_fm`) needs the sampled rows in
ascending order, the sampled values (SA >> sf) in row order, their inverse,
the mark plane's words and rank prefixes, and the wrap row (the row of SA
value 0).  `lift` uploads the .gcx's bytes as they are stored
(`SampledSAIndex.stored_streams`: the mark, a ranked bit vector over the
block's n rows, and the index wavelet tree's bit_length(m) level planes
over its m sampled values) and decodes them with two entry points, a scan
of the words' popcounts between them:

* `unpack(raw, n, m, planes_at)` -> (words, pc): every vector's 32-bit
  words out of its interleaved stream (bits past its length cleared) and
  their popcounts, int32 [ceil(n/32) + nlv * ceil(m/32)];
* `decode(words, inc, n, m)` -> (perm, inv, rows, mark_pre, info), from the
  words and their inclusive ranks: perm, inv and rows int32 [m], mark_pre
  int32 [ceil(n/32)], info int32 [2 + nlv] (the mark's one-count, the wrap
  row or -1, each plane's one-count).

On CUDA tensors each launches the hand-written Hopper kernel (`csrc/gcx.cu`,
built at first use, its kernels loaded by `_lib()`) and adds one to its
count in `LAUNCHES`; a failed build or launch raises.  On CPU tensors they
run the plain PyTorch versions (`unpack_ref`, `decode_ref`), which the card
is also checked against.

The walk is `index/iwt.py::LazyIWT.get` for every sampled position at once,
with one plane word and one rank read a level (the source note of
`csrc/gcx.cu` says why); no host `IndexWaveletTree` is built.  It replaces
no TPU kernel: the JAX package decodes the .gcx on the host.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from gecoz_tpu_torch.index.rankbv import rbv_bytes
from gecoz_tpu_torch.ops.fmsearch import popcount32
from gecoz_tpu_torch.ops.scan import cumsum_i32
from gecoz_tpu_torch.utils import metrics

_I32 = torch.int32

# launches of the CUDA kernels per entry point; plain versions never count
LAUNCHES: dict[str, int] = {"unpack": 0, "decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_LIB: ctypes.CDLL | None = None
INIT_SECONDS: float | None = None       # the kernels' load time (_lib())


def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared and its kernels
    loaded (first use)."""
    global _LIB, INIT_SECONDS
    if _LIB is not None:
        return _LIB
    from gecoz_tpu_torch.kernels import _build
    lib = _build.load("gcx")
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gecoz_gcx_unpack.argtypes = [P, I64, I64, I, I64, I64, P, P, P]
    lib.gecoz_gcx_decode.argtypes = [P, P, I64, I64, I, P, P, P, P, P, P]
    lib.gecoz_gcx_init.argtypes = []
    for fn in (lib.gecoz_gcx_unpack, lib.gecoz_gcx_decode,
               lib.gecoz_gcx_init):
        fn.restype = I
    lib.gecoz_cuda_error_string.argtypes = [I]
    lib.gecoz_cuda_error_string.restype = ctypes.c_char_p
    t0 = time.perf_counter()
    rc = lib.gecoz_gcx_init()
    if rc != 0:
        msg = lib.gecoz_cuda_error_string(rc).decode()
        raise RuntimeError(f"gcx kernels did not load: CUDA error {rc}: "
                           f"{msg}")
    INIT_SECONDS = time.perf_counter() - t0
    _LIB = lib
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().gecoz_cuda_error_string(rc).decode()
        raise RuntimeError(f"gcx {what} kernel was not launched: CUDA error "
                           f"{rc}: {msg}")


def _shape(n: int, m: int) -> tuple[int, int, int]:
    """(mark words, words a plane, planes) of n rows and m sampled values."""
    return (n + 31) // 32, (m + 31) // 32, int(m).bit_length()


class DeviceGcx(NamedTuple):
    """A block's .gcx on its device, as `DeviceFMBlock` holds it."""

    wrap_row: torch.Tensor     # int32 [] row with SA value 0
    mark_words: torch.Tensor   # u32 bits as int32 [ceil(n/32)]
    mark_pre: torch.Tensor     # int32 [ceil(n/32)] exclusive rank prefixes
    mark_rows: torch.Tensor    # int32 [m] sampled rows, ascending
    ssa_perm: torch.Tensor     # int32 [m] sampled values >> sf, row order
    ssa_inv: torch.Tensor      # int32 [m] inverse permutation


# -- plain versions -----------------------------------------------------------

def unpack_ref(raw: torch.Tensor, n: int, m: int, planes_at: int):
    """Plain PyTorch unpack: each word's four bytes gathered from its
    stream, the bits past the vector's length cleared."""
    wn, wm, nlv = _shape(n, m)
    dev = raw.device
    o = torch.arange(wn + nlv * wm, dtype=torch.int64, device=dev)
    plane = torch.clamp(o - wn, min=0) // wm
    mark = o < wn
    w = torch.where(mark, o, o - wn - plane * wm)
    at = torch.where(mark, 0, planes_at + plane * rbv_bytes(m))
    length = torch.where(mark, n, m)
    k = w << 2
    src = at + 66 * (k >> 6) + 6 * (k >> 13) + (k & 63)
    b = raw[src[:, None] + torch.arange(4, device=dev)].long()
    word = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    valid = torch.clamp(length - (w << 5), max=32)
    word = word & ((torch.ones_like(valid) << valid) - 1)
    return (word - ((word >> 31) << 32)).to(_I32), popcount32(word)


def decode_ref(words: torch.Tensor, inc: torch.Tensor, n: int, m: int):
    """Plain PyTorch decode: the level walks of every sampled position in
    lockstep, then the mark's compaction."""
    wn, wm, nlv = _shape(n, m)
    dev = words.device
    w64 = words.long() & 0xFFFFFFFF
    inc64 = inc.long()
    p = torch.arange(m, dtype=torch.int64, device=dev)
    lo = torch.zeros_like(p)
    val = torch.zeros_like(p)
    for i in range(nlv):
        at = wn + i * wm
        word = w64[at + (p >> 5)]
        bit = (word >> (p & 31)) & 1
        val = (val << 1) | bit
        if i == nlv - 1:
            break
        s = nlv - i
        mid = torch.clamp(lo + (1 << (s - 1)), max=m)
        hi = torch.clamp(lo + (1 << s), max=m)
        r1p = (inc64[at + (p >> 5)] - inc64[at - 1] - popcount32(word)
               + popcount32(word & ((2 << (p & 31)) - 1)))
        r1lo = lo >> 1
        one = bit == 1
        p = torch.where(one, mid + r1p - r1lo - 1, p - r1p + r1lo)
        lo, hi = torch.where(one, mid, lo), torch.where(one, hi, mid)
        p = torch.minimum(torch.maximum(p, lo), hi - 1)
    inv = torch.zeros(m, dtype=_I32, device=dev)
    ok = val < m
    inv[val[ok]] = torch.arange(m, dtype=_I32, device=dev)[ok]
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((w64[:wn, None] >> shifts) & 1).reshape(-1)
    rows = torch.nonzero(bits).flatten()[:m].to(_I32)
    rows = torch.cat([rows, rows.new_zeros(m - rows.shape[0])])
    mark_pre = inc[:wn] - popcount32(w64[:wn])
    ends = inc64[wn - 1::wm][:nlv + 1]            # the mark's and planes' last
    j0 = int(inv[0])                              # the sample of value 0
    wrap = int(rows[j0]) if (val == 0).any() and j0 < ends[0] else -1
    info = torch.cat([ends[:1], torch.tensor([wrap], device=dev),
                      ends[1:] - ends[:-1]]).to(_I32)
    return val.to(_I32), inv, rows, mark_pre, info


# -- entry points -------------------------------------------------------------

def _want(t: torch.Tensor, name: str, dtype, size: int, dev) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise TypeError(f"gcx: {name} must be a contiguous 1-D {dtype}, got "
                        f"{t.dtype} {tuple(t.shape)}"
                        f"{'' if t.is_contiguous() else ' (strided)'}")
    if t.device != dev:
        raise TypeError(f"gcx: {name} on {t.device}, expected {dev}")
    if t.shape[0] < size:
        raise ValueError(f"gcx: {name} holds {t.shape[0]} elements, fewer "
                         f"than {size}")


def _dispatch(t: torch.Tensor, what: str) -> bool:
    """True: launch the kernel; False: the plain version (CPU)."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise TypeError(f"gcx {what}: unsupported device {t.device}")
    return False


def unpack(raw: torch.Tensor, n: int, m: int, planes_at: int):
    """(words, popcounts), int32 [ceil(n/32) + nlv * ceil(m/32)], of the
    stored streams in `raw` (uint8): the mark's n bits at 0, the nlv =
    bit_length(m) planes' m bits each from `planes_at` on, `rbv_bytes(m)`
    apart, every stream readable 4 bytes past its end."""
    wn, wm, nlv = _shape(n, m)
    if n < 1 or m < 1:
        raise ValueError(f"gcx unpack: n = {n}, m = {m}")
    _want(raw, "raw", torch.uint8, planes_at + nlv * rbv_bytes(m) + 4,
          raw.device)
    if not _dispatch(raw, "unpack"):
        return unpack_ref(raw, n, m, planes_at)
    words, pc = (torch.empty(wn + nlv * wm, dtype=_I32, device=raw.device)
                 for _ in range(2))
    with torch.cuda.device(raw.device):
        rc = _lib().gecoz_gcx_unpack(
            raw.data_ptr(), n, m, nlv, planes_at, rbv_bytes(m),
            words.data_ptr(), pc.data_ptr(),
            torch.cuda.current_stream(raw.device).cuda_stream)
    _raise_on(rc, f"unpack (n={n}, m={m})")
    LAUNCHES["unpack"] += 1
    return words, pc


def decode(words: torch.Tensor, inc: torch.Tensor, n: int, m: int):
    """(perm, inv, rows, mark_pre, info) of a block's .gcx from its unpacked
    `words` and their inclusive ranks `inc` (int32, the layout of
    `unpack`): perm, inv, rows int32 [m], mark_pre int32 [ceil(n/32)], info
    int32 [2 + nlv], the mark's one-count, the wrap row (-1: none), each
    plane's one-count."""
    wn, wm, nlv = _shape(n, m)
    if n < 1 or m < 1:
        raise ValueError(f"gcx decode: n = {n}, m = {m}")
    dev = words.device
    _want(words, "words", _I32, wn + nlv * wm, dev)
    _want(inc, "inc", _I32, wn + nlv * wm, dev)
    if not _dispatch(words, "decode"):
        return decode_ref(words, inc, n, m)
    perm, inv, rows = (torch.empty(m, dtype=_I32, device=dev)
                       for _ in range(3))
    mark_pre = torch.empty(wn, dtype=_I32, device=dev)
    info = torch.empty(2 + nlv, dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().gecoz_gcx_decode(
            words.data_ptr(), inc.data_ptr(), n, m, nlv, perm.data_ptr(),
            inv.data_ptr(), rows.data_ptr(), mark_pre.data_ptr(),
            info.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, f"decode (n={n}, m={m})")
    LAUNCHES["decode"] += 1
    return perm, inv, rows, mark_pre, info


# -- the lift -----------------------------------------------------------------

def _ones_below(m: int, b: int) -> int:
    """How many of 0..m-1 have bit b set: what an IWT plane of a
    permutation of them counts."""
    return ((m >> (b + 1)) << b) + max(0, (m & ((2 << b) - 1)) - (1 << b))


def upload(index, device) -> tuple[torch.Tensor, int]:
    """The stored streams of `index` (a host `SampledSAIndex`) on `device`
    in one copy: (raw uint8, where the planes start), the mark at 0, the
    planes 8-byte aligned after it, 8 zero bytes past the end."""
    mark, planes = index.stored_streams()
    at = -(-len(mark) // 8) * 8
    host = np.zeros(at + len(planes) + 8, dtype=np.uint8)
    host[:len(mark)] = mark
    host[at:at + len(planes)] = planes
    return torch.from_numpy(host).to(torch.device(device)), at


def lift(index, device) -> DeviceGcx:
    """The .gcx of `index` (a host `SampledSAIndex`) decoded on `device`:
    `upload`, `unpack`, one scan, `decode`, then one sync, the fetch of
    `info`, which holds the mark's count to m (as `sampled_rows` does),
    each level's to a permutation's, and finds the wrap row.  Counts m in
    `lift.gcx_values_device`."""
    n, m = index.mark.length, index.ssa_len
    raw, planes_at = upload(index, device)
    words, pc = unpack(raw, n, m, planes_at)
    perm, inv, rows, mark_pre, info = decode(words, cumsum_i32(pc), n, m)
    marked, wrap, *ones = info.tolist()
    if marked != m:
        raise ValueError(
            f"block [{index.name}] of {n} rows at sampling factor "
            f"{index.sampling_factor}: {marked} marked rows against {m} "
            "sampled values")
    want = [_ones_below(m, len(ones) - 1 - i) for i in range(len(ones))]
    if ones != want or wrap < 0:
        raise ValueError(f"block [{index.name}]: the .gcx's {len(ones)} IWT "
                         f"levels count {ones} ones, not a permutation's "
                         f"{want}")
    metrics.count("lift.gcx_values_device", m)
    wn = (n + 31) // 32
    return DeviceGcx(info[1], words[:wn], mark_pre, rows, perm, inv)
