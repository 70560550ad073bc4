"""A block's BWT decoded out of its wavelet tree on the block's device.

The lift of a block (`fmq.device_block_from_fm`) needs the BWT on the
device.  `lift` uploads the wavelet tree's nodes as the .gcz stores them
(`HSWT.stored_streams`: each internal node a ranked bit vector, in
pre-order) with the node table in front, in one copy, and decodes them
with two entry points, a scan of the words' popcounts between them:

* `unpack(raw, nodes, total)` -> (words, pc): every node's 32-bit words
  out of its interleaved stream (bits past its length cleared) and their
  popcounts, int32 [total], total = the sum of ceil(length / 32);
* `decode(raw, words, inc, nodes, n)` -> uint8 [n], the BWT, from the
  words and their inclusive ranks: every position walked from the root to
  its leaf, one bit and one rank a level (`HSWT.getRS`).

`raw` (uint8) holds the node table, int64 [nodes, 5] (`COLS`: the node's
byte offset in the streams, its length in bits, its first word, its
0-side and its 1-side, a child's row or ~symbol at a leaf), then the
streams from `streams_at(nodes)` on, 8 zero bytes past their end.

On CUDA tensors each launches the hand-written Hopper kernel
(`csrc/hswt.cu`, built at first use, its kernels loaded by `_lib()`) and
adds one to its count in `LAUNCHES`; a failed build or launch raises.  On
CPU tensors they run the plain PyTorch versions (`unpack_ref`,
`decode_ref`), which the card is also checked against; the host's
`HSWT.decode_bwt` is the tests' oracle.  It replaces no TPU kernel: the
JAX package decodes the BWT on the host.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from gecoz_tpu_torch.ops.fmsearch import popcount32
from gecoz_tpu_torch.ops.scan import cumsum_i32
from gecoz_tpu_torch.utils import metrics

_I32 = torch.int32
COLS = 5                 # off, len, wbase, child0, child1 (int64 each)
MAX_NODES = 255          # 256 symbols

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
    lib = _build.load("hswt")
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gecoz_hswt_unpack.argtypes = [P, I, I64, I64, P, P, P]
    lib.gecoz_hswt_decode.argtypes = [P, P, P, I, I64, P, P]
    lib.gecoz_hswt_init.argtypes = []
    for fn in (lib.gecoz_hswt_unpack, lib.gecoz_hswt_decode,
               lib.gecoz_hswt_init):
        fn.restype = I
    lib.gecoz_cuda_error_string.argtypes = [I]
    lib.gecoz_cuda_error_string.restype = ctypes.c_char_p
    t0 = time.perf_counter()
    rc = lib.gecoz_hswt_init()
    if rc != 0:
        msg = lib.gecoz_cuda_error_string(rc).decode()
        raise RuntimeError(f"hswt kernels did not load: CUDA error {rc}: "
                           f"{msg}")
    INIT_SECONDS = time.perf_counter() - t0
    _LIB = lib
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().gecoz_cuda_error_string(rc).decode()
        raise RuntimeError(f"hswt {what} kernel was not launched: CUDA "
                           f"error {rc}: {msg}")


def streams_at(nodes: int) -> int:
    """Where the streams start in `raw`: past the node table."""
    return nodes * COLS * 8


def _table(raw: torch.Tensor, nodes: int) -> torch.Tensor:
    """The node table at the front of `raw`, int64 [nodes, COLS]."""
    return raw[:streams_at(nodes)].view(torch.int64).reshape(nodes, COLS)


# -- plain versions -----------------------------------------------------------

def unpack_ref(raw: torch.Tensor, nodes: int, total: int):
    """Plain PyTorch unpack: each word's four bytes gathered from its
    node's stream, the bits past the node's length cleared."""
    table = _table(raw, nodes)
    dev = raw.device
    o = torch.arange(total, dtype=torch.int64, device=dev)
    node = torch.searchsorted(table[:, 2].contiguous(), o, right=True) - 1
    w = o - table[node, 2]
    k = w << 2
    src = (streams_at(nodes) + table[node, 0] + 66 * (k >> 6)
           + 6 * (k >> 13) + (k & 63))
    b = raw[src[:, None] + torch.arange(4, device=dev)].long()
    word = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    valid = torch.clamp(table[node, 1] - (w << 5), min=0, max=32)
    word = word & ((torch.ones_like(valid) << valid) - 1)
    return (word - ((word >> 31) << 32)).to(_I32), popcount32(word)


def decode_ref(raw: torch.Tensor, words: torch.Tensor, inc: torch.Tensor,
               nodes: int, n: int) -> torch.Tensor:
    """Plain PyTorch decode: every position's walk from the root in
    lockstep, a level a step, as the kernel walks each."""
    table = _table(raw, nodes)
    dev = raw.device
    w64 = words.long() & 0xFFFFFFFF
    inc64 = inc.long() & 0xFFFFFFFF
    wbase, length = table[:, 2], table[:, 1]
    base = torch.where(wbase > 0, inc64[torch.clamp(wbase - 1, min=0)], 0)
    p = torch.arange(n, dtype=torch.int64, device=dev)
    node = torch.zeros_like(p)
    out = torch.zeros(n, dtype=torch.uint8, device=dev)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    rows = torch.arange(nodes, device=dev)
    while bool(live.any()):
        at = wbase[node] + (p >> 5)
        word = w64[at]
        b = p & 31
        bit = (word >> b) & 1
        child = torch.where(bit == 1, table[node, 4], table[node, 3])
        leaf = live & (child < 0)
        out[leaf] = (~child[leaf] & 0xFF).to(torch.uint8)
        live &= (child > rows[node]) & (child < nodes)  # else: symbol 0
        r1 = (inc64[at] - base[node] - popcount32(word)
              + popcount32(word & ((2 << b) - 1))) & 0xFFFFFFFF
        p = torch.where(bit == 1, r1 - 1, p - r1)
        node = torch.where(live, child, node)
        p = torch.clamp(torch.minimum(p, length[node] - 1), min=0)
    return out


# -- entry points -------------------------------------------------------------

def _want(t: torch.Tensor, name: str, dtype, size: int, dev) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise TypeError(f"hswt: {name} must be a contiguous 1-D {dtype}, "
                        f"got {t.dtype} {tuple(t.shape)}"
                        f"{'' if t.is_contiguous() else ' (strided)'}")
    if t.device != dev:
        raise TypeError(f"hswt: {name} on {t.device}, expected {dev}")
    if t.shape[0] < size:
        raise ValueError(f"hswt: {name} holds {t.shape[0]} elements, fewer "
                         f"than {size}")


def _dispatch(t: torch.Tensor, what: str) -> bool:
    """True: launch the kernel; False: the plain version (CPU)."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise TypeError(f"hswt {what}: unsupported device {t.device}")
    return False


def _want_raw(raw: torch.Tensor, nodes: int) -> None:
    if not 1 <= nodes <= MAX_NODES:
        raise ValueError(f"hswt: {nodes} nodes, not 1 to {MAX_NODES}")
    _want(raw, "raw", torch.uint8, streams_at(nodes) + 4, raw.device)


def unpack(raw: torch.Tensor, nodes: int, total: int):
    """(words, popcounts), int32 [total], of the `nodes` stored streams in
    `raw` (uint8, the layout at the top of this module), whose lengths
    take `total` words."""
    _want_raw(raw, nodes)
    if total < 1:
        raise ValueError(f"hswt unpack: {total} words")
    if not _dispatch(raw, "unpack"):
        return unpack_ref(raw, nodes, total)
    words, pc = (torch.empty(total, dtype=_I32, device=raw.device)
                 for _ in range(2))
    with torch.cuda.device(raw.device):
        rc = _lib().gecoz_hswt_unpack(
            raw.data_ptr(), nodes, streams_at(nodes), total,
            words.data_ptr(), pc.data_ptr(),
            torch.cuda.current_stream(raw.device).cuda_stream)
    _raise_on(rc, f"unpack ({nodes} nodes, {total} words)")
    LAUNCHES["unpack"] += 1
    return words, pc


def decode(raw: torch.Tensor, words: torch.Tensor, inc: torch.Tensor,
           nodes: int, n: int) -> torch.Tensor:
    """The n BWT symbols, uint8 [n], from the unpacked `words` of the tree
    in `raw` and their inclusive ranks `inc` (int32, the layout of
    `unpack`)."""
    _want_raw(raw, nodes)
    if n < 1:
        raise ValueError(f"hswt decode: n = {n}")
    dev = raw.device
    total = words.shape[0]
    _want(words, "words", _I32, total, dev)
    _want(inc, "inc", _I32, total, dev)
    if not _dispatch(raw, "decode"):
        return decode_ref(raw, words, inc, nodes, n)
    out = torch.empty(-(-n // 4) * 4, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().gecoz_hswt_decode(
            raw.data_ptr(), words.data_ptr(), inc.data_ptr(), nodes, n,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, f"decode ({nodes} nodes, n={n})")
    LAUNCHES["decode"] += 1
    return out[:n]


# -- the lift -----------------------------------------------------------------

def upload(hswt, device) -> tuple[torch.Tensor, int, int]:
    """The node table and stored streams of `hswt` (a host `HSWT`) on
    `device` in one copy: (raw uint8, nodes, their words)."""
    streams, table = hswt.stored_streams()
    nodes, n = len(table), hswt.shape.length
    if not 1 <= nodes <= MAX_NODES or table[0, 1] != n:
        raise ValueError(f"wavelet tree of {n} symbols: {nodes} nodes, the "
                         f"root's {table[0, 1] if nodes else 0} bits")
    full = np.empty((nodes, COLS), dtype=np.int64)
    full[:, :2], full[:, 3:] = table[:, :2], table[:, 2:]
    ends = np.cumsum((table[:, 1] + 31) // 32)
    full[:, 2] = ends - (table[:, 1] + 31) // 32
    at = streams_at(nodes)
    host = np.zeros(at + len(streams) + 8, dtype=np.uint8)
    host[:at] = full.reshape(-1).view(np.uint8)
    host[at:at + len(streams)] = streams
    return (torch.from_numpy(host).to(torch.device(device)), nodes,
            int(ends[-1]))


def lift(hswt, device) -> torch.Tensor:
    """The BWT of `hswt` (a host `HSWT`) decoded on `device`, uint8 [n]:
    `upload`, `unpack`, one scan, `decode`; no sync.  Counts n in
    `lift.bwt_symbols_device`."""
    n = hswt.shape.length
    raw, nodes, total = upload(hswt, device)
    words, pc = unpack(raw, nodes, total)
    bwt = decode(raw, words, cumsum_i32(pc), nodes, n)
    metrics.count("lift.bwt_symbols_device", n)
    return bwt
