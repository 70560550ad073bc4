"""Rank primitives and batched FM backward search (kernel K1, `fm_search`).

Port of `_rank_words`, `occ_inclusive` and `search_batch` of
gecoz_tpu/ops/fmq.py (583-613, 688-741).  `backward_search(block,
patterns, lengths)` takes the block's tensors and right-aligned patterns:

* on CUDA tensors it launches the hand-written Hopper kernel
  (`csrc/fmsearch.cu`, built at first use, its kernel loaded by `_lib()`),
  which reads the block's rank table (`rank_blocks`, attached by
  `fmq.with_rank_blocks`: one 32-byte block per occ lookup), and adds one
  to its count in `LAUNCHES`; a block without the table, or a failed build
  or launch, raises;
* on CPU tensors it runs `backward_search_ref`, the plain PyTorch version
  on the flat planes, which the card is also checked against.

`block` is any object with the fields of `ops/fmq.py::DeviceFMBlock`.
uint32 words are held in int32 tensors with the same bits.
"""

from __future__ import annotations

import ctypes
import time

import torch

_I32 = torch.int32
# BWT positions a rank block covers: 7 bit words (csrc/fmsearch.cu kBlockChars)
BLOCK_CHARS = 224

# launches of the CUDA kernel; the plain version never counts
LAUNCHES: dict[str, int] = {"fm_search": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_LIB: ctypes.CDLL | None = None
INIT_SECONDS: float | None = None       # the kernel's load time (_lib())


def _lib() -> ctypes.CDLL:
    """The built kernel library, its C signatures declared and its kernel
    loaded (first use): the first CUDA call of the library's own runtime
    and the kernel's module load happen here, not in the first launch."""
    global _LIB, INIT_SECONDS
    if _LIB is not None:
        return _LIB
    from gecoz_tpu_torch.kernels import _build
    lib = _build.load("fmsearch")
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gecoz_fm_search_max_k.argtypes = []
    lib.gecoz_fm_search.argtypes = [P, P, I64, I64, P, I64, P, P, P, I, I,
                                    P, P, P]
    lib.gecoz_fm_init.argtypes = []
    for fn in (lib.gecoz_fm_search_max_k, lib.gecoz_fm_search,
               lib.gecoz_fm_init):
        fn.restype = I
    lib.gecoz_cuda_error_string.argtypes = [I]
    lib.gecoz_cuda_error_string.restype = ctypes.c_char_p
    t0 = time.perf_counter()
    rc = lib.gecoz_fm_init()
    if rc != 0:
        msg = lib.gecoz_cuda_error_string(rc).decode()
        raise RuntimeError(f"fm_search kernel did not load: CUDA error {rc}: "
                           f"{msg}")
    INIT_SECONDS = time.perf_counter() - t0
    _LIB = lib
    return lib


# -- rank primitives ---------------------------------------------------------

def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of 32-bit words held in int64 [0, 2^32) (SWAR; torch has
    no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(_I32)


def rank_words(words: torch.Tensor, pre: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """Inclusive rank in one bit plane (u32 words as int32, exclusive
    per-word prefixes) at positions `pos` >= 0."""
    p = pos.long()
    w = p >> 5
    word = words[w].long() & 0xFFFFFFFF
    mask = (2 << (p & 31)) - 1
    return pre[w] + popcount32(word & mask)


def occ_inclusive(block, syms: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Count of `syms` in BWT[0..pos] (0 when pos < 0 or the symbol is
    absent from the block), batched: one word and one prefix read from the
    flat planes and a popcount."""
    row = block.sym_plane[syms.long()]
    base = row.clamp(min=0).long() * block.W
    p = pos.clamp(min=0).long()
    cnt = rank_words(block.plane_words, block.plane_pres, base * 32 + p)
    return torch.where((pos < 0) | (row < 0), 0, cnt)


def kmer_offset(bits: int, j: int) -> int:
    """Start row of the length-j level in the stacked k-mer table."""
    return sum(1 << (bits * i) for i in range(1, j))


def _seed_k(block, L: int) -> int:
    """Seeded suffix length: 0 when the search starts from c[] alone."""
    return min(block.kmer_k, L) if block.has_kmer and L > 1 else 0


# -- backward search ---------------------------------------------------------

def _check_lengths(lengths) -> None:
    """The search's contract: every pattern is at least one character
    long.  A length-0 row would seed on its padding byte, 0, the
    separator, and match every record end (ROADMAP C7).  torch's min of a
    host copy (numpy is shared, not copied) keeps pace with the kernel at
    2^20 patterns, where a numpy scan of them takes longer than it."""
    lengths = torch.as_tensor(lengths)
    if lengths.numel() and int(lengths.min()) < 1:
        raise ValueError("backward_search: every pattern length must be "
                         ">= 1; drop empty patterns before the search")


def backward_search_ref(block, patterns: torch.Tensor,
                        lengths: torch.Tensor):
    """Plain PyTorch `search_batch`: all patterns in lockstep, one column
    a round, on the device of the tensors.  Every length >= 1."""
    _check_lengths(lengths)
    B, L = patterns.shape
    k = _seed_k(block, L)
    if k:
        bits = block.kmer_bits
        code = torch.zeros(B, dtype=torch.int64, device=patterns.device)
        bad = torch.zeros(B, dtype=torch.bool, device=patterns.device)
        for t in range(k):
            row = block.sym_plane[patterns[:, L - 1 - t].long()]
            code |= row.clamp(min=0).long() << (bits * t)
            # a symbol absent from the block, within the query: no match
            bad |= (row < 0) & (t < lengths)
        j = lengths.clamp(1, k).long()
        code &= (1 << (bits * j)) - 1
        offs = torch.tensor([kmer_offset(bits, jj) for jj in range(k + 2)],
                            dtype=torch.int64, device=patterns.device)
        seed = block.kmer_tab[offs[j] + code]
        sp = torch.where(bad, 1, seed[:, 0])
        ep = torch.where(bad, 0, seed[:, 1])
        start_col = L - k
    else:
        last = patterns[:, L - 1].long()
        sp = block.c[last]
        ep = block.c[last + 1] - 1
        start_col = L - 1
    for col in range(start_col - 1, -1, -1):
        ch = patterns[:, col].long()
        active = (col >= L - lengths) & (sp <= ep)
        cs = block.c[ch]
        nsp = cs + occ_inclusive(block, ch, sp - 1)
        nep = cs + occ_inclusive(block, ch, ep) - 1
        sp = torch.where(active, nsp, sp)
        ep = torch.where(active, nep, ep)
    return sp, ep


def _check(block, patterns: torch.Tensor, lengths: torch.Tensor) -> None:
    if patterns.dtype != torch.uint8 or patterns.dim() != 2 \
            or not patterns.is_contiguous():
        raise TypeError("backward_search wants contiguous uint8 patterns "
                        f"[B, L], got {patterns.dtype} {tuple(patterns.shape)}")
    if lengths.dtype != _I32 or lengths.shape != patterns.shape[:1] \
            or not lengths.is_contiguous():
        raise TypeError("backward_search wants contiguous int32 lengths "
                        f"[B], got {lengths.dtype} {tuple(lengths.shape)}")
    for t in (block.plane_words, block.plane_pres, block.c,
              block.sym_plane, block.kmer_tab, lengths):
        if t.device != patterns.device:
            raise TypeError(f"backward_search: a tensor on {t.device}, "
                            f"patterns on {patterns.device}")
        if t.dtype != _I32 or not t.is_contiguous():
            raise TypeError("backward_search: block tensors must be "
                            f"contiguous int32, got {t.dtype}")
    if block.c.shape != (257,) or block.sym_plane.shape != (256,):
        raise TypeError("backward_search: c must be [257], sym_plane [256]")


def _check_rank_blocks(block) -> int:
    """Blocks per plane of the block's rank table; raises when the table is
    missing or not what the kernel reads."""
    rb = block.rank_blocks
    if rb.shape[0] == 0:
        raise ValueError("backward_search on the card reads the block's rank "
                         "table: attach it with fmq.with_rank_blocks")
    nplanes = block.plane_words.shape[0] // max(block.W, 1)
    wb = -(-block.n // BLOCK_CHARS)
    if rb.dtype != _I32 or tuple(rb.shape) != (nplanes * wb, 8) \
            or not rb.is_contiguous():
        raise TypeError(f"backward_search: rank_blocks must be contiguous "
                        f"int32 [{nplanes * wb}, 8], got {rb.dtype} "
                        f"{tuple(rb.shape)}")
    if rb.device != block.plane_words.device:
        raise TypeError(f"backward_search: rank_blocks on {rb.device}")
    if rb.data_ptr() % 32:
        raise ValueError("backward_search: rank_blocks must be 32-byte "
                         "aligned (one sector a block)")
    return wb


def _search_launch(block, patterns, lengths):
    """One launch of the search kernel on checked CUDA tensors."""
    B, L = patterns.shape
    sp = torch.empty(B, dtype=_I32, device=patterns.device)
    ep = torch.empty_like(sp)
    wb = _check_rank_blocks(block)
    if B == 0:
        return sp, ep
    lib = _lib()
    k = _seed_k(block, L)
    bits = block.kmer_bits if k else 0
    if k > lib.gecoz_fm_search_max_k() or bits * k > 30:
        raise ValueError(f"backward_search: k-mer table of k={k}, "
                         f"{bits} bits per code is beyond the kernel")
    if k and block.kmer_tab.data_ptr() % 8:
        raise ValueError("backward_search: kmer_tab must be 8-byte aligned")
    kmer = block.kmer_tab.data_ptr() if k else None
    with torch.cuda.device(patterns.device):
        stream = torch.cuda.current_stream(patterns.device).cuda_stream
        rc = lib.gecoz_fm_search(
            patterns.data_ptr(), lengths.data_ptr(), B, L,
            block.rank_blocks.data_ptr(), wb, block.c.data_ptr(),
            block.sym_plane.data_ptr(), kmer, bits, k, sp.data_ptr(),
            ep.data_ptr(), stream)
    if rc != 0:
        msg = lib.gecoz_cuda_error_string(rc).decode()
        raise RuntimeError(f"fm_search kernel (B={B}, L={L}) was not "
                           f"launched: CUDA error {rc}: {msg}")
    return sp, ep


def backward_search(block, patterns: torch.Tensor, lengths: torch.Tensor,
                    host_lengths=None):
    """Backward-search many patterns against one block.

    `patterns` is uint8 [B, L] right-aligned (last character at column
    L-1, leading columns zero-padded), `lengths` int32 [B], every length
    >= 1 and L >= 1.  The lengths are checked on the host: pass
    `host_lengths`, the caller's host copy of `lengths` (numpy or a CPU
    tensor), and a call on the card adds no sync; without it the check
    reads `lengths` back.  With a k-mer table attached the last min(len,
    k) characters resolve in one table read.  On the card the block needs
    its rank table (`fmq.with_rank_blocks`).  Returns int32 (sp, ep)
    inclusive row ranges; ep < sp means no match."""
    _check(block, patterns, lengths)
    if patterns.shape[1] == 0:
        raise ValueError("backward_search: patterns need L >= 1 columns")
    if host_lengths is not None and len(host_lengths) != patterns.shape[0]:
        raise TypeError(f"backward_search: {len(host_lengths)} host lengths "
                        f"for {patterns.shape[0]} patterns")
    _check_lengths(lengths if host_lengths is None else host_lengths)
    if patterns.is_cuda:
        out = _search_launch(block, patterns, lengths)
        if patterns.shape[0]:
            LAUNCHES["fm_search"] += 1
        return out
    if patterns.device.type != "cpu":
        raise TypeError(f"backward_search: unsupported device "
                        f"{patterns.device}")
    return backward_search_ref(block, patterns, lengths)
