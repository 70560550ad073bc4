"""FM-index query engine on the card: query state, tables, search, locate,
decode.

Port of gecoz_tpu/ops/fmq.py: `DeviceFMBlock` (41-131), the query-state
builds (`build_device_block_jit` 507-578, `build_device_block_parts_jit`
394-448, `device_block_from_fm` 386), the tables (`with_lf_table` 210,
`with_locate_table` 170, `with_kmer_table` 635; and the port's own
search table, `with_rank_blocks`), the queries (`occ_inclusive`
591, `lf_batch` 616, `search_batch` 689, `locate_batch` 756,
`decode_text_jit` 816); `decode_text_device` (923) is the port's
`tools/driver.py::_device_decode`, phase by phase.  Every function
runs on the device of the block's tensors.  The two pointer chases run
through hand-written CUDA kernels on the card: backward search through K1
(`ops/fmsearch.py`), the decode walks and the fused-table locate walk
through K2 (`ops/lfwalk.py`); on CPU tensors they run their plain PyTorch
versions.

Differences from the reference:

* `DeviceFMBlock` is a dataclass of tensors.  uint32 words and table rows
  are stored as int32 tensors with the same bits (`block_to_numpy` views
  them back as uint32), so bit 31 of an `lf_tab` row (the sampled mark)
  reads as a negative int32.
* The reference splits the plane layout at `_PAIR_LIMIT` into a fused
  (word, prefix) pair table for the TPU's (8, 128) tiling; the port keeps
  the flat `plane_words`/`plane_pres`, and for the search kernel K1 a rank
  table of 32-byte blocks (`rank_blocks`), one sector per occ lookup.
* Permutations are composed by direct gather (`lf[lf]`), where the
  reference composes them on the sort side; the tables are the same.
* The lift uploads no BWT: the wavelet tree's stored node streams go up
  and are decoded on the device (`ops/hswt_device.py`, the kernels of
  `csrc/hswt.cu` on the card), where the reference decodes the BWT on the
  host and uploads it 2-bit packed (`utils/xfer.py`, as its 4-bit text
  fetch, not ported).
* torch has no popcount: a SWAR popcount on int64 stands in.
* Blocks of more than 16 symbols (protein, IUPAC codes in both cases, up
  to all 256 byte values): the reference's plane engine refuses them
  ("exceeds the plane engine"), so its decompress decodes them on the
  host tier and its `--backend device` logs the failure and falls back
  there.  The port serves them on the device with the same output: the
  decode rows past `CODE_PLANES` planes hold bytes (k = 4) where the
  4-bit plane codes of k = 16 and 8 do not fit, and the search's k-mer
  table codes `bits` = 5-8 bits a plane.
* The decode lift (`device_block_from_fm(..., planes=False)`) builds no
  bit planes, since the decode walks read none; c comes from a histogram
  of the BWT.  The reference's decode builds them.
* The lift decodes the .gcx on the device from its packed bits
  (`ops/gcx.py`, the kernel of `csrc/gcx.cu` on the card); the reference
  decodes the sampled rows and values on the host and uploads them.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from gecoz_tpu_torch.ops import fmsearch, gcx, hswt_device, lfwalk
from gecoz_tpu_torch.ops.fmsearch import occ_inclusive
from gecoz_tpu_torch.ops.fmsearch import popcount32 as _popcount32
from gecoz_tpu_torch.ops.scan import cumsum_i32
from gecoz_tpu_torch.utils import metrics

_I32 = torch.int32
# planes the 4-bit codes of the k = 16 and k = 8 decode rows can name; a
# block with more decodes through byte rows (k = 4)
CODE_PLANES = 16

# lf values below this pack with the symbol in one 32-bit row (tests
# monkeypatch it to reach the plain row format at small sizes)
_PACK_LIMIT = 1 << 23


@dataclass
class DeviceFMBlock:
    """Query state of one block."""

    bwt: torch.Tensor          # uint8 [n] BWT bytes
    plane_words: torch.Tensor  # u32 bits as int32 [sigma*W] bit words;
                               # empty [0] when not built (decode lift)
    plane_pres: torch.Tensor   # u32 bits as int32 [sigma*W] exclusive
                               # per-word rank prefixes; empty [0] likewise
    c: torch.Tensor            # int32 [257] cumulative symbol counts
    sym_plane: torch.Tensor    # int32 [256] byte -> plane row (-1 absent)
    wrap_row: torch.Tensor     # int32 [] row with SA value 0
    mark_words: torch.Tensor   # u32 bits as int32 [W] sampled-row plane
    mark_pre: torch.Tensor     # int32 [W]
    mark_rows: torch.Tensor    # int32 [m] sampled rows, ascending
    ssa_perm: torch.Tensor     # int32 [m] sampled SA values >> sf, row order
    ssa_inv: torch.Tensor      # int32 [m] inverse permutation
    lf_tab: torch.Tensor       # u32 bits as int32 [n] fused LF rows:
                               # (lf << 8) | sym below _PACK_LIMIT, else
                               # plain lf; bit 31 = sampled row; empty [0]
                               # when not built
    lfk_tab: torch.Tensor      # u32 bits as int32 [n, 3] k=16 rows (LF^16,
                               # two words of eight 4-bit plane codes), or
                               # [n, 2] k=8 (LF^8, eight codes) / k=4 (LF^4,
                               # four symbol bytes); empty [0, 2]
    kmer_tab: torch.Tensor     # int32 [T, 2] (sp, ep) of every plane-coded
                               # string of length 1..kmer_k, level j at
                               # kmer_offset(kmer_bits, j); empty [0, 2]
    loc_tab: torch.Tensor      # int32 [n, 2] (first sampled row on the
                               # row's LF path, steps to it); empty [0, 2]
    rank_blocks: torch.Tensor  # u32 bits as int32 [sigma*Wb, 8], Wb =
                               # ceil(n/224): per plane and 224 positions,
                               # the rank prefix and 7 bit words (K1's occ
                               # table); empty [0, 8]
    sf: int                    # sampling factor
    kmer_bits: int = 0         # bits per plane code of kmer_tab
    kmer_k: int = 0            # longest seeded suffix
    lfk_k: int = 0             # LF steps per lfk_tab row (4, 8 or 16)

    @property
    def n(self) -> int:
        return self.bwt.shape[0]

    @property
    def W(self) -> int:
        return (self.bwt.shape[0] + 31) // 32

    @property
    def has_lf(self) -> bool:
        return self.lf_tab.shape[0] > 0

    @property
    def lf_packed(self) -> bool:
        """lf_tab rows carry the symbol in the low byte (small blocks)."""
        return self.bwt.shape[0] < _PACK_LIMIT

    @property
    def has_lfk(self) -> bool:
        return self.lfk_tab.shape[0] > 0

    @property
    def lfk_steps(self) -> int:
        """LF steps per fused-table read (4, 8 or 16)."""
        return self.lfk_k

    @property
    def has_kmer(self) -> bool:
        return self.kmer_tab.shape[0] > 0

    @property
    def has_loc(self) -> bool:
        return self.loc_tab.shape[0] > 0

    @property
    def has_rank_blocks(self) -> bool:
        return self.rank_blocks.shape[0] > 0


_U32_FIELDS = ("plane_words", "plane_pres", "mark_words", "lf_tab",
               "lfk_tab", "rank_blocks")
_INT_FIELDS = ("sf", "kmer_bits", "kmer_k", "lfk_k")


def _no_tables(dev) -> dict[str, torch.Tensor]:
    """The optional tables, empty (the reference's shapes; rank_blocks is
    the port's own)."""
    return dict(lf_tab=torch.zeros(0, dtype=_I32, device=dev),
                lfk_tab=torch.zeros((0, 2), dtype=_I32, device=dev),
                kmer_tab=torch.zeros((0, 2), dtype=_I32, device=dev),
                loc_tab=torch.zeros((0, 2), dtype=_I32, device=dev),
                rank_blocks=torch.zeros((0, 8), dtype=_I32, device=dev))


def block_to_numpy(block: DeviceFMBlock) -> dict[str, np.ndarray]:
    """Fields as host numpy arrays in the reference's dtypes (uint32 words
    and table rows; the static ints as ints)."""
    out: dict[str, np.ndarray] = {}
    for f in fields(block):
        v = getattr(block, f.name)
        if f.name in _INT_FIELDS:
            out[f.name] = int(v)
            continue
        a = v.detach().cpu().numpy()
        out[f.name] = a.view(np.uint32) if f.name in _U32_FIELDS else a
    return out


def block_from_numpy(fields_np: dict, sf: int) -> DeviceFMBlock:
    """The port's block from the reference's `DeviceFMBlock` taken as a
    dict of numpy arrays (e.g. `{k: np.asarray(v) for k, v in
    ref._asdict().items()}`), tables and static ints included.

    A non-empty `plane_pairs` [sigma*W, 2] maps to the flat
    `plane_words`/`plane_pres`; `rank_blocks`, which the reference does not
    have, is empty unless given.  The tensors are on the CPU.
    """
    src = dict(fields_np)
    src.setdefault("rank_blocks", np.zeros((0, 8), np.uint32))
    pairs = src.get("plane_pairs")
    if pairs is not None and np.asarray(pairs).shape[0] > 0:
        pairs = np.asarray(pairs)
        src["plane_words"] = pairs[:, 0]
        src["plane_pres"] = pairs[:, 1]
    kw = {}
    for f in fields(DeviceFMBlock):
        if f.name in _INT_FIELDS:
            kw[f.name] = int(src.get(f.name, 0))
            continue
        a = np.array(src[f.name])           # a copy, 0-d kept 0-d
        if f.name in _U32_FIELDS or a.dtype == np.uint32:
            a = a.astype(np.uint32).view(np.int32)
        elif f.name != "bwt":
            a = a.astype(np.int32)
        kw[f.name] = torch.from_numpy(a)
    kw["sf"] = int(sf)
    return DeviceFMBlock(**kw)


# -- query-state build -------------------------------------------------------

def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 (any int/bool dtype) [..., n] -> uint32 words [..., ceil(n/32)]
    held in int64, LSB-first."""
    n = bits.shape[-1]
    W = (n + 31) // 32
    b = bits.to(torch.int64)
    if W * 32 != n:
        b = torch.cat([b, b.new_zeros(*b.shape[:-1], W * 32 - n)], -1)
    weights = torch.ones(32, dtype=torch.int64, device=b.device) \
        << torch.arange(32, dtype=torch.int64, device=b.device)
    return (b.view(*b.shape[:-1], W, 32) * weights).sum(-1)


def _plane(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(words as int64 uint32 values, exclusive per-word rank prefix)."""
    words = _pack_bits(bits)
    pc = _popcount32(words)
    pre = torch.cat([pc.new_zeros(1), cumsum_i32(pc)[:-1]])
    return words, pre


def _u32_as_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same bits."""
    return (words - ((words >> 31) << 32)).to(_I32)


def _sym_plane(symbols: tuple[int, ...], dev) -> torch.Tensor:
    """int32 [256]: byte -> its plane row in `symbols` order, -1 absent."""
    sym_plane = np.full(256, -1, dtype=np.int32)
    sym_plane[list(symbols)] = np.arange(len(symbols), dtype=np.int32)
    return torch.from_numpy(sym_plane).to(dev)


# characters times planes built at once: a short block builds all its
# planes in one pass (a few launches, not a few dozen a plane), a long one
# a plane at a time, so the build's int64 bit temporaries stay near 128 MB
PLANE_CHUNK_CHARS = 1 << 24


def _symbol_planes(bwt: torch.Tensor, symbols: tuple[int, ...]):
    """(plane_words, plane_pres, c, sym_plane) of the BWT over the static
    alphabet `symbols` (plane order); symbol counts fall out of the plane
    popcounts.  The planes are built PLANE_CHUNK_CHARS // n at a time and
    written into the outputs, so the build holds sigma/4 bytes a character
    and one chunk's temporaries."""
    dev = bwt.device
    n = bwt.shape[0]
    W = (n + 31) // 32
    words = torch.empty((len(symbols), W), dtype=_I32, device=dev)
    pres = torch.empty((len(symbols), W), dtype=_I32, device=dev)
    counts = torch.zeros(256, dtype=_I32, device=dev)
    sym = torch.tensor(symbols, dtype=torch.uint8, device=dev)
    per = max(1, PLANE_CHUNK_CHARS // max(n, 1))
    for lo in range(0, len(symbols), per):
        s = sym[lo:lo + per]
        w = _pack_bits(bwt[None, :] == s[:, None])
        pc = _popcount32(w)
        # the planes' exclusive prefixes: one scan over the chunk's planes
        # end to end, less each plane's start (the counts sum to <= n)
        inc = cumsum_i32(pc.reshape(-1)).view(pc.shape)
        base = inc[:, :1] - pc[:, :1]
        words[lo:lo + per] = _u32_as_i32(w)
        pres[lo:lo + per] = inc - pc - base
        counts[s.long()] = inc[:, -1] - base[:, 0]
    c = torch.cat([counts.new_zeros(1), cumsum_i32(counts)])
    return (words.view(-1), pres.view(-1), c, _sym_plane(symbols, dev))


def _histogram_c(bwt: torch.Tensor) -> torch.Tensor:
    """c (int32 [257]) from a histogram of the BWT, without the planes."""
    counts = torch.bincount(bwt, minlength=256).to(_I32)
    return torch.cat([counts.new_zeros(1), cumsum_i32(counts)])


def n_planes(block: DeviceFMBlock) -> int:
    """The block's alphabet size: its plane rows, built or not."""
    return int((block.sym_plane >= 0).sum())


def _need_planes(block: DeviceFMBlock, what: str) -> None:
    if block.n and block.plane_words.shape[0] == 0:
        raise ValueError(f"{what} reads the bit planes, which this block was "
                         "lifted without (device_block_from_fm(..., "
                         "planes=False))")


def build_device_block(bwt: torch.Tensor, sa: torch.Tensor, sf: int,
                       symbols: tuple[int, ...]) -> DeviceFMBlock:
    """Query-state construction on the BWT's device (reference
    `build_device_block_jit`).

    `symbols` is the static alphabet (plane order); symbols outside it must
    not occur in `bwt`.  The sampled-row count is exactly ceil(n/rate).
    The sampled rows are compacted with one partition sort (the
    reference's TPU branch).
    """
    dev = bwt.device
    n = bwt.shape[0]
    rate = 1 << sf
    m = (n + rate - 1) // rate
    words, pres, c, sym_plane = _symbol_planes(bwt, symbols)

    marked = (sa & (rate - 1)) == 0
    mark_words, mark_pre = _plane(marked)
    # sampled values in row order via one stable partition sort (marked
    # rows first); the (not-marked, row) key packs into one int31 word, and
    # its low bits are the select-1 table
    iota = torch.arange(n, dtype=_I32, device=dev)
    pkey = ((~marked).to(_I32) << 30) | iota
    keys_s, order = torch.sort(pkey, stable=True)
    perm = (sa >> sf)[order[:m]]
    mark_rows = keys_s[:m] & ((1 << 30) - 1)
    inv = torch.zeros(m, dtype=_I32, device=dev)
    inv[perm.long()] = torch.arange(m, dtype=_I32, device=dev)
    wrap = torch.argmax((sa == 0).to(_I32)).to(_I32)

    return DeviceFMBlock(
        bwt=bwt, plane_words=words, plane_pres=pres, c=c,
        sym_plane=sym_plane, wrap_row=wrap,
        mark_words=_u32_as_i32(mark_words), mark_pre=mark_pre,
        mark_rows=mark_rows, ssa_perm=perm, ssa_inv=inv, sf=sf,
        **_no_tables(dev))


def build_device_block_parts(bwt: torch.Tensor, parts: gcx.DeviceGcx,
                             sf: int, symbols: tuple[int, ...],
                             planes: bool = True) -> DeviceFMBlock:
    """Query state on the BWT's device from the decode-path parts: the BWT
    plus the .gcx decoded on the same device (`gcx.lift`, the wrap row
    included); no suffix array (reference `build_device_block_parts_jit`,
    which takes the sampled rows and values and the wrap row and builds
    the mark plane and the inverse itself).  planes=False leaves the bit
    planes empty and takes c from a histogram (decode reads no plane)."""
    dev = bwt.device
    if planes:
        words, pres, c, sym_plane = _symbol_planes(bwt, symbols)
    else:
        words = torch.zeros(0, dtype=_I32, device=dev)
        pres = torch.zeros(0, dtype=_I32, device=dev)
        c, sym_plane = _histogram_c(bwt), _sym_plane(symbols, dev)
    return DeviceFMBlock(
        bwt=bwt, plane_words=words, plane_pres=pres, c=c,
        sym_plane=sym_plane, sf=int(sf), **parts._asdict(),
        **_no_tables(dev))


def device_block_from_fm(fm, device, planes: bool = True) -> DeviceFMBlock:
    """Lift a host FMIndex (gecoz_tpu.index.fm) onto `device`: the wavelet
    tree's and the .gcx's stored bytes go up and are decoded there (the
    BWT by `hswt_device.lift`; the sampled rows and values, the mark plane
    and the wrap row by `gcx.lift`), and planes and c are built there; the
    host's `fm.bwt` is not read.  Any alphabet, up to all 256 byte values;
    the planes cost about sigma/4 bytes a character, and planes=False (the
    decode lift) skips them.  Phases: `lift.bwt` (the tree's streams up,
    unpacked, ranked and walked on the device, no sync; counters
    `lift.bwt_symbols` and `lift.bwt_symbols_device`, the symbols lifted
    and those the device decoded), `lift.gcx` (the .gcx decoded on the
    device, ending in a sync; counters `lift.gcx_values` and
    `lift.gcx_values_device`) and `lift.build` (the build's launches)."""
    fm._require_index()
    n = fm.length
    dev = torch.device(device)
    with metrics.phase("lift.bwt"):
        metrics.count("lift.bwt_symbols", n)
        bwt = hswt_device.lift(fm.hswt, dev)
    with metrics.phase("lift.gcx", n):
        metrics.count("lift.gcx_values", fm.index.ssa_len)
        parts = gcx.lift(fm.index, dev)
    with metrics.phase("lift.build", n):
        counts = fm.hswt.symbol_counts()
        symbols = tuple(int(x) for x in np.flatnonzero(counts))
        return build_device_block_parts(
            bwt, parts, int(fm.index.sampling_factor), symbols, planes)


# -- LF mapping and its tables -----------------------------------------------

def _corrected_lf(block: DeviceFMBlock) -> torch.Tensor:
    """Full corrected LF mapping as int32 [n].

    One stable sort of the BWT yields the plain LF (stable argsort groups
    by symbol preserving row order, which IS C[sym]+rank); the separator
    correction is a cumsum (the scan kernel on the card) over the zero
    plane (see gecoz_tpu/index/fm.py).  Recovered elementwise from an
    already-built fused table when present."""
    if block.has_lf:
        return _lf_from_row(block, block.lf_tab)
    n = block.n
    dev = block.bwt.device
    iota = torch.arange(n, dtype=_I32, device=dev)
    order = torch.sort(block.bwt, stable=True).indices
    lf = torch.empty(n, dtype=_I32, device=dev)
    lf[order] = iota
    del order
    is_zero = block.bwt == 0
    zero_rank = cumsum_i32(is_zero.to(_I32)) - 1
    corr = 1 + zero_rank - (block.wrap_row < iota).to(_I32)
    lf = torch.where(is_zero, corr, lf)
    return torch.where(iota == block.wrap_row, 0, lf)


def _marked_bits(block: DeviceFMBlock) -> torch.Tensor:
    """Per-row sampled flag as int32 [n], expanded from the mark plane."""
    shifts = torch.arange(32, dtype=_I32, device=block.mark_words.device)
    mb = (block.mark_words[:, None] >> shifts[None, :]) & 1
    return mb.reshape(-1)[:block.n]


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] along dim 0 with int32 indices (no int64 index copy)."""
    return torch.index_select(t, 0, idx)


def with_locate_table(block: DeviceFMBlock) -> DeviceFMBlock:
    """Attach the locate table: for every BWT row, the first SAMPLED row on
    its LF path and the step distance to it.

    Built by sf pointer-doubling rounds: round t extends every row's known
    path from 2^t to 2^(t+1) steps through jump = LF^(2^t), composed by
    gather (hit[jump], d[jump], jump[jump]).  Every row reaches a sampled
    row within rate steps, so sf rounds always converge; a locate is then
    one row read plus the sampled-value lookup."""
    n = block.n
    if n == 0 or block.has_loc:
        return block
    iota = torch.arange(n, dtype=_I32, device=block.bwt.device)
    jump = _corrected_lf(block)                  # LF^1, a true permutation
    done = _marked_bits(block)
    hit = torch.where(done == 1, iota, 0)
    d = torch.zeros(n, dtype=_I32, device=iota.device)
    del iota
    # invariant before round t: (done, hit, d) cover steps [0, 2^t),
    # jump = LF^(2^t); rows stay in play until their first mark
    for t in range(block.sf):
        live = done == 0
        hit = torch.where(live, _gather(hit, jump), hit)
        d = torch.where(live, (1 << t) + _gather(d, jump), d)
        done = done | _gather(done, jump)
        jump = _gather(jump, jump)
    return replace(block, loc_tab=torch.stack([hit, d], dim=1))


def with_lf_table(block: DeviceFMBlock, decode: bool = True) -> DeviceFMBlock:
    """Attach the fused LF table.

    Decode/locate steps then cost ONE row read instead of three (bwt +
    plane + prefix); bit 31 of each row marks a sampled row, so a locate
    walk needs one read per step.  With decode=True the fused k-step
    decode table is also built: LF^k plus the k symbols emitted along the
    way.  k = 16 (12-byte rows) when the sampling rate divides by 16, 8
    when it divides by 8, as 4-bit plane codes, so only for blocks of up
    to `CODE_PLANES` planes; else k = 4, the symbols as bytes (any
    alphabet).  Locate-only callers pass decode=False.
    """
    n = block.n
    if n == 0 or block.has_lf:
        return block
    lf = _corrected_lf(block)
    marked31 = _marked_bits(block) << 31
    if n < _PACK_LIMIT:
        tab = (lf << 8) | block.bwt.to(_I32) | marked31
    else:
        # rows don't fit 24 bits: plain lf; the steps that also need the
        # symbol read bwt separately
        tab = lf | marked31
    del marked31
    if not decode:
        return replace(block, lf_tab=tab)

    # permutation composition lf[lf[i]] by direct gather; the codes of the
    # steps taken ride along the same gathers (q = codes[lf])
    rate = 1 << block.sf
    if rate % 8 == 0 and n_planes(block) <= CODE_PLANES:
        # eight 4-bit PLANE codes per word, decoded back to bytes through a
        # 16-entry map in the walk
        pc = _gather(block.sym_plane, block.bwt.to(_I32)).clamp(min=0)
        lf2, c2 = _gather(lf, lf), pc | (_gather(pc, lf) << 4)
        del pc
        lf4, c4 = _gather(lf2, lf2), c2 | (_gather(c2, lf2) << 8)
        del lf2, c2
        lf8, c8 = _gather(lf4, lf4), c4 | (_gather(c4, lf4) << 16)
        del lf4, c4
        if rate % 16 == 0:
            lfk = torch.stack([_gather(lf8, lf8), c8, _gather(c8, lf8)], 1)
            return replace(block, lf_tab=tab, lfk_tab=lfk, lfk_k=16)
        return replace(block, lf_tab=tab, lfk_tab=torch.stack([lf8, c8], 1),
                       lfk_k=8)
    sym = block.bwt.to(_I32)
    lf2, s2 = _gather(lf, lf), sym | (_gather(sym, lf) << 8)
    del sym, lf
    lf4, s4 = _gather(lf2, lf2), s2 | (_gather(s2, lf2) << 16)
    del lf2, s2
    return replace(block, lf_tab=tab, lfk_tab=torch.stack([lf4, s4], 1),
                   lfk_k=4)


def _lf_from_row(block: DeviceFMBlock, v: torch.Tensor) -> torch.Tensor:
    """LF value out of a fused-table row (strips the bit-31 mark bit)."""
    if block.lf_packed:
        return (v >> 8) & 0x7FFFFF
    return v & 0x7FFFFFFF


def _lf_next(block: DeviceFMBlock, idx: torch.Tensor) -> torch.Tensor:
    """Next row only (locate walks don't need the symbol)."""
    return _lf_from_row(block, block.lf_tab[idx.long()])


def lf_batch(block: DeviceFMBlock, idx: torch.Tensor) -> torch.Tensor:
    """Corrected LF mapping for rows `idx` (batched)."""
    if block.has_lf:
        return _lf_next(block, idx)
    _need_planes(block, "lf_batch without the fused LF table")
    syms = block.bwt[idx.long()].to(_I32)
    occ = occ_inclusive(block, syms, idx)       # inclusive, >= 1
    plain = block.c[syms.long()] + occ - 1
    sep = occ - (block.wrap_row < idx).to(_I32)
    out = torch.where(syms == 0, sep, plain)
    return torch.where(idx == block.wrap_row, 0, out)


# -- backward search ---------------------------------------------------------

def with_kmer_table(block: DeviceFMBlock, k: int | None = None
                    ) -> DeviceFMBlock:
    """Attach the stacked k-mer seed table.

    Level j holds (sp, ep) after backward-searching every plane-coded
    string of length j, for j = 1..k; a query's last min(len, k)
    characters are then ONE table read instead of min(len, k)-1 search
    steps.  Built bottom-up: level j+1 extends level j by one earlier
    character, all codes stepped in one vectorized occ batch.
    """
    if block.n == 0 or block.has_kmer:
        return block
    _need_planes(block, "with_kmer_table")
    nplanes = block.plane_words.shape[0] // max(block.W, 1)
    # 5-8 bits a code past 16 planes: k <= cap // bits keeps bits * k <= 24
    bits = max(1, (nplanes - 1).bit_length())
    if k is None:
        # table capped at ~2^19 rows for small blocks, 2^24 for blocks
        # >= 4 MiB: at genomic sigma (6 planes -> 3 bits) that is k = 8
        cap = 24 if block.n >= (1 << 22) else 19
        k = max(1, min(8, cap // bits,
                       int(max(block.n, 2)).bit_length() // bits))
    dev = block.c.device
    plane_sym = code_map(block, 1 << bits).long()
    c = block.c
    levels = [torch.stack([c[plane_sym], c[plane_sym + 1] - 1], dim=1)]
    for j in range(1, k):
        codes = torch.arange(1 << (bits * (j + 1)), dtype=torch.int64,
                             device=dev)
        prev = levels[j - 1][codes & ((1 << (bits * j)) - 1)]
        ch = plane_sym[codes >> (bits * j)]     # the added, earlier char
        sp, ep = prev[:, 0], prev[:, 1]
        nsp = c[ch] + occ_inclusive(block, ch, sp - 1)
        nep = c[ch] + occ_inclusive(block, ch, ep) - 1
        dead = sp > ep
        levels.append(torch.stack([torch.where(dead, sp, nsp),
                                   torch.where(dead, ep, nep)], dim=1))
    return replace(block, kmer_tab=torch.cat(levels, dim=0),
                   kmer_bits=bits, kmer_k=k)


def with_rank_blocks(block: DeviceFMBlock) -> DeviceFMBlock:
    """Attach the search's rank table: for plane r and block b (224 BWT
    positions, 7 words), row r*Wb + b holds the plane's count of ones before
    position 224*b (`plane_pres[r*W + 7b]`) and its words 7b .. 7b+6, zero
    past W.  Kernel K1 then reads one aligned 32-byte block per occ lookup;
    the flat planes stay for every other reader.  A strided gather of the
    prefixes and a cat with the words; about sigma * 32 / 224 bytes a
    character (0.86 at sigma = 6, 36.6 at sigma = 256)."""
    W = block.W
    if block.n == 0 or block.has_rank_blocks:
        return block
    _need_planes(block, "with_rank_blocks")
    per = fmsearch.BLOCK_CHARS // 32                 # words a block: 7
    nplanes = block.plane_words.shape[0] // W
    wb = -(-W // per)                                # = ceil(n / 224)
    words = block.plane_words.view(nplanes, W)
    if wb * per > W:
        words = torch.cat([words, words.new_zeros(nplanes, wb * per - W)], 1)
    pres = block.plane_pres.view(nplanes, W)[:, ::per]
    rb = torch.cat([pres.unsqueeze(2), words.view(nplanes, wb, per)], 2)
    return replace(block, rank_blocks=rb.view(nplanes * wb, 1 + per))


def search_batch(block: DeviceFMBlock, patterns: torch.Tensor,
                 lengths: torch.Tensor, host_lengths=None):
    """Backward-search many patterns (kernel K1 on the card).

    `patterns` is uint8 [B, L] right-aligned (last character at column
    L-1, leading columns zero-padded); `lengths` is int32 [B], every length
    >= 1, checked on `host_lengths` (the caller's host copy) when given
    (`fmsearch.backward_search`).  Returns int32 (sp, ep) inclusive row
    ranges; ep < sp means no match.  With a k-mer table attached each
    query's last min(len, k) characters resolve in one table read.  On the
    card the block needs its rank table (`with_rank_blocks`)."""
    return fmsearch.backward_search(block, patterns, lengths, host_lengths)


# -- locate ------------------------------------------------------------------

def _sampled_value(block: DeviceFMBlock, idx: torch.Tensor):
    """(is_sampled, sa_value) for rows idx."""
    return lfwalk.sampled_value(block.mark_words, block.mark_pre,
                                block.ssa_perm, block.sf, idx)


def locate_batch(block: DeviceFMBlock, rows: torch.Tensor) -> torch.Tensor:
    """SA values (int32) for `rows` (int32, each in [0, n)).

    Three branches, as the reference: with the locate table one row read
    per query; with the fused LF table a walk of one read per step to the
    nearest sampled row (kernel K2 on the card); else the table-free walk
    through the planes."""
    if block.has_loc:
        row = block.loc_tab[rows.long()]
        _, val = _sampled_value(block, row[:, 0])
        return val + row[:, 1]

    if block.has_lf:
        return lfwalk.locate_walks(block.lf_tab, rows, block.mark_words,
                                   block.mark_pre, block.ssa_perm, block.sf,
                                   block.lf_packed)

    idx = rows
    steps = torch.zeros_like(rows)
    out = torch.full_like(rows, -1)
    live = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    for _ in range((1 << block.sf) + 1):
        sampled, val = _sampled_value(block, idx)
        out = torch.where(live & sampled, val + steps, out)
        live = live & ~sampled
        idx = torch.where(live, lf_batch(block, idx), idx)
        steps = steps + live.to(_I32)
    return out


# -- full-text decode --------------------------------------------------------

def _row_with_sa(block: DeviceFMBlock, value: torch.Tensor) -> torch.Tensor:
    """Row whose SA value is `value` (a sampled multiple of the rate): two
    small gathers through the select table, batched."""
    j = block.ssa_inv[(value >> block.sf).long()]
    return block.mark_rows[j.long()]


def code_map(block: DeviceFMBlock, size: int = CODE_PLANES) -> torch.Tensor:
    """uint8 [size]: the byte whose plane row is r (0 where none is).
    Raises when the block has more planes than `size` codes."""
    live = torch.nonzero(block.sym_plane >= 0).flatten()
    if live.shape[0] > size:
        raise ValueError(f"code_map: {live.shape[0]} planes do not fit "
                         f"{size} codes")
    out = torch.zeros(size, dtype=torch.uint8, device=live.device)
    out[block.sym_plane[live].long()] = live.to(torch.uint8)
    return out


def _walk_plain(block: DeviceFMBlock, seeds: torch.Tensor,
                rate: int) -> torch.Tensor:
    """Per-step walks through the planes (no fused table built)."""
    out = torch.empty((seeds.shape[0], rate), dtype=torch.uint8,
                      device=seeds.device)
    idx = seeds
    for j in range(rate):
        out[:, rate - 1 - j] = block.bwt[idx.long()]
        idx = lf_batch(block, idx)
    return out


def _walks(block: DeviceFMBlock, seeds: torch.Tensor,
           rate: int) -> torch.Tensor:
    """Per-step walks: the fused table through K2, else the planes."""
    if block.has_lf:
        mode = "packed" if block.lf_packed else "plain"
        return lfwalk.decode_walks(block.lf_tab, seeds, rate, mode,
                                   bwt=block.bwt)
    return _walk_plain(block, seeds, rate)


def decode_text(block: DeviceFMBlock) -> torch.Tensor:
    """Reconstruct the whole generalized string (uint8 [n]) on the block's
    device (reference `decode_text_jit`).

    One walk per sampling interval: walk w covers positions
    [w*rate, (w+1)*rate) and is seeded at the sampled row with SA value
    (w+1)*rate, so step j of every full walk writes column rate-1-j.  The
    ragged tail [W*rate, n-1) is one more walk of tail_len steps from row
    0 (SA value n-1); the final terminator goes at n-1.
    """
    n = block.n
    dev = block.bwt.device
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    rate = 1 << block.sf
    W = (n - 1) // rate                  # full walks
    tail_len = (n - 1) - W * rate        # 0 <= tail_len < rate

    seeds = _row_with_sa(block, (torch.arange(W, dtype=_I32, device=dev)
                                 + 1) * rate)
    k = block.lfk_steps
    if W and block.has_lfk and rate % k == 0:
        # k = 16 and 8 rows hold plane codes; k = 4 rows hold the bytes
        cmap = code_map(block) if k in (8, 16) else None
        out = lfwalk.decode_walks(block.lfk_tab, seeds, rate, f"lfk{k}",
                                  code_map=cmap)
    elif W:
        out = _walks(block, seeds, rate)
    else:
        out = torch.zeros((0, rate), dtype=torch.uint8, device=dev)

    parts = [out.reshape(-1)]
    if tail_len:
        # tail walk: from row 0 (suffix n-1); step j emits position n-2-j
        zero = torch.zeros(1, dtype=_I32, device=dev)
        parts.append(_walks(block, zero, tail_len).reshape(-1))
    parts.append(torch.zeros(1, dtype=torch.uint8, device=dev))
    return torch.cat(parts)

