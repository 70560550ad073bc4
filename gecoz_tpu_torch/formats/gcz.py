"""`.gcz` / `.gcx` container format: block headers, encode, writer, reader.

The port's copy of gecoz_tpu/formats/gcz.py, with the encode on the card.
Headers, serializers and the reader are the reference's code (imports
changed only), so the bytes are the reference's:

* GecozRefBlockHeader.java:39-137 — "GecozBWT", version 1, size u64 LE,
  len u64 LE, ``\\0``-separated header list, double-``\\0`` terminated.
* GecozSSABlockHeader.java:38-79 — "GecozSSA", version 1, len u64 LE,
  headers-hash u64 LE; fixed 25 bytes.
* GecozFileWriter.java:61-310 — per block: [ref header | RFC1951 lengths
  table (byte aligned) | HSWT nodes pre-order]; `.gcx`: [ssa header | rank
  vector | index wavelet tree].
* GecozFileReader.java:58-200 — chained header scan; sampling factor
  re-derived from total `.gcx` size (140-149) and, unlike the reference,
  from each block's mark count as well (ROADMAP C5).

`encode_block` is one block through the device-state route of
`parallel/mesh.py::encode_blocks`: the suffix sort, the BWT, the sampled
suffix array's mark bits and values and the wavelet bit planes are derived
on the device, and the host fetches only those and serializes.  Unlike the
reference, a failed device step raises: there is no quiet host fallback, no
`auto` probe and no packed upload.  `encode_block_host` is the reference's
host tier, the card's oracle.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from itertools import accumulate
from pathlib import Path

import numpy as np
import torch

from gecoz_tpu_torch.index.fm import FMIndex
from gecoz_tpu_torch.index.hswt import HSWT
from gecoz_tpu_torch.index.rankbv import interleaved_total_ones, rbv_bytes
from gecoz_tpu_torch.index.shape import HSWTShape
from gecoz_tpu_torch.index.ssa import SampledSAIndex, index_size
from gecoz_tpu_torch.ops.sa import bwt_from_sa, suffix_array
from gecoz_tpu_torch.utils.hostmem import warm_for_block

REF_MAGIC = b"GecozBWT"
SSA_MAGIC = b"GecozSSA"
VERSION = 1
SSA_HEADER_LEN = 25
DEFAULT_SAMPLING_RATE = 32


def header_hash(headers: list[str]) -> int:
    """Java-style 31x string hash over all headers, mod 2^64
    (GecozRefBlockHeader.getBlockHeaderHash:120-128)."""
    h = 1125899906842597
    for header in headers:
        for ch in header:
            h = ((h << 5) - h + ord(ch)) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass
class RefBlockHeader:
    headers: list[str]
    size: int   # total block size incl. this header
    len: int    # generalized string length

    @property
    def header_length(self) -> int:
        return ref_header_length(self.headers)

    def write(self) -> bytes:
        out = bytearray()
        out += REF_MAGIC
        out.append(VERSION)
        out += struct.pack("<QQ", self.size, self.len)
        for h in self.headers:
            out += h.encode() + b"\0"
        out += b"\0"
        return bytes(out)

    @classmethod
    def parse(cls, buf: bytes, offset: int) -> "RefBlockHeader":
        # NB the reference ignores magic/version mismatches silently
        # (GecozRefBlockHeader.java:64-66); we validate.
        if buf[offset:offset + 8] != REF_MAGIC or buf[offset + 8] != VERSION:
            raise ValueError("bad gcz block header")
        size, length = struct.unpack_from("<QQ", buf, offset + 9)
        headers = []
        p = offset + 25
        while buf[p] != 0:
            q = buf.index(b"\0", p)
            headers.append(buf[p:q].decode())
            p = q + 1
        return cls(headers=headers, size=size, len=length)


def ref_header_length(headers: list[str]) -> int:
    return 26 + sum(len(h.encode()) + 1 for h in headers)


def write_ssa_header(headers: list[str], idx_size: int) -> bytes:
    return SSA_MAGIC + bytes([VERSION]) + struct.pack(
        "<QQ", idx_size, header_hash(headers))


def parse_ssa_header(buf: bytes, offset: int) -> tuple[int, int]:
    if buf[offset:offset + 8] != SSA_MAGIC or buf[offset + 8] != VERSION:
        raise ValueError("bad gcx block header")
    length, hsh = struct.unpack_from("<QQ", buf, offset + 9)
    return length, hsh


# -- block encode ----------------------------------------------------------

def _serialize(headers: list[str], n: int, shape: HSWTShape, hswt: HSWT,
               ssa: SampledSAIndex) -> tuple[bytes, bytes]:
    """(gcz_block, gcx_block) of one encoded block
    (GecozFileWriter.java:124-159): ref header + wavelet nodes, ssa header
    + sampled suffix array."""
    block_size = ref_header_length(headers) + shape.size
    gcz = RefBlockHeader(headers, block_size, n).write() + hswt.serialize()
    if len(gcz) != block_size:
        raise RuntimeError(f"gcz block is {len(gcz)} bytes, header says "
                           f"{block_size}")
    idx_size = index_size(n, ssa.sampling_factor)
    gcx = write_ssa_header(headers, idx_size) + ssa.serialize()
    if len(gcx) != SSA_HEADER_LEN + idx_size:
        raise RuntimeError(f"gcx block is {len(gcx)} bytes, expected "
                           f"{SSA_HEADER_LEN + idx_size}")
    return gcz, gcx


def encode_block(data: np.ndarray, headers: list[str],
                 sampling_rate: int = DEFAULT_SAMPLING_RATE,
                 device: torch.device | str | None = None
                 ) -> tuple[bytes, bytes]:
    """Encode one generalized string block -> (gcz_block, gcx_block).

    histogram -> shape -> suffix array, BWT, sampled-SA state and wavelet
    nodes (device) -> serialization (host).  `device` defaults to the card.
    """
    from gecoz_tpu_torch.parallel.mesh import encode_blocks
    return encode_blocks([data], [headers], sampling_rate, device)[0]


def encode_block_host(data: np.ndarray, headers: list[str],
                      sampling_rate: int = DEFAULT_SAMPLING_RATE,
                      backend: str = "native") -> tuple[bytes, bytes]:
    """The reference's host tier of `encode_block` (gecoz_tpu/formats/
    gcz.py:145-202 with backend "native" or "numpy"): suffix array by the
    host library's SA-IS (or numpy prefix doubling), BWT gather and
    wavelet fill on the host.  Nothing runs on the card; `chip_smoke.py`
    holds the card's bytes against these."""
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    if n >= 1 << 31:
        raise ValueError("blocks are capped at 2^31 bytes by the int32-SA "
                         "contract (SAIS.java:103)")
    warm_for_block(n)
    counts = np.bincount(data, minlength=256).astype(np.int64)
    shape = HSWTShape.from_counts(counts)
    sa = suffix_array(data, backend=backend)
    hswt = HSWT.build(bwt_from_sa(data, sa), shape)
    return _serialize(headers, n, shape, hswt,
                      SampledSAIndex.build(sa, sampling_rate))


class GecozWriter:
    """Streaming multi-block writer for a .gcz/.gcx pair."""

    def __init__(self, ref_path: str | Path,
                 ssa_path: str | Path | None = None,
                 append: bool = False):
        ref_path = Path(ref_path)
        if ssa_path is None:
            ssa_path = default_gcx_path(ref_path)
        mode = "ab" if append else "wb"
        self.ref = open(ref_path, mode)
        try:
            self.ssa = open(ssa_path, mode)
        except OSError:
            self.ref.close()
            raise

    def write_encoded(self, gcz: bytes, gcx: bytes) -> None:
        """Append an already-encoded block (the mesh route's output)."""
        self.ref.write(gcz)
        self.ssa.write(gcx)

    def close(self) -> None:
        self.ref.close()
        self.ssa.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def default_gcx_path(ref_path: Path) -> Path:
    name = ref_path.name
    if name.endswith(".gcz"):
        name = name[:-3]
    return ref_path.with_name(name + "gcx")


class GecozReader:
    """Reader for a .gcz (+ optional .gcx) pair."""

    def __init__(self, ref_path: str | Path):
        ref_path = Path(ref_path)
        # memory-mapped: block reads touch only their own byte ranges
        # (the reference mmaps per block, GecozFileReader.java:123)
        self.ref_data = np.memmap(ref_path, dtype=np.uint8, mode="r")
        ssa_path = default_gcx_path(ref_path)
        self.ssa_data = (np.memmap(ssa_path, dtype=np.uint8, mode="r")
                         if ssa_path.is_file() else None)

        self.headers: list[RefBlockHeader] = []
        self.offsets: list[int] = []
        pos = 0
        total = len(self.ref_data)
        while pos < total:
            # headers are small; parse from a bounded window
            win = bytes(self.ref_data[pos:pos + (1 << 16)])
            h = RefBlockHeader.parse(win, 0)
            self.headers.append(h)
            self.offsets.append(pos)
            pos += h.size

        self.sampling_factor = self._derive_sampling_factor()

    def _derive_sampling_factor(self) -> int | None:
        """GecozFileReader.java:134-149, repaired (ROADMAP C5).

        The `.gcx` does not store the factor.  The reference takes the
        first one whose index sizes fit the file; but where every block is
        short, two factors can give the same sizes (an IndexWaveletTree
        of 2 samples is as long as one of 3), and the smaller one then
        reads more values than there are marks.  Here each factor that
        fits is also held to the marks: a block's mark vector comes first
        in its payload, sized by the block length alone, and must hold
        ceil(n / 2^sf) ones.  Factors that pass only because every block
        has one sample give the same arrays; none passing refuses the
        file.  Sets `ssa_offsets`, each block's `.gcx` offset."""
        if self.ssa_data is None:
            return None
        data_len = len(self.ssa_data) - len(self.headers) * SSA_HEADER_LEN
        for sf in range(42):
            sizes = [index_size(h.len, sf) for h in self.headers]
            if data_len < sum(sizes):
                continue
            offsets = list(accumulate((SSA_HEADER_LEN + s for s in sizes[:-1]),
                                      initial=0))
            if all(self._marks(off, h.len) == (h.len + (1 << sf) - 1) >> sf
                   for off, h in zip(offsets, self.headers)):
                self.ssa_offsets = offsets
                return sf
        raise ValueError("cannot derive sampling factor")

    def _marks(self, ssa_pos: int, n: int) -> int:
        """One-count of the mark vector of the n-row block at `ssa_pos`."""
        pos = ssa_pos + SSA_HEADER_LEN
        return interleaved_total_ones(self.ssa_data[pos:pos + rbv_bytes(n)],
                                      n)

    def find_block(self, header: str) -> RefBlockHeader | None:
        for h in self.headers:
            if header in h.headers:
                return h
        return None

    def read(self, bheader: RefBlockHeader) -> FMIndex:
        # by identity: blocks of equal headers, length and size (reads
        # that share a name) are equal dataclasses (ROADMAP C5)
        i = next(k for k, h in enumerate(self.headers) if h is bheader)
        off = self.offsets[i] + bheader.header_length
        hswt = HSWT.read(self.ref_data[off:self.offsets[i] + bheader.size],
                         bheader.len)
        if self.ssa_data is None:
            # counting still works (occ-only); locate/extract need samples.
            # NB the reference silently builds a broken index here
            # (GSSAIndex.java:88-127) and then hangs/corrupts on locate;
            # we expose a count-only FM-index instead.
            return FMIndex(hswt, None)
        sf = self.sampling_factor
        ssa_pos = self.ssa_offsets[i]
        blen, hsh = parse_ssa_header(
            bytes(self.ssa_data[ssa_pos:ssa_pos + SSA_HEADER_LEN + len(REF_MAGIC)]), 0)
        if hsh != header_hash(bheader.headers):
            raise ValueError("gcx header hash mismatch")
        if blen != index_size(bheader.len, sf):
            raise ValueError("gcx block length mismatch")
        ssa = SampledSAIndex.deserialize(
            self.ssa_data[ssa_pos + SSA_HEADER_LEN:], bheader.len, sf,
            name=", ".join(bheader.headers))
        return FMIndex(hswt, ssa)

    def check_format(self) -> bool:
        return bytes(self.ref_data[:8]) == REF_MAGIC


def check_format(path: str | Path) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(8) == REF_MAGIC
    except OSError:
        return False
