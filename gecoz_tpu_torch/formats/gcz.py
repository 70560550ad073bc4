"""`.gcz`/`.gcx` block encode on the card.

Port of the encode half of gecoz_tpu/formats/gcz.py (100-240): the suffix
sort, BWT and wavelet bit planes run on the device; the sampled suffix
array and the serialization run on the host, through gecoz_tpu's own
(framework-free) header and serializer code, so the bytes are the
reference's.

Unlike the reference, a failed device step raises: there is no quiet host
fallback, no `auto` probe and no packed upload.  A block whose suffix sort
does not fit one card raises too; the sharded suffix sort is ROADMAP A9.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gecoz_tpu.formats.gcz import (DEFAULT_SAMPLING_RATE, SSA_HEADER_LEN,
                                   RefBlockHeader, default_gcx_path,
                                   ref_header_length, write_ssa_header)
from gecoz_tpu.index.hswt import HSWT
from gecoz_tpu.index.shape import HSWTShape
from gecoz_tpu.index.ssa import SampledSAIndex, index_size
from gecoz_tpu.utils import metrics
from gecoz_tpu_torch.ops.sa_device import suffix_array_device
from gecoz_tpu_torch.ops.wavelet import build_hswt_device
from gecoz_tpu_torch.utils.device import device as default_device
from gecoz_tpu_torch.utils.device import sync

def _encode_on_device(data: np.ndarray, shape: HSWTShape,
                      dev: torch.device, strategy: str = "sort"):
    """SA + BWT + wavelet bit planes on `dev`; returns host (sa, hswt)."""
    with metrics.phase("encode.suffix_sort", len(data)):
        try:
            sa_dev, bwt_dev = suffix_array_device(
                data, with_bwt=True, device=dev, strategy=strategy)
            sync(dev)
        except torch.cuda.OutOfMemoryError as e:
            raise MemoryError(
                f"the suffix sort of a {len(data)}-byte block does not fit "
                f"{dev}; blocks beyond one card wait for the sharded suffix "
                "sort (ROADMAP A9)") from e
    with metrics.phase("encode.wavelet", len(data)):
        hswt = HSWT.from_packed(shape, build_hswt_device(bwt_dev, shape))
    with metrics.phase("encode.fetch_sa", len(data)):
        sa = sa_dev.cpu().numpy().astype(np.int64)
    return sa, hswt


def encode_block(data: np.ndarray, headers: list[str],
                 sampling_rate: int = DEFAULT_SAMPLING_RATE,
                 device: torch.device | str | None = None,
                 strategy: str = "sort") -> tuple[bytes, bytes]:
    """Encode one generalized string block -> (gcz_block, gcx_block).

    histogram -> shape -> suffix array + BWT + wavelet nodes (device) ->
    sampled SA + serialization (host).  `device` defaults to the card.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    if n >= 1 << 31:
        raise ValueError("blocks are capped at 2^31 bytes by the int32-SA "
                         "contract (SAIS.java:103)")
    dev = default_device(device)
    from gecoz_tpu.utils.hostmem import warm_for_block
    warm_for_block(n)
    counts = np.bincount(data, minlength=256).astype(np.int64)
    shape = HSWTShape.from_counts(counts)
    sa, hswt = _encode_on_device(data, shape, dev, strategy)
    with metrics.phase("encode.serialize", n):
        ssa = SampledSAIndex.build(sa, sampling_rate)
        block_size = ref_header_length(headers) + shape.size
        gcz = RefBlockHeader(headers, block_size, n).write() \
            + hswt.serialize()
        if len(gcz) != block_size:
            raise RuntimeError(f"gcz block is {len(gcz)} bytes, header "
                               f"says {block_size}")
        sf = sampling_rate.bit_length() - 1
        idx_size = index_size(n, sf)
        gcx = write_ssa_header(headers, idx_size) + ssa.serialize()
        if len(gcx) != SSA_HEADER_LEN + idx_size:
            raise RuntimeError(f"gcx block is {len(gcx)} bytes, expected "
                               f"{SSA_HEADER_LEN + idx_size}")
    return gcz, gcx


class GecozWriter:
    """Streaming multi-block writer for a .gcz/.gcx pair."""

    def __init__(self, ref_path: str | Path,
                 ssa_path: str | Path | None = None,
                 sampling_rate: int = DEFAULT_SAMPLING_RATE,
                 device: torch.device | str | None = None,
                 append: bool = False):
        ref_path = Path(ref_path)
        if ssa_path is None:
            ssa_path = default_gcx_path(ref_path)
        self.device = default_device(device)
        self.sampling_rate = sampling_rate
        mode = "ab" if append else "wb"
        self.ref = open(ref_path, mode)
        try:
            self.ssa = open(ssa_path, mode)
        except OSError:
            self.ref.close()
            raise

    def write(self, headers: list[str], data: np.ndarray) -> None:
        gcz, gcx = encode_block(data, headers, self.sampling_rate,
                                self.device)
        self.ref.write(gcz)
        self.ssa.write(gcx)

    def close(self) -> None:
        self.ref.close()
        self.ssa.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
