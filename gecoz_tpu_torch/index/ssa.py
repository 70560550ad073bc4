"""Sparse (sampled) suffix-array index: the `.gcx` payload.

The port's copy of gecoz_tpu/index/ssa.py: the same code,
its imports pointed at gecoz_tpu_torch, so that the port imports
nothing of the JAX package.

Byte-compatible with GSSAIndex (nova-algo ssa/GSSAIndex.java:42-206):
a ranked bit vector over all BWT rows marking those whose SA value is a
multiple of the sampling rate, followed by an IndexWaveletTree of the
sampled values (>> sampling_factor) in row order.

The sampling factor is *not* stored; readers recover it from file sizes
(GSSAIndex.java:62-67, GecozFileReader.java:140-149) and the mark counts
(ROADMAP C5) — handled by the gcz container layer.  `sampled_rows`, the
lift every host decode reads, refuses marks and values that differ in
count; the device tier's lift (`ops/gcx.py`, from `stored_streams`) does
too.
"""

from __future__ import annotations

import numpy as np

from gecoz_tpu_torch.index.iwt import IndexWaveletTree, LazyIWT, iwt_size
from gecoz_tpu_torch.index.rankbv import RankBitVector, rbv_bytes


def index_size(sa_len: int, sampling_factor: int) -> int:
    """Serialized index size (GSSAIndex.getIndexSize)."""
    ssa_len = (sa_len + (1 << sampling_factor) - 1) >> sampling_factor
    return iwt_size(ssa_len) + rbv_bytes(sa_len)


class SampledSAIndex:
    def __init__(self, mark: RankBitVector, wsa: IndexWaveletTree | None,
                 sampling_factor: int, wsa_buf: np.ndarray | None = None,
                 ssa_len: int | None = None, name: str = ""):
        self.mark = mark
        self.name = name                 # the block's headers, for errors
        self._wsa = wsa
        self._wsa_buf = wsa_buf          # serialized IWT, decoded lazily
        self._ssa_len = ssa_len
        self._lazy: LazyIWT | None = None
        self.sampling_factor = int(sampling_factor)

    @property
    def wsa(self) -> IndexWaveletTree:
        """The materialized sampled-value permutation; deserializing the
        IWT costs ~levels stable sorts, so decode-heavy paths
        (sampled_rows) pay it once while point queries go through the
        in-place plane walks of `_q`."""
        if self._wsa is None:
            self._wsa = IndexWaveletTree.deserialize(self._wsa_buf,
                                                     self._ssa_len)
        return self._wsa

    @property
    def _q(self):
        """Query backend: the materialized permutation when present, else
        in-place walks over the serialized planes (LazyIWT) — the
        reference's own O(levels) get/find (IndexWaveletTree.java:127-165),
        so a cold locate/count never materializes the IWT."""
        if self._wsa is not None:
            return self._wsa
        if self._lazy is None:
            self._lazy = LazyIWT(self._wsa_buf, self._ssa_len)
        return self._lazy

    @classmethod
    def build(cls, sa: np.ndarray, sampling_rate: int) -> "SampledSAIndex":
        """Build from a full suffix array (GSSAIndex ctor at 129-150)."""
        sf = sampling_rate.bit_length() - 1
        assert (1 << sf) == sampling_rate, "sampling rate must be a power of 2"
        sa = np.asarray(sa, dtype=np.int64)
        mask = (1 << sf) - 1
        marked = (sa & mask) == 0
        ssa = sa[marked] >> sf
        return cls(RankBitVector.from_bits(marked.astype(np.uint8)),
                   IndexWaveletTree(ssa), sf)

    def serialize(self) -> bytes:
        if self._wsa is None and self._wsa_buf is not None:
            return self.mark.serialize() + bytes(
                np.asarray(self._wsa_buf, dtype=np.uint8))
        return self.mark.serialize() + self.wsa.serialize()

    @classmethod
    def deserialize(cls, buf: np.ndarray, sa_len: int,
                    sampling_factor: int, name: str = "") -> "SampledSAIndex":
        buf = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
        nb = rbv_bytes(sa_len)
        mark = RankBitVector.from_interleaved(buf[:nb], sa_len)
        ssa_len = (sa_len + (1 << sampling_factor) - 1) >> sampling_factor
        return cls(mark, None, sampling_factor,
                   wsa_buf=buf[nb:nb + iwt_size(ssa_len)], ssa_len=ssa_len,
                   name=name)

    @property
    def ssa_len(self) -> int:
        """Number of sampled values (ceil(rows / rate))."""
        if self._ssa_len is not None:
            return self._ssa_len
        return len(self._wsa.perm)

    def stored_streams(self) -> tuple[np.ndarray, np.ndarray]:
        """The mark's and the IWT's serialized streams, interleaved with
        their rank counters as the .gcx stores them: the bytes the device
        tier decodes (`ops/gcx.py`).  Views of the bytes read; an index built
        in memory serializes its own.  Materializes neither `wsa` nor the
        mark's rank tiers, so point queries stay in place."""
        mark = self.mark._raw
        if mark is None:
            mark = np.frombuffer(self.mark.serialize(), dtype=np.uint8)
        wsa = self._wsa_buf
        if wsa is None:
            wsa = np.frombuffer(self._wsa.serialize(), dtype=np.uint8)
        return mark, wsa

    # -- queries (GSSAIndex.get / find) ------------------------------------

    def get(self, pos):
        """SA value at row `pos`, or -1 when the row is not sampled."""
        pos = np.asarray(pos, dtype=np.int64)
        scalar = pos.ndim == 0
        p = np.atleast_1d(pos)
        sampled = np.asarray(self.mark.get(p)).astype(bool)
        out = np.full(p.shape, np.int64(-1))
        if sampled.any():
            j = np.asarray(self.mark.rank1_inclusive(p[sampled])) - 1
            out[sampled] = (np.asarray(self._q.get(j))
                            << self.sampling_factor)
        return out[0] if scalar else out.reshape(pos.shape)

    def find(self, sa_value):
        """Row whose SA value is `sa_value` (must be a sampled multiple)."""
        sa_value = np.asarray(sa_value, dtype=np.int64)
        j = np.asarray(self._q.find(sa_value >> self.sampling_factor))
        return self.mark.select1(j + 1)

    def sampled_rows(self) -> np.ndarray:
        """All sampled rows' (row, sa_value) as two arrays, vectorized."""
        rows = np.flatnonzero(
            np.unpackbits(self.mark.data, count=self.mark.length,
                          bitorder="little"))
        values = self.wsa.perm << self.sampling_factor
        if len(rows) != len(values):
            raise ValueError(
                f"block [{self.name}] of {self.mark.length} rows at sampling "
                f"factor {self.sampling_factor}: {len(rows)} marked rows "
                f"against {len(values)} sampled values")
        return rows, values
