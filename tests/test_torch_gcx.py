"""The .gcx decoded on the device (`gecoz_tpu_torch/ops/gcx.py`) against
gecoz_tpu's host decode: the plain version of the level walks and the
sampled rows' compaction equals `deserialize_iwt` and `sampled_rows` of
the reference's index on the same bytes, and the lift of a block
(`fmq.device_block_from_fm`) equals the reference's
`ref_fmq.device_block_from_fm` in every .gcx field and the wrap row, with
the port's host IWT decode and walks made to raise.  Integers only:
tolerance 0.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from gecoz_tpu.index import iwt as ref_iwt
from gecoz_tpu.index import ssa as ref_ssa
from gecoz_tpu.index.rankbv import RankBitVector as RefRankBitVector
from gecoz_tpu.index.rankbv import rbv_bytes
from gecoz_tpu.ops import fmq as ref_fmq
from gecoz_tpu_torch.index import fm as port_fm
from gecoz_tpu_torch.index import iwt, ssa
from gecoz_tpu_torch.ops import fmq, gcx
from gecoz_tpu_torch.utils import metrics

from conftest import random_block
from test_fm import build_fm
from test_torch_host_copies import build_port_fm

torch.set_num_threads(1)

GCX_FIELDS = ("ssa_perm", "ssa_inv", "mark_rows", "mark_words", "mark_pre")


def _gcx_bytes(seed, m, sf):
    """A .gcx payload of m sampled values at sampling factor sf, written by
    the reference: n rows (ceil(n / 2^sf) = m), m of them marked at random,
    the values a permutation drawn from the seed."""
    rng = np.random.default_rng(seed)
    rate = 1 << sf
    n = int(rng.integers((m - 1) * rate + 1, m * rate + 1))
    bits = np.zeros(n, np.uint8)
    bits[rng.choice(n, m, replace=False)] = 1
    index = ref_ssa.SampledSAIndex(RefRankBitVector.from_bits(bits),
                                   ref_iwt.IndexWaveletTree(
                                       rng.permutation(m)), sf)
    return np.frombuffer(index.serialize(), np.uint8), n


def _no_host_iwt(monkeypatch):
    """The port's host IWT decode, its materialized tree and its in-place
    walks raise."""
    def refuse(*a, **k):
        raise AssertionError("the host IWT was read")
    for mod in (iwt, ssa):
        monkeypatch.setattr(mod, "IndexWaveletTree", refuse)
        monkeypatch.setattr(mod, "LazyIWT", refuse)
    monkeypatch.setattr(iwt, "deserialize_iwt", refuse)


# m crosses the planes' 64 Kbit counter segments (65,536 bits)
@pytest.mark.parametrize("m,sf,seed", [
    (1, 5, 1), (2, 0, 2), (3, 2, 3), (31, 5, 4), (32, 3, 5), (33, 0, 6),
    (65535, 2, 7), (65536, 5, 8), (65537, 1, 9), (200003, 5, 10),
    (200003, 0, 11)])
def test_plain_decode_equals_the_host_decode(m, sf, seed, monkeypatch):
    buf, n = _gcx_bytes(seed, m, sf)
    ref = ref_ssa.SampledSAIndex.deserialize(buf, n, sf)
    want_rows, want_values = ref.sampled_rows()
    want_perm = ref_iwt.deserialize_iwt(buf[rbv_bytes(n):], m)
    _no_host_iwt(monkeypatch)
    got = gcx.lift(ssa.SampledSAIndex.deserialize(buf, n, sf), "cpu")
    assert np.array_equal(got.ssa_perm.numpy(), want_perm)
    assert np.array_equal(got.ssa_perm.numpy().astype(np.int64) << sf,
                          want_values)
    assert np.array_equal(got.mark_rows.numpy(), want_rows)
    assert np.array_equal(got.ssa_inv.numpy(), np.argsort(want_perm))


def _serialized_port_fm(data, rate):
    """The port's host FM-index of `data` with its .gcx read back from the
    stored bytes, as a reader opens it: no IWT materialized."""
    built = build_port_fm(data, rate)
    sf = rate.bit_length() - 1
    raw = np.frombuffer(built.index.serialize(), np.uint8)
    return port_fm.FMIndex(built.hswt, ssa.SampledSAIndex.deserialize(
        raw, len(data), sf))


@pytest.mark.parametrize("alphabet", [b"ACGTN", b"ACDEFGHIKLMNPQRSTVWYX"],
                         ids=["dna", "protein22"])
@pytest.mark.parametrize("rate", [8, 32])
def test_lift_equals_the_reference_block(rng, monkeypatch, alphabet, rate):
    data, _ = random_block(rng, nseq=5, minlen=50, maxlen=3000,
                           alphabet=alphabet)
    ref_fm = build_fm(data, rate)
    if alphabet == b"ACGTN":
        ref_block = ref_fmq.device_block_from_fm(ref_fm)
    else:
        # the reference's plane engine stops at 16 symbols: its
        # build_device_block on the block's own .gcx, beside a BWT of one
        # symbol
        assert len(np.unique(data)) == 22
        rows, _ = ref_fm.index.sampled_rows()
        ref_block = ref_fmq.build_device_block(
            np.zeros(len(data), np.uint8), rows, ref_fm.index.wsa.perm,
            ref_fm.index.sampling_factor, ref_fm.wrap_row)
    ref = fmq.block_to_numpy(fmq.block_from_numpy(
        {k: np.asarray(v) for k, v in ref_block._asdict().items()},
        rate.bit_length() - 1))
    fm = _serialized_port_fm(data, rate)
    _no_host_iwt(monkeypatch)
    metrics.reset()
    got = fmq.block_to_numpy(fmq.device_block_from_fm(fm, "cpu"))
    for name in GCX_FIELDS + ("wrap_row",):
        assert np.array_equal(got[name], ref[name]), name
    m = len(got["ssa_perm"])
    st = metrics.stats()
    assert st["lift.gcx_values"].count == m
    assert st["lift.gcx_values_device"].count == m


def _faulty_gcx(fault, m=1000, sf=5):
    """A .gcx whose mark counts one row more or less than its m sampled
    values, or whose IWT has one level bit flipped."""
    rng = np.random.default_rng(12)
    n = 32 * m - 7
    bits = np.zeros(n, np.uint8)
    bits[rng.choice(n, m, replace=False)] = 1
    if fault != "level_bit_flipped":
        at = np.flatnonzero(bits == (fault == "one_mark_less"))[0]
        bits[at] ^= 1
    mark = RefRankBitVector.from_bits(bits).serialize()
    planes = bytearray(ref_iwt.serialize_iwt(rng.permutation(m)))
    if fault == "level_bit_flipped":
        planes[3 * rbv_bytes(m) + 7] ^= 4       # level 3, its 8th byte
    return np.frombuffer(mark + bytes(planes), np.uint8), n


@pytest.mark.parametrize("fault", ["one_mark_more", "one_mark_less",
                                   "level_bit_flipped"])
def test_the_lift_refuses_a_gcx_that_does_not_fit(fault):
    buf, n = _faulty_gcx(fault)
    with pytest.raises(ValueError, match="marked rows against|not a "
                       "permutation"):
        gcx.lift(ssa.SampledSAIndex.deserialize(buf, n, 5), "cpu")


def test_the_entry_points_refuse_what_the_kernels_do_not_take():
    buf, n = _gcx_bytes(13, 100, 5)
    raw, at = gcx.upload(ssa.SampledSAIndex.deserialize(buf, n, 5), "cpu")
    words, pc = gcx.unpack(raw, n, 100, at)
    with pytest.raises(TypeError, match="uint8"):
        gcx.unpack(raw.to(torch.int32), n, 100, at)
    with pytest.raises(ValueError, match="fewer than"):
        gcx.unpack(raw[:-8], n, 100, at)
    with pytest.raises(TypeError, match="int32"):
        gcx.decode(words.long(), pc, n, 100)
    with pytest.raises(TypeError, match="strided"):
        gcx.decode(torch.stack([words, words], 1)[:, 0], pc, n, 100)
    with pytest.raises(ValueError, match="fewer than"):
        gcx.decode(words, pc, n, 200)
