"""Wavelet-tree build of the PyTorch port vs gecoz_tpu/ops/wavelet.py.

Level words and per-node bit vectors must equal the reference's device
build and the host `HSWT.build`, exactly, for DNA-like and skewed
alphabets (deeper Huffman codes, so more levels and nodes).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.index.hswt import HSWT
from gecoz_tpu.index.shape import HSWTShape
from gecoz_tpu.ops import wavelet as ref
from gecoz_tpu_torch.index.hswt import HSWT as PortHSWT
from gecoz_tpu_torch.index.shape import HSWTShape as PortShape
from gecoz_tpu_torch.ops import wavelet as port

from conftest import random_block

torch.set_num_threads(1)


def _cases(rng):
    dna, _ = random_block(rng, nseq=3, minlen=50, maxlen=500,
                          alphabet=b"ACGTN")
    skew = rng.choice(np.frombuffer(b"ABCDEFGHIJKLMNOP", np.uint8),
                      size=3000,
                      p=np.r_[np.full(4, 0.2), np.full(12, 0.2 / 12)])
    skew[-1] = 0
    tiny = np.frombuffer(b"A\0", np.uint8).copy()
    return [dna, skew, tiny]


def test_level_words_match_reference(rng):
    for data in _cases(rng):
        shape = HSWTShape.from_counts(np.bincount(data, minlength=256))
        maxlen = int(shape.bit_lengths.max())
        codes = shape.codes.astype(np.int32)
        lens = shape.bit_lengths.astype(np.int32)
        want = np.asarray(ref.wavelet_level_words(
            jnp.asarray(data), jnp.asarray(codes), jnp.asarray(lens),
            maxlen))
        got = port.wavelet_level_words(torch.from_numpy(data.copy()),
                                       torch.from_numpy(codes),
                                       torch.from_numpy(lens), maxlen)
        assert np.array_equal(got.numpy().view(np.uint32), want)
        pshape = PortShape.from_counts(np.bincount(data, minlength=256))
        assert port._level_bit_counts(pshape, maxlen) == \
            ref._level_bit_counts(shape, maxlen)


def test_node_bits_match_reference_and_host(rng):
    for data in _cases(rng):
        shape = HSWTShape.from_counts(np.bincount(data, minlength=256))
        host = HSWT.build(data, shape)      # data taken as a BWT directly
        dev = ref.build_hswt_device(data, shape)
        pshape = PortShape.from_counts(np.bincount(data, minlength=256))
        got = port.build_hswt_device(torch.from_numpy(data.copy()), pshape)
        assert got.keys() == dev.keys()
        for key in shape.nodes:
            assert np.array_equal(got[key], dev[key]), key
            assert np.array_equal(got[key], host.nodes[key].data), key
        assert PortHSWT.from_packed(pshape, got).serialize() == \
            host.serialize()
