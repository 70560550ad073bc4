"""Query-state build of the PyTorch port vs gecoz_tpu's device build.

`build_device_block` and `index_block` (both `sa_impl` values, both
strategies) must give, field by field and exactly, the block that
gecoz_tpu's `build_device_block_jit` / `pipeline.index_block` build from
the same input.  The reference's fused `plane_pairs` (below its
`_PAIR_LIMIT`) is compared against the port's flat `plane_words` /
`plane_pres` through `block_from_numpy`.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops import fmq as ref_fmq
from gecoz_tpu.ops import pipeline as ref_pipeline
from gecoz_tpu.ops import sa_device as ref_sa
from gecoz_tpu.ops.sa import bwt_from_sa, suffix_array_numpy
from gecoz_tpu_torch.ops import fmq
from gecoz_tpu_torch.ops.pipeline import DNA_SYMBOLS, index_block

from conftest import random_block

torch.set_num_threads(1)


def ref_fields(block) -> dict:
    """The reference block as the port's numpy field dict."""
    src = {k: np.asarray(v) for k, v in block._asdict().items()
           if k != "sf"}
    return fmq.block_to_numpy(fmq.block_from_numpy(src, block.sf))


def assert_same(port_block, ref_block):
    a = fmq.block_to_numpy(port_block)
    b = ref_fields(ref_block)
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        assert np.array_equal(x, y), k


def _block_text(rng):
    data, _ = random_block(rng, nseq=4, minlen=50, maxlen=900,
                           alphabet=b"ACGTN")
    data[100:400] = ord("N")
    return data


@pytest.mark.parametrize("force_sorts", [False, True])
def test_build_device_block_matches_reference(rng, monkeypatch,
                                              force_sorts):
    if force_sorts:
        # the reference's TPU branch (partition sort instead of nonzero)
        monkeypatch.setattr(ref_fmq, "_scatter_is_cheap", lambda: False)
    data = _block_text(rng)
    sa = suffix_array_numpy(data).astype(np.int32)
    bwt = bwt_from_sa(data, sa)
    for sf in (3, 5):
        want = ref_fmq.build_device_block_jit(jnp.asarray(bwt),
                                              jnp.asarray(sa), sf,
                                              DNA_SYMBOLS)
        for strategy in ("sort", "scatter"):
            got = fmq.build_device_block(torch.from_numpy(bwt.copy()),
                                         torch.from_numpy(sa), sf,
                                         DNA_SYMBOLS, strategy=strategy)
            assert got.n == len(data) and got.W == (len(data) + 31) // 32
            assert_same(got, want)


@pytest.mark.parametrize("sa_impl", ["runs", "kmer"])
def test_index_block_matches_reference(rng, sa_impl):
    data = _block_text(rng)
    want = ref_pipeline.index_block(jnp.asarray(data), sa_impl=sa_impl)
    for strategy in ("sort", "scatter"):
        got = index_block(torch.from_numpy(data.copy()), sa_impl=sa_impl,
                          strategy=strategy)
        assert_same(got, want)


def test_index_block_with_host_bounds(rng, monkeypatch):
    """The bench's form: host-precomputed m_pad / tok_table / ell_bits /
    r1_keys, the reference on its sort branches."""
    monkeypatch.setattr(ref_sa, "_scatter_is_cheap", lambda: False)
    monkeypatch.setattr(ref_fmq, "_scatter_is_cheap", lambda: False)
    jax.clear_caches()
    try:
        data = _block_text(rng)
        ebs = ref_sa.runs_ell_bits(data)
        tab = ref_sa.runs_token_table(data, DNA_SYMBOLS, ell_bits=ebs)
        kw = dict(m_pad=ref_sa.runs_m_pad(data), ell_bits=ebs,
                  r1_keys=ref_sa.runs_r1_keys(tab))
        want = ref_pipeline.index_block(jnp.asarray(data),
                                        tok_table=jnp.asarray(tab), **kw)
        got = index_block(torch.from_numpy(data.copy()),
                          tok_table=torch.from_numpy(tab), **kw)
        assert_same(got, want)
    finally:
        jax.clear_caches()


def test_numpy_round_trip_and_pair_layout(rng):
    data = _block_text(rng)
    ref_block = ref_pipeline.index_block(jnp.asarray(data))
    assert ref_block.plane_pairs.shape[0] > 0      # below _PAIR_LIMIT
    fields = ref_fields(ref_block)
    pairs = np.asarray(ref_block.plane_pairs)
    assert np.array_equal(fields["plane_words"], pairs[:, 0])
    assert np.array_equal(fields["plane_pres"], pairs[:, 1])
    back = fmq.block_to_numpy(fmq.block_from_numpy(fields, fields["sf"]))
    for k in fields:
        assert np.array_equal(np.asarray(back[k]), np.asarray(fields[k])), k


def test_popcount_and_pack_bits(rng):
    words = rng.integers(0, 1 << 32, size=1000, dtype=np.int64)
    words[:3] = [0, 1 << 31, (1 << 32) - 1]
    got = fmq._popcount32(torch.from_numpy(words)).numpy()
    assert np.array_equal(got, np.bitwise_count(words.astype(np.uint32)))
    bits = rng.integers(0, 2, size=77)
    packed = fmq._pack_bits(torch.from_numpy(bits)).numpy()
    want = np.asarray(ref_fmq._pack_bits_jit(jnp.asarray(bits)))
    assert np.array_equal(packed.astype(np.uint32), want)
