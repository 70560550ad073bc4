"""The port on the card: CUDA scan kernel and encode path (marker `gpu`).

These tests need a CUDA card and skip elsewhere, deciding inside a fixture.
They import no JAX, so they also run where JAX is absent (the card's
machine); there `tests/conftest.py`, which imports JAX, is left out:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

The oracles are the port's plain versions and gecoz_tpu's host tier.
"""

import numpy as np
import pytest
import torch

import gecoz_tpu_torch  # noqa: F401 - keeps gecoz_tpu from importing JAX
from gecoz_tpu.ops.sa import bwt_from_sa, suffix_array_numpy
from gecoz_tpu_torch.ops import scan
from gecoz_tpu_torch.ops.fmq import block_to_numpy
from gecoz_tpu_torch.ops.pipeline import index_block
from gecoz_tpu_torch.ops.sa_device import suffix_array_device

pytestmark = pytest.mark.gpu

ENTRIES = ("cumsum_i32", "cummax_i32", "cummin_rev_i32", "fill_fwd_i32",
           "fill_rev_i32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scan kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _inputs(name, n, gen):
    if name.startswith("fill"):
        x = np.full(n, -1, np.int32)
        marks = gen.choice(n, size=max(1, n // 100), replace=False)
        x[marks] = gen.integers(0, 1 << 30, size=marks.size)
        x[: n // 10] = -1
        return x
    return gen.integers(-2 ** 31, 2 ** 31, size=n,
                        dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("n", [1, 777, 4096, 4097, 65536, 2 * 65536 + 7,
                               (1 << 22) + 3])
def test_kernel_matches_plain(cuda, n, gen):
    for name in ENTRIES:
        x = torch.from_numpy(_inputs(name, n, gen)).to(cuda)
        before = scan.LAUNCHES[name]
        got = getattr(scan, name)(x)
        torch.cuda.synchronize()
        assert scan.LAUNCHES[name] == before + 1
        assert torch.equal(got, getattr(scan, name + "_ref")(x)), (name, n)


def _genomic(gen, n=1 << 16):
    s = gen.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    s[500:500 + n // 8] = ord("N")
    s[n // 3] = 0
    s[-1] = 0
    return s


@pytest.mark.parametrize("strategy", ["sort", "scatter"])
def test_suffix_sort_on_card(cuda, gen, strategy):
    s = _genomic(gen)
    want = suffix_array_numpy(s)
    for impl in ("runs", "kmer"):
        sa, bwt = suffix_array_device(s, impl=impl, with_bwt=True,
                                      device=cuda, strategy=strategy)
        assert sa.is_cuda and sa.dtype == torch.int32
        assert np.array_equal(sa.cpu().numpy(), want), impl
        assert np.array_equal(bwt.cpu().numpy(), bwt_from_sa(s, want))


def test_index_block_card_equals_cpu(cuda, gen):
    s = _genomic(gen)
    for sa_impl in ("runs", "kmer"):
        a = block_to_numpy(index_block(torch.from_numpy(s).to(cuda),
                                       sa_impl=sa_impl))
        b = block_to_numpy(index_block(torch.from_numpy(s),
                                       sa_impl=sa_impl))
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_encode_on_card_equals_host_tier(cuda, gen, tmp_path):
    from gecoz_tpu.formats.gcz import encode_block as host_encode
    from gecoz_tpu_torch.formats.gcz import encode_block
    s = _genomic(gen)
    want = host_encode(s, ["a", "b"], backend="native")
    scan.reset_launches()
    assert encode_block(s, ["a", "b"], device=cuda) == want
    for name in ("cumsum_i32", "fill_rev_i32", "fill_fwd_i32"):
        assert scan.LAUNCHES[name] > 0, name
