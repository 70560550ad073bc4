"""Scan entry points of the PyTorch port vs the Pallas reference.

The port's five entry points (gecoz_tpu_torch/ops/scan.py) run their plain
PyTorch versions on CPU tensors; they must equal, exactly, the Pallas
kernel in interpret mode and the reference's jnp dispatchers, on the cases
of tests/test_scan_pallas.py: both directions, ragged tails, wrapping
int32 adds and sparse-mark fills.  The CUDA kernel itself is checked
against the plain versions on the card in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops import scan_pallas as sp
from gecoz_tpu_torch.ops import scan

torch.set_num_threads(1)

# entry point -> (Pallas op, reverse, reference dispatcher)
ENTRIES = {
    "cumsum_i32": ("add", False, sp.cumsum_i32),
    "cummax_i32": ("max", False, sp.cummax_i32),
    "cummin_rev_i32": ("min", True, sp.cummin_rev_i32),
    "fill_fwd_i32": ("last", False, sp.fill_fwd_i32),
    "fill_rev_i32": ("last", True, sp.fill_rev_i32),
}


def _inputs(name, n, rng):
    if name.startswith("fill"):
        # sparse marks (~1%) after a leading unmarked region
        x = np.full(n, -1, np.int32)
        marks = rng.choice(n, size=max(1, n // 100), replace=False)
        x[marks] = rng.integers(0, 1 << 30, size=marks.size)
        x[: n // 10] = -1
        return x
    if name == "cumsum_i32":
        # full-range values: the running sum overflows and must wrap
        return rng.integers(-2 ** 31, 2 ** 31, size=n,
                            dtype=np.int64).astype(np.int32)
    return rng.integers(-1000, 1000, size=n).astype(np.int32)


@pytest.mark.parametrize("name", sorted(ENTRIES))
@pytest.mark.parametrize("n", [777, sp._C, 2 * sp._C + 12345])
def test_plain_matches_pallas_and_dispatcher(name, n, rng):
    op, reverse, dispatcher = ENTRIES[name]
    x = _inputs(name, n, rng)
    got = getattr(scan, name)(torch.from_numpy(x)).numpy()
    kernel = np.asarray(sp._scan_pallas(jnp.asarray(x), op, reverse=reverse,
                                        interpret=True))
    assert got.dtype == np.int32
    assert np.array_equal(got, kernel), (name, n)
    assert np.array_equal(got, np.asarray(dispatcher(jnp.asarray(x))))


def test_cpu_runs_plain_and_counts_no_launch(rng):
    scan.reset_launches()
    x = torch.from_numpy(rng.integers(-5, 5, size=100).astype(np.int32))
    for name in ENTRIES:
        assert torch.equal(getattr(scan, name)(x),
                           getattr(scan, name + "_ref")(x))
    assert all(v == 0 for v in scan.LAUNCHES.values())


def test_edge_sizes(rng):
    for n in (0, 1, 2):
        x = rng.integers(-3, 3, size=n).astype(np.int32)
        t = torch.from_numpy(x)
        assert np.array_equal(scan.cumsum_i32(t).numpy(), np.cumsum(x))
        assert np.array_equal(scan.cummin_rev_i32(t).numpy(),
                              np.minimum.accumulate(x[::-1])[::-1])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        scan.cumsum_i32(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(TypeError):
        scan.fill_fwd_i32(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(TypeError):
        scan.fill_rev_i32(torch.zeros(8, dtype=torch.int32)[::2])
