"""The search's rank table (`fmq.with_rank_blocks`) against occ on the flat
planes.

Kernel K1 reads one 32-byte block per occ lookup: the plane's count of
ones before the block's 224 positions and its 7 bit words.  A numpy occ
over those blocks must equal the port's `occ_inclusive` and gecoz_tpu's
`occ_inclusive` (both on the flat planes or pairs) for every plane, at the
block and word edges and at random positions, on blocks whose word count
is and is not a multiple of 7 and on a block shorter than one rank block.
Everything is an integer: tolerance 0.  The kernel itself runs only on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops import pipeline as ref_pipeline
from gecoz_tpu.ops import fmq as ref_fmq
from gecoz_tpu_torch.ops import fmq
from gecoz_tpu_torch.ops.fmsearch import BLOCK_CHARS, occ_inclusive
from gecoz_tpu_torch.ops.pipeline import DNA_SYMBOLS, index_block

torch.set_num_threads(1)


def occ_from_blocks(rb: np.ndarray, wb: int, row: int, pos: int) -> int:
    """Ones of plane `row` in BWT[0..pos] from its rank block alone."""
    blk = rb[row * wb + pos // BLOCK_CHARS]
    off = pos % BLOCK_CHARS
    wi = off >> 5
    mask = (2 << (off & 31)) - 1
    whole = sum(bin(int(w)).count("1") for w in blk[1:1 + wi])
    return int(blk[0]) + whole + bin(int(blk[1 + wi]) & mask).count("1")


def _text(rng, n):
    data = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n)
    data[n // 2] = 0
    data[-1] = 0
    return data


# n < 224; W = 21 (a multiple of 7); W = 37 and 100 (not)
@pytest.mark.parametrize("n", [100, 3 * 224, 5 * 224 + 40, 3200])
def test_rank_blocks_give_occ(rng, n):
    data = _text(rng, n)
    block = fmq.with_rank_blocks(index_block(torch.from_numpy(data.copy())))
    W, wb = block.W, -(-n // BLOCK_CHARS)
    nplanes = len(DNA_SYMBOLS)
    assert block.has_rank_blocks
    assert tuple(block.rank_blocks.shape) == (nplanes * wb, 8)
    assert fmq.with_rank_blocks(block) is block
    rb = fmq.block_to_numpy(block)["rank_blocks"]
    assert rb.dtype == np.uint32
    ref_block = ref_pipeline.index_block(jnp.asarray(data))
    pos = [p for p in (0, 31, 32, 223, 224, 225, n - 1) if p < n]
    pos += rng.integers(0, n, size=40).tolist()
    pos_t = torch.tensor(pos, dtype=torch.int32)
    bwt = block.bwt.numpy()
    for row, sym in enumerate(DNA_SYMBOLS):
        syms = torch.full_like(pos_t, sym)
        port = occ_inclusive(block, syms, pos_t).numpy()
        ref = np.asarray(ref_fmq.occ_inclusive(
            ref_block, jnp.asarray(syms.numpy()), jnp.asarray(pos_t.numpy())))
        want = [int(np.count_nonzero(bwt[:p + 1] == sym)) for p in pos]
        got = [occ_from_blocks(rb, wb, row, p) for p in pos]
        assert got == port.tolist() == ref.tolist() == want, (sym, n)
    # words past W in the last block of each plane are zero
    pad = wb * 7 - W
    if pad:
        assert not rb.reshape(nplanes, wb, 8)[:, -1, 8 - pad:].any()


def test_rank_blocks_travel_with_the_block(rng):
    """block_to_numpy / block_from_numpy carry the table; a reference
    block, which has none, comes across with it empty."""
    block = fmq.with_rank_blocks(index_block(torch.from_numpy(
        _text(rng, 1000))))
    back = fmq.block_from_numpy(fmq.block_to_numpy(block), block.sf)
    assert torch.equal(back.rank_blocks, block.rank_blocks)
    ref_block = ref_pipeline.index_block(jnp.asarray(_text(rng, 500)))
    carried = fmq.block_from_numpy(
        {k: np.asarray(v) for k, v in ref_block._asdict().items()},
        ref_block.sf)
    assert not carried.has_rank_blocks
    assert tuple(carried.rank_blocks.shape) == (0, 8)
