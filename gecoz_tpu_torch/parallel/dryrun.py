"""Dry run of the sharded paths over a mesh (the counterpart of
`dryrun_multichip` in the reference's __graft_entry__.py:43-133).

    python -c "import torch; from gecoz_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip((torch.device('cuda', 0),) * 8)"

Part 1 is the in-block distribution: the run-aware sharded suffix sort of a
1 MiB block with a 256 KiB N run over every shard of the mesh, bit-exact
against the host suffix array.  Part 2 is block data parallelism only:
blocks are scheduled largest-first over the mesh's devices, and each goes
through `pipeline.index_and_query` (index, search, locate, decode) on its
device, with the round trip and every located hit checked.  The
reference's GSPMD sharding of the in-block arrays has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from gecoz_tpu_torch.ops.pipeline import index_and_query
from gecoz_tpu_torch.ops.sa import bwt_from_sa, suffix_array
from gecoz_tpu_torch.parallel.mesh import largest_first_schedule
from gecoz_tpu_torch.parallel.sharded_sa import (gather_shards,
                                                 suffix_array_sharded)


def _example_block(n: int = 65536, nseq: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    syms = np.frombuffer(b"ACGT", np.uint8)
    data = rng.choice(syms, size=n).astype(np.uint8)
    # sprinkle sequence terminators (generalized string) + final '\0'
    cuts = np.sort(rng.choice(np.arange(1, n - 1), size=nseq - 1,
                              replace=False))
    data[cuts] = 0
    data[n - 1] = 0
    return data


def _example_queries(B: int = 32, L: int = 12, seed: int = 1):
    rng = np.random.default_rng(seed)
    syms = np.frombuffer(b"ACGT", np.uint8)
    pats = rng.choice(syms, size=(B, L)).astype(np.uint8)
    lens = rng.integers(4, L + 1, size=B).astype(np.int32)
    # right-aligned: zero out leading columns
    cols = np.arange(L)[None, :]
    pats = np.where(cols >= (L - lens[:, None]), pats, 0).astype(np.uint8)
    return pats, lens


def dryrun_multichip(mesh) -> None:
    """Run both parts over `mesh` (a tuple of devices, repeats allowed);
    raises AssertionError on any mismatch."""
    mesh = tuple(torch.device(d) for d in mesh)
    D = len(mesh)

    # -- part 1: the run-seeded sharded suffix sort at 1 MiB ----------------
    big = _example_block(1 << 20, nseq=4, seed=3)
    big[(1 << 18):(1 << 18) + (1 << 18)] = ord("N")
    big[-1] = 0
    sa, bwt = suffix_array_sharded(big, mesh=mesh)
    want = suffix_array(big)
    if not np.array_equal(gather_shards(sa).numpy(), want):
        raise AssertionError("sharded suffix array != host suffix array")
    if not np.array_equal(gather_shards(bwt).numpy(), bwt_from_sa(big, want)):
        raise AssertionError("sharded BWT mismatch")
    print(f"dryrun part 1 ok: run-seeded sharded SA, {big.size >> 10} KiB "
          f"block with a {1 << 8} KiB N run over {D} shards "
          f"({big.size // D >> 10} KiB/shard), bit-exact")

    # -- part 2: blocks scheduled over the mesh's devices -------------------
    sizes = [(16 << 10) * (1 + i % 2) for i in range(2 * D)]
    assign = largest_first_schedule(sizes, D)
    B, L = 8, 6
    for i, (n, shard) in enumerate(zip(sizes, assign)):
        dev = mesh[shard]
        data = _example_block(n, nseq=2, seed=i)
        pats, lens = _example_queries(B, L, seed=i)
        sp, ep, loc, text = index_and_query(
            torch.from_numpy(data).to(dev), torch.from_numpy(pats).to(dev),
            torch.from_numpy(lens).to(dev))
        if not np.array_equal(text.cpu().numpy(), data):
            raise AssertionError(f"block {i} on {dev}: decode does not "
                                 "round-trip")
        # a found pattern's located start spells the pattern
        for p, ln, a, b, at in zip(pats, lens, sp.tolist(), ep.tolist(),
                                   loc.tolist()):
            pat = p[L - ln:].tobytes()
            if a <= b and data[at:at + ln].tobytes() != pat:
                raise AssertionError(f"block {i}: a located hit does not "
                                     "spell its pattern")
    print(f"dryrun part 2 ok: {len(sizes)} blocks of {min(sizes) >> 10}-"
          f"{max(sizes) >> 10} KiB over {D} shards (largest first), "
          f"{B} queries each, index + search + locate + decode round trip")
