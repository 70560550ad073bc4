"""Block-parallel encoding: the device-state route and the block gather.

Port of gecoz_tpu/parallel/mesh.py.  `encode_blocks` is the reference's
`backend="device"` route (mesh.py:424-529): each block's suffix sort runs
on the card, and the serialization-side state (the sampled suffix array's
mark bits and values, the compacted BWT) is derived there too
(`sa_state`, the counterpart of `_state_fn`), so the host fetches only the
mark bits (n/8), the sampled values (n/8 at rate 32) and the wavelet node
bits instead of the whole int32 suffix array.  A block whose sort does not
fit one card goes to the sharded sort over a mesh of more than one shard.
Serialization overlaps the next block's device work on a 2-worker pool.

What is not ported: the reference pads blocks into equal-size buckets and
vmaps one program over each (`_bucket_size`, `_batched_sa`,
`prewarm_buckets`); torch has no vmap for this program, so every block is
sorted at its own length, which changes no byte of the output.  There is
no host fallback: a failure on the card raises.

Across processes (`index_fasta_parallel`), each process encodes its share
of the block plan (`largest_first_schedule`) on its own card, the encoded
bytes are gathered over a gloo group of `torch.distributed`, and process 0
writes.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gecoz_tpu_torch.formats.fasta import iter_fasta, read_sequence
from gecoz_tpu_torch.formats.gcz import GecozWriter, _serialize
from gecoz_tpu_torch.index.hswt import HSWT
from gecoz_tpu_torch.index.iwt import IndexWaveletTree
from gecoz_tpu_torch.index.rankbv import RankBitVector
from gecoz_tpu_torch.index.shape import HSWTShape
from gecoz_tpu_torch.index.ssa import SampledSAIndex
from gecoz_tpu_torch.ops.sa_device import suffix_array_device
from gecoz_tpu_torch.ops.wavelet import _level_bit_counts, build_hswt_device
from gecoz_tpu_torch.parallel import Mesh, local_mesh
from gecoz_tpu_torch.parallel.sharded_sa import (gather_shards,
                                                 suffix_array_sharded)
from gecoz_tpu_torch.tools.blocks import plan_blocks
from gecoz_tpu_torch.utils import metrics
from gecoz_tpu_torch.utils.device import device as default_device
from gecoz_tpu_torch.utils.device import needs_sharded_sa
from gecoz_tpu_torch.utils.hostmem import warm_for_block

def largest_first_schedule(sizes: list[int], n_shards: int) -> list[int]:
    """Greedy LPT: assign each block (largest first) to the least-loaded
    shard; returns shard id per block."""
    order = np.argsort([-s for s in sizes], kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    assign = np.zeros(len(sizes), dtype=np.int64)
    for i in order:
        shard = int(np.argmin(load))
        assign[i] = shard
        load[shard] += sizes[i]
    return assign.tolist()


def _pack_bytes(bits: torch.Tensor) -> torch.Tensor:
    """bool [n] -> uint8 [ceil(n/8)], LSB-first within each byte: the bytes
    of the reference's LSB-first uint32 words, in memory order."""
    n = bits.shape[0]
    nb = (n + 7) // 8
    b = bits.to(torch.uint8)
    if nb * 8 != n:
        b = torch.cat([b, b.new_zeros(nb * 8 - n)])
    b = b.view(nb, 8)
    out = b[:, 0].clone()
    for i in range(1, 8):
        out |= b[:, i] << i
    return out


def sa_state(sa: torch.Tensor, bwt: torch.Tensor, last_byte: int, sf: int):
    """The serialization-side state of one block's (sa, bwt), on their
    device (the reference's `_state_fn(n, n, sf)`, mesh.py:101-145):

    * the BWT with the rank-0 row set to the block's last byte (the row
      reads the wrap; an unconditional fix, as the reference's);
    * the marked rows, (sa & (rate - 1)) == 0, packed LSB-first to bytes;
    * the sampled values sa >> sf of the marked rows, in row order (a
      boolean mask: the reference's distinct-key sort gives this order).

    Returns (mark_bytes uint8 [ceil(n/8)], samples int32 [ceil(n/2^sf)],
    bwt uint8 [n])."""
    bwt = torch.where(sa == 0, torch.tensor(last_byte, dtype=torch.uint8,
                                            device=bwt.device), bwt)
    marked = (sa & ((1 << sf) - 1)) == 0
    return _pack_bytes(marked), sa[marked] >> sf, bwt


def _sort_on_card(data: np.ndarray, dev: torch.device):
    """(sa, bwt) of one block by the single-card sort; an allocator
    failure becomes a MemoryError naming the way out."""
    try:
        return suffix_array_device(data, with_bwt=True, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        raise MemoryError(
            f"the suffix sort of a {len(data)}-byte block does not fit "
            f"{dev}; a block beyond one card takes the sharded suffix sort "
            "over a mesh of more than one device (encode_blocks' mesh)") \
            from e


def _block_sa(data: np.ndarray, dev: torch.device, mesh: Mesh | None):
    """(sa, bwt) of one block on `dev`: the sharded sort over `mesh` when
    the block does not fit `dev` and the mesh has more than one shard
    (gathered to `dev`), else the single-card sort."""
    if needs_sharded_sa(len(data), dev):
        mesh = local_mesh() if mesh is None else mesh
        if len(mesh) > 1:
            sa, bwt = suffix_array_sharded(data, mesh=mesh)
            return gather_shards(sa, dev), gather_shards(bwt, dev)
    return _sort_on_card(data, dev)


def index_states_batched(blocks: list[np.ndarray], sampling_rate: int,
                         device=None, mesh: Mesh | None = None) -> list:
    """Device-side index states for variable-length blocks, one sort at a
    time, each at its block's own length.

    Returns per block: (mark_bytes uint8 [ceil(n/8)], samples int32 [m],
    bwt) — the first two fetched to the host, the BWT left on `device`
    for the wavelet build."""
    dev = default_device(device)
    sf = sampling_rate.bit_length() - 1
    out = []
    for data in blocks:
        sa, bwt = _block_sa(data, dev, mesh)
        marks, samples, bwt = sa_state(sa, bwt, int(data[-1]) if len(data)
                                       else 0, sf)
        del sa
        # fetch only the derived artifacts; the BWT stays on the device
        out.append((marks.cpu().numpy(), samples.cpu().numpy(), bwt))
        _count_sort_peak(dev, len(data))
    return out


def _count_sort_peak(dev: torch.device, n: int) -> None:
    """Once a block sorted on a CUDA device (nothing elsewhere): counter
    `sa.device_peak_bytes` adds `torch.cuda.max_memory_allocated(dev)`,
    `sa.sorted_bases` adds the block's n bases.  The program never resets
    the peak, so the reading is the process's peak since it started, or
    since its caller last reset it (the benchmark does at its window's
    start): over a window of one-block compresses the ratio of the two
    counters is the window's device peak per base of the block."""
    if dev.type != "cuda":
        return
    metrics.count("sa.device_peak_bytes", torch.cuda.max_memory_allocated(dev))
    metrics.count("sa.sorted_bases", n)


def suffix_arrays_batched(blocks: list[np.ndarray], with_bwt: bool = False,
                          device=None, mesh: Mesh | None = None) -> list:
    """True suffix arrays (int64, host) of variable-length blocks, each
    sorted on `device` (or sharded over `mesh`, as `index_states_batched`
    routes); with_bwt=True returns (sa, bwt) pairs."""
    dev = default_device(device)
    out = []
    for data in blocks:
        sa, bwt = _block_sa(data, dev, mesh)
        sa = sa.cpu().numpy().astype(np.int64)
        out.append((sa, bwt.cpu().numpy()) if with_bwt else sa)
    return out


def encode_blocks(blocks: list[np.ndarray], headers: list[list[str]],
                  sampling_rate: int = 32, device=None,
                  mesh: Mesh | None = None) -> list[tuple[bytes, bytes]]:
    """Encode many blocks on `device` (default: the card): per block the
    suffix sort and its sampled-SA state (`index_states_batched`), then
    the wavelet bit planes from the device-resident BWT, then the host
    serialization, overlapped with the next block's wavelet on a 2-worker
    pool (the reference's intra-block 2-way overlap,
    GecozFileWriter.java:262-277).  Blocks that do not fit one card go to
    the sharded sort over `mesh` (default: every local card) when it has
    more than one shard.  Returns (gcz_block, gcx_block) per block, in
    input order; the bytes are the reference's."""
    blocks = [np.ascontiguousarray(b, dtype=np.uint8) for b in blocks]
    for b in blocks:
        if len(b) >= 1 << 31:
            raise ValueError("blocks are capped at 2^31 bytes by the "
                             "int32-SA contract (SAIS.java:103)")
    if len(headers) != len(blocks):
        raise ValueError(f"{len(blocks)} blocks but {len(headers)} header "
                         "lists")
    warm_for_block(max((len(b) for b in blocks), default=0))
    sf = sampling_rate.bit_length() - 1
    if 1 << sf != sampling_rate:
        raise ValueError(f"sampling rate must be a power of 2, got "
                         f"{sampling_rate}")

    caller = metrics.current()

    def serialize(n, hdrs, ssa, shape, hswt):
        with metrics.phase("mesh.serialize", n, parent=caller):
            return _serialize(hdrs, n, shape, hswt, ssa)

    with metrics.phase("mesh.sa", sum(len(b) for b in blocks)):
        states = index_states_batched(blocks, sampling_rate, device, mesh)
    futures = []
    with ThreadPoolExecutor(max_workers=2) as pool:
        for i, (data, hdrs) in enumerate(zip(blocks, headers)):
            mark_bytes, samples, bwt = states[i]
            states[i] = None                  # the BWT leaves the device
            n = len(data)
            shape = HSWTShape.from_counts(
                np.bincount(data, minlength=256).astype(np.int64))
            with metrics.phase("mesh.wavelet", n):
                hswt = HSWT.from_packed(shape, build_hswt_device(bwt, shape))
            del bwt
            maxlen = int(shape.bit_lengths.max())
            # the bytes the host fetched for the block: marks, samples and
            # the wavelet node bits
            metrics.count("mesh.fetched_bytes", mark_bytes.nbytes
                          + samples.nbytes
                          + sum(4 * ((b + 31) // 32) for b in
                                _level_bit_counts(shape, maxlen)))
            ssa = SampledSAIndex(RankBitVector(mark_bytes, n),
                                 IndexWaveletTree(samples.astype(np.int64)),
                                 sf)
            futures.append(pool.submit(serialize, n, hdrs, ssa, shape, hswt))
        with metrics.phase("mesh.serialize_wait"):
            return [f.result() for f in futures]


@dataclass
class DistributedContext:
    """Multi-process coordination over torch.distributed (the reference's
    jax.distributed); one process, index 0, without it."""

    process_index: int = 0
    process_count: int = 1

    @classmethod
    def initialize(cls) -> "DistributedContext":
        """Join the process group torchrun describes (WORLD_SIZE, RANK,
        MASTER_ADDR, MASTER_PORT) when WORLD_SIZE is above 1, over gloo
        unless a group already exists."""
        if not dist.is_available():
            return cls()
        if int(os.environ.get("WORLD_SIZE", "1")) > 1 \
                and not dist.is_initialized():
            dist.init_process_group("gloo", init_method="env://")
        if dist.is_initialized():
            return cls(dist.get_rank(), dist.get_world_size())
        return cls()

    def my_blocks(self, sizes: list[int]) -> list[int]:
        assign = largest_first_schedule(sizes, self.process_count)
        return [i for i, a in enumerate(assign) if a == self.process_index]

    def device(self, name=None) -> torch.device:
        """This process's card: `name` when given, else cuda:LOCAL_RANK
        (one process per card); raises when there is no card."""
        if name is not None or self.process_count == 1:
            return default_device(name)
        default_device()                        # raises without a card
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def index_fasta_parallel(ipath, opath, xpath=None, sampling_rate: int = 32,
                         device=None) -> None:
    """FASTA -> .gcz/.gcx with the block plan shared over processes.

    Each process encodes its schedule share on its card (`device`, default
    cuda:LOCAL_RANK), the encoded bytes are gathered in every process, and
    process 0 writes them in plan order."""
    ipath = Path(ipath)
    plans = plan_blocks(list(iter_fasta(ipath, lazy=True)))
    datas = []
    for plan in plans:
        parts = []
        for seq in plan.sequences:
            parts.append(read_sequence(ipath, seq))
            parts.append(np.zeros(1, dtype=np.uint8))
        datas.append(np.concatenate(parts))

    ctx = DistributedContext.initialize()
    dev = ctx.device(device)
    mine = ctx.my_blocks([len(d) for d in datas])
    encoded = dict(zip(mine, encode_blocks(
        [datas[i] for i in mine], [plans[i].headers for i in mine],
        sampling_rate, dev)))
    encoded = _allgather_encoded(encoded, ctx)

    if ctx.process_index == 0:
        with GecozWriter(opath, xpath) as w:
            for i in range(len(datas)):
                w.write_encoded(*encoded[i])


def _allgather_encoded(encoded: dict, ctx: DistributedContext) -> dict:
    """Every process's encoded blocks, in every process: the pickled dicts
    gathered over a gloo group (a new one when the default group runs
    another backend)."""
    if ctx.process_count <= 1:
        return encoded
    group = None if dist.get_backend() == "gloo" else dist.new_group(
        backend="gloo")
    parts: list = [None] * ctx.process_count
    dist.all_gather_object(parts, encoded, group=group)
    out: dict = {}
    for part in parts:
        out.update(part)
    return out


def main(argv: list[str] | None = None) -> int:
    """One process of a multi-process compress, started by torchrun (one
    process per card):

        torchrun --nproc-per-node N -m gecoz_tpu_torch.parallel.mesh \\
            in.fa out.gcz [--device cpu]
    """
    import sys
    args = sys.argv[1:] if argv is None else argv
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        args = args[:i] + args[i + 2:]
    if len(args) != 2:
        print(main.__doc__, file=sys.stderr)
        return 2
    index_fasta_parallel(args[0], args[1], device=device)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
