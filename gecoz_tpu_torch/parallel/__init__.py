"""Block parallelism and the sharded suffix sort over a mesh of devices.

Port of gecoz_tpu/parallel/.  The reference's mesh is a JAX device mesh
driven by one controller (`shard_map`); here a mesh is a tuple of
`torch.device`s, one per shard, with repeats allowed:

* on a host with N cards, `cuda:0 .. cuda:N-1` (`local_mesh()`);
* a virtual mesh of D shards on one card, `(cuda:0,) * D`, which runs the
  sharded algorithm's device work on that card (no interconnect);
* `(cpu,) * D` for the plain PyTorch versions, as the tests run it.

A shard exchange (the reference's `ppermute`) moves the shard's tensor to
its destination device; `torch.distributed` serves only the multi-process
block gather (`mesh.DistributedContext`).
"""

from __future__ import annotations

import torch

Mesh = tuple[torch.device, ...]


def local_mesh(devices=None) -> Mesh:
    """The mesh of `devices` (names or torch.devices), by default every
    local card.  Raises when there is no card: the CPU, or a virtual mesh,
    is named by the caller, e.g. `(torch.device("cpu"),) * 8`."""
    if devices is not None:
        mesh = tuple(torch.device(d) for d in devices)
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        return mesh
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for the mesh; pass "
                           "the devices to run on, e.g. (torch.device('cpu'),)"
                           " * 8")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
