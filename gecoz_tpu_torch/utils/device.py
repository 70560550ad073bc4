"""Tier and device selection and memory budget (counterpart of the probe,
the `--backend` policy and `device_hbm_bytes` in gecoz_tpu/utils/accel.py).

The port runs on the card.  `device()` returns `cuda:0` and raises when
there is none: a measurement or encode that finds no card fails instead of
quietly running on the CPU.  The CPU is used only when a caller names it
(`device("cpu")`), as the tests do.

`resolve_backend()` maps the reference's `--backend` names onto the port's
two tiers: `device` (the card, or the device `--device` names) for `auto`
and `device`, the host tier for `numpy` and `native`.  The reference's
`auto` weighs the device against the host with a relay cost model
(accel.py:76-181); the port does not port it (ROADMAP A10), so its `auto`
is the device tier, with no fallback.
"""

from __future__ import annotations

import os

import torch


class NoDeviceError(RuntimeError):
    """No card, and no device named: the port does not fall back to the
    CPU."""


def device(name: str | torch.device | None = None) -> torch.device:
    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise NoDeviceError("no CUDA device is available; gecoz_tpu_torch "
                            "runs on the card (pass device='cpu' to run its "
                            "plain versions on the CPU)")
    return torch.device("cuda", 0)


BACKENDS = ("auto", "numpy", "native", "device")


def resolve_backend(name: str) -> str:
    """The tier of a `--backend` name: "device" for auto and device, the
    name itself for the host tiers numpy and native.  Raises ValueError on
    any other name."""
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r} (one of "
                         f"{', '.join(BACKENDS)})")
    return "device" if name in ("auto", "device") else name


def sync(dev: torch.device) -> None:
    """Wait for the work queued on `dev` (no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def hbm_budget(dev: torch.device) -> int | None:
    """Bytes a new table may take on `dev`, or None on the CPU (host RAM
    is not the constraint).

    What the driver reports free plus what torch's allocator holds cached
    (reserved, not allocated): after one large block the cache holds most
    of the card, and torch serves new tensors from it.  GECOZ_HBM_BYTES
    overrides, as it does the reference's `device_hbm_bytes`."""
    env = os.environ.get("GECOZ_HBM_BYTES")
    if env:
        return int(env)
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return free + (torch.cuda.memory_reserved(dev)
                   - torch.cuda.memory_allocated(dev))


# The single-card suffix sort's peak device memory per input byte, on the
# card: `chip_smoke.py` phase 3, run T (NVIDIA H100 80GB HBM3, 700 W): the
# run-aware sort without the run-key table peaked at 203.2 B/char at 64 MiB
# (174.2 with the table, the branch DNA takes).  A whole compress of
# GRCh38 chr1's length (248,956,423 bytes with its terminator, the split
# final sort) peaked at 185.9 B/char on the same card, 46.29 GB
# (`sort_bytes_per_base.compress` in the benchmark's `hg38.compress_chr1`).
# The reference's 48 is a TPU figure.
SA_DEVICE_BYTES_PER_CHAR = 204


def needs_sharded_sa(nbytes: int, dev: torch.device) -> bool:
    """True when one block's suffix sort does not fit `dev`'s budget
    (`hbm_budget`, which GECOZ_HBM_BYTES overrides) and must take the
    sharded sort over a mesh (gecoz_tpu/utils/accel.py:184-191)."""
    budget = hbm_budget(dev)
    if budget is None:
        return False
    return nbytes * SA_DEVICE_BYTES_PER_CHAR > budget
