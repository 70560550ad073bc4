"""Device selection (counterpart of the probe in gecoz_tpu/utils/accel.py).

The port runs on the card.  `device()` returns `cuda:0` and raises when
there is none: a measurement or encode that finds no card fails instead of
quietly running on the CPU.  The CPU is used only when a caller names it
(`device("cpu")`), as the tests do.
"""

from __future__ import annotations

import torch


def device(name: str | torch.device | None = None) -> torch.device:
    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; gecoz_tpu_torch "
                           "runs on the card (pass device='cpu' to run its "
                           "plain versions on the CPU)")
    return torch.device("cuda", 0)


def sync(dev: torch.device) -> None:
    """Wait for the work queued on `dev` (no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
