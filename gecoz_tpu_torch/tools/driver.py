"""FASTA -> .gcz/.gcx on the card (GecoIndex.index).

Port of gecoz_tpu/tools/driver.py::index_fasta (26-113), one block at a
time.  The block plan, FASTA reading, arena warm-up, phase metrics and
`--resume` scan are gecoz_tpu's own.  The reference's batched mesh route
(driver.py:71-85 -> parallel/mesh.py) is multi-GPU work (ROADMAP A9), and
the host thread pool has no counterpart: the card encodes one block after
another.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from gecoz_tpu.formats.fasta import iter_fasta, read_sequence
from gecoz_tpu.formats.gcz import DEFAULT_SAMPLING_RATE
from gecoz_tpu.tools.blocks import plan_blocks
from gecoz_tpu.tools.driver import _resume_prefix
from gecoz_tpu.utils import metrics
from gecoz_tpu.utils.hostmem import warm_for_block
from gecoz_tpu_torch.formats.gcz import GecozWriter

log = logging.getLogger("gecoz")


def index_fasta(ipath, opath, xpath=None, sampling=DEFAULT_SAMPLING_RATE,
                resume: bool = False,
                device: torch.device | str | None = None) -> None:
    """FASTA -> .gcz/.gcx, encoding every block on `device` (default: the
    card).  With resume=True, complete leading blocks of an existing output
    pair that match the plan are kept and encoding restarts after them."""
    t0 = time.time()
    ipath = Path(ipath)
    sequences = list(iter_fasta(ipath, lazy=True))
    if not sequences:
        raise SystemExit(f"no data found in file: {ipath}")
    blocks = plan_blocks(sequences)
    warm_for_block(max(sum(s.length + 1 for s in b.sequences)
                       for b in blocks))
    log.info("indexing %d sequences in %d blocks", len(sequences), len(blocks))
    skip = _resume_prefix(opath, xpath, blocks, sampling) if resume else 0
    if skip:
        log.info("resuming after %d complete blocks", skip)
        blocks = blocks[skip:]
    with GecozWriter(opath, xpath, sampling, device=device,
                     append=skip > 0) as w:
        for block in blocks:
            with metrics.phase("index.read_fasta"):
                parts = []
                for seq in block.sequences:
                    parts.append(read_sequence(ipath, seq))
                    parts.append(np.zeros(1, dtype=np.uint8))
                data = np.concatenate(parts)
            with metrics.phase("index.encode_block", len(data)):
                w.write(block.headers, data)
    log.info("finished in %d ms", (time.time() - t0) * 1000)
