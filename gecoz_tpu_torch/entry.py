"""The port's counterpart of the repo's `__graft_entry__.py::entry`
(31-40): one full index, search, locate and decode step on the FM-index
pipeline, with its example arguments.

    from gecoz_tpu_torch.entry import entry
    fn, args = entry()                  # on the card; entry("cpu") on the CPU
    sp, ep, located, text = fn(*args)

The example block and queries are the reference's (`_example_block` and
`_example_queries`, __graft_entry__.py:8-28, copied in
`parallel/dryrun.py`).
"""

from __future__ import annotations

import torch

from gecoz_tpu_torch.ops.pipeline import index_and_query
from gecoz_tpu_torch.parallel.dryrun import _example_block, _example_queries
from gecoz_tpu_torch.utils.device import device as pick_device


def entry(device: torch.device | str | None = None):
    """(index_and_query, (block, patterns, lengths)) with the example
    arguments on `device` (default: the card; raises without one)."""
    dev = pick_device(device)
    data = torch.from_numpy(_example_block()).to(dev)
    pats, lens = _example_queries()
    return index_and_query, (data, torch.from_numpy(pats).to(dev),
                             torch.from_numpy(lens).to(dev))
