"""The shapes of the calls into the program's kernels, recorded in the
traced run by wrapping the functions that launch them:

* `scan`: `ops/scan.py::_scan_cuda(x, ...)`, every launch of `csrc/scan.cu`
  (n = x's length);
* `k1`: `ops/fmsearch.py::backward_search(block, patterns, lengths,
  host_lengths)`, kernel K1 (patterns, their summed lengths);
* `k2`: `ops/lfwalk.py::decode_walks(tab, seeds, rate, ...)`, kernel K2's
  decode (walks, steps a walk).

A function the program no longer has is skipped: the metric that reads it
then finds nothing.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

import numpy as np


def _scan(x, *_a, **_k):
    return int(x.shape[0])


def _k1(block, patterns, lengths, host_lengths=None, *_a, **_k):
    total = (np.asarray(host_lengths, dtype=np.int64).sum()
             if host_lengths is not None else lengths.sum())
    return int(patterns.shape[0]), int(total)


def _k2(tab, seeds, rate, *_a, **_k):
    return int(seeds.shape[0]), int(rate)


TARGETS = {"scan": ("gecoz_tpu_torch.ops.scan", "_scan_cuda", _scan),
           "k1": ("gecoz_tpu_torch.ops.fmsearch", "backward_search", _k1),
           "k2": ("gecoz_tpu_torch.ops.lfwalk", "decode_walks", _k2)}


@contextlib.contextmanager
def recorded():
    """Yield {key: [shape, ...]} filled by the calls made in the block."""
    calls: dict[str, list] = {key: [] for key in TARGETS}
    undo = []
    for key, (mod_name, attr, shape) in TARGETS.items():
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr, None)
        if orig is None:
            continue

        @functools.wraps(orig)
        def wrapper(*args, _orig=orig, _shape=shape, _key=key, **kw):
            calls[_key].append(_shape(*args, **kw))
            return _orig(*args, **kw)

        setattr(mod, attr, wrapper)
        undo.append((mod, attr, orig))
    try:
        yield calls
    finally:
        for mod, attr, orig in undo:
            setattr(mod, attr, orig)
