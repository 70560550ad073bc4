"""`bwt_device_share.decompress`, the share of the lifted BWT symbols that
the device decoded from the wavelet tree's stored streams: what it reads
from the registry's counters, and 1.0 in a traced run of the decompress
cell on the CPU at a small size.

    python -m pytest benchmarks/ -q
"""

from __future__ import annotations

import pytest

from gzbench.layers import Context, reader
from test_bench_harness import BENCH, _run

from gecoz_tpu_torch.utils.metrics import PhaseStats

NAME = "bwt_device_share.decompress"


def _ctx(symbols, device):
    """A window whose registry holds the two counters; None: not there."""
    spans = {name: PhaseStats(count=n) for name, n in (
        ("lift.bwt_symbols", symbols),
        ("lift.bwt_symbols_device", device)) if n is not None}
    return Context(device_name="cpu", ops=2, op_seconds=1.0, spans=spans,
                   trace=None)


@pytest.mark.parametrize("symbols,device,want", [
    (64, 64, 1.0), (64, 16, 0.25), (64, 0, 0.0), (64, None, 0.0),
    (0, 0, None),
    (None, None, None),              # the parent: no such counter
])
def test_the_share_reads_the_counters(symbols, device, want):
    assert reader(NAME)(_ctx(symbols, device)) == want


def test_the_metric_is_listed_for_the_decompress_cell():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["hg38.decompress"]
    assert m["layer"] == "Query state and tables"
    assert m["moves"] == "decompress_MBps"
    assert (m["unit"], m["better"], m["source"]) == (
        "fraction", "higher", "program_counter")


def test_a_traced_decompress_decodes_every_bwt_on_the_device():
    r = _run("hg38.decompress", traced=True)
    assert r["correct"]
    assert r["metrics"][NAME]["value"] == 1.0
