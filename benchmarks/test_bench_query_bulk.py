"""`query_bulk_share.search`, the share of the query records the FASTA
reader's bulk path parsed: what it reads from the registry's counters, and
1.0 in a traced run of the search cell on the CPU at a small size.

    python -m pytest benchmarks/ -q
"""

from __future__ import annotations

import pytest

from gzbench.layers import Context, reader
from test_bench_harness import BENCH, _run

from gecoz_tpu_torch.utils.metrics import PhaseStats

NAME = "query_bulk_share.search"


def _ctx(records, bulk):
    """A window whose registry holds the two counters; None: not there."""
    spans = {name: PhaseStats(count=n) for name, n in (
        ("search.query_records", records),
        ("search.query_records_bulk", bulk)) if n is not None}
    return Context(device_name="cpu", ops=2, op_seconds=1.0, spans=spans,
                   trace=None)


@pytest.mark.parametrize("records,bulk,want", [
    (8, 8, 1.0), (8, 2, 0.25), (8, 0, 0.0), (8, None, 0.0),
    (0, 0, None),
    (None, None, None),              # the parent: no such counter
])
def test_the_share_reads_the_counters(records, bulk, want):
    assert reader(NAME)(_ctx(records, bulk)) == want


def test_the_metric_is_listed_for_the_search_cell():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["hg38.search_reads"]
    assert m["layer"] == "FASTA reader"
    assert m["moves"] == "search_queries_per_s"


def test_a_traced_search_reads_every_record_in_bulk():
    r = _run("hg38.search_reads", traced=True)
    assert r["correct"]
    assert r["metrics"][NAME]["value"] == 1.0
