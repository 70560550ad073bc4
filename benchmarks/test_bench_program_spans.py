"""The per-layer metrics that read the program's nested phases and counters
(`gecoz_tpu_torch/utils/metrics.py`): in a traced run of each cell on the
CPU at small sizes, every one of them reads a value, and the search's
spans account for the residual that `search_host_ms.search` computes.

    python -m pytest benchmarks/ -q
"""

from __future__ import annotations

import pytest

from test_bench_harness import BENCH, SMALL, _run

NEW = {
    "hg38.compress": ["host_bounds_ms.compress", "sort_rounds.compress",
                      "serialize_wait_ms.compress", "fetched_mb.compress",
                      "file_write_ms.compress", "unspanned_ms.compress"],
    "hg38.decompress": ["gcx_decode_ms.decompress",
                        "unspanned_ms.decompress"],
    "hg38.search_reads": ["query_parse_ms.search", "pattern_pack_ms.search",
                          "hit_split_ms.search", "gff_rows_ms.search",
                          "unspanned_ms.search", "locate_ns_per_row.search"],
}


def test_every_metric_of_the_program_spans_is_listed():
    listed = {m["name"] for m in BENCH["per_layer"]}
    assert {n for names in NEW.values() for n in names} <= listed
    for cell, names in NEW.items():
        for m in BENCH["per_layer"]:
            if m["name"] in names:
                assert m["workloads"] == [cell]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_reads_the_program_spans(cell):
    r = _run(cell, traced=True)
    assert r["correct"]
    got = r["metrics"]
    assert set(NEW[cell]) <= set(got), sorted(got)
    assert all(got[n]["value"] >= 0 for n in NEW[cell])
    if cell == "hg38.compress":
        assert got["sort_rounds.compress"]["value"] >= 1
        assert got["fetched_mb.compress"]["value"] > 0
    if cell == "hg38.search_reads":
        assert got["locate_ns_per_row.search"]["value"] > 0
