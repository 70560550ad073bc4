"""The Swiss-Prot peptide search (`swissprot.search_peptides`) on the CPU at
its kinds' `SMALL` sizes: a sound run reads `correct` over many blocks of
many records, its control `search_one_row` does not (peptides shared by
orthologs have several rows), and the deployment's planner precondition
refuses a planner that is too slow.

    python -m pytest benchmarks/ -q
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import pytest

from gzbench import data
from gzbench.control import replaced
from gzbench.named import load
from gzbench.runner import ROOT, _merge, load_json, run_cell
from gzref import gcz as ref_gcz

BENCH = load_json(ROOT / "BENCHMARK.json")
CELL = "swissprot.search_peptides"
CONFIG = load_json(ROOT / "benchmarks" / "configs" / "swissprot-protein.json")
SMALL_CONFIG = load(data.KINDS, "protein", "record kind").SMALL
SMALL_TRAFFIC = {"queries": load(data.QUERIES, "peptides", "query kind").SMALL}


def _run(replace=None, traced=False):
    return run_cell(BENCH, CELL, 2 ** 31 + 19, 0.2, traced, "cpu",
                    time.perf_counter(), config_over=SMALL_CONFIG,
                    traffic_over=SMALL_TRAFFIC, replace=replace)


def test_the_small_deployment_keeps_the_shapes():
    config = _merge(CONFIG, SMALL_CONFIG)
    recs = data.records_of(config, 5)
    assert len(recs) == 400 and max(len(s) for _, s in recs) == 4000
    assert len(np.unique(np.concatenate([s for _, s in recs]))) >= 20
    assert all(s[0] == ord("M") for _, s in recs)
    assert len({h for h, _ in recs}) == len(recs)
    assert all(h.startswith("sp|") and " OS=" in h and h.endswith(
        " PE=1 SV=1") for h, _ in recs)
    mix = load_json(ROOT / "benchmarks" / "traffic" / "search_peptides.json")
    q = _merge(mix["queries"], SMALL_TRAFFIC["queries"])
    peps = data.queries_of(q, data.rng_for(5, "queries/0"), recs)
    assert len({p for _, p in peps}) == len(peps) == 300
    assert all(len(p) >= 7 and b"X" not in p for _, p in peps)
    text = b"\0".join(s.tobytes() for _, s in recs)
    assert sum(text.count(p) > 1 for _, p in peps) >= 5    # shared peptides
    names = {h.split("|")[1] for h, _ in recs}
    assert all(h.split("|")[1] in names for h, _ in peps)


def test_the_full_deployment_has_its_sizes():
    """Sizes alone (no residues): 35,687 records (1/16 of Swiss-Prot),
    titin's length once, a mean of about 360."""
    kind = load(data.KINDS, "protein", "record kind")
    lengths, family, first, headers = kind.shape(CONFIG)
    assert len(lengths) == len(headers) == 35_687 == len(set(headers))
    assert lengths.max() == 35_213 and lengths.min() >= 2
    assert 340 < lengths.mean() < 380
    assert 3 < len(lengths) / first.sum() < 5             # family size ~4


def test_the_small_search_is_correct_over_many_blocks():
    blocks = []

    def note_blocks(op):
        blocks.append(len(ref_gcz.block_headers(op.gcz.read_bytes())))
        return contextlib.nullcontext()

    r = _run(replace=note_blocks, traced=True)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert blocks[0] >= 5
    got = r["metrics"]
    assert {"block_ms.search", "record_ends_ms.search",
            "search_host_ms.search", "search_tables_ms.search",
            "device_idle_pct.search"} <= set(got), sorted(got)
    assert got["block_ms.search"]["value"] > 0


def test_the_small_search_reports_its_rate():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"search_queries_per_s", "setup_s"}


def test_the_one_row_control_fails_the_small_search():
    r = _run(replace=replaced)           # the mix's control: search_one_row
    assert not r["correct"]
    assert r["checks"]["rows_missing"]["value"] > 0


def test_the_planner_precondition_refuses_a_slow_planner(monkeypatch):
    from gecoz_tpu_torch.tools import driver
    kind = load(data.KINDS, "protein", "record kind")
    limit = CONFIG["planner_precondition"]["limit_s"]

    def slow(seqs):
        time.sleep(limit + 0.2)
        return []

    monkeypatch.setattr(driver, "plan_blocks", slow)
    with pytest.raises(RuntimeError, match="cannot plan the deployment's "
                                           "35,687 records"):
        kind.records(CONFIG, 1)


def test_the_planner_precondition_passes_the_program():
    kind = load(data.KINDS, "protein", "record kind")
    kind.check_planner(CONFIG)


def test_a_peptide_mix_names_its_control():
    mix = load_json(ROOT / "benchmarks" / "traffic" / "search_peptides.json")
    assert mix["control"] == "search_one_row"
    (cell,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["traffic"] == "search_peptides"
