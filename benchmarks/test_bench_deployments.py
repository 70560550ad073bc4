"""A deployment enters the benchmark as new files: a record kind
(`kinds/<kind>.py`), a query kind (`queries/<kind>.py`) and a control
(`controls/<name>.py`), each found by name.  Here: every kind file keeps
the seed rules; an unknown name is refused naming the file looked for; and
a toy protein deployment, written to a temporary directory as a test-only
record kind and peptide query kind, runs whole cells on the CPU (compress,
decompress, search over many blocks and more than 16 symbols), reads
`correct` when sound and not `correct` under a fault or the `search_one_row`
control.

    python -m pytest benchmarks/ -q
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import time
import types

import numpy as np
import pytest

from gzbench import data, runner
from gzbench.control import CONTROLS, replaced
from gzbench.named import load
from gzbench.runner import ROOT, _merge, load_json, run_cell
from gzref import gcz as ref_gcz
from test_bench_harness import SMALL, altered, half

BENCHMARK = load_json(ROOT / "BENCHMARK.json")
SEEDS = (2 ** 31 + 11, 2 ** 31 + 11, 12)    # a seed, again, another


# -- the seed rules of every kind file ----------------------------------------------

def _configs_of(kind: str) -> list[dict]:
    out = [load_json(ROOT / c["file"]) for c in BENCHMARK["configs"]]
    return [c for c in out if c["kind"] == kind]


def _small(config: dict) -> dict:
    return _merge(config, load(data.KINDS, config["kind"], "record kind").SMALL)


def _same_sizes(a, b) -> bool:
    return [len(s) for _, s in a] == [len(s) for _, s in b]


@pytest.mark.parametrize("kind", sorted(p.stem for p in data.KINDS.glob("*.py")))
def test_a_record_kind_keeps_the_seed_rules(kind):
    configs = _configs_of(kind)
    assert configs, f"no configuration of kind {kind!r}"
    for config in map(_small, configs):
        a, again, b = (data.records_of(config, s) for s in SEEDS)
        assert all(x.dtype == np.uint8 for _, x in a + b)
        assert [(h, x.tobytes()) for h, x in a] == \
            [(h, x.tobytes()) for h, x in again]
        assert [x.tobytes() for _, x in a] != [x.tobytes() for _, x in b]
        assert _same_sizes(a, b)


def _mixes_of(kind: str) -> list[tuple[dict, dict]]:
    """(mix, configuration) of each cell whose mix is of query kind `kind`."""
    out = []
    for cell in BENCHMARK["workloads"]:
        mix = load_json(runner.TRAFFIC / f"{cell['traffic']}.json")
        if "queries" in mix and mix["queries"].get("kind", "reads") == kind:
            (entry,) = [c for c in BENCHMARK["configs"]
                        if c["name"] == cell["config"]]
            out.append((mix, load_json(ROOT / entry["file"])))
    return out


@pytest.mark.parametrize("kind", sorted(p.stem for p in data.QUERIES.glob("*.py")))
def test_a_query_kind_keeps_the_seed_rules(kind):
    mixes = _mixes_of(kind)
    assert mixes, f"no cell's mix is of query kind {kind!r}"
    small = load(data.QUERIES, kind, "query kind").SMALL
    for mix, config in mixes:
        recs = data.records_of(_small(config), 5)
        q = _merge(mix["queries"], small)
        a, again, b = (data.queries_of(q, data.rng_for(s, "queries/0"), recs)
                       for s in SEEDS)
        assert a == again and a != b and _same_sizes(a, b)


# -- unknown names ------------------------------------------------------------------

def test_an_unknown_name_is_refused_naming_its_file():
    with pytest.raises(ValueError, match=str(data.KINDS / "nope.py")):
        data.records_of({"kind": "nope"}, 1)
    with pytest.raises(ValueError, match=str(data.QUERIES / "nope.py")):
        data.queries_of({"kind": "nope"}, data.rng_for(1, "q"), [])
    op = types.SimpleNamespace(traffic={"operation": "search",
                                        "control": "nope"})
    with pytest.raises(ValueError, match=str(CONTROLS / "nope.py")):
        replaced(op)


# -- a toy protein deployment, as new files alone ------------------------------------

TOY_KIND = '''
"""Test-only record kind: proteins of many residue kinds that share
domains, as families do."""
import numpy as np
from gzbench.data import composition_table, draw, rng_for

SMALL = {}


def records(config, seed):
    rng = rng_for(seed, "toy_protein")
    lo, hi = config["lengths"]
    lengths = np.geomspace(lo, hi, config["records"]).round().astype(int)
    table = composition_table({r: 1.0 for r in config["residues"]})
    domains = [draw(rng, table, n) for n in config["domain_lengths"]]
    out = []
    for i, n in enumerate(lengths):
        seq = draw(rng, table, n)
        d = domains[i % len(domains)]
        if len(d) < n:
            at = int(rng.integers(0, n - len(d)))
            seq[at:at + len(d)] = d
        out.append((f"toy{i}", seq))
    return out
'''

TOY_PEPTIDES = '''
"""Test-only query kind: tryptic peptides (cut after K or R) of 7-30
residues, each from a record drawn at random."""
import numpy as np

SMALL = {}


def queries(rng, records, q):
    out = []
    while len(out) < q["count"]:
        header, seq = records[int(rng.integers(0, len(records)))]
        cuts = np.concatenate([[0], np.flatnonzero(np.isin(
            seq, np.frombuffer(b"KR", np.uint8))) + 1, [len(seq)]])
        i = int(rng.integers(0, len(cuts) - 1))
        pep = seq[cuts[i]:cuts[min(i + 1 + int(rng.integers(0, 3)),
                                   len(cuts) - 1)]]
        if 7 <= len(pep) <= 30:
            out.append((f"{q['header']}{len(out)}|{header}", pep.tobytes()))
    return out
'''

TOY_CONFIG = {"kind": "toy_protein", "records": 300, "lengths": [50, 2000],
              "residues": "ACDEFGHIKLMNPQRSTVWYXB",
              "domain_lengths": [40, 60, 80, 100, 120], "sampling": 32,
              "line_width": 60}
TOY_TRAFFIC = {
    "toy_compress": {"operation": "compress", "rate_metric": "compress_MBps"},
    "toy_decompress": {"operation": "decompress",
                       "rate_metric": "decompress_MBps"},
    "toy_search": {"operation": "search", "rate_metric": "search_queries_per_s",
                   "files": 2, "queries": {"kind": "toy_peptides", "count": 60,
                                           "header": "pep"}}}
TOY_CELLS = ["toy.compress", "toy.decompress", "toy.search"]


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """BENCHMARK.json with the toy cells; the loader and the mixes pointed at
    the toy's files."""
    for d, name, text in (("kinds", "toy_protein", TOY_KIND),
                          ("queries", "toy_peptides", TOY_PEPTIDES)):
        (tmp_path / d).mkdir()
        (tmp_path / d / f"{name}.py").write_text(text)
    (tmp_path / "traffic").mkdir()
    for name, mix in TOY_TRAFFIC.items():
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (tmp_path / "toy-protein.json").write_text(json.dumps(TOY_CONFIG))
    monkeypatch.setattr(data, "KINDS", tmp_path / "kinds")
    monkeypatch.setattr(data, "QUERIES", tmp_path / "queries")
    monkeypatch.setattr(runner, "TRAFFIC", tmp_path / "traffic")
    bench = copy.deepcopy(BENCHMARK)
    bench["configs"].append({"name": "toy-protein", "source": "a test",
                             "file": str(tmp_path / "toy-protein.json"),
                             "reduced": [], "why": "a test"})
    bench["workloads"] += [{"name": c, "config": "toy-protein",
                            "traffic": "toy_" + c.split(".")[1], "chips": 1,
                            "why": "a test"} for c in TOY_CELLS]
    return bench


def _toy_run(bench, cell, replace=None):
    return run_cell(bench, cell, 2 ** 31 + 5, 0.2, False, "cpu",
                    time.perf_counter(), replace=replace)


def test_the_toy_deployment_has_many_symbols_and_shared_peptides(toy):
    recs = data.records_of(TOY_CONFIG, 3)
    assert len(recs) >= 300
    assert all(50 <= len(s) <= 2000 for _, s in recs)
    assert len(np.unique(np.concatenate([s for _, s in recs]))) >= 20
    queries = data.queries_of(TOY_TRAFFIC["toy_search"]["queries"],
                              data.rng_for(3, "q"), recs)
    assert all(7 <= len(p) <= 30 for _, p in queries)
    text = b"\0".join(s.tobytes() for _, s in recs)
    assert sum(text.count(p) > 1 for _, p in queries) >= 5


@contextlib.contextmanager
def _blocks_of(op, found):
    """Nothing replaced: notes how many blocks the `.gcz` set-up wrote."""
    found.append(len(ref_gcz.block_headers(op.gcz.read_bytes())))
    yield


@pytest.mark.parametrize("cell", TOY_CELLS)
def test_a_sound_toy_protein_run_is_correct(toy, cell):
    found: list[int] = []
    r = _toy_run(toy, cell, None if cell == "toy.compress" else
                 functools.partial(_blocks_of, found=found))
    assert r["correct"], r["checks"]
    assert cell == "toy.compress" or found[0] >= 2


TOY_FAULTS = [(c, altered) for c in TOY_CELLS] + [("toy.search", half)]


@pytest.mark.parametrize("cell, fault", TOY_FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in TOY_FAULTS])
def test_a_broken_toy_protein_run_is_not_correct(toy, cell, fault):
    r = _toy_run(toy, cell, fault)
    assert not r["correct"], r["checks"]


def test_the_one_row_control_fails_on_peptides(toy):
    r = _toy_run(toy, "toy.search",
                 functools.partial(replaced, name="search_one_row"))
    assert not r["correct"] and r["checks"]["rows_missing"]["value"] > 0


def test_the_one_row_control_fails_on_the_small_hg38_search():
    """At 20,000 bases hg38-dna holds 6 Alu-like copies, and no 150-base
    read occurs twice; at full size hundreds of its 15,570 copies are alike
    in any window left unmutated.  Copies left unmutated here stand in for
    those, so that some reads have several rows."""
    cfg, tr = SMALL["hg38.search_reads"]
    r = run_cell(BENCHMARK, "hg38.search_reads", 2 ** 31 + 3, 0.2, False,
                 "cpu", time.perf_counter(),
                 config_over=_merge(cfg, {"genome": {"alu_mutations_mean": 0}}),
                 traffic_over=_merge(tr, {"queries": {"count": 400}}),
                 replace=functools.partial(replaced, name="search_one_row"))
    assert not r["correct"] and r["checks"]["rows_missing"]["value"] > 0
