"""The harness on the CPU at small sizes: generators, the window's
arithmetic, the trace's busy union and idle attribution, the rooflines'
byte counts, BENCHMARK.json's names, the import rules, and whole runs of
each cell with the control and with the timed path broken underneath,
which must read `correct` false.

    python -m pytest benchmarks/ -q
"""

from __future__ import annotations

import ast
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from gzbench import data, roofline
from gzbench.control import replaced
from gzbench.runner import ROOT, load_json, run_cell
from gzbench.trace import Trace, busy_seconds, device_ops, device_seconds, \
    idle_by_span
from gzbench.window import run_window

BENCH = load_json(ROOT / "BENCHMARK.json")
HERE = Path(__file__).resolve().parent


# -- generators -------------------------------------------------------------------

def _small_dna():
    cfg = load_json(HERE / "configs" / "hg38-dna.json")
    cfg["records"] = [{"header": "chr21", "length": 50_000}]
    return cfg


def test_dna_records_follow_the_seed():
    cfg = _small_dna()
    a = data.records_of(cfg, 2 ** 31 + 7)
    assert np.array_equal(a[0][1], data.records_of(cfg, 2 ** 31 + 7)[0][1])
    b = data.records_of(cfg, 8)
    assert not np.array_equal(a[0][1], b[0][1])
    g = cfg["genome"]
    share = 2 * g["telomere_share"] + g["p_arm_share"] + g["centromere_share"]
    assert abs(share - 6_621_364 / 46_709_983) < 1e-4      # chr21's N
    for r in (a, b):
        assert abs(float((r[0][1] == ord("N")).mean()) - share) < 1e-4
    assert set(np.unique(a[0][1]).tobytes()) <= set(b"ACGTN")


def _reads(seed, recs, count=2000):
    q = dict(load_json(HERE / "traffic" / "search_reads.json")["queries"],
             count=count)
    return q, data.queries_of(q, data.rng_for(seed, "q"), recs)


def test_reads_follow_the_seed():
    recs = data.records_of(_small_dna(), 3)
    q, a = _reads(5, recs)
    assert a == _reads(5, recs)[1] and a != _reads(6, recs)[1]
    assert {len(s) for _, s in a} == {q["length"]}
    assert not any(b"N" in s for _, s in a)
    assert all(h == f"read{i}|chr21" for i, (h, _) in enumerate(a))


def test_reads_keep_one_mix_for_every_seed():
    """Over a record of A alone, a read's changed bases are those that are
    not A (forward) or not T (reverse complement)."""
    recs = [("a", np.full(3000, ord("A"), np.uint8))]
    pmf = np.array([math.comb(150, k) * 0.021 ** k * 0.979 ** (150 - k)
                    for k in range(151)])
    want = data.fixed_counts(pmf, 2000)
    assert want.sum() == 2000 and abs(want[0] - 0.0414 * 2000) < 1
    for seed in (5, 2 ** 33 + 1):
        _, reads = _reads(seed, recs)
        rc = [s.count(b"T") > 75 for _, s in reads]
        assert sum(rc) == 1000
        changed = [150 - s.count(b"T" if r else b"A")
                   for r, (_, s) in zip(rc, reads)]
        assert np.bincount(changed, minlength=151).tolist() == want.tolist()


def test_fixed_counts_sum_and_follow_the_pmf():
    pmf = np.array([0.5, 0.3, 0.2])
    assert data.fixed_counts(pmf, 10).tolist() == [5, 3, 2]
    assert data.fixed_counts(pmf, 7).tolist() == [4, 2, 1]
    assert data.fixed_counts(np.array([1 / 3] * 3), 4).sum() == 4


# -- the window -------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_counts_the_operation_in_flight_at_the_deadline():
    clock = _Clock()

    def op(i):
        clock.t += 3.0            # every operation takes 3 s
        if i == 2:
            raise RuntimeError("a failed operation counts its time")
        return 10.0

    w = run_window(op, 10.0, clock)
    # starts at 0, 3, 6, 9 (before the deadline): four operations, the last
    # ends at 12 s and counts; the third failed
    assert (w.attempted, w.failed, w.done) == (4, 1, [0, 1, 3])
    assert w.seconds == 12.0 and w.work == 30.0 and w.rate == 2.5


def test_window_runs_one_operation_even_past_the_deadline():
    clock = _Clock()

    def op(i):
        clock.t += 5.0
        return 1.0

    w = run_window(op, 0.0, clock)
    assert (w.attempted, w.seconds, w.rate) == (1, 5.0, 0.2)


# -- the trace ------------------------------------------------------------------

def _trace():
    return Trace(device=[("void scan_onepass<0>(int*)", 10, 20),
                         ("fm_search(x)", 15, 30), ("Memcpy HtoD", 50, 60),
                         ("fm_search_v1(x)", 200, 210)],
                 spans=[("gzbench.op.x", 0, 100), ("a", 0, 40), ("b", 40, 100),
                        ("gzbench.op.x", 100, 220), ("c", 150, 220)],
                 window=(0, 220))


def test_busy_union_and_device_time():
    t = _trace()
    assert busy_seconds(t) == pytest.approx(40e-6)     # 10..30, 50..60, 200..210
    assert device_seconds(t, r"\bfm_search\b") == pytest.approx(15e-6)
    assert device_ops(t)[:2] == [["fm_search", pytest.approx(15e-6)],
                                 ["scan_onepass", pytest.approx(10e-6)]]


def test_idle_gaps_go_to_the_innermost_span():
    got = dict(idle_by_span(_trace()))
    assert got == pytest.approx({"a": 20e-6, "b": 50e-6, "gzbench.op.x": 50e-6,
                                 "c": 60e-6})


def test_roofline_bytes():
    assert roofline.scan_bytes(1000) == 8000
    assert roofline.k1_bytes(patterns=10, pattern_chars=150) == 230
    assert roofline.k2_bytes(walks=4, steps=32) == 16 + 256


def test_roofline_share_by_hand():
    from gzbench.layers import Context, roofline_pct
    tr = Trace(device=[("void scan_onepass<0>(int*)", 0, 1000)], spans=[],
               window=(0, 1000))
    ctx = Context(device_name="NVIDIA H100 80GB HBM3", ops=1, op_seconds=1e-3,
                  spans={}, trace=tr, calls={"scan": [1 << 20]})
    # 8 MiB at 3.35 TB/s over 1 ms of scan
    assert roofline_pct(ctx, 8 << 20, r"\bscan_onepass\b") == pytest.approx(
        100 * (8 << 20) / 3.35e12 / 1e-3)
    ctx.device_name = "another card"
    assert roofline_pct(ctx, 8 << 20, r"\bscan_onepass\b") is None


# -- BENCHMARK.json ------------------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_files():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        names += [w["name"], w["traffic"]]
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert (HERE / "layer_metrics" / f"{m['name']}.py").is_file()
    assert "setup_s" in e2e
    assert all(NAME.match(n) for n in names), [n for n in names
                                               if not NAME.match(n)]
    assert len(set(m["name"] for m in b["end_to_end"] + b["per_layer"])) == \
        len(b["end_to_end"]) + len(b["per_layer"])
    for text in [c["why"] for c in b["configs"] + b["workloads"]] + \
            [c["source"] for c in b["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


# -- what the benchmark imports ----------------------------------------------------

def test_run_py_loads_no_jax_nor_the_jax_package():
    """Every module run.py and the harness load, the program's driver, the
    kernels' wrappers and every metric reader among them: no top-level name
    is jax, jaxlib, flax or gecoz_tpu (gecoz_tpu_torch is not gecoz_tpu)."""
    code = (
        "import sys, runpy\n"
        f"sys.path[:0] = [{str(HERE)!r}, {str(ROOT)!r}]\n"
        "run = runpy.run_path(sys.path[0] + '/run.py', run_name='bench')\n"
        "import gzbench.runner, gzbench.control, gzbench.layers as L\n"
        "import gecoz_tpu_torch.tools.driver, gecoz_tpu_torch.ops.scan\n"
        "import gecoz_tpu_torch.ops.fmsearch, gecoz_tpu_torch.ops.lfwalk\n"
        "import gecoz_tpu_torch.parallel.mesh\n"
        "for p in (L.LAYER_METRICS).glob('*.py'): L.reader(p.stem)\n"
        "import gzbench.data as D, gzbench.control as C, gzbench.named as N\n"
        "for d in (D.KINDS, D.QUERIES, C.CONTROLS):\n"
        "    for p in d.glob('*.py'): N.load(d, p.stem, 'file')\n"
        "print(run['loaded_refused']())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


FOUND_BY_NAME = ("kinds", "queries", "controls")


def test_the_reference_imports_nothing_of_the_program():
    """gzref imports nothing of the program nor of the harness; the record
    kinds, query kinds and controls import nothing of the program (a
    control reaches the program's driver only through
    `gzbench.control.in_place_of`)."""
    for path in (HERE / "gzref").glob("*.py"):
        assert not _imports(path) & {"gecoz_tpu_torch", "gecoz_tpu", "jax",
                                     "gzbench"}, path
    for d in FOUND_BY_NAME:
        files = list((HERE / d).glob("*.py"))
        assert files, d
        for path in files:
            assert not _imports(path) & {"gecoz_tpu_torch", "gecoz_tpu",
                                         "jax"}, path


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    assert all(any((HERE / d).glob("*.py")) for d in FOUND_BY_NAME)
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "gecoz_tpu"}, path


def test_run_py_refuses_a_machine_without_the_card():
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "hg38.compress", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    if out.returncode == 0:
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


# -- whole runs on the CPU ----------------------------------------------------------

SMALL = {
    "hg38.compress": ({"records": [{"header": "chr21", "length": 20_000}]},
                      None),
    "hg38.decompress": ({"records": [{"header": "chr21", "length": 20_000}]},
                        None),
    "hg38.search_reads": ({"records": [{"header": "chr21", "length": 20_000}]},
                          {"queries": {"count": 40, "differences": 0.005},
                           "files": 2}),
}


def _run(cell, replace=None, traced=False):
    cfg, tr = SMALL[cell]
    return run_cell(BENCH, cell, 2 ** 31 + 3, 0.2, traced, "cpu",
                    time.perf_counter(), config_over=cfg, traffic_over=tr,
                    replace=replace)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    want = {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    assert set(r["metrics"]) == want


@pytest.mark.parametrize("cell", ["hg38.compress", "hg38.search_reads"])
def test_a_traced_run_reports_span_metrics(cell):
    r = _run(cell, traced=True)
    assert r["correct"]
    kind = "compress" if cell == "hg38.compress" else "search"
    names = {f"device_idle_pct.{kind}"} | ({"suffix_sort_ms.compress"} if
                                          kind == "compress" else
                                          {"search_tables_ms.search",
                                           "search_host_ms.search"})
    assert names <= set(r["metrics"])
    # spans of the measured window alone: the host's own share stays >= 0
    assert all(v["value"] >= 0 for v in r["metrics"].values())
    assert r["device"]["window_s"] > 0 and "breakdown" in r


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell):
    r = _run(cell, replace=replaced)
    assert not r["correct"], r["checks"]


# Faults planted in the program underneath the timed path.

@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def unchanged(op):
    """Each operation returns without doing its work: its output stays as
    it was (not written)."""
    from gecoz_tpu_torch.tools import driver
    verb = {"compress": "index_fasta", "decompress": "decompress",
            "search": "gff_search"}[op.traffic["operation"]]
    return _patched(driver, verb, lambda orig: lambda *a, **k: None)


def stale(op):
    """Every operation after the warm-up returns without doing its work, so
    the shared output file holds the warm-up's output."""
    from gecoz_tpu_torch.tools import driver
    verb = {"compress": "index_fasta", "decompress": "decompress"}[
        op.traffic["operation"]]

    def make(orig):
        calls = []

        def once(*a, **k):
            if not calls:
                orig(*a, **k)
            calls.append(1)
        return once
    return _patched(driver, verb, make)


def half(op):
    """The search leaves the second half of its batch of patterns out."""
    from gecoz_tpu_torch.tools import driver

    def make(orig):
        def find(fm, patterns, dev=None):
            out = orig(fm, patterns, dev)
            return out[:len(out) // 2] + [{} for _ in out[len(out) // 2:]]
        return find
    return _patched(driver, "find_batched", make)


def altered(op):
    """One byte or one row changed where the operation produces it."""
    from gecoz_tpu_torch.tools import driver
    kind = op.traffic["operation"]
    if kind == "search":
        def make(orig):
            def search(ref, qf, out=None, **kw):
                import io
                sink = io.StringIO()
                orig(ref, qf, out=sink, **kw)
                rows = sink.getvalue().splitlines()
                f = rows[0].split("\t")
                f[3] = str(int(f[3]) + 1)
                rows[0] = "\t".join(f)
                out.write("".join(r + "\n" for r in rows))
            return search
        return _patched(driver, "gff_search", make)
    verb = "index_fasta" if kind == "compress" else "decompress"

    def make(orig):
        def verb_then_flip(ipath, opath, *a, **k):
            orig(ipath, opath, *a, **k)
            b = bytearray(Path(opath).read_bytes())
            at = len(b) - 2 if kind == "compress" else len(b) // 2
            b[at] = ord("A") if b[at] != ord("A") else ord("C")
            Path(opath).write_bytes(bytes(b))
        return verb_then_flip
    return _patched(driver, verb, make)


FAULTS = [(c, f) for c in sorted(SMALL) for f in (unchanged, altered)] + \
    [("hg38.search_reads", half)] + \
    [(c, stale) for c in ("hg38.compress", "hg38.decompress")]


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = _run(cell, replace=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    """On the card, at a small size: a sound run is correct."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, tr = SMALL["hg38.search_reads"]
    r = run_cell(BENCH, "hg38.search_reads", 5, 1.0, True, "cuda:0",
                 time.perf_counter(), config_over=cfg, traffic_over=tr)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    json.dumps(r)
