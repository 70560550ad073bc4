"""`sort_bytes_per_base.compress`, the card's peak allocation per base
sorted, and the `hg38-chr1` deployment it guards: what the reader takes
from the registry's counters; the configuration's N, as GRCh38 chr1's; and
the small cut of `hg38-chr1` compressed on the CPU with the final sort's
limits lowered, so that it takes the split form a chr1-length block takes,
judged `correct` by `gzref`, and not `correct` under the cell's control.

    python -m pytest benchmarks/ -q
"""

from __future__ import annotations

import functools
import time

import pytest

from gzbench import data
from gzbench.control import replaced
from gzbench.layers import Context, reader
from gzbench.named import load
from gzbench.runner import ROOT, load_json, run_cell
from test_bench_harness import BENCH

from gecoz_tpu_torch.utils import metrics
from gecoz_tpu_torch.utils.metrics import PhaseStats

NAME = "sort_bytes_per_base.compress"
CELL = "hg38.compress_chr1"
CHR1 = load_json(ROOT / "benchmarks" / "configs" / "hg38-chr1.json")


def _ctx(peak, bases):
    """A window whose registry holds the two counters; None: not there."""
    spans = {name: PhaseStats(count=n) for name, n in (
        ("sa.device_peak_bytes", peak), ("sa.sorted_bases", bases))
        if n is not None}
    return Context(device_name="cpu", ops=2, op_seconds=1.0, spans=spans,
                   trace=None)


@pytest.mark.parametrize("peak,bases,want", [
    (2 * 186 * 1000, 2 * 1000, 186.0), (370, 2, 185.0),
    (0, 1000, None), (1000, 0, None), (1000, None, None), (None, 1000, None),
    (None, None, None),              # the parent, or a CPU run: no counters
])
def test_the_ratio_reads_the_counters(peak, bases, want):
    assert reader(NAME)(_ctx(peak, bases)) == want


def test_the_metric_is_listed_for_both_compress_cells():
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["hg38.compress", CELL]
    assert m["layer"] == "Block encode: suffix sort and SA state"
    assert m["moves"] == "compress_MBps"
    assert (m["unit"], m["better"], m["source"]) == (
        "B/base", "lower", "program_counter")


def test_chr1_holds_grch38_chr1s_n():
    """18,475,410 N of 248,956,422 bases (GRCh38 chr1 less its 230,481,012
    ungapped bases), laid as kind `dna` lays them: two telomeric runs and
    one near the middle, no p-arm."""
    ((rec,),) = [CHR1["records"]]
    n, g = rec["length"], CHR1["genome"]
    assert (rec["header"], n) == ("chr1", 248_956_422)
    assert int(n * g["telomere_share"]) == 10_000
    assert g["p_arm_share"] == 0
    assert 2 * 10_000 + int(n * g["centromere_share"]) == 18_475_410
    assert (CHR1["sampling"], CHR1["line_width"]) == (32, 60)
    assert set(CHR1["reduced"]) == {"records"}
    (entry,) = [c for c in BENCH["configs"] if c["name"] == "hg38-chr1"]
    assert entry["file"] == "benchmarks/configs/hg38-chr1.json"
    assert entry["reduced"] == ["records"]


def _small():
    return load(data.KINDS, "dna", "record kind").SMALL


@pytest.fixture
def split_form(monkeypatch):
    """The final sort's packed forms out of reach, as at chr1's length."""
    from gecoz_tpu_torch.ops import sa_device
    monkeypatch.setattr(sa_device, "FINAL_CODE_LIMIT", 0)
    monkeypatch.setattr(sa_device, "FINAL_BYTE_LIMIT", 0)


def _run(replace=None, traced=False):
    return run_cell(BENCH, CELL, 2 ** 31 + 23, 0.2, traced, "cpu",
                    time.perf_counter(), config_over=_small(),
                    replace=replace)


def test_the_small_chr1_cut_in_the_split_form_is_correct(split_form):
    r = _run(traced=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2
    n = sum(x["length"] + 1 for x in _small()["records"])
    # the registry counts on through the traced window: every sort counted
    assert metrics.stats()["sa.split_final_bases"].count % n == 0
    assert metrics.stats()["sa.split_final_bases"].count >= n
    # on the CPU no peak is counted, so the metric stays out of the line
    assert NAME not in r["metrics"]
    assert "suffix_sort_ms.compress" in r["metrics"]


def test_the_control_fails_the_small_chr1_cut(split_form):
    r = _run(replace=functools.partial(replaced,
                                       name="compress_sampling_doubled"))
    assert not r["correct"] and r["checks"]["gcx_bytes_wrong"]["value"] > 0
