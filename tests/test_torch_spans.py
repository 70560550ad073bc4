"""The phase registry (`utils/metrics.py`) and the spans the port's verbs
open, on the CPU.

* Nesting: a phase's self time is its time less its direct children's on
  the same thread, and it names its enclosing phase; a phase on a worker
  thread names its parent and takes nothing from the parent's self time.
* Counters live in the same registry, and survive `reset`/`stats`/`report`
  as phases do; threads update it at once without losing an update.
* `profiler_trace` records a pool thread's span where torch can.
* One `index_fasta`, one `decompress` and one `gff_search` hold every span
  and counter the benchmark's per-layer metrics read, and each root's time
  is its children's plus its self time.  A search of 400 reads opens as
  many phases and counters as one of 40: none is per read or pattern.  A
  search opens `search.block` once a block (counted by `search.blocks`,
  those with a hit by `search.blocks_hit`), `search.ends` once a block
  with a hit, and packs its patterns once; a compress plans its blocks in
  `index.plan_blocks`.  A lift counts its sampled values once a block,
  those it lifts (`lift.gcx_values`) and those the device decoded
  (`lift.gcx_values_device`), inside `lift.gcx`, and its BWT's symbols
  once a block, those it lifts (`lift.bwt_symbols`) and those the device
  decoded (`lift.bwt_symbols_device`), inside `lift.bwt`: as many calls
  for a block of 11,500 symbols as for one of 1,500.
* A compress counts its sort once a block, never a round: the bases of
  each block whose final sort takes the split form
  (`sa.split_final_bases`), and, on a CUDA device alone, the card's peak
  allocation and the bases sorted (`sa.device_peak_bytes`,
  `sa.sorted_bases`), which a CPU compress leaves absent.
"""

import io
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from gecoz_tpu_torch.formats.gcz import GecozReader
from gecoz_tpu_torch.tools import driver
from gecoz_tpu_torch.utils import metrics

from conftest import random_dna
from test_gcz_files import write_fasta


def test_nested_phases_keep_self_time_and_parent():
    metrics.reset()
    with metrics.phase("t.outer"):
        time.sleep(0.02)
        with metrics.phase("t.inner"):
            time.sleep(0.03)
        with metrics.phase("t.inner"):
            pass
    st = metrics.stats()
    outer, inner = st["t.outer"], st["t.inner"]
    assert outer.parent is None and inner.parent == "t.outer"
    assert inner.calls == 2 and inner.self_seconds == inner.seconds
    assert outer.self_seconds == pytest.approx(outer.seconds - inner.seconds)
    assert 0.02 <= outer.self_seconds < outer.seconds
    assert metrics.current() is None


def test_a_worker_phase_leaves_the_callers_self_time_alone():
    metrics.reset()
    with ThreadPoolExecutor(max_workers=1) as pool:
        with metrics.phase("t.main"):
            caller = metrics.current()

            def work():
                with metrics.phase("t.worker", parent=caller):
                    with metrics.phase("t.worker_inner"):
                        time.sleep(0.03)
            pool.submit(work).result()
    st = metrics.stats()
    main, worker, inner = st["t.main"], st["t.worker"], st["t.worker_inner"]
    assert caller == "t.main" and worker.parent == "t.main"
    assert inner.parent == "t.worker"
    assert main.self_seconds == main.seconds >= worker.seconds
    assert worker.self_seconds == pytest.approx(worker.seconds
                                                - inner.seconds)


def test_counters_under_reset_stats_and_report():
    metrics.reset()
    metrics.count("t.rows", 5)
    metrics.count("t.rows", 7)
    metrics.count("t.rounds")
    with metrics.phase("t.locate", 8):
        metrics.count("t.locate", 3)
    st = metrics.stats()
    assert (st["t.rows"].count, st["t.rows"].calls) == (12, 0)
    assert st["t.rows"].seconds == 0 and st["t.rounds"].count == 1
    assert (st["t.locate"].count, st["t.locate"].calls) == (3, 1)
    lines = metrics.report().splitlines()
    assert "t.rows: 12 counted" in lines and "t.rounds: 1 counted" in lines
    assert any(line.startswith("t.locate: ") and line.endswith("3 counted")
               for line in lines)
    metrics.reset()
    assert metrics.stats() == {} and metrics.report() == ""


def test_threads_update_one_entry():
    metrics.reset()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(500):
            metrics.count("t.shared", 2)
            with metrics.phase("t.shared", 1, parent="t.root"):
                pass
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    st = metrics.stats()["t.shared"]
    assert (st.count, st.calls, st.bytes) == (16000, 8000, 8000)
    assert st.parent == "t.root"


@pytest.mark.skipif(metrics.all_threads_config() is None,
                    reason="this torch has no profile_all_threads")
def test_profiler_trace_records_a_pool_threads_span(tmp_path, monkeypatch):
    monkeypatch.setenv("GECOZ_TRACE_DIR", str(tmp_path))
    with ThreadPoolExecutor(max_workers=1) as pool:
        pool.submit(lambda: None).result()    # the thread predates the trace
        with metrics.profiler_trace() as path:
            with metrics.phase("t.caller"):
                caller = metrics.current()

                def work():
                    with metrics.phase("t.pool", parent=caller):
                        time.sleep(0.01)
                pool.submit(work).result()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"t.caller", "t.pool"} <= names


# -- the verbs' spans ---------------------------------------------------------

def _genome(rng):
    """One record with a run of N long enough for the run-aware sort."""
    seq = np.concatenate([random_dna(rng, 6000), np.full(500, ord("N"),
                                                        np.uint8),
                          random_dna(rng, 5000)])
    return [("chr1", seq), ("chr2", random_dna(rng, 1500))]


def _reads(rng, recs, count):
    out = []
    for i in range(count):
        _, seq = recs[i % len(recs)]
        at = int(rng.integers(0, 1000))
        out.append((f"read{i}", seq[at:at + 40]))
    return out


@pytest.fixture
def compressed(tmp_path, rng):
    fa, gcz = tmp_path / "in.fa", tmp_path / "in.gcz"
    recs = _genome(rng)
    write_fasta(fa, recs)
    metrics.reset()
    driver.index_fasta(fa, gcz, device="cpu")
    return recs, fa, gcz, metrics.stats()


def _root_accounted(st, root):
    """The root's time equals its direct children's plus its self time."""
    children = sum(s.seconds for name, s in st.items()
                   if s.parent == root and s.calls)
    assert st[root].parent is None and st[root].calls == 1
    assert children > 0
    assert children + st[root].self_seconds == pytest.approx(
        st[root].seconds, rel=1e-9, abs=1e-12)


def test_a_compress_holds_its_spans_and_counters(compressed):
    *_, st = compressed
    assert {"index", "index.plan", "index.read_fasta", "index.encode_mesh",
            "index.write", "mesh.sa", "sa.host_bounds", "mesh.wavelet",
            "mesh.serialize", "mesh.serialize_wait"} <= set(st)
    assert st["sa.host_bounds"].parent == "mesh.sa"
    assert st["mesh.serialize_wait"].parent == "index.encode_mesh"
    assert st["mesh.serialize"].parent == "index.encode_mesh"
    assert st["sa.rounds"].count >= 1 and st["mesh.fetched_bytes"].count > 0
    _root_accounted(st, "index")
    # the worker's serialization is not taken from the encode's self time
    encode = st["index.encode_mesh"]
    inner = sum(st[n].seconds for n in ("mesh.sa", "mesh.wavelet",
                                        "mesh.serialize_wait"))
    assert encode.self_seconds == pytest.approx(encode.seconds - inner)


def test_a_decompress_holds_its_spans(compressed, tmp_path):
    _, _, gcz, _ = compressed
    metrics.reset()
    driver.decompress(gcz, tmp_path / "back.fa", device="cpu")
    st = metrics.stats()
    assert {"decode", "decode.read_block", "decode.extract",
            "decode.host_bwt", "decode.lift", "lift.bwt", "lift.gcx",
            "lift.build", "decode.reflow"} <= set(st)
    for name in ("lift.bwt", "lift.gcx", "lift.build"):
        assert st[name].parent == "decode.lift"
    _root_accounted(st, "decode")


def test_a_search_holds_its_spans_and_counter(compressed, tmp_path, rng):
    recs, _, gcz, _ = compressed
    qa = tmp_path / "q.fa"
    write_fasta(qa, _reads(rng, recs, 40))
    metrics.reset()
    sink = io.StringIO()
    driver.gff_search(gcz, qa, out=sink, device="cpu")
    st = metrics.stats()
    assert {"search", "search.read_queries", "search.read_block",
            "search.pack", "search.tables", "lift.bwt", "lift.gcx",
            "lift.build", "search.batch", "search.expand", "search.locate",
            "search.split", "search.rows", "search.block", "search.ends",
            "search.blocks", "search.blocks_hit"} <= set(st)
    assert st["lift.gcx"].parent == "search.tables"
    assert st["search.located_rows"].count == len(sink.getvalue()
                                                   .splitlines()) >= 40
    _root_accounted(st, "search")


def test_a_compress_plans_its_blocks_in_a_span(compressed):
    *_, st = compressed
    assert st["index.plan_blocks"].parent == "index.plan"
    assert st["index.plan_blocks"].calls == 1


def test_a_search_spans_each_block(compressed, tmp_path, rng):
    """`search.block` once a block, holding the block's read, tables and
    record ends; `search.blocks` counts the blocks, `search.blocks_hit`
    those with a hit; the patterns are packed once a search."""
    recs, _, gcz, _ = compressed
    qa = tmp_path / "q.fa"
    write_fasta(qa, _reads(rng, recs, 40))
    metrics.reset()
    driver.gff_search(gcz, qa, out=io.StringIO(), device="cpu")
    st = metrics.stats()
    nblocks = len(GecozReader(gcz).headers)
    assert nblocks == 2
    assert st["search.block"].calls == st["search.blocks"].count == nblocks
    assert st["search.block"].parent == "search"
    for name in ("search.read_block", "search.tables", "search.ends",
                 "search.split"):
        assert st[name].parent == "search.block"
    assert 1 <= st["search.blocks_hit"].count <= nblocks
    assert st["search.ends"].calls == st["search.blocks_hit"].count
    assert st["search.pack"].calls == 1


def test_no_span_or_counter_per_read(compressed, tmp_path, rng,
                                     monkeypatch):
    recs, _, gcz, _ = compressed
    opened = {"phase": 0, "count": 0}
    for name in opened:
        def wrapper(*a, _orig=getattr(metrics, name), _name=name, **k):
            opened[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(metrics, name, wrapper)
    seen = []
    for count in (40, 400):
        qa = tmp_path / f"q{count}.fa"
        write_fasta(qa, _reads(rng, recs, count))
        opened.update(phase=0, count=0)
        driver.gff_search(gcz, qa, out=io.StringIO(),
                          device="cpu")
        seen.append(dict(opened))
    assert seen[0] == seen[1] and seen[0]["phase"] > 0


@pytest.mark.parametrize("verb,parent", [("decompress", "decode.lift"),
                                         ("search", "search.tables")])
def test_the_lift_counts_its_sampled_values_once_a_block(
        compressed, tmp_path, rng, monkeypatch, verb, parent):
    recs, _, gcz, _ = compressed
    calls = []

    def counting(name, n=1, _orig=metrics.count):
        calls.append(name)
        _orig(name, n)
    monkeypatch.setattr(metrics, "count", counting)
    metrics.reset()
    if verb == "decompress":
        driver.decompress(gcz, tmp_path / "back.fa", device="cpu")
    else:
        qa = tmp_path / "q.fa"
        write_fasta(qa, _reads(rng, recs, 40))
        driver.gff_search(gcz, qa, out=io.StringIO(), device="cpu")
    st = metrics.stats()
    reader = GecozReader(gcz)
    sampled = sum(reader.read(h).index.ssa_len for h in reader.headers)
    assert st["lift.gcx"].parent == parent
    for name in ("lift.gcx_values", "lift.gcx_values_device"):
        assert calls.count(name) == len(reader.headers) == 2
        assert st[name].count == sampled


@pytest.mark.parametrize("verb,parent", [("decompress", "decode.lift"),
                                         ("search", "search.tables")])
def test_the_lift_counts_its_bwt_symbols_once_a_block(
        compressed, tmp_path, rng, monkeypatch, verb, parent):
    recs, _, gcz, _ = compressed
    calls = []

    def counting(name, n=1, _orig=metrics.count):
        calls.append((name, metrics.current()))
        _orig(name, n)
    monkeypatch.setattr(metrics, "count", counting)
    metrics.reset()
    if verb == "decompress":
        driver.decompress(gcz, tmp_path / "back.fa", device="cpu")
    else:
        qa = tmp_path / "q.fa"
        write_fasta(qa, _reads(rng, recs, 40))
        driver.gff_search(gcz, qa, out=io.StringIO(), device="cpu")
    st = metrics.stats()
    reader = GecozReader(gcz)
    symbols = sum(reader.read(h).length for h in reader.headers)
    assert st["lift.bwt"].parent == parent
    assert st["lift.bwt"].calls == len(reader.headers) == 2
    for name in ("lift.bwt_symbols", "lift.bwt_symbols_device"):
        assert calls.count((name, "lift.bwt")) == len(reader.headers)
        assert st[name].count == symbols


@pytest.mark.parametrize("shape", ["fasta", "fastq_multi_line"])
def test_a_search_counts_its_query_records(compressed, tmp_path, rng, shape):
    """Both counters are set once a search; every record of a FASTA query
    file is parsed in bulk, none of a multi-line FASTQ one."""
    recs, _, gcz, _ = compressed
    reads = _reads(rng, recs, 40)
    qa = tmp_path / "q.fa"
    if shape == "fasta":
        write_fasta(qa, reads)
    else:
        qa.write_bytes(b"".join(
            b"@%s\n%s\n%s\n+\n%s\n%s\n" % (h.encode(), bytes(s[:20]),
                                         bytes(s[20:]), b"I" * 20, b"I" * 20)
            for h, s in reads))
    metrics.reset()
    sink = io.StringIO()
    driver.gff_search(gcz, qa, out=sink, device="cpu")
    st = metrics.stats()
    assert st["search.query_records"].count == 40
    bulk = st["search.query_records_bulk"].count
    assert bulk == (40 if shape == "fasta" else 0)
    assert st["search.located_rows"].count == len(sink.getvalue()
                                                   .splitlines()) >= 40


def test_a_compress_counts_its_sort_once_a_block(tmp_path, rng,
                                                 monkeypatch):
    """Two blocks, each with a run of N (the second with a periodic stretch
    too, whose ties outlast round one), with the final forms' limits
    lowered so that each takes the split form, as a chr1-length block
    does: the split form counts each block's bases once, while the
    doubling rounds count more often; the peak is taken once a block and
    counts nothing on the CPU."""
    from gecoz_tpu_torch.ops import sa_device
    from gecoz_tpu_torch.parallel import mesh
    monkeypatch.setattr(sa_device, "FINAL_CODE_LIMIT", 0)
    monkeypatch.setattr(sa_device, "FINAL_BYTE_LIMIT", 0)
    periodic = np.frombuffer(b"AC" * 500, np.uint8)   # ties past round one
    recs = _genome(rng)[:1] + [("chr2", np.concatenate([
        random_dna(rng, 1000), np.full(300, ord("N"), np.uint8), periodic]))]
    fa, gcz = tmp_path / "in.fa", tmp_path / "in.gcz"
    write_fasta(fa, recs)
    calls, peaks = [], []

    def counting(name, n=1, _orig=metrics.count):
        calls.append(name)
        _orig(name, n)

    def peak(dev, n, _orig=mesh._count_sort_peak):
        peaks.append((dev.type, n))
        _orig(dev, n)
    monkeypatch.setattr(metrics, "count", counting)
    monkeypatch.setattr(mesh, "_count_sort_peak", peak)
    metrics.reset()
    driver.index_fasta(fa, gcz, device="cpu")
    st = metrics.stats()
    lengths = sorted(len(s) + 1 for _, s in recs)     # each with its \0
    assert len(GecozReader(gcz).headers) == 2
    assert calls.count("sa.split_final_bases") == 2
    assert st["sa.split_final_bases"].count == sum(lengths)
    assert calls.count("sa.rounds") > 2
    assert sorted(peaks) == [("cpu", n) for n in lengths]
    assert "sa.device_peak_bytes" not in st and "sa.sorted_bases" not in st


def test_the_sort_peak_counts_on_a_cuda_device(monkeypatch):
    """On a CUDA device each call adds the allocator's peak reading and the
    block's bases, and resets nothing."""
    import torch

    from gecoz_tpu_torch.parallel import mesh
    readings = iter([7_000, 9_000])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda dev=None: next(readings))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: pytest.fail("the peak was reset"))
    metrics.reset()
    for n in (40, 50):
        mesh._count_sort_peak(torch.device("cuda", 0), n)
    st = metrics.stats()
    assert st["sa.device_peak_bytes"].count == 16_000
    assert st["sa.sorted_bases"].count == 90
