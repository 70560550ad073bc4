"""The port's trace hooks, `entry()` and scale tools, on the CPU.

* `utils/metrics.py`: with GECOZ_TRACE_DIR set, `phase` spans are
  `torch.profiler.record_function`s and `profiler_trace()` writes a Chrome
  trace holding them (the reference's `jax.profiler` hooks).
* `entry.py::entry` against the reference's `__graft_entry__.entry`: the
  same example, the same (sp, ep, located, text).
* `tools/validate_scale.py` and `tools/probe_sharded_scale.py` pass at a
  small size on the CPU.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gecoz_tpu_torch import cli
from gecoz_tpu_torch.entry import entry
from gecoz_tpu_torch.tools import probe_sharded_scale, validate_scale
from gecoz_tpu_torch.utils import metrics

from conftest import random_dna
from test_gcz_files import write_fasta
from test_torch_standalone import MODULES, PORT

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


def _trace_names(path) -> set[str]:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profiler_trace_holds_the_phases(tmp_path, monkeypatch):
    monkeypatch.setenv("GECOZ_TRACE_DIR", str(tmp_path / "trace"))
    metrics.reset()
    with metrics.profiler_trace() as path:
        with metrics.phase("tools.outer", 100):
            with metrics.phase("tools.inner"):
                torch.arange(1000).cumsum(0)
    assert Path(path).parent == tmp_path / "trace"
    names = _trace_names(path)
    assert {"tools.outer", "tools.inner"} <= names
    assert metrics.stats()["tools.outer"].bytes == 100
    with metrics.profiler_trace() as second:
        pass
    assert second != path and Path(second).is_file()


def test_profiler_trace_is_off_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("GECOZ_TRACE_DIR", raising=False)
    with metrics.profiler_trace() as path:
        with metrics.phase("tools.quiet"):
            pass
    assert path is None
    assert metrics.stats()["tools.quiet"].calls >= 1


def test_trace_of_a_cli_compress(tmp_path, rng, monkeypatch):
    """A whole compress through the CLI, traced: the mesh route's phases
    opened on the calling thread are in the trace, and `mesh.serialize`,
    which runs on worker threads, where torch can record those."""
    fa = tmp_path / "in.fa"
    write_fasta(fa, [("chr1", random_dna(rng, 3000, b"ACGTN")),
                     ("chr2", random_dna(rng, 900))])
    monkeypatch.setenv("GECOZ_TRACE_DIR", str(tmp_path))
    with metrics.profiler_trace() as path:
        assert cli.main(["-i", str(fa), "-o", str(tmp_path / "x.gcz"),
                         "--device", "cpu"]) == 0
    names = _trace_names(path)
    assert {"index", "index.plan", "index.read_fasta", "index.encode_mesh",
            "mesh.sa", "sa.host_bounds", "mesh.wavelet",
            "mesh.serialize_wait", "index.write"} <= names
    if metrics.all_threads_config() is not None:
        assert "mesh.serialize" in names


def test_entry_matches_the_reference_entry():
    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__ as ref_entry
    finally:
        sys.path.remove(str(REPO))
    ref_fn, ref_args = ref_entry.entry()
    fn, args = entry(device="cpu")
    for a, r in zip(args, ref_args):
        assert np.array_equal(a.numpy(), np.asarray(r))
    want = ref_fn(*ref_args)
    got = fn(*args)
    for name, g, w in zip(("sp", "ep", "located", "text"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert np.array_equal(got[3].numpy(), args[0].numpy())


def test_entry_needs_a_card_or_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_validate_scale_passes_in_process(tmp_path, capsys):
    rc = validate_scale.main(["--profile", "genome", "--mb", "2",
                              "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "LARGE-SCALE CHECK PASSED" in out and "round trip: OK" in out
    assert (tmp_path / "genome.gcz").is_file()


def test_validate_scale_host_tier_through_the_cli(tmp_path, capsys):
    rc = validate_scale.main(["--profile", "hg38", "--mb", "1", "--cli",
                              "--backend", "native", "-t", "2", "--out",
                              str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "LARGE-SCALE CHECK PASSED" in out


def test_probe_sharded_scale_passes(capsys):
    rc = probe_sharded_scale.main(["--mb", "1", "--device", "cpu",
                                   "--shards", "8"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "SHARDED-SCALE PASSED" in out
    assert "mesh: (cpu,) * 8" in out and "48 B/char" not in out


def test_the_standalone_walk_covers_the_new_modules():
    """tests/test_torch_standalone.py walks every module of the port; the
    codec, SAM/BAM, entry and scale tools are among them."""
    names = {str(p.relative_to(PORT)) for p in MODULES}
    assert {"codec/__init__.py", "codec/deflate.py", "codec/gzip_file.py",
            "formats/sam.py", "formats/bam.py", "entry.py",
            "tools/validate_scale.py",
            "tools/probe_sharded_scale.py"} <= names
