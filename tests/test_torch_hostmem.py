"""The port's host-memory policy: `utils/hostmem.py::_mallopt` and the CLI's
malloc re-exec (`cli.py::_retune_malloc`).

`_mallopt` is a deliberate divergence from gecoz_tpu (ROADMAP C3): the
reference passes `c_int((1 << 40) & 0x7FFFFFFF)`, which is 0, so its
warm-up sets both glibc thresholds to 0.  The port passes a positive C int,
keeps freed buffers in the heap, and leaves a threshold the environment
set.  `_retune_malloc` is a copy of the reference's, its module name
aside.
"""

import ctypes
import json
import logging
import os
import platform
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gecoz_tpu import cli as ref_cli
from gecoz_tpu_torch import cli
from gecoz_tpu_torch.utils import hostmem

from conftest import random_dna
from test_torch_host_copies import _fasta_bytes

REPO = Path(__file__).resolve().parent.parent
VARS = ("MALLOC_MMAP_THRESHOLD_", "MALLOC_TRIM_THRESHOLD_")
C_INT_MAX = (1 << 31) - 1


def _clean_env(**extra):
    """The environment without a malloc setting or an opt-out."""
    env = {k: v for k, v in os.environ.items()
           if k not in VARS + ("GECOZ_NO_MALLOC_TUNING",
                               "GECOZ_NO_HEAP_WARMUP", "GLIBC_TUNABLES")}
    return dict(env, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)


class _Libc:
    """Stands in for the C library: records each mallopt call."""

    def __init__(self):
        self.calls = []

    def mallopt(self, param, value):
        self.calls.append((param, value))
        return 1


@pytest.fixture
def libc(monkeypatch):
    stub = _Libc()
    monkeypatch.setattr(hostmem.ctypes, "CDLL", lambda *a, **k: stub)
    monkeypatch.setattr(hostmem, "_mallopt_done", False)
    for var in VARS:
        monkeypatch.delenv(var, raising=False)
    return stub


def test_mallopt_passes_positive_c_ints(libc, caplog):
    with caplog.at_level(logging.DEBUG, logger="gecoz.hostmem"):
        hostmem._mallopt()
    params = sorted(p for p, _ in libc.calls)
    assert params == sorted((hostmem._M_MMAP_THRESHOLD,
                             hostmem._M_TRIM_THRESHOLD))
    for _, value in libc.calls:
        assert isinstance(value, ctypes.c_int)
        # large buffers stay in the heap: far above a block's temporaries
        assert (1 << 30) <= value.value <= C_INT_MAX
    # each call's return value is logged, not assumed
    assert caplog.text.count("returned 1") == 2
    hostmem._mallopt()                       # once a process
    assert len(libc.calls) == 2


@pytest.mark.parametrize("preset", [VARS[:1], VARS[1:], VARS],
                         ids=["mmap", "trim", "both"])
def test_mallopt_leaves_thresholds_the_environment_set(libc, monkeypatch,
                                                       preset):
    for var in preset:
        monkeypatch.setenv(var, str(1 << 34))
    hostmem._mallopt()
    params = {hostmem._M_MMAP_THRESHOLD: VARS[0],
              hostmem._M_TRIM_THRESHOLD: VARS[1]}
    assert sorted(params[p] for p, _ in libc.calls) == sorted(
        set(VARS) - set(preset))


_ROUNDS = r"""
import ctypes, json, os, resource
PR_SET_THP_DISABLE = 41          # count 4 KiB pages: numpy advises huge ones
if ctypes.CDLL(None, use_errno=True).prctl(PR_SET_THP_DISABLE, 1, 0, 0, 0):
    raise SystemExit("prctl(PR_SET_THP_DISABLE) failed")
import numpy as np
from gecoz_tpu_torch.utils import hostmem
hostmem.warm_for_block(4 << 20)
page = os.sysconf("SC_PAGE_SIZE")


def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * page


drops = []
f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
for _ in range(20):
    a = np.empty(48 << 20, np.uint8)
    a[:] = 7
    before = rss()
    del a
    drops.append(before - rss())
faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - f0
print(json.dumps({"drops": drops, "faults": faults}))
"""


def test_freed_buffers_stay_in_the_heap(tmp_path):
    if platform.libc_ver()[0] != "glibc" or not os.path.exists(
            "/proc/self/statm"):
        pytest.skip("mallopt is not glibc's here")
    proc = subprocess.run([sys.executable, "-c", _ROUNDS], cwd=tmp_path,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert max(got["drops"]) <= 1 << 20, got["drops"]
    assert got["faults"] < 2000, got


class _Exec(Exception):
    pass


def _exec_call(module, monkeypatch, argv, raises=None):
    """What `module._retune_malloc(argv)` passes to os.execve, or None
    where it returns without exec'ing."""
    calls = []

    def execve(path, args, env):
        calls.append((path, list(args), dict(env)))
        if raises:
            raise raises
        raise _Exec

    monkeypatch.setattr(os, "execve", execve)
    try:
        assert module._retune_malloc(argv) is None
    except _Exec:
        pass
    return calls[0] if calls else None


def test_retune_malloc_matches_the_reference(monkeypatch):
    for var in VARS + ("GECOZ_NO_MALLOC_TUNING",):
        monkeypatch.delenv(var, raising=False)
    argv = ["-i", "x.fa", "-o", "x.gcz", "-t", "4"]
    port = _exec_call(cli, monkeypatch, argv)
    ref = _exec_call(ref_cli, monkeypatch, argv)
    assert port[0] == ref[0] == sys.executable
    assert port[1] == [sys.executable, "-m", "gecoz_tpu_torch.cli"] + argv
    assert ref[1] == [sys.executable, "-m", "gecoz_tpu.cli"] + argv
    assert port[2] == ref[2]
    assert port[2][VARS[0]] == port[2][VARS[1]] == str(1 << 34)
    assert port[2] == dict(os.environ, **{v: str(1 << 34) for v in VARS})


@pytest.mark.parametrize("module", [cli, ref_cli], ids=["port", "reference"])
@pytest.mark.parametrize("var, value", [("GECOZ_NO_MALLOC_TUNING", "1"),
                                        ("MALLOC_MMAP_THRESHOLD_", "65536")])
def test_retune_malloc_opt_outs(monkeypatch, module, var, value):
    for v in VARS + ("GECOZ_NO_MALLOC_TUNING",):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(var, value)
    assert _exec_call(module, monkeypatch, ["-i", "x.fa"]) is None


@pytest.mark.parametrize("module", [cli, ref_cli], ids=["port", "reference"])
def test_retune_malloc_carries_on_when_execve_fails(monkeypatch, module):
    for v in VARS + ("GECOZ_NO_MALLOC_TUNING",):
        monkeypatch.delenv(v, raising=False)
    call = _exec_call(module, monkeypatch, ["-i", "x.fa"],
                      raises=OSError("exec refused"))
    assert call is not None                  # tried once, then returned


def test_cli_process_reexecs_once(tmp_path):
    rng = np.random.default_rng(71)
    fa = tmp_path / "x.fa"
    fa.write_bytes(_fasta_bytes([(f"s{i}", random_dna(
        rng, int(rng.integers(200, 3000)), b"ACGTN")) for i in range(4)]))
    assert cli.main(["-i", str(fa), "-o", str(tmp_path / "a.gcz"),
                     "--backend", "native"]) == 0
    # -v DEBUG: the warm-up logs the thresholds the re-exec put in the
    # environment, which this process's environment does not hold
    proc = subprocess.run(
        [sys.executable, "-m", "gecoz_tpu_torch.cli", "-i", str(fa), "-o",
         str(tmp_path / "b.gcz"), "--backend", "native", "-v", "DEBUG"],
        cwd=tmp_path, env=_clean_env(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    for var in VARS:
        assert f"{var}={1 << 34} set by the environment" in proc.stderr
    for ext in ("gcz", "gcx"):
        assert (tmp_path / f"b.{ext}").read_bytes() == \
            (tmp_path / f"a.{ext}").read_bytes()
