"""`--backend` in the port's CLI against the reference's.

The port takes the reference's `--backend auto|numpy|native|device` on its
three card verbs.  `numpy` and `native` run the reference's host tier
through the port's copies; `device` runs the device tier (here on the CPU,
`--device cpu`, the port's plain versions); `auto` means the device tier.
Under each backend the port's CLI writes the `.gcz`/`.gcx` bytes, the
decompressed FASTA and the GFF3 rows the reference's CLI writes under the
same backend (the counterpart of tests/test_gcz_files.py:149).  Without a
card, `auto` and `device` exit non-zero and run nothing on the CPU.
"""

import logging

import numpy as np
import pytest
import torch

from gecoz_tpu.cli import main as ref_cli
from gecoz_tpu_torch import cli
from gecoz_tpu_torch.tools import driver
from gecoz_tpu_torch.utils.device import resolve_backend

from conftest import random_dna
from test_gcz_files import write_fasta

torch.set_num_threads(1)


@pytest.fixture
def genome(tmp_path, rng):
    """Records of several lengths (several blocks), a query FASTA drawn
    from them."""
    records = [(f"chr{i}", random_dna(rng, int(n), b"ACGTN"))
               for i, n in enumerate((4000, 2500, 1800, 1200, 700, 60))]
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    seq = bytes(records[0][1])
    rc = seq[300:330][::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    queries = [("q1|note", seq[100:120]), ("q2", seq[900:910]),
               ("q3", bytes(records[2][1])[5:40]), ("rc", rc),
               ("absent", b"ACGTTTTTTGCA")]
    qf = tmp_path / "q.fa"
    write_fasta(qf, [(h, np.frombuffer(s, np.uint8)) for h, s in queries])
    return fa, qf


def _run(capsys, fn, argv) -> str:
    capsys.readouterr()
    assert fn(argv) == 0, argv
    return capsys.readouterr().out


def _port_argv(backend):
    return ["--backend", backend] + (["--device", "cpu"]
                                     if backend == "device" else [])


@pytest.mark.parametrize("backend", ["numpy", "native", "device"])
def test_cli_equals_reference_cli_under_each_backend(tmp_path, genome, capsys,
                                                     backend):
    fa, qf = genome
    port, ref = tmp_path / "port.gcz", tmp_path / "ref.gcz"
    assert cli.main(["-i", str(fa), "-o", str(port)]
                    + _port_argv(backend)) == 0
    assert ref_cli(["-i", str(fa), "-o", str(ref), "--backend",
                    backend]) == 0
    assert port.read_bytes() == ref.read_bytes()
    assert port.with_suffix(".gcx").read_bytes() == \
        ref.with_suffix(".gcx").read_bytes()
    a, b = tmp_path / "a.fa", tmp_path / "b.fa"
    assert cli.main(["-i", str(port), "-o", str(a)]
                    + _port_argv(backend)) == 0
    assert ref_cli(["-i", str(ref), "-o", str(b), "--backend",
                    backend]) == 0
    assert a.read_bytes() == b.read_bytes() != b""
    rows = _run(capsys, cli.main, ["-i", str(port), "-s", str(qf)]
                + _port_argv(backend))
    assert rows == _run(capsys, ref_cli, ["-i", str(ref), "-s", str(qf),
                                          "--backend", backend])
    assert "ID=q1;Note=note" in rows and "\t-\t" in rows


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_host_tier_threads_change_nothing(tmp_path, genome, backend):
    """-t 3 writes what -t 1 writes: blocks encode on a pool in plan
    order; the decode workers write their chunks in place."""
    fa, _ = genome
    outs = []
    for threads in ("1", "3"):
        gcz, back = tmp_path / f"t{threads}.gcz", tmp_path / f"t{threads}.fa"
        assert cli.main(["-i", str(fa), "-o", str(gcz), "-t", threads,
                         "--backend", backend]) == 0
        assert cli.main(["-i", str(gcz), "-o", str(back), "-t", threads,
                         "--backend", backend]) == 0
        outs.append((gcz.read_bytes(), gcz.with_suffix(".gcx").read_bytes(),
                     back.read_bytes()))
    assert outs[0] == outs[1]


def test_host_tier_small_chunks_and_bounded_queue(tmp_path, rng,
                                                  monkeypatch):
    """Many blocks through a 2-worker pool (the pending queue fills and
    drains) and decode chunks of 128 bytes crossing record bounds."""
    monkeypatch.setattr(driver, "DECODE_CHUNK", 128)
    records = [(f"s{i}", random_dna(rng, int(rng.integers(300, 900))))
               for i in range(9)]
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    port, ref = tmp_path / "port.gcz", tmp_path / "ref.gcz"
    driver.index_fasta(fa, port, backend="native", threads=2)
    assert ref_cli(["-i", str(fa), "-o", str(ref), "--backend",
                    "native"]) == 0
    assert port.read_bytes() == ref.read_bytes()
    a, b = tmp_path / "a.fa", tmp_path / "b.fa"
    driver.decompress(port, a, backend="numpy", threads=4)
    assert ref_cli(["-i", str(ref), "-o", str(b), "--backend",
                    "numpy"]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_host_tier_logs_its_tier(tmp_path, genome, caplog):
    fa, _ = genome
    with caplog.at_level(logging.INFO, logger="gecoz"):
        driver.index_fasta(fa, tmp_path / "x.gcz", backend="numpy",
                           threads=2)
    assert "backend numpy: the host tier, 2 threads" in caplog.text


@pytest.mark.parametrize("backend", [None, "auto", "device"])
@pytest.mark.parametrize("verb", ["compress", "decompress", "search"])
def test_device_tier_without_a_card_exits_non_zero(tmp_path, genome, capsys,
                                                   monkeypatch, backend,
                                                   verb):
    """No card and no --device: auto (the default) and device exit 1 with a
    message naming the host tier and --device cpu, and nothing runs: the
    driver refuses before it reads the input or opens an output."""
    fa, qf = genome
    gcz = tmp_path / "x.gcz"
    assert ref_cli(["-i", str(fa), "-o", str(gcz), "--backend",
                    "native"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for name in ("iter_fasta", "GecozReader"):
        monkeypatch.setattr(driver, name,
                            lambda *a, name=name, **k: ran.append(name))
    argv = {"compress": ["-i", str(fa), "-o", str(tmp_path / "new.gcz")],
            "decompress": ["-i", str(gcz), "-o", str(tmp_path / "b.fa")],
            "search": ["-i", str(gcz), "-s", str(qf)]}[verb]
    if backend:
        argv += ["--backend", backend]
    capsys.readouterr()
    assert cli.main(argv) == 1
    out, err = capsys.readouterr()
    assert "--backend native" in err and "--device cpu" in err
    assert ran == [] and out == ""
    assert not (tmp_path / "new.gcz").exists()
    assert not (tmp_path / "b.fa").exists()


def test_driver_device_tier_without_a_card_raises(tmp_path, genome,
                                                  monkeypatch):
    fa, qf = genome
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("auto", "device"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            driver.index_fasta(fa, tmp_path / "x.gcz", backend=backend)
        assert not (tmp_path / "x.gcz").exists()


def test_unknown_backend_is_refused(tmp_path, genome, capsys):
    fa, _ = genome
    assert [resolve_backend(b) for b in ("auto", "device", "numpy",
                                         "native")] == \
        ["device", "device", "numpy", "native"]
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        resolve_backend("tpu")
    with pytest.raises(ValueError, match="unknown backend"):
        driver.index_fasta(fa, tmp_path / "x.gcz", backend="gpu")
    capsys.readouterr()
    assert cli.main(["-i", str(fa), "-o", str(tmp_path / "y.gcz"),
                     "--backend", "cuda"]) == 1
    assert "unknown backend 'cuda'" in capsys.readouterr().err
    assert not (tmp_path / "x.gcz").exists()
    assert not (tmp_path / "y.gcz").exists()
