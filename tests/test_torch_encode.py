"""Encode path of the PyTorch port: .gcz/.gcx bytes vs gecoz_tpu.

The port's `encode_block`, driver and CLI (plain versions on the CPU) must
write exactly the bytes gecoz_tpu writes with its device and host
backends; the files must decompress through gecoz_tpu; and the port must
import and encode with JAX and gecoz_tpu blocked, as on the card's
machine.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from gecoz_tpu.cli import main as ref_cli
from gecoz_tpu.formats.fasta import iter_fasta
from gecoz_tpu.formats.gcz import encode_block as ref_encode_block
from gecoz_tpu.tools import driver as ref_driver
from gecoz_tpu_torch import cli
from gecoz_tpu_torch.formats.gcz import (GecozWriter, default_gcx_path,
                                         encode_block)
from gecoz_tpu_torch.tools import driver

from conftest import random_block, random_dna

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def write_fasta(path, records, width=60):
    with open(path, "wb") as f:
        for header, seq in records:
            f.write(b">" + header.encode() + b"\n")
            s = bytes(seq)
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + b"\n")


def _records(rng, k=4, lo=300, hi=2500):
    recs = [(f"chr{i}", random_dna(rng, int(rng.integers(lo, hi)),
                                   alphabet=b"ACGTN"))
            for i in range(k)]
    recs[0][1][50:250] = ord("N")
    return recs


def test_encode_block_bytes(rng):
    data, _ = random_block(rng, nseq=2, minlen=100, maxlen=800)
    data[20:300] = ord("N")
    got = encode_block(data, ["a", "b"], device="cpu")
    assert got == ref_encode_block(data, ["a", "b"], backend="numpy")
    assert got == ref_encode_block(data, ["a", "b"], backend="device")
    for rate in (4, 64):
        assert encode_block(data, ["a"], rate, device="cpu") == \
            ref_encode_block(data, ["a"], rate, backend="numpy")


@pytest.mark.parametrize("append", [False, True])
def test_writer_lays_blocks_end_to_end(tmp_path, rng, append):
    """`GecozWriter` writes each encoded block after the last, the .gcx
    beside the .gcz; `append` (the resume path) keeps what they held, and
    a .gcx that cannot be opened raises."""
    data, _ = random_block(rng, nseq=2, minlen=100, maxlen=400)
    gcz, gcx = encode_block(data, ["a", "b"], device="cpu")
    out = tmp_path / "w.gcz"
    out.write_bytes(b"old")
    default_gcx_path(out).write_bytes(b"OLD")
    with GecozWriter(out, append=append) as w:
        w.write_encoded(gcz, gcx)
        w.write_encoded(gcz, gcx)
    old, old_x = (b"old", b"OLD") if append else (b"", b"")
    assert out.read_bytes() == old + gcz + gcz
    assert default_gcx_path(out).read_bytes() == old_x + gcx + gcx
    with pytest.raises(OSError):
        GecozWriter(out, tmp_path, append=True)     # a directory
    assert out.read_bytes() == old + gcz + gcz


def test_cli_bytes_equal_reference_device_cli(tmp_path, rng):
    """Like tests/test_gcz_files.py:149: the port's CLI against gecoz_tpu's
    `--backend device` CLI, byte for byte, then a gecoz_tpu round trip."""
    records = _records(rng)
    fa = tmp_path / "m.fa"
    write_fasta(fa, records)
    ref = tmp_path / "ref.gcz"
    port = tmp_path / "port.gcz"
    assert ref_cli(["-i", str(fa), "-o", str(ref), "--backend", "device"]) \
        == 0
    assert cli.main(["-i", str(fa), "-o", str(port), "--device", "cpu"]) \
        == 0
    assert port.read_bytes() == ref.read_bytes()
    assert (tmp_path / "port.gcx").read_bytes() == \
        (tmp_path / "ref.gcx").read_bytes()
    back = tmp_path / "back.fa"
    ref_driver.decompress(port, back, backend="numpy")
    assert {s.header: bytes(s.data) for s in iter_fasta(back)} == \
        {h: bytes(s) for h, s in records}


def test_cli_index_path_and_resume(tmp_path, rng):
    records = _records(rng, k=5)
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    host = tmp_path / "host.gcz"
    ref_driver.index_fasta(fa, host, backend="native")
    out, idx = tmp_path / "o.gcz", tmp_path / "side.gcx"
    assert cli.main(["-i", str(fa), "-o", str(out), "-idx", str(idx),
                     "--device", "cpu", "-v", "INFO"]) == 0
    assert out.read_bytes() == host.read_bytes()
    assert idx.read_bytes() == (tmp_path / "host.gcx").read_bytes()
    # a partial pair (two complete blocks + a torn tail) resumes to the
    # same bytes
    from gecoz_tpu.formats.gcz import (SSA_HEADER_LEN, GecozReader,
                                       index_size)
    r = GecozReader(host)
    keep = r.offsets[2]
    xkeep = sum(SSA_HEADER_LEN + index_size(h.len, r.sampling_factor)
                for h in r.headers[:2])
    part, partx = tmp_path / "p.gcz", tmp_path / "p.gcx"
    part.write_bytes(host.read_bytes()[:keep] + b"GecozBWTgarbage")
    partx.write_bytes((tmp_path / "host.gcx").read_bytes()[:xkeep + 7])
    driver.index_fasta(fa, part, resume=True, device="cpu")
    assert part.read_bytes() == host.read_bytes()
    assert partx.read_bytes() == (tmp_path / "host.gcx").read_bytes()


def test_cli_refuses_what_is_not_ported(tmp_path, rng, capsys):
    """Every verb and every backend of the reference is served now; what is
    refused is an unknown backend, a missing input, and the device tier
    without a card."""
    fa = tmp_path / "x.fa"
    write_fasta(fa, _records(rng, k=1))
    gcz = tmp_path / "x.gcz"
    assert cli.main(["-i", str(fa), "-o", str(gcz), "--device", "cpu"]) == 0
    assert cli.main(["-i", str(gcz), "-c", "ACGT"]) == 0
    assert cli.main(["-i", str(gcz), "-s", "chr0", "ACGT"]) == 0
    assert cli.main(["-i", str(gcz), "--check"]) == 0
    if not torch.cuda.is_available():
        assert cli.main(["-i", str(gcz), "-o", str(tmp_path / "b.fa")]) == 1
        assert cli.main(["-i", str(fa), "-o", str(gcz)]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["-i", str(fa), "-o", str(gcz), "--backend",
                     "tpu"]) == 1
    assert cli.main(["-i", str(fa), "-o", str(tmp_path / "n.gcz"),
                     "--backend", "native"]) == 0
    assert (tmp_path / "n.gcz").read_bytes() == gcz.read_bytes()
    assert cli.main(["-i", str(tmp_path / "missing.fa"), "-o",
                     str(gcz)]) == 1
    assert cli.main(["-h"]) == 0


def test_default_device_is_the_card():
    from gecoz_tpu_torch.utils.device import device
    assert device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError):
            device()


_BLOCKED = textwrap.dedent("""
    import sys

    class NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "gecoz_tpu"):
                raise ImportError("blocked: " + name)

    sys.meta_path.insert(0, NoJax())
    import numpy as np
    import gecoz_tpu_torch
    from gecoz_tpu_torch import cli
    rng = np.random.default_rng(3)
    with open(sys.argv[1], "w") as f:
        for i in range(3):
            seq = "".join(rng.choice(list("ACGTN"), size=700 + 300 * i))
            f.write(f">s{i}\\n{seq}\\n")
    rc = cli.main(["-i", sys.argv[1], "-o", sys.argv[2], "--device", "cpu"])
    assert rc == 0, rc
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "gecoz_tpu")]
    print("ENCODED")
""")


def test_imports_and_encodes_with_jax_blocked(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp_path / "b.fa"),
         str(tmp_path / "b.gcz")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ENCODED" in proc.stdout
    host = tmp_path / "h.gcz"
    ref_driver.index_fasta(tmp_path / "b.fa", host, backend="native")
    assert (tmp_path / "b.gcz").read_bytes() == host.read_bytes()


def test_block_beyond_the_card_raises_memory_error(rng, monkeypatch):
    """An allocator failure in the suffix sort becomes a MemoryError that
    names the sharded suffix sort; nothing is refused before it."""
    from gecoz_tpu_torch.formats import gcz
    from gecoz_tpu_torch.parallel import mesh

    def no_room(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    data, _ = random_block(rng, nseq=1, minlen=100, maxlen=300)
    monkeypatch.setattr(mesh, "suffix_array_device", no_room)
    with pytest.raises(MemoryError, match="sharded suffix sort") as err:
        gcz.encode_block(data, ["a"], device="cpu")
    assert isinstance(err.value.__cause__, torch.cuda.OutOfMemoryError)
