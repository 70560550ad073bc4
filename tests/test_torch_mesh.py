"""The port's device-state route (parallel/mesh.py) against gecoz_tpu's.

`sa_state` against the reference's `_state_fn`; `encode_blocks`, the
driver and the CLI against the reference's `backend="device"` route and
the port's host tier, byte for byte; the sharded route forced on a
`(cpu,) * 8` mesh; the block gather across two processes; the dry run.
Every comparison is exact.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp

from gecoz_tpu.cli import main as ref_cli
from gecoz_tpu.parallel import mesh as ref_mesh
from gecoz_tpu.tools import driver as ref_driver
from gecoz_tpu_torch import cli
from gecoz_tpu_torch.formats.gcz import encode_block_host
from gecoz_tpu_torch.index.shape import HSWTShape
from gecoz_tpu_torch.ops.wavelet import _level_bit_counts
from gecoz_tpu_torch.ops.sa_device import suffix_array_device
from gecoz_tpu_torch.parallel import local_mesh
from gecoz_tpu_torch.parallel import mesh
from gecoz_tpu_torch.parallel import sharded_sa as ss
from gecoz_tpu_torch.tools import driver
from gecoz_tpu_torch.utils import metrics

from conftest import random_dna

torch.set_num_threads(1)
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def write_fasta(path, records, width=60):
    with open(path, "wb") as f:
        for header, seq in records:
            f.write(b">" + header.encode() + b"\n")
            s = bytes(seq)
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + b"\n")


def _blocks(rng, sizes=(200, 205, 5000, 5100, 20_000)):
    """Blocks with N runs and separators; every other one does not end in
    a separator (its rank-0 row reads the wrap).  The default sizes share
    three of the reference's padded buckets (two of them batched), so it
    compiles three suffix sorts."""
    blocks, headers = [], []
    for i, n in enumerate(sizes):
        s = random_dna(rng, n, alphabet=b"ACGTN")
        s[n // 4:n // 4 + n // 10] = ord("N")
        s[rng.integers(1, n - 1, 3)] = 0
        if i % 2 == 0:
            s[-1] = 0
        else:
            s[-1] = ord("A")
        blocks.append(s)
        headers.append([f"b{i}", f"c{i}"])
    return blocks, headers


def test_largest_first_schedule_equals_reference(rng):
    for shards in (1, 2, 3, 5, 8):
        sizes = [int(x) for x in rng.integers(1, 10_000, 23)]
        sizes[3] = sizes[4]                      # ties keep input order
        assert mesh.largest_first_schedule(sizes, shards) == \
            ref_mesh.largest_first_schedule(sizes, shards)


@pytest.mark.parametrize("sf", [3, 5])
@pytest.mark.parametrize("ends_in_sep", [True, False])
def test_sa_state_equals_state_fn(rng, sf, ends_in_sep):
    """Mark bytes, sampled values and the fixed BWT equal the reference's
    `_state_fn(n, n, sf)` on the same (sa, bwt): the mark bytes are the
    bytes of its LSB-first uint32 words."""
    n = 3001
    s = random_dna(rng, n, alphabet=b"ACGTN")
    s[rng.integers(1, n - 1, 4)] = 0
    s[-1] = 0 if ends_in_sep else ord("G")
    sa, bwt = suffix_array_device(s, with_bwt=True, device="cpu")
    marks, samples, fixed = mesh.sa_state(sa, bwt, int(s[-1]), sf)
    words, perm, want_bwt = ref_mesh._state_fn(n, n, sf)(
        jnp.asarray(sa.numpy()), jnp.asarray(bwt.numpy()),
        jnp.asarray(np.uint8(s[-1])))
    want_marks = np.ascontiguousarray(np.asarray(words)).view(np.uint8)
    assert np.array_equal(marks.numpy(), want_marks[:(n + 7) // 8])
    assert np.array_equal(samples.numpy(), np.asarray(perm))
    assert np.array_equal(fixed.numpy(), np.asarray(want_bwt))
    assert samples.dtype == torch.int32 and marks.dtype == torch.uint8


def test_encode_blocks_equals_reference_device_route(rng):
    blocks, headers = _blocks(rng)
    metrics.reset()
    got = mesh.encode_blocks(blocks, headers, device="cpu")
    assert got == ref_mesh.encode_blocks(blocks, headers, backend="device")
    assert got == [encode_block_host(b, h) for b, h in zip(blocks, headers)]
    # the host fetched each block's marks, sampled values and node bits
    want = 0
    for b in blocks:
        n = len(b)
        shape = HSWTShape.from_counts(np.bincount(b, minlength=256))
        want += (n + 7) // 8 + 4 * ((n + 31) // 32) + sum(
            4 * ((bits + 31) // 32) for bits in _level_bit_counts(
                shape, int(shape.bit_lengths.max())))
    assert metrics.stats()["mesh.fetched_bytes"].count == want


def test_encode_blocks_sharded_route_forced(rng, monkeypatch):
    """A budget below the blocks' estimate sends each through the sharded
    sort over the (cpu,) * 8 mesh; the bytes stay the host tier's."""
    monkeypatch.setenv("GECOZ_HBM_BYTES", str(64 << 10))
    calls = []
    orig = mesh.suffix_array_sharded

    def spy(s, **kw):
        calls.append(len(s))
        return orig(s, **kw)
    monkeypatch.setattr(mesh, "suffix_array_sharded", spy)
    blocks, headers = _blocks(rng, sizes=(3000, 9001))
    got = mesh.encode_blocks(blocks, headers, 16, device="cpu",
                             mesh=(CPU,) * 8)
    assert calls == [3000, 9001]
    assert got == [encode_block_host(b, h, 16)
                   for b, h in zip(blocks, headers)]
    # a mesh of one shard keeps the single-card sort
    calls.clear()
    assert mesh.encode_blocks(blocks, headers, 16, device="cpu",
                              mesh=(CPU,)) == got
    assert calls == []


def test_driver_sharded_route_forced(tmp_path, rng, monkeypatch):
    """The driver hands its mesh to the route: with a tiny budget every
    block of a FASTA is sorted sharded, and the files are the host
    tier's."""
    monkeypatch.setenv("GECOZ_HBM_BYTES", "1")
    calls = []
    orig = mesh.suffix_array_sharded

    def spy(s, **kw):
        calls.append(len(s))
        return orig(s, **kw)
    monkeypatch.setattr(mesh, "suffix_array_sharded", spy)
    fa = tmp_path / "in.fa"
    recs = _equal_records(rng, k=3)
    write_fasta(fa, recs)
    out = tmp_path / "mesh.gcz"
    driver.index_fasta(fa, out, device="cpu", mesh=(CPU,) * 3)
    assert len(calls) == 3
    host = tmp_path / "host.gcz"
    ref_driver.index_fasta(fa, host, backend="native")
    assert out.read_bytes() == host.read_bytes()
    assert (tmp_path / "mesh.gcx").read_bytes() == \
        (tmp_path / "host.gcx").read_bytes()


def test_suffix_arrays_batched_equal_host(rng):
    from gecoz_tpu_torch.ops.sa import bwt_from_sa, suffix_array
    blocks, _ = _blocks(rng, sizes=(97, 800))
    for b, (sa, bwt) in zip(blocks, mesh.suffix_arrays_batched(
            blocks, with_bwt=True, device="cpu")):
        assert np.array_equal(sa, suffix_array(b))
        assert np.array_equal(bwt, bwt_from_sa(b, sa))


def _equal_records(rng, k=5):
    """k sequences of 1000-1200 bases: no two fuse, so k blocks."""
    recs = [(f"chr{i}", random_dna(rng, int(rng.integers(1000, 1200)),
                                   alphabet=b"ACGTN")) for i in range(k)]
    recs[1][1][100:400] = ord("N")
    return recs


def test_cli_compress_equals_reference_device_cli(tmp_path, rng,
                                                  monkeypatch):
    """The port's CLI compress goes through `_index_blocks_mesh` ->
    `encode_blocks` in windows of MESH_WINDOW_BLOCKS blocks (patched to 2:
    three windows here), fetches no full suffix array, and writes the
    bytes of the reference's `--backend device` CLI (like
    tests/test_gcz_files.py:149)."""
    monkeypatch.setattr(driver, "MESH_WINDOW_BLOCKS", 2)
    windows = []
    orig = mesh.encode_blocks

    def spy(blocks, *a, **kw):
        windows.append(len(blocks))
        return orig(blocks, *a, **kw)
    monkeypatch.setattr(mesh, "encode_blocks", spy)
    fa = tmp_path / "m.fa"
    write_fasta(fa, _equal_records(rng))
    ref, port = tmp_path / "ref.gcz", tmp_path / "port.gcz"
    assert ref_cli(["-i", str(fa), "-o", str(ref), "--backend",
                    "device"]) == 0
    metrics.reset()
    assert cli.main(["-i", str(fa), "-o", str(port), "--device", "cpu"]) == 0
    assert windows == [2, 2, 1]
    phases = set(metrics.stats())
    assert {"mesh.sa", "mesh.wavelet", "mesh.serialize",
            "index.encode_mesh"} <= phases
    assert not [p for p in phases if p.startswith("encode.")]
    assert port.read_bytes() == ref.read_bytes()
    assert (tmp_path / "port.gcx").read_bytes() == \
        (tmp_path / "ref.gcx").read_bytes()


def test_resume_through_the_mesh_route(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(driver, "MESH_WINDOW_BLOCKS", 2)
    fa = tmp_path / "in.fa"
    write_fasta(fa, _equal_records(rng))
    full = tmp_path / "full.gcz"
    driver.index_fasta(fa, full, device="cpu")
    from gecoz_tpu_torch.formats.gcz import (SSA_HEADER_LEN, GecozReader,
                                             index_size)
    r = GecozReader(full)
    keep = r.offsets[3]
    xkeep = sum(SSA_HEADER_LEN + index_size(h.len, r.sampling_factor)
                for h in r.headers[:3])
    part = tmp_path / "part.gcz"
    part.write_bytes(full.read_bytes()[:keep] + b"GecozBWTgarbage")
    (tmp_path / "part.gcx").write_bytes(
        (tmp_path / "full.gcx").read_bytes()[:xkeep + 11])
    windows = []
    orig = mesh.encode_blocks

    def spy(blocks, *a, **kw):
        windows.append(len(blocks))
        return orig(blocks, *a, **kw)
    monkeypatch.setattr(mesh, "encode_blocks", spy)
    driver.index_fasta(fa, part, resume=True, device="cpu")
    assert windows == [2]                      # blocks 4 and 5 only
    assert part.read_bytes() == full.read_bytes()
    assert (tmp_path / "part.gcx").read_bytes() == \
        (tmp_path / "full.gcx").read_bytes()


def test_no_host_fallback(tmp_path, rng, monkeypatch):
    """A failure in the device route raises out of the driver."""
    def broken(*a, **kw):
        raise RuntimeError("device failure")
    monkeypatch.setattr(mesh, "suffix_array_device", broken)
    fa = tmp_path / "in.fa"
    write_fasta(fa, _equal_records(rng, k=2))
    with pytest.raises(RuntimeError, match="device failure"):
        driver.index_fasta(fa, tmp_path / "x.gcz", device="cpu")


def test_local_mesh():
    assert local_mesh(["cpu", "cpu"]) == (CPU, CPU)
    with pytest.raises(ValueError):
        local_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_mesh()
    else:
        assert local_mesh()[0] == torch.device("cuda", 0)


def test_two_process_index_fasta_parallel(tmp_path, rng):
    """Two processes over gloo, as torchrun starts them: each encodes its
    share of the plan, the bytes are gathered, process 0 writes the file
    the sequential driver writes."""
    fa = tmp_path / "in.fa"
    write_fasta(fa, _equal_records(rng))
    seq = tmp_path / "seq.gcz"
    driver.index_fasta(fa, seq, device="cpu")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "par.gcz"
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gecoz_tpu_torch.parallel.mesh", str(fa),
             str(out), "--device", "cpu"], env=env,
            cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    assert out.read_bytes() == seq.read_bytes()
    assert (tmp_path / "par.gcx").read_bytes() == \
        (tmp_path / "seq.gcx").read_bytes()


def test_dryrun_multichip_on_a_cpu_mesh(capsys):
    from gecoz_tpu_torch.parallel.dryrun import dryrun_multichip
    ss.reset_stats()
    dryrun_multichip((CPU,) * 8)
    out = capsys.readouterr().out
    assert "part 1 ok" in out and "part 2 ok" in out
    assert ss.STATS["sorts"] > 0 and ss.STATS["rounds"] > 0
