"""The port's query verbs vs gecoz_tpu's, through both CLIs.

With `--device cpu` (the port's plain versions), the port's CLI output
equals `gecoz_tpu.cli`'s with the host backend, byte for byte: decompress
(whole file, with reflow threads and small chunks), GFF3 search of a
query FASTA, count, locate, range extract and --check.  `find_batched`
equals the host engine's `FMIndex.find` in both of its table branches.
Cases after tests/test_batch_search.py and tests/test_decode_parallel.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from gecoz_tpu.cli import main as ref_cli
from gecoz_tpu.formats.fasta import format_fasta_record
from gecoz_tpu.tools import driver as ref_driver
from gecoz_tpu_torch import cli
from gecoz_tpu_torch.formats.gcz import GecozReader
from gecoz_tpu_torch.tools import batch_search
from gecoz_tpu_torch.tools import driver

from conftest import random_block, random_dna
from test_fm import build_fm
from test_torch_host_copies import build_port_fm
from test_gcz_files import write_fasta

torch.set_num_threads(1)


@pytest.fixture
def genome(tmp_path, rng):
    records = [("chr1", random_dna(rng, 5000)),
               ("chr2 exact", random_dna(rng, 1500, b"ACGTN")),
               ("chr3", random_dna(rng, 49)),
               ("chr4", random_dna(rng, 50)),
               ("chr5", random_dna(rng, 2751))]
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    gcz = tmp_path / "x.gcz"
    assert cli.main(["-i", str(fa), "-o", str(gcz), "--device", "cpu"]) == 0
    return records, gcz


def _out(capsys, fn, argv) -> str:
    capsys.readouterr()
    assert fn(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("threads", [1, 3])
def test_decompress_equals_host_tier(tmp_path, genome, threads):
    records, gcz = genome
    port, host = tmp_path / "port.fa", tmp_path / "host.fa"
    assert cli.main(["-i", str(gcz), "-o", str(port), "-t", str(threads),
                     "--device", "cpu"]) == 0
    assert ref_cli(["-i", str(gcz), "-o", str(host), "--backend",
                    "numpy"]) == 0
    want = b"".join(format_fasta_record(h, s) for h, s in
                    sorted(records, key=lambda r: (-len(r[1]), r[0])))
    assert host.read_bytes() == want
    assert port.read_bytes() == want


def test_decompress_many_blocks_small_chunks(tmp_path, rng, monkeypatch):
    """Tiny DECODE_CHUNK forces many reflow tasks crossing record bounds;
    the long records land in blocks of their own."""
    monkeypatch.setattr(driver, "DECODE_CHUNK", 128)
    records = [("a", random_dna(rng, 700)), ("b", random_dna(rng, 333)),
               ("c", random_dna(rng, 90))]
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    gcz = tmp_path / "out.gcz"
    ref_driver.index_fasta(fa, gcz, backend="numpy")
    port, host = tmp_path / "port.fa", tmp_path / "host.fa"
    driver.decompress(gcz, port, threads=4, device="cpu")
    ref_driver.decompress(gcz, host, backend="numpy")
    assert port.read_bytes() == host.read_bytes()


def test_query_verbs_equal_reference_cli(tmp_path, genome, capsys, rng):
    records, gcz = genome
    seq = bytes(records[0][1])
    queries = [("q1|note1|note2", seq[100:120]), ("q2", seq[500:508]),
               ("q3", seq[4000:4150]), ("absent", b"ACGTNNNNACGT"),
               ("short", b"A" * 3), ("rna", seq[10:30].replace(b"T", b"U"))]
    qf = tmp_path / "q.fa"
    write_fasta(qf, [(h, np.frombuffer(s, np.uint8)) for h, s in queries])
    port = _out(capsys, cli.main, ["-i", str(gcz), "-s", str(qf),
                                   "--device", "cpu"])
    host = _out(capsys, ref_cli, ["-i", str(gcz), "-s", str(qf),
                                  "--backend", "numpy"])
    assert port == host
    assert "ID=q1;Note=note1;Note=note2" in port and "\t-\t" in port
    pat = seq[200:209].decode()
    for argv in (["-c", pat], ["-c", "chr1", pat], ["-s", "chr1", pat],
                 ["-s", pat], ["--check"], ["--check", "--deep"]):
        assert _out(capsys, cli.main, ["-i", str(gcz)] + argv) == \
            _out(capsys, ref_cli, ["-i", str(gcz)] + argv), argv
    for argv in (["chr1", "10", "900"], ["chr5"], ["chr4", "45"]):
        a, b = tmp_path / "a.seq", tmp_path / "b.seq"
        assert cli.main(["-i", str(gcz), "-o", str(a)] + argv) == 0
        assert ref_cli(["-i", str(gcz), "-o", str(b)] + argv) == 0
        assert a.read_bytes() == b.read_bytes(), argv


def test_gff_search_on_the_lf_walk_branch(tmp_path, genome, monkeypatch):
    """A budget below 40 B/char takes the fused-LF walk instead of the
    locate table; the GFF3 rows stay the same."""
    records, gcz = genome
    seq = bytes(records[1][1])
    qf = tmp_path / "q.fa"
    write_fasta(qf, [("a", np.frombuffer(seq[7:30], np.uint8)),
                     ("b", np.frombuffer(seq[90:96], np.uint8))])
    import io
    host = io.StringIO()
    ref_driver.gff_search(gcz, qf, out=host, backend="numpy")
    monkeypatch.setenv("GECOZ_HBM_BYTES", "1")
    reader = GecozReader(gcz)
    fm = reader.read(reader.headers[0])
    blk = batch_search.search_tables(fm, torch.device("cpu"))
    assert blk.has_lf and not blk.has_loc and not blk.has_lfk
    port = io.StringIO()
    driver.gff_search(gcz, qf, out=port, device="cpu")
    assert port.getvalue() == host.getvalue() != ""


@pytest.mark.parametrize("budget", [None, "1"])
def test_find_batched_matches_host(rng, monkeypatch, budget):
    if budget:
        monkeypatch.setenv("GECOZ_HBM_BYTES", budget)
    data, seqs = random_block(rng, nseq=3, minlen=100, maxlen=500,
                              alphabet=b"ACGT")
    fm = build_fm(data, rate=8)
    pats = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
            for n in (2, 4, 7, 11) for _ in range(6)]
    pats.append(b"X")  # absent symbol
    pfm = build_port_fm(data, rate=8)
    results = batch_search.find_batched(pfm, pats, "cpu")
    for p, res in zip(pats, results):
        want = fm.find(p)
        assert set(res) == set(want), p
        for k in want:
            assert np.array_equal(res[k], want[k]), (p, k)
    assert batch_search.find_batched(pfm, [], "cpu") == []


def test_decompress_raises_without_index(tmp_path, genome):
    """No host fallback: a block the card cannot decode raises."""
    _, gcz = genome
    gcz.with_suffix(".gcx").unlink()
    with pytest.raises(SystemExit, match="gcx"):
        driver.decompress(gcz, tmp_path / "x.fa", device="cpu")
    reader = GecozReader(gcz)
    fm = reader.read(reader.headers[0])
    with pytest.raises(SystemExit):
        driver._device_decode(fm, torch.device("cpu"))
