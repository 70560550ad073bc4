"""Files of short blocks (reads, probes, primers) through the port's CLI,
held to ground truth (ROADMAP C5).

The `.gcx` does not store the sampling factor.  The reference derives it
from the file's size alone (GecozFileReader.java:134-149, copied by
gecoz_tpu), and where every block is short a smaller factor fits first:
the index then holds more values than marks, and the reference's decode
writes wrong records or raises.  The port's reader holds each candidate
factor to the blocks' mark counts as well.

Every case compresses with both CLIs (the `.gcz`/`.gcx` bytes must be
equal: nothing written changes) and then holds the port's verbs to
ground truth computed here, not to the reference's output, which is wrong
on these files: decompress on the device tier (`--device cpu`, the plain
versions of the card's route) and on the host tier (`--backend numpy`)
against the input records, GFF3 search (the locate table, and the fused
LF walk under `GECOZ_HBM_BYTES=1`) against a plain byte search of both
strands, count and locate against plain occurrences, range extract
against slices, and `--check --deep`.  Everything compared is a byte or
an integer: tolerance 0.
"""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from gecoz_tpu import native as ref_native
from gecoz_tpu.cli import main as ref_cli
from gecoz_tpu.formats.gcz import GecozReader as RefReader
from gecoz_tpu_torch import cli, native
from gecoz_tpu_torch.formats.gcz import SSA_HEADER_LEN, GecozReader
from gecoz_tpu_torch.index.fm import FMIndex
from gecoz_tpu_torch.index.hswt import HSWT
from gecoz_tpu_torch.index.iwt import iwt_size
from gecoz_tpu_torch.index.rankbv import rbv_bytes
from gecoz_tpu_torch.index.ssa import SampledSAIndex, index_size
from gecoz_tpu_torch.ops import fmq
from gecoz_tpu_torch.ops.sa import suffix_array_naive, suffix_array_numpy

from test_gcz_files import write_fasta

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


def _first_fit(n: int, sf: int) -> int:
    """The factor the reference derives for one block of n rows written at
    `sf`: the first whose index size fits."""
    return next(f for f in range(sf + 1)
                if index_size(n, f) <= index_size(n, sf))


def _misread(n: int, rate: int) -> bool:
    """A one-block file the reference misreads: it derives a smaller
    factor while the block holds two samples or more."""
    sf = rate.bit_length() - 1
    return _first_fit(n, sf) != sf and (n + rate - 1) // rate >= 2


def _band_edges(rate: int) -> list[int]:
    """Block lengths on both sides of every edge of the misread bands."""
    top = 4 * rate + 8
    edges = set()
    for n in range(2, top + 1):
        if _misread(n, rate) != _misread(n - 1, rate):
            edges.update((n - 1, n))
    return sorted(edges)


# (rate, block length n: the record's bases plus its terminator)
ONE_RECORD = [(rate, n) for rate in (2, 4, 8, 16, 32)
              for n in range(1, 4 * rate + 9)]
EDGES = [(rate, n) for rate in (64, 128, 256) for n in _band_edges(rate)]


def _dna(rng, n: int) -> bytes:
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()


def _reads(count: int, lengths, seed: int, prefix: str):
    rng = np.random.default_rng(seed)
    return [(f"{prefix}{i}", _dna(rng, int(rng.integers(*lengths))))
            for i in range(count)]


MULTI = {
    "probes_50x40": lambda: _reads(50, (40, 41), 40, "probe"),
    "probes_50x35_40": lambda: _reads(50, (35, 41), 35, "probe"),
    "reads_100x36": lambda: _reads(100, (36, 37), 36, "read"),
    "reads_100x100": lambda: _reads(100, (100, 101), 100, "read"),
    "reads_100x101": lambda: _reads(100, (101, 102), 101, "read"),
    # empty records beside short ones, and one symbol repeated
    "mixed_empty": lambda: [("e0", b""), ("s1", b"ACGTTGCA"), ("e2", b""),
                            ("a3", b"A" * 40), ("c4", b"C"), ("e5", b"")]
                           + _reads(8, (33, 49), 7, "r"),
}


def _queries(records, rng) -> list[tuple[str, bytes]]:
    """Substrings of the records (1 to 24 bases), a homopolymer, and a
    pattern longer than any block."""
    seqs = [s for _, s in records if s]
    out = [("homo", b"AAAAAAAA"), ("acgt", b"ACGT"),
           ("long", b"ACGT" * (max(map(len, seqs), default=0) // 4 + 2))]
    for i in range(8 if seqs else 0):
        s = seqs[int(rng.integers(0, len(seqs)))]
        ln = int(rng.integers(1, min(24, len(s)) + 1))
        a = int(rng.integers(0, len(s) - ln + 1))
        out.append((f"q{i}", s[a:a + ln]))
    return out


def _hits(seq: bytes, pat: bytes) -> list[int]:
    """Every (overlapping) occurrence of `pat` in `seq`."""
    return [i for i in range(len(seq) - len(pat) + 1)
            if seq[i:i + len(pat)] == pat]


def _gff_truth(records, queries) -> list[tuple[tuple[str, str], str]]:
    """((query, strand), row) of a plain two-strand byte search, in the
    verb's row format."""
    rows = []
    for qname, fwd in queries:
        rev = fwd[::-1].translate(_COMPLEMENT)
        for strand, pat in (("+", fwd), ("-", rev)):
            for target, seq in records:
                for p in _hits(seq, pat):
                    rows.append(((qname, strand),
                                 f"{target}\tgecotools\tdna\t{p + 1}\t"
                                 f"{p + len(fwd)}\t1.000\t{strand}\t.\t"
                                 f"ID={qname}"))
    return rows


def _parse_fasta(path: Path) -> list[tuple[str, bytes]]:
    out = []
    for part in path.read_bytes().split(b">")[1:]:
        head, _, body = part.partition(b"\n")
        out.append((head.decode(), body.replace(b"\n", b"")))
    return out


def _out(capsys, argv, rc: int = 0) -> str:
    capsys.readouterr()
    assert cli.main(argv) == rc, argv
    return capsys.readouterr().out


def _assert_gff(text: str, truth) -> None:
    """The same rows, grouped query by query and strand by strand in the
    queries' order (rows within a group follow the blocks)."""
    got = text.splitlines()
    assert sorted(got) == sorted(r for _, r in truth)
    order = list(dict.fromkeys(k for k, _ in truth))
    seen = [(r.split("ID=")[1], r.split("\t")[6]) for r in got]
    assert list(dict.fromkeys(seen)) == order


def _assert_match(text: str, records, pat: bytes, positions: bool) -> None:
    """`-c`/`-s` output: one group a record with hits, with its
    positions when `positions`."""
    groups, cur = [], None
    for line in text.splitlines():
        if line.startswith(">"):
            head, _, k = line[1:].rpartition(" found : ")
            cur = (head, int(k), [])
            groups.append(cur)
        else:
            cur[2].append(int(line))
    want = [(h, len(_hits(s, pat)), _hits(s, pat) if positions else [])
            for h, s in records if _hits(s, pat)]
    assert sorted(groups) == sorted(want)


def _compress(tmp_path, records, rate: int) -> Path:
    """Compress on the port's device tier and its host tier (`--backend
    native`, the host library's SA-IS) and on the reference's numpy tier:
    the same bytes.  (The reference's default tier runs its own SA-IS,
    which misplaces suffixes of some short blocks: ROADMAP C6.)"""
    fa = tmp_path / "in.fa"
    write_fasta(fa, records)
    sampling = ["--sampling", str(rate)]
    out = {}
    for name, main, tier in (("port", cli.main, ["--device", "cpu"]),
                             ("host", cli.main, ["--backend", "native"]),
                             ("ref", ref_cli, ["--backend", "numpy"])):
        out[name] = tmp_path / f"{name}.gcz"
        assert main(["-i", str(fa), "-o", str(out[name])] + sampling
                    + tier) == 0, name
    for name in ("host", "ref"):
        assert out[name].read_bytes() == out["port"].read_bytes(), name
        assert out[name].with_suffix(".gcx").read_bytes() == \
            out["port"].with_suffix(".gcx").read_bytes(), name
    return out["port"]


def _check_file(tmp_path, capsys, monkeypatch, records, rate: int,
                seed: int) -> None:
    rng = np.random.default_rng(seed)
    port = _compress(tmp_path, records, rate)
    queries = _queries(records, rng)
    qf, qhost = tmp_path / "q.fa", tmp_path / "qhost.fa"
    write_fasta(qf, queries)
    write_fasta(qhost, queries[:4])
    # the factor written, or, where every block holds one sample (and
    # any such factor gives the same arrays), the first that fits
    reader = GecozReader(port)
    longest = max(h.len for h in reader.headers)
    if longest > rate:
        assert reader.sampling_factor == rate.bit_length() - 1
    else:
        assert longest <= 1 << reader.sampling_factor <= rate

    want = sorted((h, s) for h, s in records)
    for tier in (["--device", "cpu"], ["--backend", "numpy"]):
        back = tmp_path / "back.fa"
        assert cli.main(["-i", str(port), "-o", str(back)] + tier) == 0
        assert sorted(_parse_fasta(back)) == want, tier

    truth = _gff_truth(records, queries)
    gff = ["-i", str(port), "-s", str(qf), "--device", "cpu"]
    _assert_gff(_out(capsys, gff), truth)
    with monkeypatch.context() as m:       # the fused-LF locate walk
        m.setenv("GECOZ_HBM_BYTES", "1")
        _assert_gff(_out(capsys, gff), truth)
    _assert_gff(_out(capsys, ["-i", str(port), "-s", str(qhost), "--backend",
                              "numpy"]), _gff_truth(records, queries[:4]))

    for _, pat in (queries[0], queries[-1]):
        p = pat.decode()
        _assert_match(_out(capsys, ["-i", str(port), "-c", p]), records,
                      pat, False)
        _assert_match(_out(capsys, ["-i", str(port), "-s", p]), records,
                      pat, True)
    head, seq = records[int(rng.integers(0, len(records)))]
    _assert_match(_out(capsys, ["-i", str(port), "-s", head, "AC"]),
                  [(head, seq)], b"AC", True)

    n = len(seq)
    for a, b in {(0, n), (n // 3, n - n // 3), (n // 2, n // 2 + 1)}:
        seg = tmp_path / "seg.seq"
        assert cli.main(["-i", str(port), "-o", str(seg), head, str(a),
                         str(b)]) == 0
        assert seg.read_bytes() == seq[a:b], (a, b)

    lines = _out(capsys, ["-i", str(port), "--check", "--deep"]).splitlines()
    assert len(lines) == len(reader.headers)
    assert all(line.endswith(": ok") for line in lines), lines


@pytest.mark.parametrize("rate,n", ONE_RECORD + EDGES)
def test_one_record(tmp_path, capsys, monkeypatch, rate, n):
    """One record of n - 1 random bases (n counts the terminator): every
    length to 4 x rate + 8, and the misread bands' edges past rate 32."""
    rng = np.random.default_rng(1000 * rate + n)
    _check_file(tmp_path, capsys, monkeypatch, [("r1", _dna(rng, n - 1))],
                rate, n)


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 40, 47, 48, 64, 100])
def test_homopolymer(tmp_path, capsys, monkeypatch, n):
    """One symbol repeated, at the default rate (A^33 holds 26 forward
    hits of A^8)."""
    _check_file(tmp_path, capsys, monkeypatch, [("r1", b"A" * n)], 32, n)


@pytest.mark.parametrize("name", list(MULTI))
def test_multi_record(tmp_path, capsys, monkeypatch, name):
    """Files of short reads and probes, each record a block of its own."""
    records = MULTI[name]()
    _check_file(tmp_path, capsys, monkeypatch, records, 32, len(records))


def test_bands_at_rate_32():
    """The one-block lengths the reference misreads at the default rate:
    records of 32-47 and 96-111 bases."""
    bad = [n for n in range(1, 4 * 32 + 9) if _misread(n, 32)]
    assert bad == list(range(33, 49)) + list(range(97, 113))


def test_divergence_from_reference(tmp_path):
    """The 40-base file: gecoz_tpu's reader derives factor 4, the port's
    5, the factor it was written at (its IWT of 2 samples is as long as
    one of 3)."""
    rng = np.random.default_rng(40)
    fa, gcz = tmp_path / "in.fa", tmp_path / "x.gcz"
    write_fasta(fa, [("r1", _dna(rng, 40))])
    assert cli.main(["-i", str(fa), "-o", str(gcz), "--device", "cpu"]) == 0
    assert iwt_size(2) == iwt_size(3)
    assert RefReader(gcz).sampling_factor == 4
    port = GecozReader(gcz)
    assert port.sampling_factor == 5
    rows, values = port.read(port.headers[0]).index.sampled_rows()
    assert len(rows) == len(values) == 2


def _cut_values(tmp_path) -> Path:
    """A 100 x 100 bp file whose .gcx lost its last block's values."""
    fa, gcz = tmp_path / "in.fa", tmp_path / "x.gcz"
    write_fasta(fa, MULTI["reads_100x100"]())
    assert cli.main(["-i", str(fa), "-o", str(gcz), "--device", "cpu"]) == 0
    gcx = gcz.with_suffix(".gcx")
    last = GecozReader(gcz).headers[-1].len
    cut = index_size(last, 5) - rbv_bytes(last)
    assert cut == iwt_size(4)
    gcx.write_bytes(gcx.read_bytes()[:-cut])
    return gcz


def test_cut_values_are_refused(tmp_path, capsys):
    """A .gcx with its last block's values cut is refused: the reader
    raises, `--check` reports it, and decompress exits 1 writing
    nothing (under the size rule alone it would read factor 6)."""
    gcz = _cut_values(tmp_path)
    with pytest.raises(ValueError, match="cannot derive sampling factor"):
        GecozReader(gcz)
    out = _out(capsys, ["-i", str(gcz), "--check", "--deep"], rc=1)
    assert out == "CORRUPT: cannot derive sampling factor\n"
    back = tmp_path / "back.fa"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "gecoz_tpu_torch.cli", "-i", str(gcz), "-o",
         str(back), "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "ValueError: cannot derive sampling factor" in proc.stderr
    assert not back.exists()


def test_lift_refuses_mismatched_counts(tmp_path):
    """An index read at the wrong factor (as the reference's reader reads
    the 40-base file) never reaches a kernel: the lift raises naming
    the block."""
    rng = np.random.default_rng(40)
    fa, gcz = tmp_path / "in.fa", tmp_path / "x.gcz"
    write_fasta(fa, [("r1 probe", _dna(rng, 40))])
    assert cli.main(["-i", str(fa), "-o", str(gcz), "--device", "cpu"]) == 0
    reader = GecozReader(gcz)
    h = reader.headers[0]
    off = reader.offsets[0] + h.header_length
    hswt = HSWT.read(reader.ref_data[off:reader.offsets[0] + h.size], h.len)
    ssa = SampledSAIndex.deserialize(reader.ssa_data[SSA_HEADER_LEN:], h.len,
                                     4, name="r1 probe")
    fm = FMIndex(hswt, ssa)
    msg = r"block \[r1 probe\] of 41 rows at sampling factor 4: 2 marked " \
          r"rows against 3 sampled values"
    with pytest.raises(ValueError, match=msg):
        fmq.device_block_from_fm(fm, "cpu", planes=False)
    with pytest.raises(ValueError, match=msg):
        fm.decode_text()


# -- C6: the host library's SA-IS on short blocks ----------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_host_sais_every_short_block(n):
    """The host library's SA-IS equals the sorted suffixes of every block
    of n - 1 bases and a terminator (4^7 blocks at n = 8)."""
    for bases in itertools.product(b"ACGT", repeat=n - 1):
        block = np.frombuffer(bytes(bases) + b"\0", np.uint8)
        assert np.array_equal(native.sais(block),
                              suffix_array_naive(block)), bytes(bases)


def test_host_sais_reduced_strings():
    """Blocks whose reduced string, a level down, has no LMS suffix (the
    two found among random reads), and random blocks of 9-400 characters
    over two, four and five letters, against prefix doubling."""
    for seq in (b"TGCAGAGAT", b"GGCAATAATAGCCTTAGAACCC"):
        block = np.frombuffer(seq + b"\0", np.uint8)
        assert np.array_equal(native.sais(block), suffix_array_naive(block))
    rng = np.random.default_rng(6)
    for n in range(9, 401):
        for letters in (b"AC", b"ACGT", b"ACGTN"):
            block = np.append(rng.choice(np.frombuffer(letters, np.uint8),
                                         n - 1), 0).astype(np.uint8)
            assert np.array_equal(native.sais(block),
                                  suffix_array_numpy(block)), bytes(block)


def test_reference_sais_divergence(tmp_path):
    """ROADMAP C6: gecoz_tpu's SA-IS leaves slots at -1 when a block (or
    its reduced string) has no LMS suffix, so its default compress of
    the 9-base read TGCAGAGAT writes, with exit 0, a file that decodes
    to TGAGAC and passes --check --deep.  The port's host tier writes
    the device tier's bytes."""
    block = np.frombuffer(b"AAC\0", np.uint8)
    assert ref_native.sais(block).tolist() == [3, 1, -1, 2]
    assert native.sais(block).tolist() == [3, 0, 1, 2]
    records = [("r1", b"TGCAGAGAT")]
    port = _compress(tmp_path, records, 32)
    ref = tmp_path / "refauto.gcz"
    assert ref_cli(["-i", str(tmp_path / "in.fa"), "-o", str(ref)]) == 0
    assert ref.read_bytes() != port.read_bytes()
    for gcz, want in ((ref, b"TGAGAC"), (port, b"TGCAGAGAT")):
        back = tmp_path / "back.fa"
        assert cli.main(["-i", str(gcz), "-o", str(back),
                         "--device", "cpu"]) == 0
        assert _parse_fasta(back) == [("r1", want)]
