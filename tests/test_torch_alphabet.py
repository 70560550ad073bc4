"""Blocks of more than 16 symbols (protein, IUPAC codes in both cases, all
256 byte values) through the port's device tier against gecoz_tpu.

The reference's plane engine refuses such blocks, so its CLI decompresses
and searches them on its host tier; the port serves them on the device
tier, its decode rows holding bytes (k = 4) past 16 planes.  With
`--device cpu` (the port's plain versions, on the route the card takes)
the port's CLI writes the reference CLI's `.gcz`/`.gcx`, FASTA and GFF3
bytes, at sampling rates 32, 16, 8 and 4 (every decode row mode).  At
block level, a 256-symbol block's decode, search and locate equal the
reference FMIndex's.  Everything compared is a byte or an integer:
tolerance 0.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from gecoz_tpu.cli import main as ref_cli
from gecoz_tpu.ops import fmq as ref_fmq
from gecoz_tpu_torch import cli
from gecoz_tpu_torch.ops import fmq
from gecoz_tpu_torch.tools import batch_search

from test_fm import build_fm
from test_gcz_files import write_fasta
from test_torch_host_copies import build_port_fm

torch.set_num_threads(1)

IUPAC = b"ACGTRYKMSWBDHVN"
PROTEIN = b"ACDEFGHIKLMNPQRSTVWY"


def _uniform(letters: bytes, n: int):
    def make(rng):
        return rng.choice(np.frombuffer(letters, np.uint8), size=n)
    return make


def _skewed(rng):
    """tests/test_edge_cases.py::test_skewed_counts_deep_codes's 18
    symbols with Fibonacci counts (max-depth Huffman codes), moved from
    bytes 32.. to 'A'.. so that FASTA lines carry them (a line starting
    with '+', byte 43, is a FASTQ quality line)."""
    fib = [1, 1]
    for _ in range(20):
        fib.append(fib[-1] + fib[-2])
    data = np.concatenate([np.full(min(f, 3000), 65 + i, np.uint8)
                           for i, f in enumerate(fib[:18])])
    rng.shuffle(data)
    return data


# name -> (symbols counting the terminator, residue maker)
ALPHABETS = {
    "iupac16": (16, _uniform(IUPAC, 3000)),          # the 4-bit rows' bound
    "iupac17": (17, _uniform(IUPAC + b"a", 3000)),   # the first past it
    "protein21": (21, _uniform(PROTEIN, 4000)),
    "skewed19": (19, _skewed),
    "iupac31": (31, _uniform(IUPAC + IUPAC.lower(), 3000)),
}
RATES = (32, 16, 8, 4)


def _records(name: str):
    """Three records of the alphabet's residues, seeded by the name."""
    want, make = ALPHABETS[name]
    rng = np.random.default_rng(sum(name.encode()))
    res = make(rng)
    cut = sorted(rng.choice(np.arange(1, len(res)), 2, replace=False))
    parts = np.split(res, cut)
    assert len(np.unique(res)) + 1 == want
    return [(f"seq{i} {name}", p) for i, p in enumerate(parts)], rng


def _queries(records, rng):
    """Residue strings of 4-50 drawn from the records, one of every three
    with a residue changed, and one absent string."""
    out = []
    for i in range(30):
        _, seq = records[int(rng.integers(0, len(records)))]
        ln = int(rng.integers(4, min(51, len(seq))))
        a = int(rng.integers(0, len(seq) - ln))
        q = seq[a:a + ln].copy()
        if i % 3 == 1:
            q[int(rng.integers(0, ln))] = seq[int(rng.integers(0, len(seq)))]
        out.append((f"q{i}|{ln}", q))
    out.append(("absent", np.frombuffer(b"WWWWWWWWWWWWWWWWWWWW", np.uint8)))
    return out


def _out(capsys, fn, argv) -> str:
    capsys.readouterr()
    assert fn(argv) == 0, argv
    return capsys.readouterr().out


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("name", list(ALPHABETS))
def test_cli_equals_reference_cli(tmp_path, capsys, name, rate):
    """Compress, decompress and GFF3 search through the port's CLI on its
    device tier equal the reference CLI on its default backend."""
    records, rng = _records(name)
    fa, qf = tmp_path / "in.fa", tmp_path / "q.fa"
    write_fasta(fa, records)
    write_fasta(qf, _queries(records, rng))
    port, ref = tmp_path / "port.gcz", tmp_path / "ref.gcz"
    sampling = ["--sampling", str(rate)]
    assert cli.main(["-i", str(fa), "-o", str(port), "--device", "cpu"]
                    + sampling) == 0
    assert ref_cli(["-i", str(fa), "-o", str(ref)] + sampling) == 0
    assert port.read_bytes() == ref.read_bytes()
    assert port.with_suffix(".gcx").read_bytes() == \
        ref.with_suffix(".gcx").read_bytes()

    a, b = tmp_path / "a.fa", tmp_path / "b.fa"
    assert cli.main(["-i", str(port), "-o", str(a), "--device", "cpu"]) == 0
    assert ref_cli(["-i", str(ref), "-o", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    back = {h.split()[0]: s for h, s in records}
    assert len(a.read_bytes()) > sum(len(s) for s in back.values())

    rows = _out(capsys, cli.main, ["-i", str(port), "-s", str(qf),
                                   "--device", "cpu"])
    assert rows == _out(capsys, ref_cli, ["-i", str(ref), "-s", str(qf)])
    assert rows.count("\n") >= 20


@pytest.mark.parametrize("name", list(ALPHABETS))
def test_decode_rows_by_alphabet(name):
    """Up to 16 planes the decode rows keep their 4-bit plane codes (k =
    16 at rate 32, 8 at rate 8); past 16 they hold bytes (k = 4), and the
    16-entry code map refuses the block."""
    records, _ = _records(name)
    sigma = ALPHABETS[name][0]
    data = np.concatenate([np.append(s, 0).astype(np.uint8)
                           for _, s in records])
    for rate, k in ((32, 16), (8, 8), (4, 4)):
        pfm = build_port_fm(data, rate)
        blk = fmq.device_block_from_fm(pfm, "cpu", planes=False)
        assert fmq.n_planes(blk) == sigma
        blk = fmq.with_lf_table(blk)
        assert blk.lfk_k == (k if sigma <= fmq.CODE_PLANES else 4)
        assert np.array_equal(fmq.decode_text(blk).numpy(),
                              build_fm(data, rate).decode_text())
    if sigma > fmq.CODE_PLANES:
        with pytest.raises(ValueError, match="do not fit"):
            fmq.code_map(blk)
        assert fmq.code_map(blk, 32).shape == (32,)
    else:
        assert fmq.code_map(blk).shape == (16,)


def _full_byte_block(rate: int):
    """tests/test_edge_cases.py::test_full_byte_alphabet_block's recipe:
    4,000 random bytes of 1-255 and the terminator (256 symbols)."""
    rng = np.random.default_rng(rate)
    data = rng.integers(1, 256, size=4000).astype(np.uint8)
    data = np.concatenate([data, np.zeros(1, np.uint8)])
    assert len(np.unique(data)) == 256
    return data, rng, build_fm(data, rate), build_port_fm(data, rate)


@pytest.mark.parametrize("rate", [32, 8, 4])
def test_full_byte_block_decode(rate):
    data, _, fm, pfm = _full_byte_block(rate)
    want = fm.decode_text()
    assert bytes(want) == bytes(data)
    for planes in (False, True):
        blk = fmq.with_lf_table(fmq.device_block_from_fm(pfm, "cpu",
                                                         planes=planes))
        assert blk.lfk_k == 4
        assert np.array_equal(fmq.decode_text(blk).numpy(), want)


@pytest.mark.parametrize("rate", [32, 8, 4])
@pytest.mark.parametrize("budget", [None, "1"])
def test_full_byte_block_search_and_locate(monkeypatch, rate, budget):
    """search_batch (with and without the k-mer table, 8 bits a code) and
    locate_batch (the locate table, or past a forced-low budget the fused
    LF walks) against FMIndex.search_range and locate."""
    if budget:
        monkeypatch.setenv("GECOZ_HBM_BYTES", budget)
    data, rng, fm, pfm = _full_byte_block(rate)
    blk = batch_search.search_tables(pfm, torch.device("cpu"))
    assert blk.has_loc != bool(budget) and blk.has_lf == bool(budget)
    assert blk.kmer_bits == 8 and blk.kmer_k >= 1
    assert fmq.n_planes(blk) == 256
    pats = []
    for a, ln in zip(rng.integers(0, 3990, 120), rng.integers(1, 9, 120)):
        p = bytes(data[a:a + ln])
        if 0 not in p:
            pats.append(p)
    pats += [bytes(rng.integers(1, 256, 6).astype(np.uint8))
             for _ in range(20)]
    arr, lens = batch_search.pack_patterns(pats)
    a, n = torch.from_numpy(arr), torch.from_numpy(lens)
    no_kmer = fmq.with_rank_blocks(fmq.device_block_from_fm(pfm, "cpu"))
    for b in (blk, no_kmer):
        sp, ep = fmq.search_batch(b, a, n)
        want = np.array([fm.search_range(p) for p in pats])
        assert np.array_equal(sp.numpy(), want[:, 0])
        assert np.array_equal(ep.numpy(), want[:, 1])
    rows = np.arange(fm.length, dtype=np.int32)
    got = fmq.locate_batch(blk, torch.from_numpy(rows)).numpy()
    assert np.array_equal(got, fm.locate(rows.astype(np.int64)))
    # the per-sequence split of the search path (the reference's find is
    # slow on the host: a sample of the patterns)
    sample = pats[::4]
    per = batch_search.find_batched(pfm, sample, "cpu")
    for p, hits in zip(sample, per):
        want = fm.find(p)
        assert hits.keys() == want.keys()
        for k in hits:
            assert np.array_equal(hits[k], want[k])


def test_reference_plane_engine_refuses_past_16():
    """The divergence the port documents: the reference's lift raises on
    a 17-symbol block that the port lifts."""
    records, _ = _records("iupac17")
    data = np.concatenate([np.append(s, 0).astype(np.uint8)
                           for _, s in records])
    with pytest.raises(ValueError, match="plane engine"):
        ref_fmq.device_block_from_fm(build_fm(data, 8))
    blk = fmq.device_block_from_fm(build_port_fm(data, 8), "cpu")
    assert fmq.n_planes(blk) == 17


def test_decode_lift_without_planes_equals_reference(rng):
    """The decode lift (no planes, c from a histogram) gives the
    reference's c, marks and sampled values on a DNA block."""
    data = np.concatenate([rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                                      2000), np.zeros(1, np.uint8)])
    ref = ref_fmq.device_block_from_fm(build_fm(data, 8))
    port = fmq.device_block_from_fm(build_port_fm(data, 8), "cpu",
                                    planes=False)
    assert port.plane_words.shape == (0,) == port.plane_pres.shape
    for f in ("bwt", "c", "sym_plane", "wrap_row", "mark_words", "mark_pre",
              "mark_rows", "ssa_perm", "ssa_inv"):
        got = fmq.block_to_numpy(port)[f]
        assert np.array_equal(got, np.asarray(getattr(ref, f))), f
    with pytest.raises(ValueError, match="bit planes"):
        fmq.with_kmer_table(port)


@pytest.mark.parametrize("sigma,bits", [(17, 5), (33, 6), (65, 7), (129, 8),
                                        (256, 8)])
def test_kmer_table_bits_past_16_planes(sigma, bits):
    """The k-mer seed table codes ceil(log2(sigma)) bits a plane: k keeps
    bits * k within 24 (K1's 32-bit code), the table holds every level,
    and seeded searches equal unseeded ones and the reference FMIndex."""
    rng = np.random.default_rng(sigma)
    data = rng.integers(1, sigma, size=6000).astype(np.uint8)
    data[::500] = 0
    data[-1] = 0
    assert len(np.unique(data)) == sigma
    pfm, fm = build_port_fm(data, 8), build_fm(data, 8)
    plain = fmq.with_rank_blocks(fmq.device_block_from_fm(pfm, "cpu"))
    blk = fmq.with_kmer_table(plain)
    assert blk.kmer_bits == bits and 1 <= blk.kmer_k and bits * blk.kmer_k <= 24
    assert blk.kmer_tab.shape[0] == sum(1 << (bits * j)
                                        for j in range(1, blk.kmer_k + 1))
    pats = [bytes(data[a:a + ln]) for a, ln in
            zip(rng.integers(0, 5980, 200), rng.integers(1, 12, 200))]
    pats = [p for p in pats if 0 not in p]
    arr, lens = batch_search.pack_patterns(pats)
    a, n = torch.from_numpy(arr), torch.from_numpy(lens)
    got, base = fmq.search_batch(blk, a, n), fmq.search_batch(plain, a, n)
    want = np.array([fm.search_range(p) for p in pats])
    for sp_ep in (got, base):
        assert np.array_equal(sp_ep[0].numpy(), want[:, 0])
        assert np.array_equal(sp_ep[1].numpy(), want[:, 1])
