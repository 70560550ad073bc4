"""The BWT decoded out of the wavelet tree on the device
(`gecoz_tpu_torch/ops/hswt_device.py`) against the host's decode: the plain
unpack, a scan and the plain walk equal `HSWT.decode_bwt` byte for byte;
`HSWT.stored_streams` gives the same bytes and node table for a tree read
from its bytes (or from a .gcz) and for the same tree built in memory; the
device tier's lift of a CPU block, and its decompress, equal the host tier
with the host decode made to raise.  Integers only: tolerance 0.

No JAX: `tests/test_torch_gpu.py` takes the blocks from here.
"""

import numpy as np
import pytest
import torch

from gecoz_tpu_torch.formats.gcz import GecozReader
from gecoz_tpu_torch.index.hswt import HSWT
from gecoz_tpu_torch.index.rankbv import rbv_bytes
from gecoz_tpu_torch.index.shape import HSWTShape
from gecoz_tpu_torch.ops import fmq, hswt_device
from gecoz_tpu_torch.ops.sa import bwt_from_sa, suffix_array_numpy
from gecoz_tpu_torch.ops.scan import cumsum_i32
from gecoz_tpu_torch.tools import driver

torch.set_num_threads(1)


def _records_bwt(rng, alphabet, lengths, n_runs=0):
    """The BWT of \\0-terminated records over `alphabet`, the first with
    `n_runs` runs of N."""
    recs = [rng.choice(np.frombuffer(alphabet, np.uint8), size=n)
            for n in lengths]
    for _ in range(n_runs):
        at = int(rng.integers(0, lengths[0] - 300))
        recs[0][at:at + int(rng.integers(50, 300))] = ord("N")
    end = np.zeros(1, np.uint8)
    text = np.concatenate([x for r in recs for x in (r, end)])
    return bwt_from_sa(text, suffix_array_numpy(text))


def _deep_tree(rng):
    """24 symbols on a comb of codes, symbol k k ones then a zero (LSB
    first): its deepest codes 23 bits, past the 15 that a .gcz's lengths
    table holds, so built in memory only."""
    k = 24
    lengths = np.zeros(256, np.int32)
    codes = np.zeros(256, np.int64)
    lengths[:k] = np.minimum(np.arange(1, k + 1), k - 1)
    codes[:k] = (1 << np.minimum(np.arange(k), k - 1)) - 1
    counts = np.zeros(256, np.int64)
    counts[:k] = np.maximum(1, 40000 >> np.arange(1, k + 1))
    shape = HSWTShape(bit_lengths=lengths, codes=codes,
                      length=int(counts.sum()), counts=counts)
    shape._build_nodes(counts)
    bwt = np.repeat(np.arange(k, dtype=np.uint8), counts[:k])
    return bwt[rng.permutation(len(bwt))], shape


def block(name, seed=0):
    """(BWT, wavelet tree built in memory) of one of BLOCKS."""
    rng = np.random.default_rng(seed)
    if name == "deep_codes":
        bwt, shape = _deep_tree(rng)
        return bwt, HSWT.build(bwt, shape)
    if name == "dna_n_runs":
        bwt = _records_bwt(rng, b"ACGT", [60000, 9000, 1], n_runs=6)
    elif name == "protein22":
        bwt = _records_bwt(rng, b"ACDEFGHIKLMNPQRSTVWYX", [20000, 3000, 700])
    elif name == "all_256":
        bwt = rng.permutation(np.repeat(np.arange(256, dtype=np.uint8), 97))
    elif name == "one_symbol":
        bwt = np.full(77, ord("A"), np.uint8)
    elif name == "n_1":
        bwt = np.zeros(1, np.uint8)
    else:
        # nodes of 200,003 and ~100,000 bits: past 8,192 data bytes, not a
        # multiple of 32
        assert name == "counter_boundary"
        bwt = rng.choice(np.frombuffer(b"ACG", np.uint8), 200003,
                         p=[.5, .25, .25])
    shape = HSWTShape.from_counts(np.bincount(bwt, minlength=256))
    return bwt, HSWT.build(bwt, shape)


BLOCKS = ("dna_n_runs", "protein22", "all_256", "deep_codes", "one_symbol",
          "n_1", "counter_boundary")
STORED = tuple(b for b in BLOCKS if b != "deep_codes")


def read_back(tree):
    """The tree as a reader opens it, from its serialized bytes."""
    return HSWT.read(np.frombuffer(tree.serialize(), np.uint8),
                     tree.shape.length)


def plain_decode(tree):
    raw, nodes, total = hswt_device.upload(tree, "cpu")
    words, pc = hswt_device.unpack_ref(raw, nodes, total)
    return hswt_device.decode_ref(raw, words, cumsum_i32(pc), nodes,
                                  tree.shape.length)


@pytest.mark.parametrize("name", BLOCKS)
def test_plain_decode_equals_the_host_decode(name):
    bwt, tree = block(name)
    for t in (tree,) if name == "deep_codes" else (tree, read_back(tree)):
        got = plain_decode(t)
        assert got.dtype == torch.uint8
        assert np.array_equal(got.numpy(), t.decode_bwt())
        assert np.array_equal(got.numpy(), bwt)
    if name == "counter_boundary":
        lengths = hswt_device.upload(tree, "cpu")[0][:80].view(
            torch.int64).reshape(2, 5)[:, 1]
        assert (lengths > 65536).all() and (lengths % 32 != 0).all()
    if name == "deep_codes":
        assert int(tree.shape.bit_lengths.max()) >= 20


@pytest.mark.parametrize("name", BLOCKS)
def test_the_entry_points_run_the_plain_versions_on_the_cpu(name):
    bwt, tree = block(name, seed=1)
    raw, nodes, total = hswt_device.upload(tree, "cpu")
    words, pc = hswt_device.unpack(raw, nodes, total)
    inc = cumsum_i32(pc)
    got = hswt_device.decode(raw, words, inc, nodes, len(bwt))
    assert np.array_equal(got.numpy(), bwt)
    assert hswt_device.LAUNCHES == {"unpack": 0, "decode": 0}
    assert np.array_equal(hswt_device.lift(tree, "cpu").numpy(), bwt)


@pytest.mark.parametrize("name", STORED)
def test_stored_streams_of_a_read_tree_equal_the_built_trees(name):
    _, tree = block(name)
    buf = np.frombuffer(tree.serialize(), np.uint8)
    read = HSWT.read(buf, tree.shape.length)
    (s_built, t_built), (s_read, t_read) = (tree.stored_streams(),
                                            read.stored_streams())
    assert np.array_equal(s_built, s_read) and np.array_equal(t_built,
                                                                t_read)
    assert np.shares_memory(s_read, buf)          # a view, not a copy
    assert read.stored_streams()[0] is s_read      # once a tree
    # pre-order offsets, each node rbv_bytes(length) long; a child's row
    # past its parent's, a leaf's symbol of the code that ends there, ~0
    # on a side that no code takes
    assert t_read[0, 0] == 0 and t_read[0, 1] == tree.shape.length
    ends = t_read[:, 0] + [rbv_bytes(int(x)) for x in t_read[:, 1]]
    assert np.array_equal(ends[:-1], t_read[1:, 0])
    assert ends[-1] == len(s_read)
    kids = t_read[:, 2:]
    rows = np.arange(len(t_read))[:, None]
    assert ((kids > rows) | (kids < 0)).all()
    shape = tree.shape
    leaves = {(int(shape.bit_lengths[s]), int(shape.codes[s])): s
              for s in np.flatnonzero(shape.bit_lengths)}
    for (level, prefix), row in zip(shape.nodes, t_read):
        for side in (0, 1):
            if row[2 + side] < 0:
                code = prefix | (side << level)
                assert ~row[2 + side] == leaves.get((level + 1, code), 0)
    if name == "one_symbol":
        assert t_read.tolist() == [[0, 77, ~ord("A"), ~0]]


def _write_fasta(path, recs):
    with open(path, "wb") as f:
        for header, seq in recs:
            f.write(b">" + header.encode() + b"\n" + seq.tobytes() + b"\n")


@pytest.fixture
def gcz(tmp_path):
    """A .gcz of four records over DNA with N runs, in two blocks."""
    rng = np.random.default_rng(3)
    recs = []
    for i, n in enumerate((40000, 7000, 513, 30)):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
        seq[n // 3:n // 3 + n // 10] = ord("N")
        recs.append((f"r{i}", seq))
    fa, out = tmp_path / "in.fa", tmp_path / "in.gcz"
    _write_fasta(fa, recs)
    driver.index_fasta(fa, out, device="cpu")
    return fa, out


def _no_host_decode(monkeypatch):
    def refuse(self):
        raise AssertionError("the host decoded the BWT")
    monkeypatch.setattr(HSWT, "decode_bwt", refuse)


def test_a_gcz_trees_stored_streams_equal_the_built_trees(gcz):
    _, path = gcz
    reader = GecozReader(path)
    assert len(reader.headers) >= 2
    for header in reader.headers:
        fm = reader.read(header)
        built = HSWT.build(fm.bwt, fm.hswt.shape)
        for got, want in zip(fm.hswt.stored_streams(),
                             built.stored_streams()):
            assert np.array_equal(got, want)


def test_the_device_lift_of_a_cpu_block_equals_the_host_bwt(gcz,
                                                            monkeypatch):
    _, path = gcz
    reader = GecozReader(path)
    want = [reader.read(h).bwt for h in reader.headers]
    _no_host_decode(monkeypatch)
    for header, bwt in zip(reader.headers, want):
        fm = reader.read(header)
        got = fmq.device_block_from_fm(fm, "cpu", planes=False).bwt
        assert np.array_equal(got.numpy(), bwt)
        assert fm._bwt is None


def test_a_decompress_on_the_device_tier_never_decodes_on_the_host(
        gcz, tmp_path, monkeypatch):
    fa, path = gcz
    host = tmp_path / "host.fa"
    driver.decompress(path, host, backend="numpy")
    _no_host_decode(monkeypatch)
    port = tmp_path / "port.fa"
    driver.decompress(path, port, device="cpu")
    assert port.read_bytes() == host.read_bytes()


def test_a_damaged_stream_stays_inside_its_arrays():
    """Bits flipped in the stored streams: the walk's positions are clamped
    into their nodes; n symbols come out, no index leaves its array."""
    bwt, tree = block("dna_n_runs")
    streams, table = tree.stored_streams()
    bad = streams.copy()
    bad[np.random.default_rng(4).choice(len(bad), 300, replace=False)] ^= 0x5A
    tree._stored = (bad, table)
    got = plain_decode(tree)
    assert got.shape == (len(bwt),) and not np.array_equal(got.numpy(), bwt)
    assert set(np.unique(got.numpy())) <= set(np.unique(bwt))


def test_the_entry_points_refuse_what_the_kernels_do_not_take():
    bwt, tree = block("protein22")
    raw, nodes, total = hswt_device.upload(tree, "cpu")
    words, pc = hswt_device.unpack(raw, nodes, total)
    with pytest.raises(TypeError, match="uint8"):
        hswt_device.unpack(raw.to(torch.int32), nodes, total)
    with pytest.raises(ValueError, match="nodes"):
        hswt_device.unpack(raw, 0, total)
    with pytest.raises(ValueError, match="nodes"):
        hswt_device.unpack(raw, 256, total)
    with pytest.raises(ValueError, match="fewer than"):
        hswt_device.unpack(raw[:hswt_device.streams_at(nodes)], nodes, total)
    with pytest.raises(TypeError, match="int32"):
        hswt_device.decode(raw, words.long(), pc, nodes, len(bwt))
    with pytest.raises(TypeError, match="strided"):
        hswt_device.decode(raw, torch.stack([words, words], 1)[:, 0], pc,
                           nodes, len(bwt))
    with pytest.raises(ValueError, match="n = 0"):
        hswt_device.decode(raw, words, pc, nodes, 0)


def test_the_upload_refuses_a_root_that_does_not_hold_the_block():
    _, tree = block("one_symbol")
    tree.shape.length += 1
    with pytest.raises(ValueError, match="root"):
        hswt_device.upload(tree, "cpu")
