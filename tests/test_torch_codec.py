"""The port's deflate/gzip/BGZF codec and its host C++ vs gecoz_tpu's.

`gecoz_tpu_torch/codec/` is a copy of `gecoz_tpu/codec/` and the codec's
entries of `gecoz_tpu_torch/native.py` (`inflate`, `inflate_to_fd`,
`deflate`, `lpf`) bind copies of `gecoz_tpu/native/*.cpp`, built without
`-march=native`.  Each is held equal to its original on the same seeded
inputs: the bytes written, the bytes read back, the errors raised.  The
cases are those of tests/test_codec.py and tests/test_streaming_io.py, and
the gzip input with trailing zero bytes that the port once read where the
reference refuses it.
"""

import gzip as stdgzip
import io
import os
import subprocess
import sys
import unittest.mock as um
import zlib
from pathlib import Path

import numpy as np
import pytest

from gecoz_tpu import native as ref_native
from gecoz_tpu.codec import deflate as ref_deflate
from gecoz_tpu.codec import gzip_file as ref_gz
from gecoz_tpu.formats import fasta as ref_fasta
from gecoz_tpu.ops.sa import suffix_array as ref_suffix_array
from gecoz_tpu_torch import native
from gecoz_tpu_torch.codec import deflate, gzip_file
from gecoz_tpu_torch.formats import fasta
from gecoz_tpu_torch.kernels import _build
from gecoz_tpu_torch.ops.sa import suffix_array

from conftest import random_dna
from test_torch_host_copies import _fasta_bytes

REPO = Path(__file__).resolve().parent.parent

CORPORA = {
    "empty": b"",
    "one": b"a",
    "period3": b"abcabcabcabcabc",
    "text": b"the quick brown fox jumps over the lazy dog " * 300,
}


def _corpora():
    rng = np.random.default_rng(0)
    return dict(CORPORA,
                random=bytes(rng.integers(0, 256, size=40000,
                                          dtype=np.uint8)),
                dna=bytes(random_dna(rng, 120000)),
                zeros=b"\x00" * 50000)


def _two_records(rng):
    return _fasta_bytes([("chrA one", random_dna(rng, 700)),
                         ("chrB", random_dna(rng, 333, b"ACGTN"))])


# -- C1: a gzip member followed by zero bytes ------------------------------

def _c1_input(tmp_path, rng) -> Path:
    """Two records, gzipped, then 16 zero bytes."""
    p = tmp_path / "c1.fa.gz"
    p.write_bytes(stdgzip.compress(_two_records(rng)) + b"\0" * 16)
    return p


def test_trailing_zero_gzip_is_refused(tmp_path, rng):
    path = _c1_input(tmp_path, rng)
    with pytest.raises(ValueError) as ref_err:
        list(ref_fasta.iter_fasta(path))
    fasta._INFLATED_CACHE.clear()
    with pytest.raises(ValueError) as port_err:
        list(fasta.iter_fasta(path))
    assert str(port_err.value) == str(ref_err.value) == "invalid gzip header"
    out = tmp_path / "c1.gcz"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "gecoz_tpu_torch.cli", "-i", str(path), "-o",
         str(out), "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "invalid gzip header" in proc.stderr
    assert not out.exists() and not out.with_suffix(".gcx").exists()


# -- C2: a gzip member cut inside its deflate data --------------------------

_READ_CUT = r"""
import sys, unittest.mock as um
from gecoz_tpu_torch import native
from gecoz_tpu_torch.formats import fasta
assert native.available(), native.error()
for host_lib in (True, False):          # the C++ decoder, then the Python one
    fasta._INFLATED_CACHE.clear()
    with um.patch.object(native, "available", lambda: host_lib):
        try:
            list(fasta.iter_fasta(sys.argv[1]))
            print("read")
        except ValueError as ex:
            print(ex)
"""


@pytest.mark.parametrize("where", [0.25, 0.75])
def test_truncated_gzip_is_refused(tmp_path, rng, where):
    """A gzipped FASTA cut inside its deflate data (a download stopped
    early) is refused by `iter_fasta`, through the host library and
    through the Python decoder, and by the CLI, which writes no .gcz.  The
    reference reads zero bits past the end without end (ROADMAP C2), so
    each run is a process of its own with a time limit."""
    body = _fasta_bytes([("chrA", random_dna(rng, 60_000)),
                         ("chrB", random_dna(rng, 20_000, b"ACGTN"))])
    g = stdgzip.compress(body)
    path = tmp_path / "cut.fa.gz"
    path.write_bytes(g[:10 + int((len(g) - 18) * where)])
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               TMPDIR=str(tmp))
    proc = subprocess.run([sys.executable, "-c", _READ_CUT, str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n") == [deflate.TRUNCATED] * 2 + [""]
    out = tmp_path / "cut.gcz"
    proc = subprocess.run(
        [sys.executable, "-m", "gecoz_tpu_torch.cli", "-i", str(path), "-o",
         str(out), "--device", "cpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert f"ValueError: {deflate.TRUNCATED}" in proc.stderr
    assert not out.exists() and not out.with_suffix(".gcx").exists()
    assert list(tmp.iterdir()) == []          # the partial inflate is gone


# -- deflate ----------------------------------------------------------------

@pytest.mark.parametrize("matcher", ["hash", "sa"])
def test_deflate_bytes_equal_reference(matcher):
    """The Python encoder's bytes equal the reference's, inflate back
    through both inflaters and through zlib."""
    for name, data in _corpora().items():
        comp = deflate.deflate_bytes(data, matcher)
        assert comp == ref_deflate.deflate_bytes(data, matcher), name
        assert deflate.inflate_bytes(comp) == data
        assert ref_deflate.inflate_bytes(comp) == data
        assert zlib.decompress(comp, wbits=-15) == data


@pytest.mark.parametrize("corpus", ["dna", "text", "binary"])
def test_deflate_ratio_near_zlib9(corpus):
    """The SA matcher's bytes equal the reference's and stay within 10% of
    zlib level 9 (tests/test_codec.py::test_deflate_ratio_near_zlib9)."""
    rng = np.random.default_rng(0)
    if corpus == "dna":
        data = bytes(random_dna(rng, 96 * 1024))
    elif corpus == "text":
        words = (b"the quick brown fox jumps over the lazy dog and then some "
                 b"more lorem ipsum dolor sit amet consectetur adipiscing "
                 b"elit ")
        data = bytes((words * 900)[:96 * 1024])
    else:
        binry = bytearray()
        while len(binry) < 96 * 1024:
            binry += bytes(rng.integers(0, 256, size=64,
                                        dtype=np.uint8)) * 3 + b"\x00" * 32
        data = bytes(binry[:96 * 1024])
    ours = deflate.deflate_bytes(data, "sa")
    assert ours == ref_deflate.deflate_bytes(data, "sa")
    assert deflate.inflate_bytes(ours) == data
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    assert len(ours) <= len(c.compress(data) + c.flush()) * 1.10


def test_inflate_zlib_streams():
    for level in (1, 9):
        for name, data in _corpora().items():
            raw = zlib.compress(data, level)[2:-4]
            assert deflate.inflate_bytes(raw) == data, (level, name)


def test_sa_matcher_roundtrip(rng):
    data = bytes(rng.integers(60, 80, size=200_000).astype(np.uint8))
    out = deflate.Deflater("sa").deflate(data).getvalue()
    assert out == ref_deflate.Deflater("sa").deflate(data).getvalue()
    assert deflate.inflate_bytes(out) == data


def test_find_matches_sa_takes_the_ports_suffix_array(rng):
    """`_find_matches_sa` sorts with the port's ops/sa.py and matches with
    the port's native.lpf; without the library, the Python oracle gives
    the same (match_len, match_dist)."""
    win = rng.integers(65, 69, size=8192).astype(np.uint8)
    sa = suffix_array(win)
    assert np.array_equal(sa, ref_suffix_array(win))
    with um.patch.object(native, "lpf", wraps=native.lpf) as spy:
        got = deflate._find_matches_sa(win)
    assert spy.call_count == 1
    with um.patch.object(native, "available", lambda: False):
        oracle = deflate._find_matches_sa(win)
    want = ref_deflate._find_matches_sa(win)
    for g, o, w in zip(got, oracle, want):
        assert np.array_equal(g, w) and np.array_equal(o, w)


# -- the host library's codec entries ---------------------------------------

def _native_inputs():
    rng = np.random.default_rng(4)
    syms = np.frombuffer(b"ACGTN", np.uint8)
    return {
        "dna": rng.choice(syms, size=1 << 18, p=[.29, .2, .2, .29, .02]
                          ).astype(np.uint8).tobytes(),
        "empty": b"",
        "one": b"A",
        "run": b"AAAAAAAAAAAAAAAA" * 100,
        "random": bytes(rng.integers(0, 256, size=70000, dtype=np.uint8)),
    }


@pytest.mark.parametrize("case", list(_native_inputs()))
def test_native_codec_equals_reference(tmp_path, case):
    """native.deflate (both matchers), inflate and inflate_to_fd of the
    port's library against gecoz_tpu.native's, byte for byte."""
    data = _native_inputs()[case]
    for matcher in ("hash", "sa"):
        comp = native.deflate(data, matcher=matcher)
        assert comp == ref_native.deflate(data, matcher=matcher), matcher
        assert zlib.decompress(comp, wbits=-15) == data
        got = native.inflate(comp, max(len(data), 1))
        assert got == ref_native.inflate(comp, max(len(data), 1))
        assert got[0] == data and got[1] <= 8 * len(comp)
        outs = []
        for lib in (native, ref_native):
            path = tmp_path / f"{lib.__name__}.bin"
            with open(path, "wb") as f:
                meta = lib.inflate_to_fd(comp + b"trailing", f.fileno())
            outs.append((meta, path.read_bytes()))
        assert outs[0] == outs[1]
        assert outs[0][1] == data
        assert outs[0][0][2] == zlib.crc32(data)
    if data:
        with pytest.raises(MemoryError):
            native.inflate(native.deflate(data), len(data) - 1)


def test_deflate_bytes_do_not_depend_on_march_native():
    """The port's library is built without -march=native, the reference's
    with it (gecoz_tpu/native/__init__.py); their deflate bytes agree on
    1 MiB of genomic text and the SA matcher beats the hash chain."""
    assert "-march=native" not in _build.HOST_FLAGS
    assert native.available() and ref_native.available()
    rng = np.random.default_rng(9)
    syms = np.frombuffer(b"ACGTN", np.uint8)
    data = rng.choice(syms, size=1 << 20, p=[.29, .2, .2, .29, .02]
                      ).astype(np.uint8).tobytes()
    sa = native.deflate(data, matcher="sa")
    assert sa == ref_native.deflate(data, matcher="sa")
    assert native.deflate(data) == ref_native.deflate(data)
    assert len(sa) < len(native.deflate(data, matcher="hash"))


@pytest.mark.parametrize("win", ["acgt", "period", "zeros"])
def test_native_lpf_equals_reference_and_oracle(win):
    rng = np.random.default_rng(2)
    s = {"acgt": rng.integers(65, 69, size=8192).astype(np.uint8),
         "period": np.tile(np.frombuffer(b"abcabcabd", np.uint8),
                           1000)[:8000],
         "zeros": np.zeros(4000, np.uint8)}[win]
    sa = np.asarray(suffix_array(s), dtype=np.int64)
    got = native.lpf(s, sa, deflate._MIN_MATCH, deflate._MAX_MATCH)
    want = ref_native.lpf(s, sa, deflate._MIN_MATCH, deflate._MAX_MATCH)
    with um.patch.object(native, "available", lambda: False):
        oracle = deflate._find_matches_sa(s)
    for g, w, o in zip(got, want, oracle):
        assert np.array_equal(g, w) and np.array_equal(g, o)


def _outcome(fn):
    """(exception type, message) of a call, or None if it returned."""
    try:
        fn()
    except Exception as ex:               # noqa: BLE001 - compared by callers
        return type(ex), str(ex)
    return None


def test_native_inflate_errors_equal_reference(tmp_path):
    """A stream with an invalid block type is refused by both libraries,
    whole and streamed.  A stream cut in two is refused by the port's,
    whole and streamed, where the reference's reads zero bits past the end
    and overruns any bounded output (ROADMAP C2)."""
    data = bytes(random_dna(np.random.default_rng(3), 50000))
    comp = native.deflate(data)
    bad = bytes([comp[0] | 0b110]) + comp[1:]     # BTYPE 3
    for lib in (native, ref_native):
        with pytest.raises(ValueError, match="corrupt deflate stream"):
            lib.inflate(bad, 1 << 20)
        with open(tmp_path / "o.bin", "wb") as f, \
                pytest.raises(ValueError, match="corrupt deflate stream"):
            lib.inflate_to_fd(bad, f.fileno())
    cut = comp[:len(comp) // 2]
    with pytest.raises(ValueError, match="^truncated deflate stream$"):
        native.inflate(cut, 1 << 20)
    with open(tmp_path / "o.bin", "wb") as f, \
            pytest.raises(ValueError, match="^truncated deflate stream$"):
        native.inflate_to_fd(cut, f.fileno())
    assert _outcome(lambda: ref_native.inflate(cut, 1 << 20)) == \
        (MemoryError, "inflate output capacity exceeded")


# -- gzip and BGZF ----------------------------------------------------------

@pytest.mark.parametrize("matcher", ["auto", "native", "hash", "sa"])
def test_gzip_compress_bytes_equal_reference(matcher):
    for name, data in _corpora().items():
        if matcher in ("hash", "sa") and len(data) > 50000:
            continue                      # the Python encoder: small inputs
        g = gzip_file.gzip_compress(data, matcher)
        assert g == ref_gz.gzip_compress(data, matcher), name
        assert gzip_file.gzip_decompress(g) == data
        assert stdgzip.decompress(g) == data
        assert gzip_file.gzip_decompress(stdgzip.compress(data)) == data


def test_gzip_file_multi_member(tmp_path, rng):
    a, b = bytes(random_dna(rng, 5000)), bytes(random_dna(rng, 3000))
    p = tmp_path / "two.gz"
    p.write_bytes(gzip_file.gzip_compress(a) + gzip_file.gzip_compress(b))
    with gzip_file.GzipFileReader(p) as r:
        assert r.read_all() == a + b
        assert [m.offset for m in r.members()] == \
            [m.offset for m in ref_gz.GzipFileReader(p).members()]


def _member_fields(reader):
    return [(m.offset, m.header_size, m.bsize, m.name, m.comment)
            for m in reader.members()]


@pytest.mark.parametrize("bgzf,name", [(True, None), (False, "orig.fa"),
                                       (False, None)])
def test_writer_bytes_and_members_equal_reference(tmp_path, rng, bgzf, name):
    """GzipFileWriter (plain streaming or BGZF, dribbled writes) writes the
    reference's bytes; members, names and BSIZEs read back the same."""
    data = bytes(random_dna(rng, 200_000))
    paths = []
    for mod in (gzip_file, ref_gz):
        p = tmp_path / f"{mod.__name__}.gz"
        with mod.GzipFileWriter(p, bgzf=bgzf, name=name) as w:
            for i in range(0, len(data), 7777):
                w.write(data[i:i + 7777])
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    r = gzip_file.GzipFileReader(paths[0])
    assert r.read_all() == data == stdgzip.decompress(paths[0].read_bytes())
    assert _member_fields(r) == _member_fields(ref_gz.GzipFileReader(paths[0]))
    if bgzf:
        assert len(r.members()) >= 5 and all(m.bsize > 0 for m in r.members())
    else:
        assert r.members()[0].name == name


def test_bgzf_virtual_offsets_equal_reference(tmp_path, rng):
    data = bytes(random_dna(rng, 200_000))
    p = tmp_path / "x.bgzf"
    with gzip_file.GzipFileWriter(p, bgzf=True) as w:
        w.write(data)
    r, ref = gzip_file.GzipFileReader(p), ref_gz.GzipFileReader(p)
    members = r.members()
    first_len = gzip_file.GzipFileWriter.MEMBER
    assert r.read_from_virtual((members[1].offset << 16) | 100, 50) == \
        data[first_len + 100:first_len + 150]
    for m in members[:-1]:
        for within, nbytes in ((0, 10), (100, 50), (first_len - 5, 40)):
            voff = (m.offset << 16) | within
            assert r.read_from_virtual(voff, nbytes) == \
                ref.read_from_virtual(voff, nbytes)


@pytest.mark.parametrize("bgzf", [False, True])
def test_inflate_to_matches_read_all(tmp_path, rng, bgzf):
    payload = bytes(random_dna(rng, 300_000)) + b"x" * 5000
    p = tmp_path / "t.gz"
    with gzip_file.GzipFileWriter(p, bgzf=bgzf) as w:
        w.write(payload)
    out = io.BytesIO()
    assert gzip_file.GzipFileReader(p).inflate_to(out) == len(payload)
    assert out.getvalue() == payload == gzip_file.GzipFileReader(p).read_all()
    ref_out = io.BytesIO()
    ref_gz.GzipFileReader(p).inflate_to(ref_out)
    assert ref_out.getvalue() == payload


def test_inflate_to_fd_streaming(tmp_path, rng):
    """A file-descriptor output takes the native bounded-window path."""
    payload = bytes(random_dna(rng, 1_000_000))
    p = tmp_path / "t.gz"
    p.write_bytes(gzip_file.gzip_compress(payload))
    with um.patch.object(native, "inflate_to_fd",
                         wraps=native.inflate_to_fd) as spy, \
            open(tmp_path / "out.bin", "wb") as f:
        n = gzip_file.GzipFileReader(p).inflate_to(f)
    assert spy.call_count == 1
    assert n == len(payload)
    assert (tmp_path / "out.bin").read_bytes() == payload


def _faulty(kind, rng) -> bytes:
    data = bytes(random_dna(rng, 50_000))
    g = bytearray(gzip_file.gzip_compress(data))
    if kind == "bad_crc":
        g[-6] ^= 0xFF
    elif kind == "bad_isize":
        g[-2] ^= 0xFF
    elif kind.startswith("truncated"):
        # cut 2 and 90 bytes into the deflate data (after the 10-byte
        # member header), or in the CRC/ISIZE footer; a cut deep in the
        # deflate data never ends in the reference (ROADMAP C2), so it is
        # held only to the port (test_truncated_gzip_is_refused)
        g = g[:{"truncated_header": 12, "truncated_data": 100,
                "truncated_footer": len(g) - 4}[kind]]
    elif kind == "trailing_zeros":
        g += b"\0" * 16
    return bytes(g)


@pytest.mark.parametrize("kind", ["bad_crc", "bad_isize", "truncated_header",
                                  "truncated_data", "truncated_footer",
                                  "trailing_zeros"])
def test_gzip_errors_equal_reference(tmp_path, rng, kind):
    """A bad CRC, a bad ISIZE, a truncated member and C1's trailing zeros:
    the port raises what the reference raises, whole or streamed to a file
    or to a buffer.  The one difference: where the deflate data is cut,
    the port says so (ROADMAP C2), and the reference fails on the zero bits
    it reads past the end."""
    blob = _faulty(kind, rng)
    p = tmp_path / "bad.gz"
    p.write_bytes(blob)
    outcome = _outcome

    def to_file(mod):
        with open(tmp_path / "o.bin", "wb") as f:
            mod.GzipFileReader(p).inflate_to(f)

    for run in (lambda m: m.gzip_decompress(blob),
                lambda m: m.GzipFileReader(p).read_all(),
                to_file,
                lambda m: m.GzipFileReader(p).inflate_to(io.BytesIO())):
        got, want = outcome(lambda: run(gzip_file)), outcome(
            lambda: run(ref_gz))
        assert want is not None, kind
        if kind in ("truncated_header", "truncated_data"):
            assert got == (ValueError, deflate.TRUNCATED), want
        else:
            assert got == want, kind


# -- gzipped FASTA input ----------------------------------------------------

def _write_gz_fasta(mod, path, records, bgzf=False):
    with mod.GzipFileWriter(path, bgzf=bgzf) as w:
        for header, seq in records:
            w.write(b">" + header.encode() + b"\n")
            s = bytes(seq)
            for i in range(0, len(s), 60):
                w.write(s[i:i + 60] + b"\n")


@pytest.mark.parametrize("kind", ["gzip", "bgzf", "multi_member"])
def test_gzipped_fasta_equals_reference(tmp_path, rng, kind):
    records = [(f"chr{i} x", random_dna(rng, int(rng.integers(50, 5000)),
                                         b"ACGTN")) for i in range(6)]
    p = tmp_path / "in.fa.gz"
    if kind == "multi_member":
        body = _fasta_bytes(records)
        p.write_bytes(gzip_file.gzip_compress(body[:777])
                      + gzip_file.gzip_compress(body[777:]))
    else:
        _write_gz_fasta(gzip_file, p, records, bgzf=kind == "bgzf")
    fasta._INFLATED_CACHE.clear()
    got = [(r.header, bytes(r.data)) for r in fasta.iter_fasta(p)]
    assert got == [(r.header, bytes(r.data)) for r in ref_fasta.iter_fasta(p)]
    assert got == [(h, bytes(s)) for h, s in records]


def test_gzipped_fasta_inflates_exactly_once(tmp_path, rng):
    records = [(f"chr{i}", random_dna(rng, 5000)) for i in range(6)]
    p = tmp_path / "in.fa.gz"
    _write_gz_fasta(gzip_file, p, records)
    fasta._INFLATED_CACHE.clear()
    before = fasta._INFLATE_COUNT
    seqs = list(fasta.iter_fasta(p, lazy=True))
    assert [s.header for s in seqs] == [h for h, _ in records]
    for s, (_, want) in zip(seqs, records):
        assert bytes(fasta.read_sequence(p, s)) == bytes(want)
    assert fasta._INFLATE_COUNT == before + 1


def test_gzipped_fasta_through_the_cli(tmp_path, rng):
    """The port's CLI compresses a gzipped FASTA to the bytes the
    reference's CLI writes from it, and decompresses it back."""
    from gecoz_tpu.cli import main as ref_cli
    from gecoz_tpu_torch import cli
    seq = random_dna(rng, 3000)
    fa = tmp_path / "in.fa.gz"
    fa.write_bytes(gzip_file.gzip_compress(_fasta_bytes([("chrG test",
                                                          seq)])))
    port, host = tmp_path / "port.gcz", tmp_path / "host.gcz"
    assert cli.main(["-i", str(fa), "-o", str(port), "--device", "cpu"]) == 0
    assert ref_cli(["-i", str(fa), "-o", str(host), "--backend",
                    "native"]) == 0
    assert port.read_bytes() == host.read_bytes()
    assert port.with_suffix(".gcx").read_bytes() == \
        host.with_suffix(".gcx").read_bytes()
    back = tmp_path / "back.fa"
    assert cli.main(["-i", str(port), "-o", str(back), "--device",
                     "cpu"]) == 0
    assert [bytes(r.data) for r in fasta.iter_fasta(back)] == [bytes(seq)]
