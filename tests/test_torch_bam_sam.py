"""The port's SAM/BAM/BAI layer vs gecoz_tpu's.

`gecoz_tpu_torch/formats/{sam,bam}.py` are copies of gecoz_tpu's on the
port's codec.  Each case of tests/test_bam_sam.py and
tests/test_bam_golden.py runs through both: the BAM, BAI and SAM bytes
written and the records, tags and query hits read back are equal.
"""

import numpy as np
import pytest

from gecoz_tpu.formats import bam as ref_bam
from gecoz_tpu.formats import sam as ref_sam
from gecoz_tpu_torch.formats import bam, sam

from conftest import random_dna
from test_bam_golden import build_fixture

SAM_LINE = ("r001\t99\tchr1\t7\t30\t8M2I4M1D3M\t=\t37\t39\t"
            "TTAGATAAAGGATACTG\t*\tNM:i:1\tXX:Z:hello\tXB:B:c,1,-2,3")
SAM_HEADER = ("@HD\tVN:1.6\tSO:coordinate\n"
              "@SQ\tSN:chr1\tLN:1000\n@SQ\tSN:chr2\tLN:500\n"
              "@RG\tID:rg1\tPL:ILLUMINA\n@PG\tID:p1\tPN:gecoz\n@CO\thello\n")


def _fields(rec):
    """Everything a record carries, as plain values."""
    return (rec.qname, rec.flag, rec.rname, rec.pos, rec.mapq, rec.cigar,
            rec.rnext, rec.pnext, rec.tlen, rec.seq, rec.qual,
            [(t.tag, t.type, t.value) for t in rec.tags], rec.format())


@pytest.mark.parametrize("cigar", ["10M2I5D3S", "*", "3S6M1P1I4M", "9M",
                                   "10Q"])
def test_cigar_equals_reference(cigar):
    def run(mod):
        try:
            ops = mod.decode_cigar(cigar)
        except ValueError as ex:
            return "ValueError", str(ex)
        return ops, mod.encode_cigar(ops), mod.reference_span(ops)
    assert run(sam) == run(ref_sam)


def test_sam_record_and_header_equal_reference():
    rec, want = sam.SAMRecord.parse(SAM_LINE), ref_sam.SAMRecord.parse(
        SAM_LINE)
    assert _fields(rec) == _fields(want)
    assert rec.format() == SAM_LINE
    assert rec.position_end() == want.position_end() == 22
    assert rec.get_tag("XB").value == ("c", [1, -2, 3])
    h, hw = sam.SAMHeader.parse(SAM_HEADER), ref_sam.SAMHeader.parse(
        SAM_HEADER)
    assert h.format() == hw.format() == SAM_HEADER
    assert (h.version, h.sort_order, h.references) == \
        (hw.version, hw.sort_order, hw.references)


def test_sam_tag_registry_equals_reference():
    assert sam.SAM_TAG_TYPES == ref_sam.SAM_TAG_TYPES
    for tag, typ in (("NM", "i"), ("NM", "c"), ("XX", "f"), ("za", "Z"),
                     ("GC", "Z"), ("NM", "Z"), ("MD", "i"), ("QQ", "i")):
        assert sam.validate_tag(tag, typ) == ref_sam.validate_tag(tag, typ)
    line = "r1\t0\tchr1\t100\t60\t4M\t*\t0\t0\tACGT\tFFFF\tNM:i:1\tMD:Z:4"
    rec = sam.SAMRecord.parse(line)
    rec.tags.append(sam.SAMTag("NM", "Z", "oops"))
    want = ref_sam.SAMRecord.parse(line)
    want.tags.append(ref_sam.SAMTag("NM", "Z", "oops"))
    assert rec.validate_tags() == want.validate_tags() != []
    assert rec.get_tag("NM").canonical_type() == "i"


def _write_bam(mod, smod, path, seed, nrec):
    """The records of tests/test_bam_sam.py::_make_bam, written by `mod`."""
    rng = np.random.default_rng(seed)
    header = mod.BAMHeader(text="@HD\tVN:1.6\n@SQ\tSN:chrT\tLN:100000\n",
                           ref_names=["chrT", "chrU"],
                           ref_lengths=[100000, 50000])
    positions = np.sort(rng.integers(0, 100000 - 200, size=nrec))
    with mod.BAMFileWriter(path, header) as w:
        for i, pos in enumerate(positions):
            seq = bytes(random_dna(rng, 50)).decode()
            w.write(smod.SAMRecord(qname=f"r{i:04d}", flag=0, rname="chrT",
                                   pos=int(pos) + 1, mapq=60, cigar="50M",
                                   seq=seq, qual="I" * 50,
                                   tags=[smod.SAMTag("NM", "i", i % 5)]))


@pytest.mark.parametrize("nrec", [1, 50, 300])
def test_bam_bytes_records_and_queries_equal_reference(tmp_path, nrec):
    port_path, ref_path = tmp_path / "port.bam", tmp_path / "ref.bam"
    _write_bam(bam, sam, port_path, nrec, nrec)
    _write_bam(ref_bam, ref_sam, ref_path, nrec, nrec)
    assert port_path.read_bytes() == ref_path.read_bytes()
    r, w = bam.BAMFileReader(port_path), ref_bam.BAMFileReader(port_path)
    assert (r.header.text, r.header.ref_names, r.header.ref_lengths) == \
        (w.header.text, w.header.ref_names, w.header.ref_lengths)
    got = [(_fields(rec), voff) for rec, voff in r.records()]
    assert got == [(_fields(rec), voff) for rec, voff in w.records()]
    assert len(got) == nrec
    for start, end in [(0, 1000), (50000, 52000), (99000, 100000),
                       (0, 100000)]:
        assert [_fields(x) for x in r.search(0, start, end)] == \
            [_fields(x) for x in w.search(0, start, end)]


def test_bai_bytes_equal_reference(tmp_path):
    path = tmp_path / "t.bam"
    _write_bam(bam, sam, path, 7, 100)
    pb, rb = tmp_path / "port.bai", tmp_path / "ref.bai"
    bam.BAMFileReader(path).make_index().save(pb)
    ref_bam.BAMFileReader(path).make_index().save(rb)
    assert pb.read_bytes() == rb.read_bytes()
    back, want = bam.BAI.load(rb), ref_bam.BAI.load(pb)
    assert (back.n_ref, back.bins, back.linear) == \
        (want.n_ref, want.bins, want.linear)
    (tmp_path / "t.bam.bai").write_bytes(pb.read_bytes())
    r = bam.BAMFileReader(path)
    assert r.bai is not None and len(r.search(0, 0, 100000)) == 100


@pytest.mark.parametrize("beg,end", [(0, 1), (0, 1 << 15), (12345, 12346),
                                     (0, 1 << 29), (70000, 300000)])
def test_reg2bin_equals_reference(beg, end):
    assert bam.reg2bin(beg, end) == ref_bam.reg2bin(beg, end)
    assert bam.reg2bins(beg, end) == ref_bam.reg2bins(beg, end)


def test_sam_bam_sam_equals_reference(tmp_path):
    text = ("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrQ\tLN:5000\n"
            "r1\t0\tchrQ\t100\t60\t8M\t*\t0\t0\tACGTACGT\tIIIIIIII\tNM:i:0\n"
            "r2\t16\tchrQ\t220\t37\t4M1I3M\t*\t0\t0\tGGGGTCCC\tFFFFFFFF\n")
    s = tmp_path / "a.sam"
    s.write_text(text)
    outs = []
    for mod in (bam, ref_bam):
        b = tmp_path / f"{mod.__name__}.bam"
        back = tmp_path / f"{mod.__name__}.sam"
        mod.sam_to_bam(s, b)
        mod.bam_to_sam(b, back)
        outs.append((b.read_bytes(), back.read_text()))
    assert outs[0] == outs[1]
    assert outs[0][1] == text
    header, records = sam.read_sam(s)
    want_header, want_records = ref_sam.read_sam(s)
    assert header.format() == want_header.format()
    assert [_fields(r) for r in records] == [_fields(r) for r in want_records]


@pytest.mark.parametrize("bai", [True, False])
def test_golden_bam_equals_reference(tmp_path, bai):
    """The SAMv1 worked example built with struct + zlib alone
    (tests/test_bam_golden.py): records and range queries, with the
    hand-built index and with one the reader builds."""
    path, bai_path = build_fixture(tmp_path)
    kw = {"bai_path": bai_path} if bai else {}
    r, w = bam.BAMFileReader(path, **kw), ref_bam.BAMFileReader(path, **kw)
    if not bai:
        r.bai = w.bai = None
    assert r.header.text == "@HD\tVN:1.5\tSO:coordinate\n@SQ\tSN:ref\tLN:45\n"
    recs = [_fields(rec) for rec, _ in r.records()]
    assert recs == [_fields(rec) for rec, _ in w.records()]
    assert [x[:6] for x in recs] == [("r001", 99, "ref", 7, 30, "8M2I4M1D3M"),
                                     ("r002", 0, "ref", 9, 30, "3S6M1P1I4M"),
                                     ("r001", 147, "ref", 37, 30, "9M")]
    for beg, end in ((8, 10), (40, 45), (22, 25), (0, 45)):
        got = [(h.qname, h.flag) for h in r.search(0, beg, end)]
        assert got == [(h.qname, h.flag) for h in w.search(0, beg, end)]
    assert [(h.qname, h.flag) for h in r.search(0, 8, 10)] == \
        [("r001", 99), ("r002", 0)]
