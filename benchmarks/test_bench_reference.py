"""The plain reference (`gzref`) against hand-computed answers and, at
small sizes on the CPU, against the program's own host tier, which is held
to the JAX package by the repository's tests.

    python -m pytest benchmarks/ -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gzref import fasta as ref_fasta
from gzref import gcz as ref_gcz
from gzref import search as ref_search
from gzref.suffix import bwt, suffix_array


def _t(b: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(b, np.uint8).copy())


@pytest.mark.parametrize("text, want", [
    (b"banana\0", [6, 5, 3, 1, 0, 4, 2]),
    (b"ab\0ab\0", [5, 2, 3, 0, 4, 1]),
    (b"A\0", [1, 0]),
    (b"\0", [0]),
])
def test_suffix_array_by_hand(text, want):
    assert suffix_array(_t(text)).tolist() == want


def test_suffix_array_and_bwt_against_sorted_suffixes():
    rng = np.random.default_rng(4)
    for n in (2, 7, 300, 2000):
        s = rng.choice(np.frombuffer(b"\0NAC", np.uint8), n).tobytes()
        want = sorted(range(n), key=lambda i: s[i:])
        assert suffix_array(_t(s)).tolist() == want
        assert bytes(bwt(_t(s), suffix_array(_t(s))).numpy()) == bytes(
            s[i - 1] for i in want)


def test_bwt_by_hand():
    t = _t(b"banana\0")
    assert bytes(bwt(t, suffix_array(t)).numpy()) == b"annb\0aa"


def test_rbv_layout_by_hand():
    # 1,000 bits: two 64-byte groups, one 2-byte counter between them
    bits = np.zeros(1000, np.uint8)
    bits[[0, 5, 511, 512, 999]] = 1
    packed = np.packbits(bits, bitorder="little")
    out = ref_gcz.rbv_serialize(packed, 1000)
    assert ref_gcz.rbv_bytes(1000) == len(out) == 125 + 2
    assert out[:64].tobytes() == packed[:64].tobytes()
    assert int.from_bytes(out[64:66].tobytes(), "little") == 3
    assert out[66:].tobytes() == packed[64:].tobytes()
    # past 64 Kbit: the group at 8192 data bytes gets an 8-byte counter
    big = np.ones(70000, np.uint8)
    out = ref_gcz.rbv_serialize(np.packbits(big, bitorder="little"), 70000)
    at = 66 * 128 + 6 - 8
    assert int.from_bytes(out[at:at + 8].tobytes(), "little") == 65536
    assert int.from_bytes(out[at - 66:at - 64].tobytes(), "little") == 127 * 512


def test_header_hash_by_hand():
    h = 1125899906842597
    for ch in "ab":
        h = (31 * h + ord(ch)) % 2 ** 64
    assert ref_gcz.header_hash(["a", "b"]) == h


def test_lengths_table_of_the_program_parses_to_an_optimal_code():
    counts = np.zeros(256, np.int64)
    counts[[0, 65, 67, 71, 78, 84]] = [1, 300, 200, 200, 30, 300]
    seq = np.random.default_rng(4).permutation(np.repeat(
        np.frombuffer(b"ACGNT", np.uint8), [300, 200, 200, 30, 300]))
    gcz, _ = _host_pair({"a": seq}, [["a"]], 32)
    hlen = ref_gcz.parse_gcz_header(gcz, 0)[3]
    got, nbytes = ref_gcz.parse_lengths_table(gcz, hlen)
    assert 0 < nbytes < 64 and ref_gcz.code_table_errors(got, counts) == 0
    lengths = ref_gcz.huffman_lengths(counts)
    assert ref_gcz.code_cost(got, counts) == ref_gcz.code_cost(lengths, counts)
    # an optimal code costs the heap's merges: 1+30=31, 31+200, ...
    assert ref_gcz.code_cost(lengths, counts) == 31 + 231 + 431 + 600 + 1031
    bad = lengths.copy()
    bad[65] += 1
    assert ref_gcz.code_table_errors(bad, counts) == 1


def test_canonical_codes_rfc1951_example():
    # RFC 1951 3.2.2: lengths (3, 3, 3, 3, 3, 2, 4, 4) for A..H
    codes = ref_gcz.canonical_codes([3, 3, 3, 3, 3, 2, 4, 4])
    assert [codes[i] for i in range(8)] == [2, 3, 4, 5, 6, 0, 14, 15]
    assert ref_gcz.lsb_first(0b110, 3) == 0b011


def _host_pair(records: dict, blocks: list[list[str]], sampling: int):
    from gecoz_tpu_torch.formats.gcz import encode_block_host
    gcz, gcx = [], []
    for headers in blocks:
        data = np.concatenate([np.append(records[h], 0) for h in headers])
        g, x = encode_block_host(data.astype(np.uint8), headers, sampling,
                                 "native")
        gcz.append(g)
        gcx.append(x)
    return b"".join(gcz), b"".join(gcx)


@pytest.mark.parametrize("alphabet", [b"ACGTN", b"ACDEFGHIKLMNPQRSTVWYX",
                                      bytes(range(1, 256))])
@pytest.mark.parametrize("sampling", [32, 4])
def test_judge_accepts_the_host_tier_and_finds_each_flipped_byte(alphabet,
                                                                  sampling):
    rng = np.random.default_rng(len(alphabet) + sampling)
    seq = rng.choice(np.frombuffer(alphabet, np.uint8), 9000)
    seq[100:1500] = alphabet[-1]
    records = {"chr1 x": seq, "c2": seq[:3000].copy(), "c3": seq[50:90].copy()}
    blocks = [["chr1 x"], ["c2", "c3"]]
    gcz, gcx = _host_pair(records, blocks, sampling)
    sound = ref_gcz.judge_pair(gcz, gcx, records, sampling, "cpu")
    assert not any(sound.values()), sound
    assert ref_gcz.block_headers(gcz) == blocks
    for at in (len(gcz) - 1, len(gcz) // 2):
        bad = bytearray(gcz)
        bad[at] ^= 1
        assert sum(ref_gcz.judge_pair(bytes(bad), gcx, records, sampling,
                                      "cpu").values())
    bad = bytearray(gcx)
    bad[-1] ^= 0x80
    assert ref_gcz.judge_pair(gcz, bytes(bad), records, sampling,
                              "cpu")["gcx_bytes_wrong"] == 1
    # a pair at another sampling rate, and one that lost a record
    g2, x2 = _host_pair(records, blocks, sampling * 2)
    assert ref_gcz.judge_pair(g2, x2, records, sampling, "cpu")["gcx_bytes_wrong"]
    g3, x3 = _host_pair(records, [["chr1 x"]], sampling)
    assert ref_gcz.judge_pair(g3, x3, records, sampling, "cpu")["records_wrong"] == 2


def test_fasta_layout_by_hand():
    assert ref_fasta.record_bytes("h", np.frombuffer(b"A" * 3, np.uint8)) == \
        b">h\nAAA\n"
    assert ref_fasta.record_bytes("h", np.frombuffer(b"C" * 100, np.uint8)) \
        == b">h\n" + b"C" * 50 + b"\n" + b"C" * 50 + b"\n\n"
    assert ref_fasta.record_bytes("e", np.zeros(0, np.uint8)) == b">e\n"
    got = np.frombuffer(b">h\nAAT\n", np.uint8)
    want = np.frombuffer(b">h\nAAA\n\n", np.uint8)
    assert ref_fasta.bytes_wrong(got, want) == 2


def test_fasta_matches_the_program_writer():
    from gecoz_tpu_torch.formats.fasta import format_fasta_record
    rng = np.random.default_rng(2)
    for n in (0, 1, 49, 50, 51, 100, 1234):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
        assert ref_fasta.record_bytes("r 1", seq) == format_fasta_record(
            "r 1", seq)


def test_occurrences_against_find():
    rng = np.random.default_rng(5)
    text = rng.choice(np.frombuffer(b"AC", np.uint8), 3000).tobytes()
    pats = [text[i:i + ln] for i, ln in ((5, 3), (100, 9), (2000, 12))]
    pats += [b"GG", b"C" * 40, text]
    got = ref_search.occurrences(_t(text), pats)
    for p, at in zip(pats, got):
        want = [i for i in range(len(text)) if text.startswith(p, i)]
        assert at.tolist() == want


def test_expected_rows_by_hand():
    records = {"r1": np.frombuffer(b"ACGTACGTAA", np.uint8),
               "r2": np.frombuffer(b"TTACGT", np.uint8)}
    rows = ref_search.expected_rows([[("q1|x", b"ACGT"), ("q2", b""),
                                      ("q3", b"UAA")]], ["r2", "r1"],
                                    records, "cpu")[0]
    a = "ID=q1;Note=x"
    assert rows == [f"r2\tgecotools\tdna\t3\t6\t1.000\t+\t.\t{a}",
                    f"r1\tgecotools\tdna\t1\t4\t1.000\t+\t.\t{a}",
                    f"r1\tgecotools\tdna\t5\t8\t1.000\t+\t.\t{a}",
                    f"r2\tgecotools\tdna\t3\t6\t1.000\t-\t.\t{a}",
                    f"r1\tgecotools\tdna\t1\t4\t1.000\t-\t.\t{a}",
                    f"r1\tgecotools\tdna\t5\t8\t1.000\t-\t.\t{a}",
                    "r1\tgecotools\tdna\t8\t10\t1.000\t+\t.\tID=q3",
                    "r2\tgecotools\tdna\t1\t3\t1.000\t-\t.\tID=q3"]


def test_rows_match_the_program_host_tier(tmp_path):
    from gecoz_tpu_torch.tools import driver
    rng = np.random.default_rng(8)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    recs = {"c1": seq, "c2": seq[1000:1600].copy()}
    fa = tmp_path / "in.fa"
    fa.write_bytes(b"".join(b">" + h.encode() + b"\n" + s.tobytes() + b"\n"
                            for h, s in recs.items()))
    driver.index_fasta(fa, tmp_path / "in.gcz", backend="native")
    queries = [(f"q{i}|n", seq[i * 37:i * 37 + 12].tobytes()) for i in range(30)]
    qf = tmp_path / "q.fa"
    qf.write_bytes(b"".join(b">" + h.encode() + b"\n" + q + b"\n"
                            for h, q in queries))
    import io
    sink = io.StringIO()
    driver.gff_search(tmp_path / "in.gcz", qf, out=sink, backend="numpy")
    order = [h for b in ref_gcz.block_headers((tmp_path / "in.gcz").read_bytes())
             for h in b]
    want = ref_search.expected_rows([queries], order, recs, "cpu")[0]
    assert len(want) >= 32
    assert sink.getvalue().splitlines() == want


def test_row_faults_by_hand():
    assert ref_search.row_faults(["a", "b", "c", "d"], ["a", "c", "b", "e"]) \
        == dict(rows_missing=1, rows_extra=1, rows_misplaced=2)
    assert ref_search.row_faults(["a", "a"], ["a"]) == dict(
        rows_missing=0, rows_extra=1, rows_misplaced=0)
