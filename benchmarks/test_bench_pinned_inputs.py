"""The hg38 cells' inputs and controls, pinned: sha256 digests of what the
generators and controls made for two seeds before they became files found
by name (`kinds/dna.py`, `queries/reads.py`, `controls/`).  The records of
hg38-dna cut to 50,000 bases, 2,000 reads of the search mix drawn from
them, and each default control's output at that size.

    python -m pytest benchmarks/ -q
"""

from __future__ import annotations

import hashlib

import pytest

from gzbench import data
from gzbench.control import replaced
from gzbench.operations import OPERATIONS
from gzbench.runner import BENCH, _merge, load_json

SEEDS = (7, 2 ** 40 + 3)
RECORDS = {7: "ab77370750745b009ea00dcd2662a47c6d9629bc1657c7725cf41824620483f6",
           2 ** 40 + 3:
           "95b7ee73b2850eda87d09d68680cf5b72bcd5fbce606d5446ed90c9d5798dcd5"}
READS = {7: "52ff7778d9fb3b85e258832eb6789a76ccd74b49419797da907bcdb387a4ed56",
         2 ** 40 + 3:
         "9b41ceea772733385cf26067cb5b3535f7caa289f1177f7a1b5fb8c072f5a306"}
CONTROLS = {  # seed 7; compress: the .gcz's bytes, then the .gcx's
    "decompress": "f536b7a8eee97441ee82de2e78aa4800d419ed7cf4c185daa4506efb2eae6fd9",
    "compress": "ce717f5f1145927a19b2dd283121b0d0662d09cb865ffadfb9ce0e3df31aa60f",
    "search": "0b5a970813a09ff6e652093fe8129658c5cecd764f45960abdea2a67103a425a"}


def _config():
    cfg = load_json(BENCH / "configs" / "hg38-dna.json")
    cfg["records"] = [{"header": "chr21", "length": 50_000}]
    return cfg


def _reads_mix():
    return _merge(load_json(BENCH / "traffic" / "search_reads.json"),
                  {"files": 1, "queries": {"count": 2000}})


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("seed", SEEDS)
def test_hg38_records_keep_their_bytes(seed):
    recs = data.records_of(_config(), seed)
    assert _sha(b"".join(h.encode() + b"\0" + s.tobytes()
                         for h, s in recs)) == RECORDS[seed]


@pytest.mark.parametrize("seed", SEEDS)
def test_hg38_reads_keep_their_bytes(seed):
    reads = data.queries_of(_reads_mix()["queries"],
                            data.rng_for(seed, "queries/0"),
                            data.records_of(_config(), seed))
    assert _sha(b"".join(b">" + h.encode() + b"\n" + q + b"\n"
                         for h, q in reads)) == READS[seed]


@pytest.mark.parametrize("kind", sorted(CONTROLS))
def test_hg38_controls_keep_their_outputs(kind, tmp_path):
    traffic = (_reads_mix() if kind == "search" else
               load_json(BENCH / "traffic" / f"{kind}.json"))
    op = OPERATIONS[kind](_config(), traffic, 7, tmp_path, "cpu")
    op.prepare()
    with replaced(op):
        op.run(0)
    got = {"decompress": lambda: op.path(0, ".fa").read_bytes(),
           "compress": lambda: op.path(0, ".gcz").read_bytes()
           + op.path(0, ".gcx").read_bytes(),
           "search": lambda: op.rows[0].encode()}[kind]()
    assert _sha(got) == CONTROLS[kind]
