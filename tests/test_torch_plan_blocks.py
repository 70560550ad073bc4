"""The port's block planner (`gecoz_tpu_torch/tools/blocks.py`, a heap)
against the reference's (`gecoz_tpu/tools/blocks.py`, a sorted list it
bisects into): the same blocks, the same sequences in each, in the same
order, on seeded inputs with every kind of tie; and a plan of Swiss-Prot's
shape at the benchmark's 71,375 records within seconds.
"""

import time

import numpy as np
import pytest

from gecoz_tpu.formats import fasta as ref_fasta
from gecoz_tpu.tools import blocks as ref_blocks
from gecoz_tpu_torch.formats import fasta
from gecoz_tpu_torch.tools import blocks


def _plans(spec):
    """Both planners' plans of (header, length) records, each sequence
    named by its input position as well, so that records of the same
    header and length are told apart."""
    got = blocks.plan_blocks([fasta.FastaSequence(h, n, i, False)
                              for i, (h, n) in enumerate(spec)])
    want = ref_blocks.plan_blocks([ref_fasta.FastaSequence(h, n, i, False)
                                   for i, (h, n) in enumerate(spec)])
    return ([[(s.header, s.position) for s in b.sequences] for b in got],
            [[(s.header, s.position) for s in b.sequences] for b in want],
            [b.size for b in got], [b.size for b in want])


def _spec(seed: int, count: int, kind: str):
    rng = np.random.default_rng(seed)
    if kind == "spread":
        lengths = rng.integers(1, 5000, count)
    elif kind == "few_sizes":              # ties of equal size
        lengths = rng.choice([3, 3, 5, 9, 40], count)
    elif kind == "one_length":
        lengths = np.full(count, 7)
    else:                                  # Swiss-Prot-shaped, one titin
        lengths = np.clip(rng.lognormal(5.70, 0.62, count).astype(int), 2,
                          35213)
        lengths[rng.integers(0, count)] = 35213
    # headers drawn with repeats: blocks of equal size and equal first
    # sequence, and sequences of equal key inside a block
    heads = rng.integers(0, max(1, count // 3), count)
    return [(f"h{h}", int(n)) for h, n in zip(heads, lengths)]


CASES = [(seed, count, kind) for seed, count in enumerate((1, 2, 3, 17, 300,
                                                          3000))
         for kind in ("spread", "few_sizes", "one_length", "swissprot")]


@pytest.mark.parametrize("seed, count, kind", CASES,
                         ids=[f"{c}-{k}" for _, c, k in CASES])
def test_the_plan_is_the_references(seed, count, kind):
    got, want, got_sizes, want_sizes = _plans(_spec(seed, count, kind))
    assert got == want and got_sizes == want_sizes
    assert sorted(p for b in got for p in b) == sorted(
        (h, i) for i, (h, _) in enumerate(_spec(seed, count, kind)))


def test_no_record_plans_nothing():
    assert blocks.plan_blocks([]) == []


def test_swissprot_lengths_plan_within_seconds():
    rng = np.random.default_rng(19)
    lengths = np.clip(rng.lognormal(5.70, 0.62, 71_375).astype(int), 2,
                      35213)
    lengths[0] = 35213
    seqs = [fasta.FastaSequence(f"sp|P{i:05d}|X", int(n), 0, False)
            for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    plan = blocks.plan_blocks(seqs)
    assert time.perf_counter() - t0 < 10
    assert sum(len(b.sequences) for b in plan) == 71_375
    assert max(b.size for b in plan) == 35214
    assert 900 <= len(plan) <= 1200
