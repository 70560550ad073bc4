"""Record kind `dna`: a genome's chromosomes, one record per entry of the
configuration's `records` (header, length), each drawn by
`dna_chromosome` from the configuration's `genome` sizes and shares.

A record kind is `kinds/<kind>.py` with `records(config, seed)`, the
records of a configuration of that kind for a seed, and `SMALL`, the
configuration keys that cut one to the size of a CPU test.  Everything
random comes from `data.rng_for(seed, stream)`; every seed gets the same
sizes.
"""

from __future__ import annotations

import numpy as np

from gzbench.data import composition_table, draw, rng_for

SMALL = {"records": [{"header": "small", "length": 20_000}]}


def records(config: dict, seed: int) -> list[tuple[str, np.ndarray]]:
    return [(r["header"], dna_chromosome(rng_for(seed, f"dna/{r['header']}"),
                                         r["length"], config["genome"]))
            for r in config["records"]]


def dna_chromosome(rng: np.random.Generator, n: int, g: dict) -> np.ndarray:
    """One chromosome of n bases: copies of one Alu-like unit with point
    mutations and microsatellites over bases of the given composition,
    then N runs over them: telomeric runs at both ends, the unsequenced
    p-arm after the first, and one centromeric run near the middle.  The
    method of `tools/validate_scale.py::synth_chromosome`, with each size
    that method draws fixed by `g`, and the N runs laid last so that
    their share is exact."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    out = draw(rng, composition_table(g["base_composition"]), n)
    unit_len = g["alu_length"]
    copies = int(n * g["alu_share"]) // unit_len
    if copies:
        unit = rng.choice(bases, unit_len)
        block = np.tile(unit, (copies, 1))
        nmut = rng.poisson(g["alu_mutations_mean"], copies)
        rows = np.repeat(np.arange(copies), nmut)
        block[rows, rng.integers(0, unit_len, len(rows))] = \
            rng.choice(bases, len(rows))
        starts = rng.integers(0, n - unit_len, copies)
        out[starts[:, None] + np.arange(unit_len)] = block

    count = max(1, n // g["bases_per_microsatellite"])
    m_lo, m_hi = g["microsatellite_motif"]
    r_lo, r_hi = g["microsatellite_repeats"]
    for i in range(count):
        motif = rng.choice(bases, m_lo + i % (m_hi - m_lo + 1))
        reps = r_lo + (r_hi - r_lo) * i // max(1, count - 1)
        run = np.tile(motif, reps)
        at = int(rng.integers(0, max(1, n - len(run))))
        run = run[:max(0, min(len(run), n - at))]
        out[at:at + len(run)] = run

    tel = int(n * g["telomere_share"])
    p_arm = int(n * g["p_arm_share"])
    cen = int(n * g["centromere_share"])
    out[:tel + p_arm] = ord("N")
    out[n - tel:] = ord("N")
    mid = n // 2 + int(rng.integers(-(n // 10), n // 10 + 1))
    out[mid:mid + cen] = ord("N")
    return out
