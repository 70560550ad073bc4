"""Inputs made from the seed: records of a configuration, query files of a
traffic mix, and FASTA files of both.

Every seed gets the same sizes: the same record lengths, the same N-run,
repeat and microsatellite sizes, the same read length and the same
histogram of changed bases per read.  The seed moves what is random inside
them: bases, positions, strands.
"""

from __future__ import annotations

import math
import zlib
from pathlib import Path

import numpy as np


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """The generator of one named stream of `seed` (any integer)."""
    return np.random.default_rng([seed % (1 << 64), zlib.crc32(stream.encode())])


def composition_table(probs: dict[str, float], resolution: int = 100_000):
    """A lookup table whose uniform entries give `probs`' symbols at their
    shares, rounded to 1/resolution."""
    total = sum(probs.values())
    counts = [round(p / total * resolution) for p in probs.values()]
    return np.repeat(np.frombuffer("".join(probs).encode(), np.uint8), counts)


def draw(rng: np.random.Generator, table: np.ndarray, n: int) -> np.ndarray:
    return table[rng.integers(0, len(table), n)]


# -- DNA ------------------------------------------------------------------------

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


def records_of(config: dict, seed: int) -> list[tuple[str, np.ndarray]]:
    """The records of a configuration file for `seed`."""
    kind = config["kind"]
    if kind == "dna":
        return [(r["header"], dna_chromosome(rng_for(seed, f"dna/{r['header']}"),
                                             r["length"], config["genome"]))
                for r in config["records"]]
    raise ValueError(f"unknown configuration kind {kind!r}")


# -- queries --------------------------------------------------------------------

_COMPLEMENT = np.arange(256, dtype=np.uint8)
_COMPLEMENT[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def fixed_counts(pmf: np.ndarray, count: int) -> np.ndarray:
    """`count` items spread over the outcomes of `pmf` by largest
    remainders: the same histogram for every seed."""
    want = pmf / pmf.sum() * count
    out = np.floor(want).astype(np.int64)
    out[np.argsort(out - want, kind="stable")[:count - int(out.sum())]] += 1
    return out


def simulated_reads(rng: np.random.Generator,
                    records: list[tuple[str, np.ndarray]],
                    q: dict) -> list[tuple[str, bytes]]:
    """`q["count"]` reads of `q["length"]` bases in the manner of wgsim:
    each from a start drawn uniformly over the records' bases (a window
    holding a byte of `avoid` is drawn again), each base changed to one of
    the three others with probability `q["differences"]`, and a
    `reverse_complement` share reverse-complemented.  The number of
    changed bases per read is Binomial(length, differences) as one fixed
    histogram (`fixed_counts`), which the seed shuffles over the reads, so
    every seed searches the same mix."""
    count, ln = q["count"], q["length"]
    p = q["differences"]
    k = np.arange(ln + 1)
    pmf = np.array([math.comb(ln, int(i)) for i in k], float) \
        * p ** k * (1 - p) ** (ln - k)
    changed = rng.permutation(np.repeat(k, fixed_counts(pmf, count)))
    rc = rng.permutation(np.arange(count) < round(count * q["reverse_complement"]))
    sizes = np.array([len(s) - ln + 1 for _, s in records])
    text = np.concatenate([s for _, s in records])
    offs = np.concatenate([[0], np.cumsum([len(s) for _, s in records])])
    bad = np.zeros(len(text) + 1, np.int64)
    bad[1:] = np.cumsum(np.isin(text, np.frombuffer(q.get("avoid", "").encode(),
                                                   np.uint8)))
    rec = np.zeros(count, np.int64)
    at = np.zeros(count, np.int64)
    todo = np.arange(count)
    while len(todo):
        r = np.searchsorted(np.cumsum(sizes), rng.integers(0, sizes.sum(),
                                                           len(todo)),
                            side="right")
        a = rng.integers(0, sizes[r]) + offs[r]
        ok = bad[a + ln] == bad[a]
        rec[todo[ok]], at[todo[ok]] = r[ok], a[ok]
        todo = todo[~ok]
    reads = np.lib.stride_tricks.sliding_window_view(text, ln)[at]
    owner = np.repeat(np.arange(count), changed)
    pos = rng.integers(0, ln, len(owner))
    while True:                    # distinct positions within each read
        order = np.argsort(owner * ln + pos, kind="stable")
        key = (owner * ln + pos)[order]
        again = order[np.flatnonzero(key[1:] == key[:-1]) + 1]
        if not len(again):
            break
        pos[again] = rng.integers(0, ln, len(again))
    bases = np.frombuffer(b"ACGT", np.uint8)
    code = np.searchsorted(bases, reads[owner, pos])
    reads[owner, pos] = bases[(code + rng.integers(1, 4, len(code))) % 4]
    reads[rc] = _COMPLEMENT[reads[rc, ::-1]]
    return [(f"{q['header']}{i}|{records[rec[i]][0]}", reads[i].tobytes())
            for i in range(count)]


# -- files ------------------------------------------------------------------------

def write_queries(path: Path, queries: list[tuple[str, bytes]]) -> None:
    """Queries as FASTA, one line a sequence."""
    Path(path).write_bytes(b"".join(b">" + h.encode() + b"\n" + q + b"\n"
                                    for h, q in queries))


def write_fasta(path: Path, records, width: int) -> None:
    """Records as FASTA with `width`-character lines."""
    with open(path, "wb") as f:
        for header, seq in records:
            full = len(seq) // width * width
            lines = np.full((full // width, width + 1), ord("\n"), np.uint8)
            lines[:, :width] = seq[:full].reshape(-1, width)
            tail = seq[full:].tobytes() + b"\n" if full < len(seq) else b""
            f.write(b">" + header.encode() + b"\n" + lines.tobytes() + tail)
