"""Inputs made from the seed: records of a configuration, query files of a
traffic mix, and FASTA files of both.

A configuration's records come from its record kind, `kinds/<kind>.py`,
and a mix's queries from its query kind, `queries/<kind>.py` (`reads`
where the mix names none); both are found by name, and draw what they need
from the helpers here.  Every seed gets the same sizes (for `dna` and
`reads`: the same record lengths, the same N-run, repeat and
microsatellite sizes, the same read length and the same histogram of
changed bases per read).  The seed moves what is random inside them:
bases, positions, strands.

`tests/test_torch_query_reader.py` loads this file by its path, with no
`gzbench` package to import, and writes the benchmark's reads with
`simulated_reads`: so the generator stays here, and the loader is
imported inside the functions that use it.
"""

from __future__ import annotations

import math
import zlib
from pathlib import Path

import numpy as np

KINDS = Path(__file__).resolve().parent.parent / "kinds"
QUERIES = Path(__file__).resolve().parent.parent / "queries"


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


def records_of(config: dict, seed: int) -> list[tuple[str, np.ndarray]]:
    """The records of a configuration file for `seed`, by its kind's file."""
    from gzbench.named import load
    return load(KINDS, config["kind"], "record kind").records(config, seed)


def queries_of(q: dict, rng: np.random.Generator,
               records: list[tuple[str, np.ndarray]]) -> list[tuple[str, bytes]]:
    """One query file of a mix's `queries` parameters `q`, drawn with `rng`
    from `records` by its kind's file."""
    from gzbench.named import load
    return load(QUERIES, q.get("kind", "reads"), "query kind").queries(
        rng, records, q)


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
