"""Query kind `peptides`: a peptide list of a proteomics run, as it is mapped
back to its proteins, from an in-silico digest of the records.

The digest follows the mix's `digest`: cleavage after each residue of
`cleave_after` (Trypsin/P: K or R, before P too), up to `missed_cleavages`
missed, peptides of `min_length` residues or more and a monoisotopic mass
(`residue_mass` + one water, fixed modifications included) of at most
`max_mass_da`, none holding a residue of `exclude`.

Every seed gets the same sizes: peptide i has the length of slot i of a
fixed list, which holds `length_share`'s histogram (`data.fixed_counts`)
in an order drawn from a fixed stream.  For each slot the seed picks a
record uniformly among those with a peptide of that length, then one of
the record's peptides of that length uniformly, drawn again where the
file already holds it.  Headers are `<header><i>|<accession>`.
"""

from __future__ import annotations

import numpy as np

from gzbench.data import fixed_counts, rng_for

SMALL = {"count": 300}

FIXED = 0           # the seed of the stream every seed shares
ROUNDS = 1000       # draws of a slot before a digest counts as too small


def digest(records: list[tuple[str, np.ndarray]], d: dict):
    """Every peptide of the digest: (record, start, end) arrays, start and
    end in the records' concatenated text, and that text."""
    text = np.concatenate([s for _, s in records])
    lens = np.array([len(s) for _, s in records], np.int64)
    starts = np.cumsum(lens) - lens
    cut = np.flatnonzero(np.isin(text, np.frombuffer(
        d["cleave_after"].encode(), np.uint8))) + 1
    bounds = np.union1d(np.append(starts, len(text)), cut)
    mass = np.zeros(256)
    for residue, m in d["residue_mass"].items():
        mass[ord(residue)] = m
    cum_mass = np.concatenate([[0.0], np.cumsum(mass[text])])
    bad = np.concatenate([[0], np.cumsum(np.isin(text, np.frombuffer(
        d["exclude"].encode(), np.uint8)))])
    rec, beg, end = [], [], []
    for m in range(d["missed_cleavages"] + 1):
        b, e = bounds[:-1 - m], bounds[1 + m:]
        r = np.searchsorted(starts, b, side="right") - 1
        ok = (e <= starts[r] + lens[r]) & (e - b >= d["min_length"])
        ok &= cum_mass[e] - cum_mass[b] + d["water_mass"] <= d["max_mass_da"]
        ok &= bad[e] == bad[b]
        rec.append(r[ok])
        beg.append(b[ok])
        end.append(e[ok])
    return np.concatenate(rec), np.concatenate(beg), np.concatenate(end), text


def slot_lengths(q: dict) -> np.ndarray:
    """The length of each peptide of a file: the same for every seed."""
    share = q["length_share"]
    lengths = np.array([int(k) for k in share])
    counts = fixed_counts(np.array([share[k] for k in share], float),
                          q["count"])
    return rng_for(FIXED, "peptides/slots").permutation(
        np.repeat(lengths, counts))


def queries(rng: np.random.Generator, records, q: dict):
    rec, beg, end, text = digest(records, q["digest"])
    want = slot_lengths(q)
    length = end - beg
    # the peptides grouped by (length, record)
    order = np.lexsort((rec, length))
    rec, beg, length = rec[order], beg[order], length[order]
    key = length * len(records) + rec
    names = [h.split("|")[1] if h.count("|") >= 2 else h for h, _ in records]
    out: list = [None] * len(want)
    seen: set[bytes] = set()
    todo = np.arange(len(want))
    for _ in range(ROUNDS):
        if not len(todo):
            return out
        again = []
        for n in np.unique(want[todo]):
            slots = todo[want[todo] == n]
            lo, hi = np.searchsorted(length, [n, n + 1])
            if lo == hi:
                raise ValueError(f"no peptide of {n} residues in the digest")
            recs = np.unique(rec[lo:hi])
            r = recs[rng.integers(0, len(recs), len(slots))]
            first = np.searchsorted(key, n * len(records) + r)
            last = np.searchsorted(key, n * len(records) + r, side="right")
            pick = first + (rng.random(len(slots)) * (last - first)).astype(
                np.int64)
            for slot, at, owner in zip(slots, beg[pick], r):
                pep = text[at:at + n].tobytes()
                if pep in seen:
                    again.append(slot)
                else:
                    seen.add(pep)
                    out[slot] = (f"{q['header']}{slot}|{names[owner]}", pep)
        todo = np.array(sorted(again), np.int64)
    raise ValueError(f"{len(todo)} peptides still drawn twice after {ROUNDS} "
                     f"rounds: the digest holds too few of their lengths")
