"""Record kind `protein`: a protein database shaped like UniProtKB/Swiss-Prot,
`records` entries in families of orthologs, each drawn from the
configuration's length law, residue composition, family model and
headers.

Lengths, families, headers and the order of the records come from fixed
streams, the same for every seed; the seed draws the residues: each
family's first record from the composition, the others copies of it with
a share `1 - identity` of their residues substituted.  Every record starts
with M.

Before drawing, the deployment's precondition: the program's block planner
plans `planner_precondition.records` lengths of the same law within
`limit_s`, else a RuntimeError says that it cannot plan the deployment.
The planner is reached through the harness's route to the program's driver
(`gzbench.operations._driver`), as a control reaches the driver through
`gzbench.control.in_place_of`.
"""

from __future__ import annotations

import time

import numpy as np

from gzbench.data import composition_table, draw, rng_for
from gzbench.operations import _driver

# 400 records of up to 4,000 residues: ~40 blocks of ~10 records on the CPU
SMALL = {"records": 400, "lengths": {"max": 4000}, "longest": 4000}

FIXED = 0           # the seed of the streams every seed shares


def records(config: dict, seed: int) -> list[tuple[str, np.ndarray]]:
    check_planner(config)
    lengths, family, first, headers = shape(config)
    rng = rng_for(seed, "protein/residues")
    table = composition_table(config["residue_composition"])
    roots = np.flatnonzero(first)
    root_len = lengths[roots]
    root_res = draw(rng, table, int(root_len.sum()))
    root_at = np.zeros(family.max() + 1, np.int64)
    root_at[family[roots]] = np.cumsum(root_len) - root_len
    starts = np.cumsum(lengths) - lengths
    total = int(lengths.sum())
    text = root_res[np.repeat(root_at[family] - starts, lengths)
                    + np.arange(total)]
    change = rng.random(total) < 1 - config["families"]["identity"]
    change &= np.repeat(~first, lengths)
    at = np.flatnonzero(change)
    new = draw(rng, table, len(at))
    same = new == text[at]
    while same.any():                      # a substitution changes the residue
        new[same] = draw(rng, table, int(same.sum()))
        same = new == text[at]
    text[at] = new
    text[starts] = ord("M")
    return [(h, text[s:s + n]) for h, s, n in zip(headers, starts, lengths)]


def length_law(config: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    law = config["lengths"]
    return np.clip(rng.lognormal(law["mu"], law["sigma"], n).astype(np.int64),
                   law["min"], law["max"])


def shape(config: dict):
    """(lengths, family, first member?, headers) of every record in file
    order, from fixed streams: the same for every seed."""
    rng = rng_for(FIXED, "protein/shape")
    count = config["records"] - 1              # and the longest record
    species = config["headers"]["species"]
    mean = config["families"]["size_mean"]
    sizes = np.minimum(rng.geometric(1 / mean, count), len(species))
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), count) + 1]
    sizes[-1] -= sizes.sum() - count
    nfam = len(sizes)
    fam_len = length_law(config, rng, nfam)
    family = np.repeat(np.arange(nfam), sizes)
    member = np.arange(count) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    genes = [_gene(f) for f in rng.permutation(nfam)]
    descr = config["headers"]["descriptions"]
    fam_descr = rng.integers(0, len(descr), nfam)
    fam_species = [rng.permutation(len(species))[:s] for s in sizes]
    accessions = rng.permutation(count)
    headers = []
    for i, (f, m) in enumerate(zip(family, member)):
        code, os_name, ox = species[fam_species[f][m]]
        gene = genes[f]
        headers.append(f"sp|{_accession(accessions[i])}|{gene}_{code} "
                       f"{descr[fam_descr[f]].format(gene=gene)} OS={os_name} "
                       f"OX={ox} GN={gene} PE=1 SV=1")
    lengths = np.append(fam_len[family], config["longest"])
    family = np.append(family, nfam)
    first = np.append(member == 0, True)
    headers.append(config["headers"]["longest"])
    order = rng.permutation(config["records"])
    return (lengths[order], family[order], first[order],
            [headers[i] for i in order])


_ALNUM = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


def _accession(i: int) -> str:
    """The i-th accession of UniProt's [OPQ][0-9][A-Z0-9]{3}[0-9] form."""
    i, a = divmod(int(i), 3)
    i, b = divmod(i, 10)
    i, c = divmod(i, 36)
    i, d = divmod(i, 36)
    i, e = divmod(i, 36)
    return f"{'OPQ'[a]}{b}{_ALNUM[c]}{_ALNUM[d]}{_ALNUM[e]}{i % 10}"


def _gene(f: int) -> str:
    """The f-th gene name: three letters and a digit."""
    f, a = divmod(int(f), 26)
    f, b = divmod(f, 26)
    f, c = divmod(f, 26)
    return f"{_ALNUM[c]}{_ALNUM[b]}{_ALNUM[a]}{f % 9 + 1}"


class _Length:
    """What the planner reads of a FASTA record."""

    def __init__(self, header: str, length: int):
        self.header, self.length = header, length

    def sort_key(self):
        return (-self.length, self.header)


def check_planner(config: dict) -> None:
    """The deployment's precondition: the program's `plan_blocks` plans
    the precondition's count of lengths of this law within its limit."""
    pre = config["planner_precondition"]
    lengths = length_law(config, rng_for(FIXED, "protein/precondition"),
                         pre["records"])
    seqs = [_Length(f"p{i}", int(n)) for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    _driver().plan_blocks(seqs)
    took = time.perf_counter() - t0
    if took > pre["limit_s"]:
        raise RuntimeError(
            f"this program's block planner cannot plan the deployment's "
            f"{config['records']:,} records: {pre['records']:,} records of "
            f"its length law took {took:.1f} s (limit {pre['limit_s']} s)")
