"""Search control: the reference's first row of each query on each strand,
its other occurrences left out (the locate cut short).  It fails where
queries occur more than once, as peptides shared by proteins do, which the
strand control cannot show there: a peptide's reverse complement almost
never occurs in a protein."""

from gzbench.control import reference_search


def first_of_each_strand(rows: list[str]) -> list[str]:
    seen, out = set(), []
    for row in rows:
        strand = row.split("\t")[6]
        if strand not in seen:
            seen.add(strand)
            out.append(row)
    return out


def replaced(op):
    return reference_search(op, first_of_each_strand)
