"""Search control: the reference's rows of the queries as written alone,
the reverse complements left unsearched (half the patterns: the search
that "both strands" rules out)."""

from gzbench.control import reference_search


def replaced(op):
    return reference_search(
        op, lambda rows: [r for r in rows if r.split("\t")[6] == "+"])
