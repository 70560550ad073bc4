"""Compress control: the program's own compress with the suffix array
sampled at twice the configured rate (a smaller `.gcx`, the configured
`.gcz`)."""

from gzbench.control import in_place_of


def replaced(op):
    def make(orig):
        def compress(ipath, opath, xpath=None, sampling=32, **kw):
            orig(ipath, opath, xpath, sampling=2 * sampling, **kw)
        return compress
    return in_place_of("index_fasta", make)
