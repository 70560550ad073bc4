"""Kernel fmsearch.cu (K1): the backward search's bytes (`roofline.k1_bytes`
of each call's patterns) at the card's HBM peak over the device time of
`fm_search`."""

from gzbench.layers import roofline_pct
from gzbench.roofline import k1_bytes


def read(ctx):
    return roofline_pct(ctx, sum(k1_bytes(b, c) for b, c in ctx.calls.get("k1", ())),
                        r"\bfm_search\b")
