"""Kernel lfwalk.cu (K2 decode): the decode's bytes (`roofline.k2_bytes`
of each call's walks and steps) at the card's HBM peak over the device
time of the `lf_decode_*` kernels."""

from gzbench.layers import roofline_pct
from gzbench.roofline import k2_bytes


def read(ctx):
    return roofline_pct(ctx, sum(k2_bytes(w, s) for w, s in ctx.calls.get("k2", ())),
                        r"\blf_decode_(tiles|steps)\b")
