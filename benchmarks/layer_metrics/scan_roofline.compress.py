"""Kernel scan.cu: the scans' bytes (`roofline.scan_bytes` of each launch's
n) at the card's HBM peak over the device time of `scan_onepass`."""

from gzbench.layers import roofline_pct
from gzbench.roofline import scan_bytes


def read(ctx):
    return roofline_pct(ctx, sum(scan_bytes(n) for n in ctx.calls.get("scan", ())),
                        r"\bscan_onepass\b")
