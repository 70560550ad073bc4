"""The FASTA a decompress must write.

gecoz writes each record as `>header`, then its sequence in lines of 50
characters, each ended by a newline; a sequence whose length is a whole
multiple of 50 gets one more, empty, line.  Records come in the order of
the `.gcz`'s blocks and, in a block, in the block's header order.
"""

from __future__ import annotations

import numpy as np

LINE = 50


def record_bytes(header: str, seq: np.ndarray) -> bytes:
    n = len(seq)
    rows = -(-n // LINE)
    body = np.full(rows * (LINE + 1), ord("\n"), np.uint8)
    pos = np.arange(n)
    body[pos + pos // LINE] = seq
    body = body[:n + rows]
    tail = b"\n" if n and n % LINE == 0 else b""
    return b">" + header.encode() + b"\n" + body.tobytes() + tail


def fasta_bytes(order: list[str], records: dict[str, np.ndarray]) -> bytes:
    """The decompressed file of `records` in header order `order`."""
    return b"".join(record_bytes(h, records[h]) for h in order)


def bytes_wrong(got: np.ndarray, want: np.ndarray) -> int:
    """Bytes in which `got` differs from `want`, a length gap counted
    whole."""
    m = min(len(got), len(want))
    return int((got[:m] != want[:m]).sum()) + abs(len(got) - len(want))
