"""The bytes each kernel's call needs: the algorithm's own inputs and
outputs, counted from the call's shapes, each read once and written once,
whatever table layout implements the kernel.  K1's and K2's rows are read
at random, so their bytes bounds are loose."""

from __future__ import annotations


def scan_bytes(n: int) -> int:
    """An int32 scan of n elements: n int32 read, n int32 written."""
    return 8 * n


def k1_bytes(patterns: int, pattern_chars: int) -> int:
    """Backward search: the patterns' characters read, one int32 (sp, ep)
    pair written per pattern."""
    return pattern_chars + 8 * patterns


def k2_bytes(walks: int, steps: int) -> int:
    """LF-walk decode of `walks` walks of `steps` steps: one int32 seed row
    read per walk, one BWT byte read and one text byte written per step."""
    return 4 * walks + 2 * walks * steps
