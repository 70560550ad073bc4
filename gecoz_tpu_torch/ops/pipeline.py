"""End-to-end steps on the card: index one block, and index-and-query.

Port of gecoz_tpu/ops/pipeline.py: `index_block` (26-60), the step the
reference's `bench.py` headline times, and `index_and_query` (63-78),
which runs every stage of the engine once.
"""

from __future__ import annotations

import torch

from gecoz_tpu_torch.ops.fmq import (DeviceFMBlock, build_device_block,
                                     decode_text, locate_batch, search_batch,
                                     with_kmer_table, with_lf_table,
                                     with_rank_blocks)
from gecoz_tpu_torch.ops.sa_device import (_suffix_array, _suffix_array_runs,
                                           bwt_device)
from gecoz_tpu_torch.ops.sa_host import dense_table

# '\0' terminator + IUPAC-ish genomic alphabet (static plane set)
DNA_SYMBOLS = (0, 65, 67, 71, 78, 84)  # \0 A C G N T


def index_block(s: torch.Tensor, sf: int = 5,
                symbols: tuple[int, ...] = DNA_SYMBOLS,
                sa_impl: str = "runs",
                m_pad: int | None = None,
                tok_table: torch.Tensor | None = None,
                ell_bits: int | None = None,
                r1_keys: int | None = None) -> DeviceFMBlock:
    """Raw block bytes (uint8 tensor) -> query state on the same device.

    sa_impl 'runs' (default) is robust to the long equal-symbol runs of
    real genomes; 'kmer' is the dense-packed doubling variant.  `m_pad`,
    `tok_table`, `ell_bits` and `r1_keys` are the host-precomputed bounds
    of `ops/sa_host.py`.
    """
    if sa_impl == "runs":
        sa, bwt = _suffix_array_runs(
            s, syms=symbols if len(symbols) <= 7 else None, m_pad=m_pad,
            tok_table=tok_table, ell_bits=ell_bits, r1_keys=r1_keys)
    elif sa_impl == "kmer":
        table, bits = dense_table(symbols)
        sa = _suffix_array(s, torch.from_numpy(table), bits=bits)
        bwt = bwt_device(s, sa)
    else:
        raise ValueError(f"sa_impl must be runs or kmer, got {sa_impl!r}")
    return build_device_block(bwt, sa, sf, symbols)


def index_and_query(s: torch.Tensor, patterns: torch.Tensor,
                    lengths: torch.Tensor, sf: int = 5,
                    symbols: tuple[int, ...] = DNA_SYMBOLS,
                    sa_impl: str = "runs"):
    """One full forward step: build the index, run a search batch, locate
    every hit range's start row, and decode the text back.

    Returns (sp, ep, located_start, text).  The locate reads row sp
    clamped into [0, n), as the reference's gather clamps an empty range's
    sp = n."""
    block = with_rank_blocks(with_kmer_table(with_lf_table(
        index_block(s, sf=sf, symbols=symbols, sa_impl=sa_impl))))
    sp, ep = search_batch(block, patterns, lengths)
    start_vals = locate_batch(block, sp.clamp(0, block.n - 1))
    return sp, ep, start_vals, decode_text(block)
