"""Index one block on the card: suffix sort -> BWT -> query state.

Port of gecoz_tpu/ops/pipeline.py::index_block (26-60), the step the
reference's `bench.py` headline times.  `index_and_query` waits for the
query engine (ROADMAP A7).
"""

from __future__ import annotations

import torch

from gecoz_tpu_torch.ops.fmq import DeviceFMBlock, build_device_block
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
                r1_keys: int | None = None,
                strategy: str = "sort") -> DeviceFMBlock:
    """Raw block bytes (uint8 tensor) -> query state on the same device.

    sa_impl 'runs' (default) is robust to the long equal-symbol runs of
    real genomes; 'kmer' is the dense-packed doubling variant.  `m_pad`,
    `tok_table`, `ell_bits` and `r1_keys` are the host-precomputed bounds
    of `ops/sa_host.py`.
    """
    if sa_impl == "runs":
        sa, bwt = _suffix_array_runs(
            s, syms=symbols if len(symbols) <= 7 else None, m_pad=m_pad,
            tok_table=tok_table, ell_bits=ell_bits, r1_keys=r1_keys,
            strategy=strategy)
    elif sa_impl == "kmer":
        table, bits = dense_table(symbols)
        sa = _suffix_array(s, torch.from_numpy(table), bits=bits,
                           strategy=strategy)
        bwt = bwt_device(s, sa)
    else:
        raise ValueError(f"sa_impl must be runs or kmer, got {sa_impl!r}")
    return build_device_block(bwt, sa, sf, symbols, strategy=strategy)
