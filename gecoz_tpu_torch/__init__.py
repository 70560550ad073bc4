"""gecoz_tpu_torch: the PyTorch/CUDA port of gecoz_tpu for NVIDIA Hopper.

Ported: compress/index (FASTA -> .gcz/.gcx, byte-identical to gecoz_tpu),
decompress and GFF3 batch search on one card, and the CLI with every verb
of the reference.  The TPU kernels are hand-written CUDA kernels in
`csrc/`: the streaming scan (`scan.cu`), the backward search
(`fmsearch.cu`) and the LF walks (`lfwalk.cu`).  The framework-free host
modules of gecoz_tpu (formats,
index serializers, Huffman shape, C++ SA-IS, block planner) are imported,
not copied; nothing here imports JAX.
"""

import os

# gecoz_tpu/__init__.py sets up a JAX compile cache (importing jax) unless
# told not to; this package must import on machines without JAX
os.environ["GECOZ_NO_COMPILE_CACHE"] = "1"

__version__ = "0.1.0"
