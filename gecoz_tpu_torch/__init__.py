"""gecoz_tpu_torch: the PyTorch/CUDA port of gecoz_tpu for NVIDIA Hopper.

Ported so far: compress/index on one card (FASTA -> .gcz/.gcx, byte-identical
to gecoz_tpu), with the Pallas streaming scan rewritten as a CUDA kernel
(`csrc/scan.cu`).  The framework-free host modules of gecoz_tpu (formats,
index serializers, Huffman shape, C++ SA-IS, block planner) are imported,
not copied; nothing here imports JAX.
"""

import os

# gecoz_tpu/__init__.py sets up a JAX compile cache (importing jax) unless
# told not to; this package must import on machines without JAX
os.environ["GECOZ_NO_COMPILE_CACHE"] = "1"

__version__ = "0.1.0"
