"""gecoz_tpu_torch: the PyTorch/CUDA port of gecoz_tpu for NVIDIA Hopper.

Ported: compress/index (FASTA -> .gcz/.gcx, byte-identical to gecoz_tpu),
decompress and GFF3 batch search on one card, and the CLI with every verb
of the reference.  The TPU kernels are hand-written CUDA kernels in
`csrc/`: the streaming scan (`scan.cu`), the backward search
(`fmsearch.cu`) and the LF walks (`lfwalk.cu`).

The package stands alone: it imports neither JAX nor gecoz_tpu.  The
reference's framework-free host modules have their copies here, laid out
as in gecoz_tpu: `formats/` (FASTA, the .gcz/.gcx container), `index/`
(rank vectors, Huffman shape, wavelet trees, sampled SA, host FM-index),
`huffman/`, `utils/` (bits, metrics, host memory), `ops/sa.py`,
`tools/blocks.py`, and the host C++ in `csrc/host/` (SA-IS, LF walks,
wavelet fill), bound in `native.py` and built with g++ at first use.
"""

__version__ = "0.1.0"
