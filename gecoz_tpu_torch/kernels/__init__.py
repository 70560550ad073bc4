"""Hand-written CUDA kernels: build and ctypes loading (`_build`)."""
