"""Device operations of the encode path (PyTorch; CUDA kernels in csrc/)."""
