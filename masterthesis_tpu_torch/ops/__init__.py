"""Norms, initializers and the CUDA kernels under them."""
