"""PyTorch + CUDA port of masterthesis_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only: nothing of JAX, Flax or
the JAX package. The first slice serves AdaINModel's float forward, with the
norm statistics and AdaIN as CUDA kernels (``ops/kernels``).
"""
