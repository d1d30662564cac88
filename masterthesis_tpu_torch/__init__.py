"""PyTorch + CUDA port of masterthesis_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only (PIL and cv2 inside the
data functions that read images): nothing of JAX, Flax or the JAX package.
It serves AdaINModel and BaseModel (float f32/bf16, and int8 after
calibration), trains both, and has the train CLI (``python -m
masterthesis_tpu_torch.train``) with its data tier and checkpoints; every
TPU kernel of the JAX package has its hand-written CUDA counterpart under
``csrc/``, wrapped with its plain PyTorch version in ``ops/kernels``.
"""
