"""PyTorch + CUDA port of masterthesis_tpu for NVIDIA Hopper.

Imports torch, numpy and the standard library only (PIL and cv2 inside the
data functions that read images, scipy inside FID's ``sqrtm``): nothing of
JAX, Flax or the JAX package. It serves AdaINModel and BaseModel (float
f32/bf16, and int8 after calibration), trains both, and has the train,
sample and evaluate CLIs (``python -m masterthesis_tpu_torch.train``,
``.sample``, ``.evaluate``) with the data tier, the checkpoints and the
metrics (FID, LPIPS); every TPU kernel of the JAX package has its
hand-written CUDA counterpart under ``csrc/``, wrapped with its plain
PyTorch version in ``ops/kernels``.
"""
