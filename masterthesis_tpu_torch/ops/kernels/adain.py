"""Adaptive instance norm forward, the norm of every decoder resblock.

``adain`` is the wrapper: on a CPU tensor it runs :func:`adain_plain`, on a
CUDA tensor it launches ``csrc/adain.cu`` (which replaces
``masterthesis_tpu/ops/pallas/adain.py`` ``_pallas_adain_fwd``) or raises.
``adain.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from masterthesis_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# the kernel stages one (b, c) plane in shared memory; a block can hold at
# most 227 KB of it on Hopper
MAX_PLANE_BYTES = 232448


def adain_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5):
    """(1 + gamma) * IN(x) + beta with a centered variance, in x's dtype.

    x: (B, C, H, W); gamma, beta: (B, C). The arithmetic of the kernel.
    """
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    scale = (1.0 + gamma.float())[:, :, None, None] * torch.rsqrt(var + eps)
    shift = beta.float()[:, :, None, None] - mean * scale
    return (x32 * scale + shift).to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load("adain")
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"mt_adain_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _I64, _I64, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


def adain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5):
    """x (B, C, H, W) f32 or bf16, gamma and beta f32 (B, C) -> x's shape and dtype.

    Forward only: raises if a gradient is required.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta)):
        raise RuntimeError("adain has no backward yet; call it under torch.inference_mode()")
    if x.device.type == "cpu":
        return adain_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"adain runs on CPU or CUDA tensors, not {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(
            f"adain takes a contiguous 4-D f32 or bf16 x, got {tuple(x.shape)} {x.dtype} "
            f"contiguous={x.is_contiguous()}"
        )
    b, c, h, w = x.shape
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (
            t.shape != (b, c) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != x.device
        ):
            raise ValueError(
                f"adain: {name} must be contiguous f32 ({b}, {c}) on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if h * w * x.element_size() > MAX_PLANE_BYTES:
        raise ValueError(
            f"adain: a {h}x{w} {x.dtype} plane does not fit in one block's shared memory"
        )
    if b * c >= 2**31:
        raise ValueError(f"adain: {b * c} planes exceed the grid")
    out = torch.empty_like(x)
    lib = _library()
    fn = getattr(lib, f"mt_adain_{_DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            b * c, h * w, float(eps), build.stream_of(x),
        )
    build.check(lib, err, "adain")
    adain.launches += 1
    return out


adain.launches = 0
