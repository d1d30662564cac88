"""Per-(sample, channel) spatial sums, the statistics pass of every norm on
the float forward.

``moments`` is the wrapper: on a CPU tensor it runs :func:`moments_plain`,
on a CUDA tensor it launches ``csrc/moments.cu`` (which replaces
``masterthesis_tpu/ops/pallas/moments.py`` ``spatial_sums`` and
``spatial_sums_sbc``) or raises. ``moments.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes

import torch

from masterthesis_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) -> (sum, sumsq) over H, W, both f32 (B, C): summed in
    f64 and rounded once, as the kernel does."""
    x64 = x.double()
    return x64.sum(dim=(2, 3)).float(), (x64 * x64).sum(dim=(2, 3)).float()


def _library() -> ctypes.CDLL:
    lib = build.load("moments")
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"mt_moments_{suffix}")
        fn.argtypes = [_P, _P, _P, _I64, _I64, _P]
        fn.restype = ctypes.c_int
    return lib


def moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) f32 or bf16 -> (sum, sumsq) over H, W, both f32 (B, C).

    Forward only: raises if a gradient is required.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("moments has no backward yet; call it under torch.inference_mode()")
    if x.device.type == "cpu":
        return moments_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"moments runs on CPU or CUDA tensors, not {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(
            f"moments takes a contiguous 4-D f32 or bf16 tensor, got {tuple(x.shape)} "
            f"{x.dtype} contiguous={x.is_contiguous()}"
        )
    b, c, h, w = x.shape
    if b * c >= 2**31:
        raise ValueError(f"moments: {b * c} planes exceed the grid")
    s = torch.empty((b, c), device=x.device, dtype=torch.float32)
    sq = torch.empty_like(s)
    lib = _library()
    fn = getattr(lib, f"mt_moments_{_DTYPES[x.dtype]}")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), s.data_ptr(), sq.data_ptr(), b * c, h * w, build.stream_of(x))
    build.check(lib, err, "moments")
    moments.launches += 1
    return s, sq


moments.launches = 0
