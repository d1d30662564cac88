"""Per-(sample, channel) spatial sums, the statistics pass of every norm on
the float forward.

``moments`` is the wrapper, around the op ``masterthesis_tpu_torch::moments``
(``library.py``): on a CPU tensor it runs :func:`moments_plain`, on a CUDA
tensor it launches ``csrc/moments.cu`` (:func:`moments_cuda`, which replaces
``masterthesis_tpu/ops/pallas/moments.py`` ``spatial_sums`` and
``spatial_sums_sbc``) or raises. ``moments.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes

import torch

from masterthesis_tpu_torch.ops.kernels import build, library
from masterthesis_tpu_torch.utils import profiling

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) -> (sum, sumsq) over H, W, both f32 (B, C): summed in
    f64 and rounded once, as the kernel does; f64 for an f64 x."""
    x64 = x.double()
    out = torch.promote_types(x.dtype, torch.float32)
    return x64.sum(dim=(2, 3)).to(out), (x64 * x64).sum(dim=(2, 3)).to(out)


def _library() -> ctypes.CDLL:
    lib = build.load("moments")
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"mt_moments_{suffix}")
        fn.argtypes = [_P, _P, _P, _I64, _I64, _P]
        fn.restype = ctypes.c_int
    return lib


def moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) f32 or bf16 -> (sum, sumsq) over H, W, both f32 (B, C).
    Its gradient is ``ops/norms.py``'s."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moments runs on CPU or CUDA tensors, not {x.device}")
    return library.call("moments", x)


def moments_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel: :func:`moments` on a CUDA tensor."""
    with profiling.span("mt.k.moments"):
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


def _moments_cpu(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # looks moments_plain up at each call, so that a substitute for it runs
    return moments_plain(x)


def _moments_fake(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    out = torch.promote_types(x.dtype, torch.float32)
    return x.new_empty(x.shape[:2], dtype=out), x.new_empty(x.shape[:2], dtype=out)


moments.launches = 0
library.register("moments", "(Tensor x) -> (Tensor, Tensor)", _moments_cpu, moments_cuda,
                 _moments_fake)
