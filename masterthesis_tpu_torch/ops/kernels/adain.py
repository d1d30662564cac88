"""Adaptive instance norm forward, the norm of every decoder resblock.

``adain`` is the wrapper, around the op ``masterthesis_tpu_torch::adain``
(``library.py``): on a CPU tensor it runs :func:`adain_plain`, on a CUDA
tensor it launches ``csrc/adain.cu`` (:func:`adain_cuda`, which replaces
``masterthesis_tpu/ops/pallas/adain.py`` ``_pallas_adain_fwd``) or raises.
``adain.launches`` counts the kernel's launches.

``adain_stats`` is the same norm with its (B, C) mean and rstd given (the
spatially sharded forward's, from the statistics of the whole image): on a
CPU tensor :func:`adain_stats_plain`, on a CUDA tensor the file's second
entry, ``mt_adain_stats_*``, or it raises; ``adain_stats.launches`` counts
its launches.
"""
from __future__ import annotations

import ctypes

import torch

from masterthesis_tpu_torch.ops.kernels import build, library
from masterthesis_tpu_torch.utils import profiling

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


def adain_stats_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x * scale + shift in x's dtype, scale = (1 + gamma) * rstd and shift =
    beta - mean * scale; every operand but x (B, C) f32. The kernel rounds
    each product and sum on its own, in this order."""
    scale = (1.0 + gamma.float()) * rstd.float()
    shift = beta.float() - mean.float() * scale
    return (x.float() * scale[:, :, None, None] + shift[:, :, None, None]).to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = build.load("adain")
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"mt_adain_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _I64, _I64, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"mt_adain_stats_{suffix}")
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I64, _I64, _P]
        fn.restype = ctypes.c_int
    return lib


def _check_x(what: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(
            f"{what} takes a contiguous 4-D f32 or bf16 x, got {tuple(x.shape)} {x.dtype} "
            f"contiguous={x.is_contiguous()}"
        )
    if x.shape[0] * x.shape[1] >= 2**31:
        raise ValueError(f"{what}: {x.shape[0] * x.shape[1]} planes exceed the grid")


def _check_planes(what: str, x: torch.Tensor, **operands) -> None:
    b, c = x.shape[:2]
    for name, t in operands.items():
        if (
            t.shape != (b, c) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != x.device
        ):
            raise ValueError(
                f"{what}: {name} must be contiguous f32 ({b}, {c}) on {x.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )


def adain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5):
    """x (B, C, H, W) f32 or bf16, gamma and beta f32 (B, C) -> x's shape and
    dtype. Its gradient is ``ops/norms.py``'s."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"adain runs on CPU or CUDA tensors, not {x.device}")
    return library.call("adain", x, gamma, beta, float(eps))


def adain_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5):
    """One launch of the kernel: :func:`adain` on a CUDA tensor."""
    with profiling.span("mt.k.adain"):
        _check_x("adain", x)
        _check_planes("adain", x, gamma=gamma, beta=beta)
        b, c, h, w = x.shape
        if h * w * x.element_size() > MAX_PLANE_BYTES:
            raise ValueError(
                f"adain: a {h}x{w} {x.dtype} plane does not fit in one block's shared memory"
            )
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


def _adain_cpu(x, gamma, beta, eps):
    # looks adain_plain up at each call, so that a substitute for it runs
    return adain_plain(x, gamma, beta, eps)


def _adain_fake(x, gamma, beta, eps):
    return torch.empty_like(x)


adain.launches = 0
library.register("adain", "(Tensor x, Tensor gamma, Tensor beta, float eps) -> Tensor",
                 _adain_cpu, adain_cuda, _adain_fake)


def adain_stats(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) f32 or bf16, mean, rstd, gamma, beta f32 (B, C) -> x's
    shape and dtype (no gradient: the sharded forward serves)."""
    if x.device.type == "cpu":
        return adain_stats_plain(x, mean, rstd, gamma, beta)
    with profiling.span("mt.k.adain_stats"):
        _check_x("adain_stats", x)
        _check_planes("adain_stats", x, mean=mean, rstd=rstd, gamma=gamma, beta=beta)
        b, c, h, w = x.shape
        out = torch.empty_like(x)
        lib = _library()
        fn = getattr(lib, f"mt_adain_stats_{_DTYPES[x.dtype]}")
        with torch.cuda.device(x.device):
            err = fn(
                x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                out.data_ptr(), b * c, h * w, build.stream_of(x),
            )
        build.check(lib, err, "adain_stats")
        adain_stats.launches += 1
        return out


adain_stats.launches = 0
