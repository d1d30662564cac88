"""The int8 decoder's 1x1 tanh head with the last upsample's LayerNorm.

``head`` is the wrapper, around the op ``masterthesis_tpu_torch::head``
(``library.py``): on a CPU tensor it runs :func:`head_plain`, on a CUDA
tensor it launches ``csrc/head.cu`` (:func:`head_cuda`, which replaces
``masterthesis_tpu/ops/pallas/conv_int8.py`` ``pallas_packed_head``) or
raises. One pass: the deferred per-(sample, channel) LayerNorm affine, relu,
the 1x1 conv C -> Co, bias and tanh. The TPU kernel's lane-packed layout is
not ported: the port's upsample writes NCHW, which the kernel reads as it is.
``head.launches`` counts the kernel's launches.

An optional per-image term ``t`` (B, Co) f32 joins each pixel's f32 sum over
C before any rounding: the share of the 1x1 conv of input channels that are
constant over each image. ``DecoderConcat`` passes its z channels so, as
``t = z W_z^T``, in place of concatenating z's planes after x. While the
program's recorder is on, the calls with a term add to the counter
``head.term_launches``.

The kernel's grid and the pixels each thread takes are computed here, by
:func:`head_tiling`, so that the CPU tests can check that every pixel of
every plane is covered once: a thread takes one run, a 16-byte vector of
pixels (one element per load where the planes are not 16-byte aligned), and
runs come in warp groups of 32.

x and the output are f32 or bf16. In bf16 both versions round where the
JAX package's CPU route does (``blocks.py`` ``_packed_head`` off the TPU:
``apply_pending`` to bf16, a bf16 1x1 conv, a bf16 bias add, tanh): the
affine and relu to bf16, the weights and bias to bf16, the f32 sum over the
channels (with ``t``) to bf16, the bias add to bf16, tanh to bf16. The
kernel sums the channels in another order than the plain version's conv, so
in bf16 an output can differ by a bf16 rounding step of the pre-tanh value
(see :data:`BF16_TOL`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.ops.kernels import build, library
from masterthesis_tpu_torch.ops.kernels.int8_conv import Pending
from masterthesis_tpu_torch.utils import profiling

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
MAX_OUT = 8  # output channels a thread keeps in registers (csrc/head.cu kMaxOut)
THREADS = 256  # threads per block (csrc/head.cu kThreads)
WARP = 32  # runs per warp group
VECTOR_BYTES = 16  # a run: one 16-byte vector of pixels
ACTS = (None, "tanh")
# kernel against plain version in bf16: two bf16 rounding steps of an output
# in [-1, 1] (2^-8 each in [0.5, 1)), from sums over C in another order
BF16_TOL = 2.0**-7


class HeadTiling(NamedTuple):
    """How one launch of ``csrc/head.cu`` covers the hw pixels of each of B
    samples: the grid is (blocks_per_sample, B), one run per thread."""

    elems: int  # pixels per run: one 16-byte vector of x's type
    vector: bool  # a run's pixels adjacent, one 16-byte copy per plane
    runs: int  # runs per plane, in whole warp groups
    blocks_per_sample: int


def head_tiling(hw: int, dtype: torch.dtype, aligned: bool = True) -> HeadTiling:
    """The tiling of a plane of ``hw`` pixels of ``dtype``. A run is one
    16-byte vector of pixels; runs come in warp groups of 32. When hw is a
    multiple of the vector and x is 16-byte aligned (``aligned``), every
    plane's runs are vectors; otherwise the kernel loads and stores one
    element at a time, lane l of a warp group taking pixels l, l + 32, ...
    of the group's 32 runs' span."""
    elems = VECTOR_BYTES // dtype.itemsize
    runs = WARP * math.ceil(hw / (WARP * elems))
    return HeadTiling(elems, aligned and hw % elems == 0, runs, math.ceil(runs / THREADS))


def head_plain(x: torch.Tensor, pending: Pending, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None, act: Optional[str] = "tanh",
               t: Optional[torch.Tensor] = None):
    """x (B, C, H, W) f32 or bf16; pending the deferred norm on x; weight
    (Co, C); bias (Co,) or None; t (B, Co) f32 or None, added to the f32 sum
    over C -> (B, Co, H, W) in x's dtype."""
    term = None if t is None else t.float()[:, :, None, None]
    w = weight.float()
    b = None if bias is None else bias.float()
    if x.dtype == torch.bfloat16:  # weights and bias as bf16 values, as the kernel rounds them
        w = w.to(torch.bfloat16).float()
        b = None if b is None else b.to(torch.bfloat16).float()
    y = pending.apply(x)
    if x.dtype == torch.float32:
        if term is None:
            y = F.conv2d(y, w[:, :, None, None], b)
        else:
            y = F.conv2d(y, w[:, :, None, None]) + term
            y = y if b is None else y + b[:, None, None]
        return torch.tanh(y) if act == "tanh" else y
    y = F.conv2d(y.to(x.dtype).float(), w[:, :, None, None])
    y = (y if term is None else y + term).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)[:, None, None]
    return torch.tanh(y) if act == "tanh" else y


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("head")
    lib.mt_head.argtypes = [_P, _P, _P, _I32, _F32, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32,
                            _I32, _I64, _I64, _I32, _P]
    lib.mt_head.restype = ctypes.c_int
    return lib


def _checked(x: torch.Tensor, pending: Pending, weight: torch.Tensor,
             bias: Optional[torch.Tensor], t: Optional[torch.Tensor] = None):
    """The f32 weight and bias the kernel takes (it rounds them to bf16
    values itself for a bf16 x, as it stages them), after every check of
    what it cannot take, the term's among them; raises ValueError first."""
    b, c, h, w = x.shape
    co = weight.shape[0]
    if co > MAX_OUT:
        raise ValueError(f"head: {co} output channels, the kernel keeps at most {MAX_OUT}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"head: x must be contiguous f32 or bf16, got {x.dtype}")
    weight = weight.float().contiguous()
    bias = None if bias is None else bias.float()
    checks = [("scale", pending.scale, (b, c)), ("shift", pending.shift, (b, c)),
              ("weight", weight, (co, c))]
    if bias is not None:
        checks.append(("bias", bias, (co,)))
    if t is not None:
        checks.append(("t", t, (b, co)))
    for name, t, shape in checks:
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"head: {name} must be contiguous f32 {shape} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if b >= 2**16 or h * w >= 2**31:
        raise ValueError(f"head: {tuple(x.shape)} exceeds the grid")
    return weight, bias


def head(x: torch.Tensor, pending: Pending, weight: torch.Tensor,
         bias: Optional[torch.Tensor] = None, act: Optional[str] = "tanh",
         t: Optional[torch.Tensor] = None):
    """:func:`head_plain` on the card, in one launch. Forward only."""
    if act not in ACTS:
        raise ValueError(f"head: activation {act!r} is not one of {ACTS}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("head has no backward; call it under torch.inference_mode()")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"head runs on CPU or CUDA tensors, not {x.device}")
    if t is not None and profiling.ON:
        profiling.add("head.term_launches", 1)
    return library.call("head", x, pending.scale, pending.shift, pending.relu, pending.alpha,
                        weight, bias, act == "tanh", t)


def _head_cpu(x, scale, shift, relu, alpha, weight, bias, tanh, t=None):
    return head_plain(x, Pending(scale, shift, relu, alpha), weight, bias,
                      "tanh" if tanh else None, t)


def head_cuda(x, scale, shift, relu, alpha, weight, bias, tanh, t=None):
    """One launch of the kernel: :func:`head` on a CUDA tensor, the pending
    affine, the activation and the per-image term as the op passes them."""
    with profiling.span("mt.k.head"):
        weight, bias = _checked(x, Pending(scale, shift, relu, alpha), weight, bias, t)
        b, c, h, w = x.shape
        co = weight.shape[0]
        tiling = head_tiling(h * w, x.dtype, x.data_ptr() % VECTOR_BYTES == 0)
        out = torch.empty((b, co, h, w), device=x.device, dtype=x.dtype)
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.mt_head(
                x.data_ptr(), scale.data_ptr(), shift.data_ptr(), int(relu), float(alpha),
                weight.data_ptr(), None if bias is None else bias.data_ptr(),
                None if t is None else t.data_ptr(), out.data_ptr(),
                b, c, h * w, co, int(tanh), int(x.dtype == torch.bfloat16), tiling.runs,
                tiling.blocks_per_sample, int(tiling.vector), build.stream_of(x),
            )
        build.check(lib, err, "head")
        head.launches += 1
        return out


def _head_fake(x, scale, shift, relu, alpha, weight, bias, tanh, t=None):
    return x.new_empty((x.shape[0], weight.shape[0], x.shape[2], x.shape[3]))


head.launches = 0
# t defaults to None, so that a bundle exported before the term replays
library.register(
    "head", "(Tensor x, Tensor scale, Tensor shift, bool relu, float alpha, Tensor weight, "
    "Tensor? bias, bool tanh, Tensor? t=None) -> Tensor", _head_cpu, head_cuda, _head_fake)
