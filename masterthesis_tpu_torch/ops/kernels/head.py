"""The int8 decoder's 1x1 tanh head with the last upsample's LayerNorm.

``head`` is the wrapper: on a CPU tensor it runs :func:`head_plain`, on a
CUDA tensor it launches ``csrc/head.cu`` (which replaces
``masterthesis_tpu/ops/pallas/conv_int8.py`` ``pallas_packed_head``) or
raises. One pass: the deferred per-(sample, channel) LayerNorm affine, relu,
the 1x1 conv C -> Co, bias and tanh. The TPU kernel's lane-packed layout is
not ported: the port's upsample writes NCHW, which the kernel reads as it is.
``head.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.ops.kernels import build

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
MAX_OUT = 8  # output channels a thread keeps in registers (csrc/head.cu kMaxOut)
ACTS = (None, "tanh")


def head_plain(x: torch.Tensor, pending: dict, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None, act: Optional[str] = "tanh"):
    """x (B, C, H, W) f32; pending {"scale", "shift" (B, C), "relu", "alpha"};
    weight (Co, C) f32; bias (Co,) or None -> (B, Co, H, W) f32."""
    y = x.float() * pending["scale"][:, :, None, None] + pending["shift"][:, :, None, None]
    if pending.get("relu"):
        y = torch.maximum(y, float(pending.get("alpha", 0.0)) * y)
    y = F.conv2d(y, weight.float()[:, :, None, None], None if bias is None else bias.float())
    return torch.tanh(y) if act == "tanh" else y


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("head")
    lib.mt_head.argtypes = [_P, _P, _P, _I32, _F32, _P, _P, _P, _I64, _I64, _I64, _I64, _I32, _P]
    lib.mt_head.restype = ctypes.c_int
    return lib


def head(x: torch.Tensor, pending: dict, weight: torch.Tensor,
         bias: Optional[torch.Tensor] = None, act: Optional[str] = "tanh"):
    """:func:`head_plain` on the card, in one launch. Forward only."""
    if act not in ACTS:
        raise ValueError(f"head: activation {act!r} is not one of {ACTS}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("head has no backward; call it under torch.inference_mode()")
    if x.device.type == "cpu":
        return head_plain(x, pending, weight, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"head runs on CPU or CUDA tensors, not {x.device}")
    b, c, h, w = x.shape
    co = weight.shape[0]
    if co > MAX_OUT:
        raise ValueError(f"head: {co} output channels, the kernel keeps at most {MAX_OUT}")
    checks = [("x", x, (b, c, h, w)), ("scale", pending["scale"], (b, c)),
              ("shift", pending["shift"], (b, c)), ("weight", weight, (co, c))]
    if bias is not None:
        checks.append(("bias", bias, (co,)))
    for name, t, shape in checks:
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"head: {name} must be contiguous f32 {shape} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if b >= 2**16 or h * w >= 2**31:
        raise ValueError(f"head: {tuple(x.shape)} exceeds the grid")
    out = torch.empty((b, co, h, w), device=x.device, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mt_head(
            x.data_ptr(), pending["scale"].data_ptr(), pending["shift"].data_ptr(),
            int(bool(pending.get("relu"))), float(pending.get("alpha", 0.0)),
            weight.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, c, h * w, co, int(act == "tanh"), build.stream_of(x),
        )
    build.check(lib, err, "head")
    head.launches += 1
    return out


head.launches = 0
