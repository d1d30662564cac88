"""Quantization-aware training (``--int8_train``): int8 forward convs with a
straight-through backward.

The port of ``masterthesis_tpu/ops/qat.py``. :func:`int8_conv3x3_ste` and
:func:`int8_deconv_ste` are ``torch.autograd.Function``s:

- the FORWARD is exactly the serving int8 conv, without prologue or
  statistics: ``int8_conv.conv3x3`` (kernel 4) at stride 1,
  ``int8_conv.downconv`` (kernel 7) at stride 2, ``int8_conv.deconv``
  (kernel 5) for the (3, 2, 1, 1) transposed conv; y in the compute dtype;
- the BACKWARD is the float conv's, in the compute dtype, at the saved
  unquantized x, weight and bias (the straight-through estimator): the
  reflect or replicate pad (its backward through autograd), then
  ``aten.convolution_backward``, the call that autograd makes for the
  float conv's ``F.conv2d`` / ``F.conv_transpose2d``, so the gradients are
  the float conv's without running its forward again. The activation amax
  gets a zero gradient.

The kernel wrappers refuse inputs that need a gradient; inside
``Function.forward`` grad mode is off, so they are called there. A conv
whose kernel fails raises: nothing falls back to the float conv.

Routing (``models/blocks.py``): inside :func:`qat_trace` (the main training
step of a model with a QAT calibration installed), an eligible conv of a
kind in :func:`qat_scope` runs its STE Function; the serving-only chains
(deferred norms, in-kernel statistics, the whole-block kernels 6, 9 and 10)
stay off. The mode is a module global, as in the JAX package: it is set
only inside the context and restored after it.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from masterthesis_tpu_torch.ops.kernels import int8_conv as kint8

KINDS = frozenset({"conv", "stride2", "deconv"})

_qat_mode = False
_qat_scope = KINDS


def qat_trace_mode() -> bool:
    """True inside a QAT (``--int8_train``) step."""
    return _qat_mode


def qat_scope() -> frozenset:
    """Conv kinds the QAT step routes through the int8 STE Functions."""
    return _qat_scope


def parse_qat_scope(scope) -> frozenset:
    """Parse ``--int8_train_scope``: "all" or a comma list of
    conv/stride2/deconv (``masterthesis_tpu/ops/qat.py:69``)."""
    if scope in (None, "all", ""):
        return KINDS
    kinds = frozenset(s.strip() for s in str(scope).split(",") if s.strip())
    bad = kinds - KINDS
    if bad:
        raise ValueError(f"unknown --int8_train_scope kinds: {sorted(bad)}")
    return kinds


@contextlib.contextmanager
def qat_trace(scope: Optional[frozenset] = None):
    """Mark the enclosed step as quantization-aware training, with ``scope``
    (from :func:`parse_qat_scope`) for its duration only."""
    global _qat_mode, _qat_scope
    prev = _qat_mode, _qat_scope
    _qat_mode = True
    if scope is not None:
        _qat_scope = scope
    try:
        yield
    finally:
        _qat_mode, _qat_scope = prev


def _float_conv_grads(need, g, x, weight, bias, dtype, stride: int,
                      padding_type: Optional[str], transposed: bool):
    """(dx, dweight, dbias) of the float conv ``models/blocks.py`` runs:
    ``F.conv2d(pad(x).to(dtype), weight.to(dtype), bias.to(dtype), stride,
    pad)``, or ``F.conv_transpose2d(..., 2, 1, 1)``; each gradient in its
    input's dtype, or None where ``need`` (three bools) says it is not
    needed."""
    from masterthesis_tpu_torch.models.blocks import pad2d

    xd = x.detach().to(dtype)
    padded = padding_type in ("reflect", "replicate")
    if padded:
        xr = xd.requires_grad_(True)
        with torch.enable_grad():
            xp = pad2d(xr, 1, padding_type)
    else:
        xp = xd
    pad = 0 if padded else 1
    need = [bool(need[0]), bool(need[1]), bias is not None and bool(need[2])]
    dxp, dw, db = torch.ops.aten.convolution_backward(
        g.to(dtype), xp.detach(), weight.detach().to(dtype),
        None if bias is None else [bias.shape[0]], [stride, stride], [pad, pad], [1, 1],
        transposed, [1, 1] if transposed else [0, 0], 1, need)
    dx = None
    if need[0]:
        dx = torch.autograd.grad(xp, xr, dxp)[0] if padded else dxp
        dx = dx.to(x.dtype)
    return (dx, None if dw is None else dw.to(weight.dtype),
            None if db is None else db.to(bias.dtype))


class Int8ConvSTE(torch.autograd.Function):
    """3x3/p1 conv, stride 1 or 2: int8 forward (kernel 4 or 7), float
    straight-through backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, amax, qc: kint8.QuantConv, padding_type, dtype):
        ctx.save_for_backward(x, weight, bias, amax)
        ctx.conf = (qc.stride, padding_type, dtype)
        conv = kint8.conv3x3 if qc.stride == 1 else kint8.downconv
        return conv(x.contiguous(), qc).to(dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, amax = ctx.saved_tensors
        stride, padding_type, dtype = ctx.conf
        dx, dw, db = _float_conv_grads(ctx.needs_input_grad, g, x, weight, bias, dtype, stride,
                                       padding_type, False)
        return dx, dw, db, _zero_like(ctx, amax), None, None, None


class Int8DeconvSTE(torch.autograd.Function):
    """ConvTranspose(3, 2, 1, 1): int8 sub-pixel forward (kernel 5), float
    straight-through backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, amax, qc: kint8.QuantConv, dtype):
        ctx.save_for_backward(x, weight, bias, amax)
        ctx.dtype = dtype
        return kint8.deconv(x.contiguous(), qc).to(dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, amax = ctx.saved_tensors
        dx, dw, db = _float_conv_grads(ctx.needs_input_grad, g, x, weight, bias, ctx.dtype, 2,
                                       None, True)
        return dx, dw, db, _zero_like(ctx, amax), None, None


def _zero_like(ctx, amax):
    """amax's gradient: zero, where one is needed."""
    return torch.zeros_like(amax) if ctx.needs_input_grad[3] else None


def int8_conv3x3_ste(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], amax,
                     padding_type: Optional[str] = None, stride: int = 1,
                     out_dtype: torch.dtype = torch.bfloat16,
                     qc: Optional[kint8.QuantConv] = None) -> torch.Tensor:
    """3x3 conv (weight OIHW, NCHW x): int8 forward, float straight-through
    gradient. Differentiable in ``x``, ``weight`` and ``bias``; ``amax``
    (the calibrated per-tensor input range, a 0-dim tensor) gets a zero
    gradient. The forward equals ``int8_conv.conv3x3`` / ``downconv`` of the
    same arguments. ``padding_type`` None or "zero" is zero padding. ``qc``:
    the conv quantized beforehand (``quant_conv(weight, bias, amax,
    ...)``), else it is made here."""
    if qc is None:
        with torch.no_grad():
            qc = kint8.quant_conv(weight, bias, amax, stride, padding_type)
    if qc.stride != stride:
        raise ValueError(f"int8_conv3x3_ste: stride {stride}, QuantConv's {qc.stride}")
    return Int8ConvSTE.apply(x, weight, bias, amax, qc, padding_type, out_dtype)


def int8_deconv_ste(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], amax,
                    out_dtype: torch.dtype = torch.bfloat16,
                    qc: Optional[kint8.QuantConv] = None) -> torch.Tensor:
    """ConvTranspose(3, 2, 1, 1) (weight IOHW): int8 sub-pixel forward,
    float straight-through gradient; as :func:`int8_conv3x3_ste`."""
    if qc is None:
        with torch.no_grad():
            qc = kint8.quant_deconv(weight, bias, amax)
    return Int8DeconvSTE.apply(x, weight, bias, amax, qc, out_dtype)
