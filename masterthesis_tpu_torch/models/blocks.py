"""Conv blocks on the AdaINModel inference path (NCHW).

The float branches of ``masterthesis_tpu/models/blocks.py``. Module and
attribute names follow the Flax names, so a state_dict key reads like the
JAX param path (``conv1.conv.weight`` for ``conv1/conv/kernel``).

Parameters stay f32; each op casts its input and weights to the block's
``dtype``, as the JAX modules do with ``dtype=bfloat16`` (the norm
statistics stay f32 inside ``ops/norms.py``). Convolutions, linears and
pools are cuDNN/cuBLAS calls: the JAX package leaves them to XLA, outside
any Pallas kernel.

int8 serving (``TranslationModel.calibrate_int8``). While ``calib_amax`` is
set, a conv records the running max |input| (after any pending affine), as
the JAX convs sow ``amax_in``; the installed ``amax_in`` then routes the
stride-2 3x3 convs, the resblocks and the k3/s2/p1/op1 transposed convs
through ``ops/kernels/int8_conv.py``, and the 1x1 head after a deferred
LayerNorm through ``ops/kernels/head.py``. A block that gets ``defer_norm``
returns ``(y, pending)``: its norm and activation as a per-(sample, channel)
affine ``{"scale", "shift", "relu", "alpha"}`` that the next conv applies in
its quantize prologue.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from masterthesis_tpu_torch.ops import norms
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kint8
from masterthesis_tpu_torch.ops.norms import AdaptiveInstanceNorm, InstanceNorm, LayerNorm

ACTIVATIONS = {
    "relu": F.relu,
    "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def get_activation(name: Optional[str]):
    if name is None:
        return None
    if name not in ACTIVATIONS:
        raise NotImplementedError(f"activation type '{name}' is not supported at the moment")
    return ACTIVATIONS[name]


def pad2d(x: torch.Tensor, pad: int, padding_type: Optional[str]) -> torch.Tensor:
    """Spatial reflect/replicate padding of NCHW input."""
    if pad == 0 or padding_type is None:
        return x
    if padding_type not in ("reflect", "replicate"):
        raise NotImplementedError(f"padding type '{padding_type}' is not supported at the moment")
    return F.pad(x, (pad, pad, pad, pad), mode=padding_type)


def avg_pool2d(x, window: int, stride: int, padding: int = 0, count_include_pad: bool = True):
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C)."""
    return x.mean(dim=(2, 3))


def make_norm(name: Optional[str], features: int):
    if name is None:
        return None
    if name == "instance":
        return InstanceNorm()
    if name == "layer":
        return LayerNorm(features)
    raise NotImplementedError(f"norm type '{name}' is not ported yet")


def apply_pending(x: torch.Tensor, pending: dict, dtype: torch.dtype) -> torch.Tensor:
    """Apply a deferred norm affine (+ relu/lrelu) inline, where no kernel
    prologue takes it."""
    return kint8.prologue_plain(x, pending).to(dtype)


def split_pending(out):
    """(y, pending) from a block that may or may not have deferred its norm."""
    return out if isinstance(out, tuple) else (out, None)


class _Int8State(nn.Module):
    """Calibration and int8 state of a conv. ``calib_amax`` is the running
    amax while calibrating; ``amax_in`` (a non-persistent buffer, so outside
    the state_dict) the installed one; the quantized weights are built from
    the float ones at the first int8 call and dropped by :meth:`set_amax`
    and :meth:`drop_quant`."""

    calibrates = True

    def _init_int8(self) -> None:
        self.register_buffer("amax_in", None, persistent=False)
        self.calib_amax: Optional[torch.Tensor] = None
        self._quant = None

    def record_amax(self, x: torch.Tensor) -> None:
        if self.calib_amax is not None and x.numel():
            self.calib_amax = torch.maximum(self.calib_amax, x.detach().abs().amax().float())

    def set_amax(self, amax) -> None:
        """Install an amax (a scalar), or None for the float path."""
        self.amax_in = None if amax is None else torch.as_tensor(
            amax, dtype=torch.float32).reshape(()).to(self.weight.device)
        self._quant = None

    def drop_quant(self) -> None:
        self._quant = None

    @property
    def int8(self) -> bool:
        return self.amax_in is not None and self.calib_amax is None

    def quant(self) -> kint8.QuantConv:
        if self._quant is None:
            self._quant = self._make_quant()
        return self._quant


class Conv2d(_Int8State):
    """Conv with torch-style int padding, or an explicit reflect/replicate pad
    in front of an unpadded conv. Weight OIHW.

    int8: a 3x3/s2/p1 conv with ``amax_in`` runs :func:`kint8.downconv`,
    with the per-(sample, channel) stats when ``serving_stats`` (set by a
    ConvBlock with instance norm). The stride-1 3x3 convs of this model run
    int8 inside their resblock's kernel; alone they stay float (the int8
    stride-1 conv is the BaseModel slice's kernel)."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, padding_type: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.padding_type, self.dtype = stride, padding, padding_type, dtype
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.serving_stats = False
        self._init_int8()

    @property
    def fan_in(self) -> int:
        return self.weight[0].numel()

    def _make_quant(self) -> kint8.QuantConv:
        return kint8.quant_conv(self.weight, self.bias, self.amax_in, self.stride,
                                self.padding_type)

    def forward(self, x, pending: Optional[dict] = None):
        """``pending``: a deferred norm from the previous block, applied in
        the int8 kernel's prologue or else inline. Returns y, or
        (y, sum, sumsq) from the int8 down conv with ``serving_stats``."""
        if self.calib_amax is not None:
            self.record_amax(apply_pending(x, pending, self.dtype) if pending is not None else x)
        if self.int8 and (self.kernel_size, self.stride, self.padding) == (3, 2, 1):
            return kint8.downconv(x, self.quant(), pending, self.serving_stats)
        if pending is not None:
            x = apply_pending(x, pending, self.dtype)
        pad = self.padding
        if self.padding_type is not None:
            x = pad2d(x, pad, self.padding_type)
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias, self.stride, pad)


class ConvTranspose2d(_Int8State):
    """Transposed conv with torch's (k, s, p, output_padding) arithmetic.
    Weight IOHW: the JAX kernel (HWIO, applied unflipped by
    ``conv_transpose(transpose_kernel=False)``) spatially flipped.

    int8: the (3, 2, 1, 1) case with ``amax_in`` runs :func:`kint8.deconv`,
    with the per-(sample, channel) stats when ``serving_stats`` (set by an
    UpsampleBlock with LayerNorm). Only that case calibrates."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, output_padding: int = 0, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(in_features, features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.serving_stats = False
        self.calibrates = (kernel_size, stride, padding, output_padding) == (3, 2, 1, 1)
        self._init_int8()

    @property
    def fan_in(self) -> int:
        # k*k*in, as the JAX kernel (k, k, in, out) counts it
        return self.weight.shape[0] * self.weight[0, 0].numel()

    def _make_quant(self) -> kint8.QuantConv:
        return kint8.quant_deconv(self.weight, self.bias, self.amax_in)

    def forward(self, x, pending: Optional[dict] = None):
        if self.calibrates:
            self.record_amax(x)
            if self.int8:
                return kint8.deconv(x, self.quant(), pending, self.serving_stats)
        if pending is not None:
            x = apply_pending(x, pending, self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv_transpose2d(
            x.to(self.dtype), self.weight.to(self.dtype), bias,
            self.stride, self.padding, self.output_padding,
        )


class Dense(nn.Linear):
    """Linear layer computing in ``dtype``. The JAX ``blocks.Dense`` nests its
    params under ``Dense_0``; here they sit on the module itself."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features, bias=use_bias)
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class ConvBlock(nn.Module):
    """pad -> conv -> norm -> activation.

    ``use_bias`` defaults to False, as in the JAX ConvBlock: the resblock
    convs and the 1x1 head have no bias, the stem, downs and ups ask for one.

    ``defer_norm`` (the int8 content encoder): an instance norm followed by
    relu/lrelu or nothing is not applied but returned as ``(y, pending)``.
    Its statistics come from the int8 down conv, or from one moments launch
    after a float conv (the 7x7 stem).
    """

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = False, norm: Optional[str] = None,
                 activation: Optional[str] = None, padding_type: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel_size, stride, padding,
                           use_bias=use_bias, padding_type=padding_type, dtype=dtype)
        self.conv.serving_stats = norm == "instance"
        self.norm_type, self.activation, self.dtype = norm, activation, dtype
        self.norm = make_norm(norm, features)
        self.act = get_activation(activation)

    def forward(self, x, pending: Optional[dict] = None, defer_norm: bool = False):
        out = self.conv(x, pending)
        stats = None
        if isinstance(out, tuple):
            y, s1, s2 = out
            n = y.shape[2] * y.shape[3]
            stats = (s1 / n, (s2 / n - (s1 / n).square()).clamp_min(0.0))
        else:
            y = out
        deferable = defer_norm and self.norm_type == "instance" and (
            self.activation in (None, "relu", "lrelu")
        )
        if deferable and stats is None:
            mean, var = norms.moments(y)
            stats = (mean.flatten(1), var.flatten(1))
        if stats is not None:
            mean, var = stats
            a = torch.rsqrt(var + norms.EPS)
            if deferable:
                return y, {
                    "scale": a, "shift": -mean * a, "relu": self.activation is not None,
                    "alpha": 0.01 if self.activation == "lrelu" else 0.0,
                }
            y = apply_pending(y, {"scale": a, "shift": -mean * a}, self.dtype)
        elif self.norm is not None:
            y = self.norm(y)
        return self.act(y) if self.act is not None else y


class UpsampleBlock(nn.Module):
    """Transposed-conv upsampling -> norm -> activation. Only the
    ``transpose`` up type is ported.

    int8 serving: with ``defer_norm`` an int8 upsample hands its LayerNorm
    (+ relu) on as ``(y, pending)``; a 1x1 block without a norm (the tanh
    head) takes a pending LayerNorm in one :func:`khead.head` launch.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, output_padding: int = 0, use_bias: bool = False,
                 norm: Optional[str] = None, activation: Optional[str] = None,
                 up_type: str = "transpose", dtype: torch.dtype = torch.float32):
        super().__init__()
        if "transpose" not in up_type:
            raise NotImplementedError(f"up_type '{up_type}' is not ported yet")
        self.conv = ConvTranspose2d(in_features, features, kernel_size, stride, padding,
                                    output_padding, use_bias=use_bias, dtype=dtype)
        self.conv.serving_stats = norm == "layer"
        self.activation, self.dtype = activation, dtype
        self.norm = make_norm(norm, features)
        self.act = get_activation(activation)

    def forward(self, x, pending: Optional[dict] = None, defer_norm: bool = False):
        if (pending is not None and self.norm is None and self.conv.kernel_size == 1
                and self.conv.stride == 1 and self.activation in khead.ACTS):
            w = self.conv.weight[:, :, 0, 0].t().float().contiguous()
            bias = None if self.conv.bias is None else self.conv.bias.float()
            return khead.head(x, pending, w, bias, self.activation).to(self.dtype)
        out = self.conv(x, pending)
        if isinstance(out, tuple):
            y, s1, s2 = out
            if defer_norm and isinstance(self.norm, LayerNorm) and self.activation in ("relu", None):
                a, b = self.norm(y, stats=(s1, s2), defer=True)
                return y, {"scale": a, "shift": b, "relu": self.activation == "relu", "alpha": 0.0}
            y = self.norm(y, stats=(s1, s2))
        else:
            y = out
            if self.norm is not None:
                y = self.norm(y)
        return self.act(y) if self.act is not None else y


class DownResnetBlock(nn.Module):
    """Pre-activation residual downsampling block."""

    def __init__(self, in_features: int, features: int, norm: Optional[str] = "instance",
                 activation: Optional[str] = "lrelu", padding_type: Optional[str] = "reflect",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pre_norm = make_norm(norm, in_features)
        self.act = get_activation(activation)
        self.conv1 = ConvBlock(in_features, in_features, 3, 1, 1, use_bias=use_bias, norm=norm,
                               activation=activation, padding_type=padding_type, dtype=dtype)
        self.conv2 = ConvBlock(in_features, features, 3, 1, 1, use_bias=use_bias,
                               padding_type=padding_type, dtype=dtype)
        self.shortcut = Conv2d(in_features, features, 1, 1, 0, use_bias=use_bias, dtype=dtype)

    def forward(self, x):
        h = self.pre_norm(x) if self.pre_norm is not None else x
        h = self.act(h)
        # The original's quirk, kept: its pre-activation is an in-place
        # LeakyReLU on the block input, so without a pre-norm (AdaINModel's
        # style encoder has norm=None) the shortcut sees the ACTIVATED input.
        shortcut_in = x if self.pre_norm is not None else h
        h = self.conv2(self.conv1(h))
        h = avg_pool2d(h, 2, 2)
        s = self.shortcut(avg_pool2d(shortcut_in, 2, 2))
        return h + s


class ResnetBlock(nn.Module):
    """conv -> norm -> act -> conv -> norm, plus the input."""

    def __init__(self, features: int, norm: Optional[str] = "instance",
                 padding_type: Optional[str] = "reflect", activation: Optional[str] = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBlock(features, features, 3, 1, 1, norm=norm, activation=activation,
                               padding_type=padding_type, dtype=dtype)
        self.conv2 = ConvBlock(features, features, 3, 1, 1, norm=norm,
                               padding_type=padding_type, dtype=dtype)
        self.int8_ok = norm == "instance" and activation == "relu"

    def forward(self, x):
        if self.int8_ok and self.conv1.conv.int8 and self.conv2.conv.int8:
            zero = torch.zeros(x.shape[:2], device=x.device, dtype=torch.float32)
            return kint8.resblock(x, self.conv1.conv.quant(), self.conv2.conv.quant(), zero, zero)
        return x + self.conv2(self.conv1(x))


class AdaINResnetBlock(nn.Module):
    """Residual block with one AdaIN, shared by both convs (its style
    projection too)."""

    def __init__(self, features: int, style_dim: int, padding_type: Optional[str] = "reflect",
                 activation: Optional[str] = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adain = AdaptiveInstanceNorm(features, style_dim, dtype=dtype)
        self.activation = activation
        self.act = get_activation(activation)
        self.conv1 = ConvBlock(features, features, 3, 1, 1, padding_type=padding_type, dtype=dtype)
        self.conv2 = ConvBlock(features, features, 3, 1, 1, padding_type=padding_type, dtype=dtype)

    def forward(self, x, z):
        if self.activation in ("relu", None) and self.conv1.conv.int8 and self.conv2.conv.int8:
            # the shared style projection in f32, matmul then bias as in JAX
            p = self.adain.style_proj
            h = z.float() @ p.weight.float().t() + p.bias.float()
            gamma, beta = (t.contiguous() for t in h.chunk(2, dim=-1))
            return kint8.resblock(x, self.conv1.conv.quant(), self.conv2.conv.quant(),
                                  gamma, beta, relu_mid=self.activation == "relu")
        h = self.act(self.adain(self.conv1(x), z))
        # no activation after the second AdaIN
        h = self.adain(self.conv2(h), z)
        return x + h


class GaussianNoise(nn.Module):
    """Additive noise while training; the identity at inference, which is
    all the port runs."""

    def forward(self, x):
        return x
