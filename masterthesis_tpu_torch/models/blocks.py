"""Conv blocks on the AdaINModel inference path (NCHW).

The float branches of ``masterthesis_tpu/models/blocks.py``. Module and
attribute names follow the Flax names, so a state_dict key reads like the
JAX param path (``conv1.conv.weight`` for ``conv1/conv/kernel``).

Parameters stay f32; each op casts its input and weights to the block's
``dtype``, as the JAX modules do with ``dtype=bfloat16`` (the norm
statistics stay f32 inside ``ops/norms.py``). Convolutions, linears and
pools are cuDNN/cuBLAS calls: the JAX package leaves them to XLA, outside
any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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


class Conv2d(nn.Module):
    """Conv with torch-style int padding, or an explicit reflect/replicate pad
    in front of an unpadded conv. Weight OIHW."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, padding_type: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.padding_type, self.dtype = stride, padding, padding_type, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    @property
    def fan_in(self) -> int:
        return self.weight[0].numel()

    def forward(self, x):
        pad = self.padding
        if self.padding_type is not None:
            x = pad2d(x, pad, self.padding_type)
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias, self.stride, pad)


class ConvTranspose2d(nn.Module):
    """Transposed conv with torch's (k, s, p, output_padding) arithmetic.
    Weight IOHW: the JAX kernel (HWIO, applied unflipped by
    ``conv_transpose(transpose_kernel=False)``) spatially flipped."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, output_padding: int = 0, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_features, features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    @property
    def fan_in(self) -> int:
        # k*k*in, as the JAX kernel (k, k, in, out) counts it
        return self.weight.shape[0] * self.weight[0, 0].numel()

    def forward(self, x):
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
    """

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = False, norm: Optional[str] = None,
                 activation: Optional[str] = None, padding_type: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel_size, stride, padding,
                           use_bias=use_bias, padding_type=padding_type, dtype=dtype)
        self.norm = make_norm(norm, features)
        self.act = get_activation(activation)

    def forward(self, x):
        y = self.conv(x)
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y) if self.act is not None else y


class UpsampleBlock(nn.Module):
    """Transposed-conv upsampling -> norm -> activation. Only the
    ``transpose`` up type is ported."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, output_padding: int = 0, use_bias: bool = False,
                 norm: Optional[str] = None, activation: Optional[str] = None,
                 up_type: str = "transpose", dtype: torch.dtype = torch.float32):
        super().__init__()
        if "transpose" not in up_type:
            raise NotImplementedError(f"up_type '{up_type}' is not ported yet")
        self.conv = ConvTranspose2d(in_features, features, kernel_size, stride, padding,
                                    output_padding, use_bias=use_bias, dtype=dtype)
        self.norm = make_norm(norm, features)
        self.act = get_activation(activation)

    def forward(self, x):
        y = self.conv(x)
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

    def forward(self, x):
        return x + self.conv2(self.conv1(x))


class AdaINResnetBlock(nn.Module):
    """Residual block with one AdaIN, shared by both convs (its style
    projection too)."""

    def __init__(self, features: int, style_dim: int, padding_type: Optional[str] = "reflect",
                 activation: Optional[str] = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adain = AdaptiveInstanceNorm(features, style_dim, dtype=dtype)
        self.act = get_activation(activation)
        self.conv1 = ConvBlock(features, features, 3, 1, 1, padding_type=padding_type, dtype=dtype)
        self.conv2 = ConvBlock(features, features, 3, 1, 1, padding_type=padding_type, dtype=dtype)

    def forward(self, x, z):
        h = self.act(self.adain(self.conv1(x), z))
        # no activation after the second AdaIN
        h = self.adain(self.conv2(h), z)
        return x + h


class GaussianNoise(nn.Module):
    """Additive noise while training; the identity at inference, which is
    all the port runs."""

    def forward(self, x):
        return x
