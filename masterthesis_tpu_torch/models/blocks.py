"""Conv blocks of AdaINModel, BaseModel and their discriminators (NCHW).

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
3x3 pad-1 convs (stride 1 and 2), the resblocks and the k3/s2/p1/op1
transposed convs through ``ops/kernels/int8_conv.py``, and the 1x1 head after a deferred
LayerNorm through ``ops/kernels/head.py``. A norm is deferred only into a
consumer that takes it in a kernel: its block, called with ``defer_norm``,
returns ``(y, pending)``, pending its norm and activation as a
:class:`kint8.Pending` (or None where it applied them), and every other
consumer of a pending norm applies it inline (:meth:`kint8.Pending.apply`).
The content encoder asks for it where the next down's conv runs int8
(``_Int8State.int8``); the decoders always ask, and an upsample defers only
from its int8 transposed conv's statistics.

int8 training (``--int8_train``, ``TranslationModel.calibrate_quant_train``).
A conv holds a second amax, ``train_amax``, apart from the serving
``amax_in``, as the JAX package keeps ``_train_quant`` apart from
``quant_cols``. Inside ``ops/qat.qat_trace`` (the main training step) an
eligible conv with one (the 3x3 pad-1 convs at stride 1, scope "conv", and
2, "stride2"; the (3, 2, 1, 1) transposed convs, "deconv") whose kind is in
the step's scope runs its straight-through Function of ``ops/qat.py``, from
weights quantized on the device again whenever they changed
(:meth:`_Int8State.train_quant`); any other conv runs float. The serving
routes (deferred norms, in-kernel statistics, the whole-block kernels 6, 9
and 10) stay off there, as in ``masterthesis_tpu/models/blocks.py:257-281``,
``:459-475`` and ``:870-876``.

Training. Inside ``resblock_train.fused_train_trace`` (the main training
step), a ``ResnetBlock`` with instance norm and relu, or an
``AdaINResnetBlock`` with relu or no activation, whose input passes the JAX
package's gate (``resblock_train_eligible``: C % 128 == 0, H, W >= 8, a byte
cap) runs as one differentiable whole-block op, kernels 9 and 10
(``ops/kernels/resblock_train.py``), as ``blocks.py`` ``_fused_train`` of the
JAX package does; the same blocks route there, so the two packages compare
like with like. Elsewhere the blocks compose, and autograd goes through the
norms' Functions.

Dropout. A block built with ``dropout`` (``ResnetBlock``,
``AdaINResnetBlock``, ``DecResnetBlock``) takes a keep ``mask`` of its
output's shape from its caller and applies Flax's ``nn.Dropout(0.5)`` with it
before the residual (:func:`dropout`); without a mask it is the identity,
the JAX block's ``deterministic=True``. It never draws one: the training step
does (``translation.StepDraws.masks``). Such a block never takes the
whole-block kernels (6, 9, 10), as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from masterthesis_tpu_torch.ops import norms, qat
from masterthesis_tpu_torch.ops.kernels import dec_mix as kmix
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kint8
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb
from masterthesis_tpu_torch.ops.norms import AdaptiveInstanceNorm, InstanceNorm, LayerNorm
from masterthesis_tpu_torch.ops.spectral import SpectralNorm
from masterthesis_tpu_torch.parallel import mesh as pmesh

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
    if padding_type == "reflect" and pad == 1 and 1 in x.shape[2:]:
        # jnp.pad reflects an axis of one value into copies of it (a small
        # discriminator's last maps); torch refuses, so that axis replicates
        h_mode, w_mode = ("replicate" if n == 1 else "reflect" for n in x.shape[2:])
        return F.pad(F.pad(x, (0, 0, 1, 1), mode=h_mode), (1, 1, 0, 0), mode=w_mode)
    return F.pad(x, (pad, pad, pad, pad), mode=padding_type)


def concat_label(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Broadcast per-sample codes (N, K), one-hot domains or a style, over
    H, W and concat them after x on channels."""
    n, _, h, w = x.shape
    c_map = c[:, :, None, None].expand(n, c.shape[1], h, w).to(x.dtype)
    return torch.cat([x, c_map], dim=1)


def avg_pool2d(x, window: int, stride: int, padding: int = 0, count_include_pad: bool = True):
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C)."""
    return x.mean(dim=(2, 3))


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Each pixel repeated ``factor`` x ``factor`` times."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def depth_to_space(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(N, f*f*C, H, W) -> (N, C, f*H, f*W) in the JAX package's channel
    order: output channel c at phase (i, j) reads input channel (f*i + j)*C
    + c (``F.pixel_shuffle`` reads f*f*c + f*i + j), so the conv weights and
    their per-output-channel int8 scales carry across unpermuted."""
    n, c4, h, w = x.shape
    c = c4 // (factor * factor)
    x = x.view(n, factor, factor, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, h * factor, w * factor)


class BatchNorm2d(nn.Module):
    """Batch normalization with the batch's statistics in training and in
    eval alike, and no running statistics (DESIGN.md divergence 6): per
    channel over (N, H, W), the biased variance as the mean square deviation,
    eps 1e-5, in f32, cast back to the input dtype; params ``scale`` and
    ``bias``. Two plain reductions, as the JAX package's two ``jnp.mean``s,
    which reach no Pallas kernel.

    ``group`` (data parallelism, set by ``Model.set_mesh``): the batch is
    split over the group's ranks, and both reductions are sums all-reduced
    over it (with their gradient), so the statistics are the global batch's,
    as under the JAX package's mesh. Every rank of the group runs each
    forward."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.group = None

    def forward(self, x):
        x32 = x.float()
        if self.group is None:
            mean = x32.mean(dim=(0, 2, 3), keepdim=True)
            var = (x32 - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        else:
            n = x32.numel() // x32.shape[1] * pmesh.group_size(self.group)
            mean = pmesh.all_reduce_sum(x32.sum(dim=(0, 2, 3), keepdim=True), self.group) / n
            var = pmesh.all_reduce_sum((x32 - mean).square().sum(dim=(0, 2, 3), keepdim=True),
                                       self.group) / n
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float()[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


def make_norm(name: Optional[str], features: int):
    if name is None:
        return None
    if name == "batch":
        return BatchNorm2d(features)
    if name == "instance":
        return InstanceNorm()
    if name == "layer":
        return LayerNorm(features)
    raise NotImplementedError(f"norm type '{name}' is not supported at the moment")


class _Int8State(nn.Module):
    """Calibration and int8 state of a conv. ``calib_amax`` is the running
    amax while calibrating; ``amax_in`` (a non-persistent buffer, so outside
    the state_dict) the installed one; the quantized weights are built from
    the float ones at the first int8 call and dropped by :meth:`set_amax`
    and :meth:`drop_quant`. ``train_amax`` is the ``--int8_train`` one
    (:meth:`set_train_amax`), with its activation scales made once; its
    quantized weights (:meth:`train_quant`) are built at the first QAT
    forward after each update or load, which call :meth:`drop_quant`."""

    calibrates = True

    def _init_int8(self) -> None:
        self.register_buffer("amax_in", None, persistent=False)
        self.calib_amax: Optional[torch.Tensor] = None
        self._quant = None
        self.train_amax: Optional[torch.Tensor] = None
        self._train_scales = None  # kint8.act_scales(train_amax), inv_sx on the device
        self._train_quant = None

    def record_amax(self, x: torch.Tensor) -> None:
        if self.calib_amax is not None and x.numel():
            self.calib_amax = torch.maximum(self.calib_amax, x.detach().abs().amax().float())

    def set_amax(self, amax) -> None:
        """Install an amax (a scalar), or None for the float path."""
        self.amax_in = None if amax is None else torch.as_tensor(
            amax, dtype=torch.float32).reshape(()).to(self.weight.device)
        self._quant = None

    def drop_quant(self) -> None:
        """The weights changed: quantize them again at the next int8 call."""
        self._quant = self._train_quant = None

    @property
    def int8(self) -> bool:
        """Whether the serving int8 route is on (never inside a QAT step)."""
        return self.amax_in is not None and self.calib_amax is None and not qat.qat_trace_mode()

    def quant(self) -> kint8.QuantConv:
        if self._quant is None:
            self._quant = self._make_quant()
        return self._quant

    def set_train_amax(self, amax) -> None:
        """Install an ``--int8_train`` amax (a scalar), or None: its scales
        are made here, on the CPU, once per calibration."""
        self._train_quant = None
        if amax is None:
            self.train_amax = self._train_scales = None
            return
        a = torch.as_tensor(amax, dtype=torch.float32).detach().reshape(())
        inv, sx = kint8.act_scales(a)
        dev = self.weight.device
        self.train_amax = a.to(dev)
        self._train_scales = (inv.to(dev), sx.to(dev))

    def train_quant(self) -> kint8.QuantConv:
        """The QAT QuantConv of the current weights, quantized on their
        device at the first QAT forward after :meth:`drop_quant`: once per
        update, not once per forward."""
        if self._train_quant is None:
            with torch.no_grad():
                self._train_quant = self._make_quant(self._train_scales)
        return self._train_quant


class Conv2d(_Int8State):
    """Conv with torch-style int padding, or an explicit reflect/replicate pad
    in front of an unpadded conv. Weight OIHW.

    int8: a 3x3/p1 conv with ``amax_in`` runs :func:`kint8.conv3x3`
    (stride 1) or :func:`kint8.downconv` (stride 2), with the
    per-(sample, channel) stats when ``serving_stats`` (set by a ConvBlock
    with instance norm), as the JAX ``_int8_eligible`` convs do off the TPU.
    Other convs (the 7x7 stem, the 1x1 mix convs) calibrate but stay float.

    ``sn`` (the discriminators' convs under ``--dis_sn``): the kernel goes
    through its :class:`SpectralNorm` ``sn`` on every float forward."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, padding_type: Optional[str] = None,
                 sn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.padding_type, self.dtype = stride, padding, padding_type, dtype
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.sn = SpectralNorm(features) if sn else None
        self.serving_stats = False
        self._init_int8()

    @property
    def fan_in(self) -> int:
        return self.weight[0].numel()

    def _make_quant(self, scales=None) -> kint8.QuantConv:
        return kint8.quant_conv(self.weight, self.bias, self.amax_in, self.stride,
                                self.padding_type, scales)

    def forward(self, x, pending: Optional[kint8.Pending] = None):
        """``pending``: a deferred norm from the previous block, applied in
        the int8 kernel's prologue or else inline. Returns y, or
        (y, sum, sumsq) from an int8 conv with ``serving_stats``."""
        if self.calib_amax is not None:
            self.record_amax(pending.apply(x, self.dtype) if pending is not None else x)
        eligible = (self.kernel_size, self.padding) == (3, 1) and self.stride in (1, 2)
        if self.int8 and eligible:
            conv = kint8.conv3x3 if self.stride == 1 else kint8.downconv
            return conv(x, self.quant(), pending, self.serving_stats)
        if pending is not None:
            x = pending.apply(x, self.dtype)
        if (qat.qat_trace_mode() and self.train_amax is not None and eligible and self.sn is None
                and ("conv" if self.stride == 1 else "stride2") in qat.qat_scope()):
            return qat.int8_conv3x3_ste(x, self.weight, self.bias, self.train_amax,
                                        self.padding_type, self.stride, self.dtype,
                                        self.train_quant())
        pad = self.padding
        if self.padding_type is not None:
            x = pad2d(x, pad, self.padding_type)
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        weight = self.weight if self.sn is None else self.sn(self.weight)
        return F.conv2d(x.to(self.dtype), weight.to(self.dtype), bias, self.stride, pad)


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

    def _make_quant(self, scales=None) -> kint8.QuantConv:
        return kint8.quant_deconv(self.weight, self.bias, self.amax_in, scales)

    def forward(self, x, pending: Optional[kint8.Pending] = None):
        if self.calibrates:
            self.record_amax(x)
            if self.int8:
                return kint8.deconv(x, self.quant(), pending, self.serving_stats)
        if pending is not None:
            x = pending.apply(x, self.dtype)
        if (self.calibrates and qat.qat_trace_mode() and self.train_amax is not None
                and "deconv" in qat.qat_scope()):
            return qat.int8_deconv_ste(x, self.weight, self.bias, self.train_amax, self.dtype,
                                       self.train_quant())
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
    """pad -> (spectrally normalized, ``sn``) conv -> norm -> activation.

    ``use_bias`` defaults to False, as in the JAX ConvBlock: the resblock
    convs and the 1x1 head have no bias, the stem, downs and ups ask for one.

    ``defer_norm`` (the int8 content encoder): the block returns ``(y,
    pending)``. An instance norm followed by relu/lrelu or nothing is not
    applied but is the pending :class:`kint8.Pending`, its statistics from
    the int8 conv, or from one moments launch after a float conv (the 7x7
    stem); any other block applies its own and hands on None.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = False, norm: Optional[str] = None,
                 activation: Optional[str] = None, padding_type: Optional[str] = None,
                 sn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel_size, stride, padding,
                           use_bias=use_bias, padding_type=padding_type, sn=sn, dtype=dtype)
        self.conv.serving_stats = norm == "instance"
        self.norm_type, self.activation, self.dtype = norm, activation, dtype
        self.norm = make_norm(norm, features)
        self.act = get_activation(activation)

    def forward(self, x, pending: Optional[kint8.Pending] = None, defer_norm: bool = False):
        out = self.conv(x, pending)
        stats = None
        if isinstance(out, tuple):
            y, s1, s2 = out
            n = y.shape[2] * y.shape[3]
            stats = (s1 / n, (s2 / n - (s1 / n).square()).clamp_min(0.0))
        else:
            y = out
        deferable = (defer_norm and self.norm_type == "instance"
                     and self.activation in (None, "relu", "lrelu"))
        if deferable and stats is None:
            mean, var = norms.moments(y)
            stats = (mean.flatten(1), var.flatten(1))
        if stats is not None:
            mean, var = stats
            a = torch.rsqrt(var + norms.EPS)
            if deferable:
                return y, kint8.Pending(a, -mean * a, self.activation is not None,
                                        0.01 if self.activation == "lrelu" else 0.0)
            y = kint8.Pending(a, -mean * a, False, 0.0).apply(y, self.dtype)
        elif self.norm is not None:
            y = self.norm(y)
        y = self.act(y) if self.act is not None else y
        return (y, None) if defer_norm else y


class UpsampleBlock(nn.Module):
    """Upsampling -> norm -> activation, by ``up_type``:

    - ``transpose``: a transposed conv (``conv``);
    - ``nearest``: a nearest 2x upsample, then a stride-1 ``ConvBlock``
      (``conv``, so the weight is ``conv.conv.weight``, the Flax
      ``conv/conv/kernel``);
    - ``pixelshuffle``: a stride-1 ``ConvBlock`` to 4 x ``features``
      channels (DESIGN.md divergence 4), then :func:`depth_to_space`.

    The ConvBlock of the last two has no norm and no activation; with int8
    serving its 3x3 conv runs :func:`kint8.conv3x3` (kernel 4) without
    prologue or statistics, as the JAX ``int8_conv3x3_ste`` does, and the
    block's norm runs after the upsample (a pending affine reaching such a
    block is applied inline first).

    ``defer_norm``: the block returns ``(y, pending)``. An int8 transposed
    upsample hands its LayerNorm (+ relu) on as the pending
    :class:`kint8.Pending`; any other applies its own and hands on None. A
    1x1 block without a norm (the tanh head) takes a pending LayerNorm in
    one :func:`khead.head` launch. Such a head given a per-image ``code``
    (N, K) reads it as the last K input channels, the same at every pixel
    (``DecoderConcat``'s z): their share of the 1x1 sum is
    :func:`khead.head`'s per-image term ``t``, in place of a concat of the
    code's planes.
    """

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, output_padding: int = 0, use_bias: bool = False,
                 norm: Optional[str] = None, activation: Optional[str] = None,
                 padding_type: Optional[str] = None, up_type: str = "transpose",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up_type = up_type
        self.transpose = "transpose" in up_type
        if self.transpose:
            self.conv = ConvTranspose2d(in_features, features, kernel_size, stride, padding,
                                        output_padding, use_bias=use_bias, dtype=dtype)
            self.conv.serving_stats = norm == "layer"
        elif "nearest" in up_type or "pixelshuffle" in up_type:
            width = features * (4 if "pixelshuffle" in up_type else 1)
            self.conv = ConvBlock(in_features, width, kernel_size, 1, padding, use_bias=use_bias,
                                  padding_type=padding_type, dtype=dtype)
        else:
            raise NotImplementedError(f"Mode {up_type} is not supported at the moment")
        self.activation, self.dtype = activation, dtype
        self.norm = make_norm(norm, features)
        self.act = get_activation(activation)

    def _finish(self, y, stats=None):
        if self.norm is not None:
            y = self.norm(y) if stats is None else self.norm(y, stats=stats)
        return self.act(y) if self.act is not None else y

    def forward(self, x, pending: Optional[kint8.Pending] = None, defer_norm: bool = False,
                code: Optional[torch.Tensor] = None):
        if not self.transpose:
            if pending is not None:
                x = pending.apply(x, self.dtype)
            if "nearest" in self.up_type:
                y = self._finish(self.conv(upsample_nearest(x)))
            else:
                y = self._finish(depth_to_space(self.conv(x)))
        elif (pending is not None and self.norm is None and self.conv.kernel_size == 1
                and self.conv.stride == 1 and self.activation in khead.ACTS):
            w = self.conv.weight[:, :, 0, 0].t().float()
            bias = None if self.conv.bias is None else self.conv.bias.float()
            t, c = None, x.shape[1]
            if code is not None:  # rounded as concat_label and the conv round them
                t = (code.to(x.dtype).float() @ w[:, c:].to(x.dtype).float().t()).contiguous()
            y = khead.head(x, pending, w[:, :c].contiguous(), bias, self.activation,
                           t).to(self.dtype)
        elif code is not None:
            raise ValueError("UpsampleBlock: a code goes only to a 1x1 head with a pending norm")
        else:
            out = self.conv(x, pending)
            if not isinstance(out, tuple):
                y = self._finish(out)
            elif (defer_norm and isinstance(self.norm, LayerNorm)
                  and self.activation in ("relu", None)):
                y, s1, s2 = out
                a, b = self.norm(y, stats=(s1, s2), defer=True)
                return y, kint8.Pending(a, b, self.activation == "relu", 0.0)
            else:
                y = self._finish(out[0], out[1:])
        return (y, None) if defer_norm else y


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


DROPOUT_RATE = 0.5


def dropout(h: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Flax ``nn.Dropout(0.5)`` with a given keep mask (bool, h's shape): the
    kept values scaled by 1 / (1 - rate), the others 0; h itself without a
    mask."""
    if mask is None:
        return h
    return torch.where(mask, h / (1.0 - DROPOUT_RATE), torch.zeros_like(h))


def _fused_train(x: torch.Tensor, padding_type: Optional[str]) -> bool:
    """The JAX package's routing of a training resblock to the whole-block op."""
    return (krb.fused_train_active(x) and padding_type in ("reflect", "zero", None)
            and krb.resblock_train_eligible(x))


class ResnetBlock(nn.Module):
    """conv -> norm -> act -> conv -> norm [-> dropout], plus the input.

    ``dropout``: the block applies its caller's mask (:func:`dropout`) and,
    as in the JAX package, stays off the whole-block int8 and training
    kernels, so its int8 convs compose through :func:`kint8.conv3x3` with
    statistics."""

    def __init__(self, features: int, norm: Optional[str] = "instance",
                 padding_type: Optional[str] = "reflect", activation: Optional[str] = "relu",
                 dropout: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBlock(features, features, 3, 1, 1, norm=norm, activation=activation,
                               padding_type=padding_type, dtype=dtype)
        self.conv2 = ConvBlock(features, features, 3, 1, 1, norm=norm,
                               padding_type=padding_type, dtype=dtype)
        self.padding_type, self.dtype, self.dropout = padding_type, dtype, dropout
        self.fusible = norm == "instance" and activation == "relu" and not dropout

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        if self.fusible and self.conv1.conv.int8 and self.conv2.conv.int8:
            zero = torch.zeros(x.shape[:2], device=x.device, dtype=torch.float32)
            return kint8.resblock(x, self.conv1.conv.quant(), self.conv2.conv.quant(), zero, zero)
        if self.fusible and _fused_train(x, self.padding_type):
            # instance norm: the block's affine is gamma = beta = 0
            zero = torch.zeros(x.shape[:2], device=x.device, dtype=torch.float32)
            return krb.fused_resblock(x.to(self.dtype), self.conv1.conv.weight,
                                      self.conv2.conv.weight, zero, zero, self.padding_type)
        return x + dropout(self.conv2(self.conv1(x)), mask)


class AdaINResnetBlock(nn.Module):
    """Residual block with one AdaIN, shared by both convs (its style
    projection too).

    ``dropout``: the block applies its caller's mask after the second AdaIN
    (:func:`dropout`) and, as in the JAX package, stays off the whole-block
    int8 and training kernels, so its int8 convs compose through
    :func:`kint8.conv3x3` with the AdaIN after each."""

    def __init__(self, features: int, style_dim: int, padding_type: Optional[str] = "reflect",
                 activation: Optional[str] = "relu", dropout: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adain = AdaptiveInstanceNorm(features, style_dim, dtype=dtype)
        self.activation, self.padding_type, self.dtype = activation, padding_type, dtype
        self.dropout = dropout
        self.fusible = activation in ("relu", None) and not dropout
        self.act = get_activation(activation)
        self.conv1 = ConvBlock(features, features, 3, 1, 1, padding_type=padding_type, dtype=dtype)
        self.conv2 = ConvBlock(features, features, 3, 1, 1, padding_type=padding_type, dtype=dtype)

    def _style_affine(self, z):
        """(gamma, beta) of the shared style projection in f32, matmul then
        bias as in JAX."""
        p = self.adain.style_proj
        h = z.float() @ p.weight.float().t() + p.bias.float()
        return (t.contiguous() for t in h.chunk(2, dim=-1))

    def forward(self, x, z, mask: Optional[torch.Tensor] = None):
        if self.fusible and self.conv1.conv.int8 and self.conv2.conv.int8:
            gamma, beta = self._style_affine(z)
            return kint8.resblock(x, self.conv1.conv.quant(), self.conv2.conv.quant(),
                                  gamma, beta, relu_mid=self.activation == "relu")
        if self.fusible and _fused_train(x, self.padding_type):
            gamma, beta = self._style_affine(z)
            return krb.fused_resblock(x.to(self.dtype), self.conv1.conv.weight,
                                      self.conv2.conv.weight, gamma, beta, self.padding_type,
                                      relu_mid=self.activation == "relu")
        h = self.act(self.adain(self.conv1(x), z))
        # no activation after the second AdaIN
        h = self.adain(self.conv2(h), z)
        return x + dropout(h, mask)


class DecResnetBlock(nn.Module):
    """BaseModel's decoder block: conv -> IN -> mix -> conv -> IN -> mix,
    plus the input, reflect padded. ``mix`` concatenates the block's style
    chunk, broadcast over H, W, after h ([h, z]) and runs two 1x1 convs with
    bias, each followed by relu. The 3x3 convs have no norm of their own
    (``norm1`` and ``norm2`` are separate modules), so int8 runs them
    through :func:`kint8.conv3x3` without prologue or statistics, and the
    norms take a moments launch each. ``dropout``: the block applies its
    caller's mask after ``mix2`` (:func:`dropout`).

    Serving in bf16 (float or int8 at bf16 compute), each norm and mix,
    with the residual add in the second, is one :func:`kmix.dec_mix` after
    the norm's moments launch, where :meth:`_takes_kernel` finds that it
    computes what the composed path does; elsewhere (f32, gradients,
    dropout masks, calibration, QAT, widths the kernel does not take) the
    block composes."""

    def __init__(self, features: int, style_dim: int, dropout: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        cat = features + style_dim
        self.conv1 = ConvBlock(features, features, 3, 1, 1, padding_type="reflect", dtype=dtype)
        self.norm1 = InstanceNorm()
        self.block1_a = Conv2d(cat, cat, 1, dtype=dtype)
        self.block1_b = Conv2d(cat, features, 1, dtype=dtype)
        self.conv2 = ConvBlock(features, features, 3, 1, 1, padding_type="reflect", dtype=dtype)
        self.norm2 = InstanceNorm()
        self.block2_a = Conv2d(cat, cat, 1, dtype=dtype)
        self.block2_b = Conv2d(cat, features, 1, dtype=dtype)

    def _takes_kernel(self, x, h, z, mask) -> bool:
        """Whether the mixes take the kernel, given the block's input x, its
        first conv's output h and the style chunk z: x and h bf16 and the
        1x1 convs computing in bf16, no gradient needed of x, h, z or any
        mix conv's parameter, no mask, no 1x1 conv recording its amax, no
        QAT step, and widths the kernel takes."""
        mixes = (self.block1_a, self.block1_b, self.block2_a, self.block2_b)
        params = (p for c in mixes for p in c.parameters())
        return (mask is None and x.dtype == h.dtype == self.block1_a.dtype == torch.bfloat16
                and not (torch.is_grad_enabled()
                         and any(t.requires_grad for t in (x, h, z, *params)))
                and all(c.calib_amax is None for c in mixes) and not qat.qat_trace_mode()
                and kmix.takes(h.shape[1], self.block1_a.weight.shape[0]))

    @staticmethod
    def _kernel_mix(a, b, norm, h, z, r=None):
        """One norm and mix (+ r) as :func:`kmix.dec_mix`, after the norm's
        moments launch."""
        mean, var = norms.moments(h)
        rstd = torch.rsqrt(var + norm.eps)
        return kmix.dec_mix(h, mean.flatten(1), rstd.flatten(1),
                            *kmix.operands(a.weight, a.bias, b.weight, b.bias, z, a.dtype), r)

    def forward(self, x, z, mask: Optional[torch.Tensor] = None):
        def mix(a, b, h):
            return F.relu(b(F.relu(a(concat_label(h, z)))))

        h = self.conv1(x)
        if self._takes_kernel(x, h, z, mask):
            h = self.conv2(self._kernel_mix(self.block1_a, self.block1_b, self.norm1, h, z))
            return self._kernel_mix(self.block2_a, self.block2_b, self.norm2, h, z, x)
        h = mix(self.block1_a, self.block1_b, self.norm1(h))
        return x + dropout(mix(self.block2_a, self.block2_b, self.norm2(self.conv2(h))), mask)


class GaussianNoise(nn.Module):
    """Adds ``noise``, a standard normal draw of x's shape that the caller
    makes while training, in x's dtype; the identity without one."""

    def forward(self, x, noise: Optional[torch.Tensor] = None):
        return x if noise is None else x + noise.to(x.dtype)
