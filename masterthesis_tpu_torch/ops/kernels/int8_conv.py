"""int8 serving convolutions: the down conv, the whole residual block and the
transposed conv of AdaINModel's int8 forward.

Three wrappers, one CUDA source (``csrc/int8_conv.cu``):

- :func:`downconv` replaces ``masterthesis_tpu/ops/pallas/conv_int8.py``
  ``pallas_int8_downconv`` (3x3, stride 2, pad 1);
- :func:`resblock` replaces ``pallas_int8_resblock`` (q -> conv1 -> IN/AdaIN
  -> relu -> q -> conv2 -> norm -> + x), as two stride-1 convs of the same
  template;
- :func:`deconv` replaces ``pallas_int8_deconv`` (ConvTranspose k3/s2/p1/op1
  as a 2x2 sub-pixel conv to four phases, interleaved on store).

Every conv is a quantize-and-pad launch (optional prologue affine and
relu/lrelu, ``clip(round(x * 127/amax), +-127)`` half to even, reflect or
zero pad, into an int8 NHWC copy whose channels are padded to a multiple of
32) and an implicit-GEMM launch (int8 products, int32 sums, dequantize
``acc * (sx * sw_c) + bias_c`` in f32, NCHW f32 out, optional per-tile
int64 sums of the accumulators and their squares, from which a third launch
forms the per-(sample, channel) (sum, sumsq) of y exactly as
:func:`stats_plain` does: the statistics are the same bits on the card and
on the CPU, whatever the summation order).

On a CPU tensor each wrapper runs its plain version, which does the same
arithmetic with torch ops: the integer conv runs in float64, which is exact
(|acc| <= 9 * 256 * 127^2 < 2^53; f32 would not be, past 2^24). On a CUDA
tensor it launches the kernels or raises. Each wrapper counts its calls that
launch the kernels in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.ops.kernels import build

INT8_MAX = 127.0
K_ALIGN = 32  # channel padding of the int8 operands: one mma k-step
TILE_M = 64  # output pixels per conv block (csrc/int8_conv.cu kTileM)
_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


# --------------------------------------------------------------- quantize --


def act_scales(amax) -> tuple[torch.Tensor, torch.Tensor]:
    """(127 / amax, amax / 127) as f32 CPU tensors, each one correctly
    rounded division. Scales are made on the CPU: there torch divides, where
    ``127.0 / t`` and a CUDA tensor over a scalar multiply by a reciprocal."""
    a = torch.as_tensor(amax, dtype=torch.float32).detach().cpu().clamp_min(1e-12)
    return torch.full_like(a, INT8_MAX) / a, a / INT8_MAX


def quantize_act(x: torch.Tensor, amax) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``clip(round(x * (127 / amax)), +-127)``."""
    inv, sx = act_scales(amax)
    return _quantize(x, inv.to(x.device)), sx


def _quantize(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return torch.round(x.float() * inv).clamp(-INT8_MAX, INT8_MAX).to(torch.int8)


def quantize_weight(w: torch.Tensor, out_dim: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 over every other dim of ``w``, on
    the CPU (see :func:`act_scales`)."""
    w = w.detach().cpu()
    dims = [d for d in range(w.dim()) if d != out_dim]
    shape = [1] * w.dim()
    shape[out_dim] = -1
    scale = w.float().abs().amax(dim=dims).clamp_min(1e-12) / INT8_MAX
    q = torch.round(w.float() / scale.view(shape)).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def subpixel_weights(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Co) transposed-conv kernel in the JAX layout (HWIO, applied
    unflipped) -> (2, 2, C, 4Co) taps of a 2x2 VALID conv over the input
    zero-padded by one row and column at the end. Output phase (p, q) is
    channels [(2p + q) Co, (2p + q + 1) Co)."""
    c, co = k.shape[2], k.shape[3]
    w = k.new_zeros((2, 2, c, 4 * co))
    w[0, 0, :, 0:co] = k[1, 1]
    w[0, 0, :, co:2 * co] = k[1, 0]
    w[0, 1, :, co:2 * co] = k[1, 2]
    w[0, 0, :, 2 * co:3 * co] = k[0, 1]
    w[1, 0, :, 2 * co:3 * co] = k[2, 1]
    w[0, 0, :, 3 * co:] = k[0, 0]
    w[0, 1, :, 3 * co:] = k[0, 2]
    w[1, 0, :, 3 * co:] = k[2, 0]
    w[1, 1, :, 3 * co:] = k[2, 2]
    return w


@dataclass(frozen=True)
class QuantConv:
    """A conv's int8 operands, built once from its float weights and amax.

    ``w`` is (R, kh * kw, Cp) int8: R output rows (Co, or 4 Co phase rows for
    the transposed conv), taps, input channels zero-padded to Cp. ``scale``
    and ``bias`` are (R,) f32 (``bias`` may be None); ``inv_sx`` is the (1,)
    f32 127 / amax. ``pad`` is (top, bottom, left, right).
    """

    w: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor]
    inv_sx: torch.Tensor
    cin: int
    cout: int
    kh: int
    kw: int
    stride: int
    pad: tuple[int, int, int, int]
    reflect: bool
    phases: int  # 1, or 4 for the sub-pixel transposed conv

    @property
    def cp(self) -> int:
        return self.w.shape[2]


def _kernel_layout(w_rhwc: torch.Tensor) -> torch.Tensor:
    """(R, kh, kw, C) int8 -> (R, kh * kw, Cp) with zero channels to Cp."""
    r, kh, kw, c = w_rhwc.shape
    cp = -(-c // K_ALIGN) * K_ALIGN
    return F.pad(w_rhwc.reshape(r, kh * kw, c), (0, cp - c)).contiguous()


def quant_conv(weight: torch.Tensor, bias, amax, stride: int, padding_type: Optional[str]) -> QuantConv:
    """A 3x3, pad-1 Conv2d (weight OIHW) quantized for :func:`downconv` or a
    resblock conv. ``padding_type`` None is zero padding, as in the JAX
    package; 'replicate' has no kernel and is refused."""
    if padding_type not in (None, "zero", "reflect"):
        raise NotImplementedError(f"int8 conv: padding '{padding_type}' has no kernel")
    co, ci, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"int8 conv takes 3x3 kernels, got {kh}x{kw}")
    inv, sx = act_scales(amax)
    w_q, sw = quantize_weight(weight, out_dim=0)
    dev = weight.device
    return QuantConv(
        w=_kernel_layout(w_q.permute(0, 2, 3, 1)).to(dev),
        scale=(sx * sw).to(dev),
        bias=None if bias is None else bias.float().contiguous(),
        inv_sx=inv.reshape(1).to(dev),
        cin=ci, cout=co, kh=3, kw=3, stride=stride, pad=(1, 1, 1, 1),
        reflect=padding_type == "reflect", phases=1,
    )


def quant_deconv(weight: torch.Tensor, bias, amax) -> QuantConv:
    """A ConvTranspose2d(3, 2, 1, 1) (weight IOHW, the port's layout: the
    JAX kernel spatially flipped) quantized for :func:`deconv`."""
    ci, co, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"int8 deconv takes 3x3 kernels, got {kh}x{kw}")
    inv, sx = act_scales(amax)
    w_q, sw = quantize_weight(weight, out_dim=1)
    k = w_q.flip(2, 3).permute(2, 3, 0, 1)  # the JAX HWIO kernel
    w4 = subpixel_weights(k)  # (2, 2, C, 4Co)
    dev = weight.device
    b = torch.zeros(co, device=dev) if bias is None else bias.float()
    return QuantConv(
        w=_kernel_layout(w4.permute(3, 0, 1, 2)).to(dev),
        scale=(sx * sw).repeat(4).to(dev),
        bias=b.repeat(4).contiguous(),
        inv_sx=inv.reshape(1).to(dev),
        cin=ci, cout=co, kh=2, kw=2, stride=1, pad=(0, 1, 0, 1),
        reflect=False, phases=4,
    )


# ------------------------------------------------------------ plain path --


def prologue_plain(x: torch.Tensor, pending: Optional[dict]) -> torch.Tensor:
    """The deferred per-(sample, channel) affine and relu/lrelu, f32."""
    y = x.float()
    if pending is not None:
        y = y * pending["scale"][:, :, None, None]
        y = y + pending["shift"][:, :, None, None]
        if pending.get("relu"):
            y = torch.maximum(y, float(pending.get("alpha", 0.0)) * y)
    return y


def quant_pad_plain(x: torch.Tensor, qc: QuantConv, pending: Optional[dict] = None) -> torch.Tensor:
    """NCHW float -> padded NHWC int8 (B, Hp, Wp, Cp), as the kernel writes it."""
    q = _quantize(prologue_plain(x, pending), qc.inv_sx)
    t, b, l, r = qc.pad
    # integers up to 127 are exact in f32, which reflect padding needs
    q = F.pad(q.float(), (l, r, t, b), mode="reflect" if qc.reflect else "constant")
    q = F.pad(q.permute(0, 2, 3, 1), (0, qc.cp - qc.cin))
    return q.to(torch.int8).contiguous()


def conv_acc_plain(xq: torch.Tensor, qc: QuantConv) -> torch.Tensor:
    """Padded NHWC int8 -> int32 accumulators (B, R, Ho, Wo), exact via f64."""
    r = qc.w.shape[0]
    w = qc.w.reshape(r, qc.kh, qc.kw, qc.cp).permute(0, 3, 1, 2).double()
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w, stride=qc.stride)
    return acc.to(torch.int32)


def _interleave(y: torch.Tensor, phases: int) -> torch.Tensor:
    """(B, 4Co, H, W) phase-major -> (B, Co, 2H, 2W); the identity for 1 phase."""
    if phases == 1:
        return y
    b, r, h, w = y.shape
    co = r // 4
    return y.reshape(b, 2, 2, co, h, w).permute(0, 3, 4, 1, 5, 2).reshape(b, co, 2 * h, 2 * w)


def stats_plain(acc: torch.Tensor, qc: QuantConv) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum, sumsq) (B, Co) f32 of y = acc * scale + bias over all phases,
    from the exact integer sums of ``acc`` (B, R, Ho, Wo) and its squares,
    with the f64 steps of ``csrc/int8_conv.cu`` (see its Numerics note): each
    total rounded once to f64, sum = s A1 + n bias and sumsq = s^2 A2 +
    2 s bias A1 + n bias^2 per phase row, phases added in order, then f32."""
    a = acc.long()
    s1 = a.sum(dim=(2, 3))
    sq = a * a
    # the squares' total as 32-bit halves, each summed exactly
    d2 = (sq >> 32).sum(dim=(2, 3)).double() * 2.0**32 + (sq & 0xFFFFFFFF).sum(dim=(2, 3)).double()
    d1 = s1.double()
    sc = qc.scale.double()
    bi = torch.zeros_like(sc) if qc.bias is None else qc.bias.double()
    hw = float(acc.shape[2] * acc.shape[3])
    s_rows = sc * d1 + hw * bi
    q_rows = (sc * sc) * d2 + ((2.0 * sc) * bi) * d1 + hw * (bi * bi)
    co = qc.cout
    s = q = torch.zeros((acc.shape[0], co), dtype=torch.float64, device=acc.device)
    for ph in range(qc.phases):
        s = s + s_rows[:, ph * co:(ph + 1) * co]
        q = q + q_rows[:, ph * co:(ph + 1) * co]
    return s.float(), q.float()


def conv_padded_plain(xq: torch.Tensor, qc: QuantConv, with_stats: bool = False):
    """Padded int8 -> dequantized NCHW f32 y, and (sum, sumsq) (B, Co) of y."""
    acc = conv_acc_plain(xq, qc)
    y = acc.float() * qc.scale[:, None, None]
    if qc.bias is not None:
        y = y + qc.bias[:, None, None]
    y = _interleave(y, qc.phases).contiguous()
    if not with_stats:
        return y
    return (y, *stats_plain(acc, qc))


def conv_plain(x: torch.Tensor, qc: QuantConv, pending: Optional[dict] = None,
               with_stats: bool = False):
    return conv_padded_plain(quant_pad_plain(x, qc, pending), qc, with_stats)


def norm_affine_plain(s, sq, n: int, gamma, beta, eps: float = 1e-5):
    """IN/AdaIN as a per-(sample, channel) affine from f32 (sum, sumsq):
    a = (1 + gamma) / sqrt(max(var, 0) + eps), b = beta - mean * a."""
    n = torch.full_like(s, n)  # a divide, as the kernel does, not a reciprocal multiply
    mean = s / n
    var = (sq / n - mean * mean).clamp_min(0.0)
    # the correctly rounded f32 sqrt, as the kernel's __fsqrt_rn: torch's f32
    # sqrt on the CPU is not, while rounding the f64 sqrt to f32 is
    a = (1.0 + gamma) * torch.sqrt((var + eps).double()).float().reciprocal()
    return a, beta - mean * a


def residual_plain(x, h, a, b):
    return x + (h * a[:, :, None, None] + b[:, :, None, None])


def resblock_plain(x, q1: QuantConv, q2: QuantConv, gamma, beta, relu_mid: bool = True,
                   eps: float = 1e-5):
    """x + norm(conv2(relu(norm(conv1(x))))), both norms (1 + gamma, beta)."""
    n = x.shape[2] * x.shape[3]
    h1, s1, sq1 = conv_plain(x, q1, None, True)
    a1, b1 = norm_affine_plain(s1, sq1, n, gamma, beta, eps)
    mid = {"scale": a1, "shift": b1, "relu": relu_mid, "alpha": 0.0}
    h2, s2, sq2 = conv_plain(h1, q2, mid, True)
    a2, b2 = norm_affine_plain(s2, sq2, n, gamma, beta, eps)
    return residual_plain(x, h2, a2, b2)


# ------------------------------------------------------------ the kernels --


@functools.cache
def _library() -> ctypes.CDLL:
    """The library with its entry points typed, once per process: the
    wrappers run on every conv of a forward."""
    lib = build.load("int8_conv")
    sigs = {
        "mt_int8_quant_pad": [_P, _P, _P, _P, _P, _I32, _F32] + [_I64] * 9 + [_I32, _P],
        "mt_int8_conv": [_P] * 7 + [_I64] * 11 + [_I32, _P],
        "mt_int8_stats": [_P] * 10 + [_I64] * 5 + [_F32, _F32, _P],
        "mt_int8_residual": [_P] * 5 + [_I64, _I64, _P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_f32(what: str, t: torch.Tensor, shape, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(
            f"{what}: needs a contiguous f32 {tuple(shape)} tensor on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device} contiguous={t.is_contiguous()}"
        )


def _check_input(what: str, x: torch.Tensor, qc: QuantConv) -> None:
    if x.dim() != 4 or x.shape[1] != qc.cin:
        raise ValueError(f"{what}: x must be (B, {qc.cin}, H, W), got {tuple(x.shape)}")
    _check_f32(what, x, x.shape, x.device)
    for name, t in (("weights", qc.w), ("scale", qc.scale), ("bias", qc.bias),
                    ("inv_sx", qc.inv_sx)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
    t, b, l, r = qc.pad
    if qc.reflect and (x.shape[2] <= max(t, b) or x.shape[3] <= max(l, r)):
        raise ValueError(f"{what}: reflect padding needs H, W > 1, got {tuple(x.shape)}")


def quant_pad_cuda(x: torch.Tensor, qc: QuantConv, pending: Optional[dict] = None) -> torch.Tensor:
    """The quantize-and-pad launch: :func:`quant_pad_plain` on the card."""
    b, c, h, w = x.shape
    t, bo, l, r = qc.pad
    hp, wp = h + t + bo, w + l + r
    out = torch.empty((b, hp, wp, qc.cp), device=x.device, dtype=torch.int8)
    pa = pb = None
    relu, alpha = 0, 0.0
    if pending is not None:
        pa, pb = pending["scale"], pending["shift"]
        _check_f32("prologue scale", pa, (b, c), x.device)
        _check_f32("prologue shift", pb, (b, c), x.device)
        relu, alpha = int(bool(pending.get("relu"))), float(pending.get("alpha", 0.0))
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mt_int8_quant_pad(
            x.data_ptr(), out.data_ptr(), qc.inv_sx.data_ptr(), _ptr(pa), _ptr(pb), relu, alpha,
            b, c, h, w, qc.cp, hp, wp, t, l, int(qc.reflect), build.stream_of(x),
        )
    build.check(lib, err, "int8 quantize-and-pad")
    return out


def conv_padded_cuda(xq: torch.Tensor, qc: QuantConv, with_stats: bool = False,
                     gamma=None, beta=None, eps: float = 1e-5):
    """The implicit-GEMM launch (and the stats launch): y, and with stats
    (sum, sumsq), or with ``gamma``/``beta`` the norm affine (a, b) of
    :func:`norm_affine_plain` computed from them in the stats launch."""
    b, hp, wp, cp = xq.shape
    if xq.dtype != torch.int8 or not xq.is_contiguous() or cp != qc.cp:
        raise ValueError(f"int8 conv: padded input must be contiguous int8 (B, Hp, Wp, {qc.cp})")
    ho, wo = (hp - qc.kh) // qc.stride + 1, (wp - qc.kw) // qc.stride + 1
    f = 2 if qc.phases == 4 else 1
    r = qc.w.shape[0]
    y = torch.empty((b, qc.cout, f * ho, f * wo), device=xq.device, dtype=torch.float32)
    tiles = math.ceil(ho * wo / TILE_M)
    if b * tiles >= 2**31 or ho * wo >= 2**31:
        raise ValueError("int8 conv: output exceeds the grid")
    psum = psq = None
    if with_stats:
        # a tile's sum of squared accumulators must fit in int64
        if TILE_M * (qc.kh * qc.kw * qc.cp * 127**2) ** 2 >= 2**63:
            raise ValueError(f"int8 conv: {qc.kh * qc.kw * qc.cp} taps x channels overflow "
                             "the int64 statistics")
        psum = torch.empty((b, tiles, r), device=xq.device, dtype=torch.int64)
        psq = torch.empty_like(psum)
    lib = _library()
    stream = build.stream_of(xq)
    with torch.cuda.device(xq.device):
        err = lib.mt_int8_conv(
            xq.data_ptr(), qc.w.data_ptr(), qc.scale.data_ptr(), _ptr(qc.bias), y.data_ptr(),
            _ptr(psum), _ptr(psq), b, hp, wp, cp, r, qc.kh * qc.kw, qc.kw, qc.stride, ho, wo,
            qc.cout, int(qc.phases == 4), stream,
        )
        build.check(lib, err, "int8 conv")
        if not with_stats:
            return y
        s = torch.empty((b, qc.cout), device=xq.device, dtype=torch.float32)
        sq = torch.empty_like(s)
        a = shift = None
        if gamma is not None:
            _check_f32("gamma", gamma, (b, qc.cout), xq.device)
            _check_f32("beta", beta, (b, qc.cout), xq.device)
            a, shift = torch.empty_like(s), torch.empty_like(s)
        err = lib.mt_int8_stats(
            psum.data_ptr(), psq.data_ptr(), qc.scale.data_ptr(), _ptr(qc.bias), s.data_ptr(),
            sq.data_ptr(), _ptr(gamma), _ptr(beta), _ptr(a), _ptr(shift), b, tiles, r,
            qc.cout, ho * wo, float(f * ho * f * wo), float(eps), stream,
        )
    build.check(lib, err, "int8 conv statistics")
    if gamma is not None:
        return y, a, shift
    return y, s, sq


def _conv(what: str, x: torch.Tensor, qc: QuantConv, pending, with_stats: bool):
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{what} has no backward; call it under torch.inference_mode()")
    if x.device.type == "cpu":
        return conv_plain(x, qc, pending, with_stats), False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {x.device}")
    _check_input(what, x, qc)
    return conv_padded_cuda(quant_pad_cuda(x, qc, pending), qc, with_stats), True


def downconv(x: torch.Tensor, qc: QuantConv, pending: Optional[dict] = None,
             with_stats: bool = False):
    """3x3/s2/p1 int8 conv of NCHW f32 ``x`` -> y (B, Co, H/2, W/2) f32, and
    with ``with_stats`` its per-(sample, channel) (sum, sumsq). ``pending``
    is the deferred norm {"scale", "shift" (B, C), "relu", "alpha"} applied
    before quantizing."""
    if qc.stride != 2 or qc.phases != 1:
        raise ValueError("downconv takes a stride-2 QuantConv")
    out, launched = _conv("int8 downconv", x, qc, pending, with_stats)
    if launched:
        downconv.launches += 1
    return out


def deconv(x: torch.Tensor, qc: QuantConv, pending: Optional[dict] = None,
           with_stats: bool = False):
    """ConvTranspose(3, 2, 1, 1) in int8: NCHW f32 (B, C, H, W) -> y
    (B, Co, 2H, 2W) f32, and with ``with_stats`` (sum, sumsq) (B, Co) over
    all four phases. ``pending`` as in :func:`downconv`."""
    if qc.phases != 4:
        raise ValueError("deconv takes a QuantConv from quant_deconv")
    out, launched = _conv("int8 deconv", x, qc, pending, with_stats)
    if launched:
        deconv.launches += 1
    return out


def resblock(x: torch.Tensor, q1: QuantConv, q2: QuantConv, gamma: torch.Tensor,
             beta: torch.Tensor, relu_mid: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """The int8 residual block on NCHW f32 x; gamma, beta (B, C) f32 (zeros
    for the encoder's instance-norm blocks).

    On the card: seven launches, in order quantize-pad, conv1, stats (which
    also forms conv2's prologue affine), quantize-pad with that affine and
    relu, conv2, stats, and the residual apply. h1 and h2 go through device
    memory: at 64x64x256 f32 an image's h1 (4 MB) is far above a block's
    227 KB of shared memory.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("int8 resblock has no backward; call it under torch.inference_mode()")
    if x.device.type == "cpu":
        return resblock_plain(x, q1, q2, gamma, beta, relu_mid, eps)
    if x.device.type != "cuda":
        raise ValueError(f"int8 resblock runs on CPU or CUDA tensors, not {x.device}")
    for qc in (q1, q2):
        if qc.stride != 1 or qc.phases != 1 or qc.cout != x.shape[1]:
            raise ValueError("int8 resblock takes two stride-1 C->C QuantConvs")
        _check_input("int8 resblock", x, qc)
    h1, a1, b1 = conv_padded_cuda(quant_pad_cuda(x, q1), q1, True, gamma, beta, eps)
    mid = {"scale": a1, "shift": b1, "relu": relu_mid, "alpha": 0.0}
    h2, a2, b2 = conv_padded_cuda(quant_pad_cuda(h1, q2, mid), q2, True, gamma, beta, eps)
    out = torch.empty_like(x)
    b, c, h, w = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mt_int8_residual(
            x.data_ptr(), h2.data_ptr(), a2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            b * c, h * w, build.stream_of(x),
        )
    build.check(lib, err, "int8 residual")
    resblock.launches += 1
    return out


def with_unit_scale(qc: QuantConv) -> QuantConv:
    """The same conv dequantizing with scale 1 and no bias, so that y holds
    the int32 accumulators (exactly, while they stay below 2^24)."""
    return replace(qc, scale=torch.ones_like(qc.scale), bias=None)


downconv.launches = 0
deconv.launches = 0
resblock.launches = 0
