"""int8 serving convolutions: the stride-1 and stride-2 3x3 convs, the whole
residual block and the transposed conv of the int8 forwards.

Four wrappers, one CUDA source (``csrc/int8_conv.cu``):

- :func:`conv3x3` replaces ``masterthesis_tpu/ops/pallas/conv_int8.py``
  ``pallas_int8_conv3x3`` (3x3, stride 1, pad 1: BaseModel's decoder
  resblock convs and the convs of a composed int8 resblock);
- :func:`downconv` replaces ``pallas_int8_downconv`` (3x3, stride 2, pad 1);
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
on the CPU, whatever the summation order). All four run one ``wgmma``
template fed by TMA. The stride-1 convs' M tiles run over the padded width
(m = oy * Wp + ox); the stride-2 and transposed convs' over boxes of
output rows and columns, the stride-2 conv's read from the padded input
viewed with its row and column parities apart, which needs an even padded
size (:func:`padded_size`), and their y goes out through TMA stores. The
transposed conv's weight rows are ordered (co, py, px)
(:func:`phase_row`), so that an N tile holds whole output channels. The
library owns the tiling: :func:`conv_tiling` asks it for the tile count
that sizes the partials, :func:`conv_launches` for its split of the N tiles
into launches.

Activations are f32 or bf16, the model's compute dtype: each wrapper takes
x in either and gives y in x's dtype, as the JAX package's CPU route does
(``out_dtype = x.dtype``): the prologue and the quantize run in f32, y =
acc * scale + bias in f32 is rounded once to bf16, and the statistics are
the same exact integer sums in either dtype. The resblock's residual adds
x + round(h * a + b) and rounds the sum (``x + y.astype(x.dtype)``).

Each wrapper runs its op (``library.call``: ``int8_conv3x3``,
``int8_downconv``, ``int8_deconv``, ``int8_resblock``), which takes the
``QuantConv`` as its tensors and flags. On a CPU tensor the op runs the
plain version, which does the same arithmetic with torch ops: the integer
conv runs in float64, which is exact (|acc| <= 9 * Cp * 127^2, far below
2^53; f32 would not be, past 2^24). On a CUDA tensor it launches the
kernels or raises. Each wrapper counts its calls that launch the kernels in
``<wrapper>.launches``; while the program's span recorder is on, beside it,
the conv launches of those calls that ran a tail N tile
(:func:`tail_launches`) in the recorder's counter
``<op>.tail_launches`` (``profiling.totals()``).

The weights quantize on their own device (:func:`quantize_weight`), bit for
bit as on the CPU, so that training with int8 forwards (``ops/qat.py``) can
quantize them again after every update without a copy to the host; the
activation scales are made on the CPU (:func:`act_scales`), once per
calibration.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.ops.kernels import build, library
from masterthesis_tpu_torch.utils import profiling

INT8_MAX = 127.0
K_ALIGN = 32  # channel padding of the int8 operands: one k32 step of the wgmma
_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
ACT_DTYPES = (torch.float32, torch.bfloat16)  # the activations the kernels take and give


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
    w's device. Both divisions are tensor by tensor, which a CUDA tensor
    rounds correctly, as the CPU does (see :func:`act_scales`), so the card
    gives the CPU's bits."""
    w = w.detach().float()
    dims = [d for d in range(w.dim()) if d != out_dim]
    shape = [1] * w.dim()
    shape[out_dim] = -1
    amax = w.abs().amax(dim=dims).clamp_min(1e-12)
    scale = amax / torch.full_like(amax, INT8_MAX)
    q = torch.round(w / scale.view(shape)).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def subpixel_weights(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, Co) transposed-conv kernel in the JAX layout (HWIO, applied
    unflipped) -> (2, 2, C, 4Co) taps of a 2x2 VALID conv over the input
    zero-padded by one row and column at the end. Output channel co of phase
    (py, px) (output pixel (2 oy + py, 2 ox + px)) is column
    :func:`phase_row` = 4 co + 2 py + px: a channel's four phases are
    neighbours, so that an N tile of the kernel holds whole output channels
    (the JAX package orders the columns phase-major)."""
    c, co = k.shape[2], k.shape[3]
    w = k.new_zeros((2, 2, c, co, 2, 2))  # (ky, kx, C, co, py, px)
    w[0, 0, :, :, 0, 0] = k[1, 1]
    w[0, 0, :, :, 0, 1] = k[1, 0]
    w[0, 1, :, :, 0, 1] = k[1, 2]
    w[0, 0, :, :, 1, 0] = k[0, 1]
    w[1, 0, :, :, 1, 0] = k[2, 1]
    w[0, 0, :, :, 1, 1] = k[0, 0]
    w[0, 1, :, :, 1, 1] = k[0, 2]
    w[1, 0, :, :, 1, 1] = k[2, 0]
    w[1, 1, :, :, 1, 1] = k[2, 2]
    return w.reshape(2, 2, c, 4 * co)


def phase_row(py: int, co, px: int):
    """The output row of channel ``co`` in phase (py, px) of a transposed
    conv (see :func:`subpixel_weights`)."""
    return co * 4 + py * 2 + px


@dataclass(slots=True)
class QuantConv:
    """A conv's int8 operands, built once from its float weights and amax.

    ``w`` is (R, kh * kw, Cp) int8: R output rows (Co, or 4 Co phase rows for
    the transposed conv), taps, input channels zero-padded to Cp. ``scale``
    and ``bias`` are (R,) f32 (``bias`` may be None); ``inv_sx`` is the (1,)
    f32 127 / amax. ``pad`` is (top, bottom, left, right). Not frozen: the
    ops make one per call from the tensors they are given, and a frozen
    dataclass's ``__init__`` costs seven times as much; nothing changes one
    after it is made (:func:`with_unit_scale` makes a copy).
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


def quant_conv(weight: torch.Tensor, bias, amax, stride: int, padding_type: Optional[str],
               scales=None) -> QuantConv:
    """A 3x3, pad-1 Conv2d (weight OIHW) quantized for :func:`conv3x3`,
    :func:`downconv` or a resblock conv, on the weight's device. ``padding_type`` None is zero
    padding, as in the JAX package; 'replicate' has no kernel and is refused. ``scales``:
    :func:`act_scales` of ``amax`` made before (then ``amax`` is not read)."""
    if padding_type not in (None, "zero", "reflect"):
        raise NotImplementedError(f"int8 conv: padding '{padding_type}' has no kernel")
    co, ci, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"int8 conv takes 3x3 kernels, got {kh}x{kw}")
    inv, sx = act_scales(amax) if scales is None else scales
    w_q, sw = quantize_weight(weight, out_dim=0)
    dev = weight.device
    return QuantConv(
        w=_kernel_layout(w_q.permute(0, 2, 3, 1)),
        scale=sx.to(dev) * sw,
        bias=None if bias is None else bias.detach().float().contiguous(),
        inv_sx=inv.reshape(1).to(dev),
        cin=ci, cout=co, kh=3, kw=3, stride=stride, pad=(1, 1, 1, 1),
        reflect=padding_type == "reflect", phases=1,
    )


def quant_deconv(weight: torch.Tensor, bias, amax, scales=None) -> QuantConv:
    """A ConvTranspose2d(3, 2, 1, 1) (weight IOHW, the port's layout: the
    JAX kernel spatially flipped) quantized for :func:`deconv`, on the
    weight's device; ``scales`` as in :func:`quant_conv`."""
    ci, co, kh, kw = weight.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"int8 deconv takes 3x3 kernels, got {kh}x{kw}")
    inv, sx = act_scales(amax) if scales is None else scales
    w_q, sw = quantize_weight(weight, out_dim=1)
    k = w_q.flip(2, 3).permute(2, 3, 0, 1)  # the JAX HWIO kernel
    w4 = subpixel_weights(k)  # (2, 2, C, 4Co)
    dev = weight.device
    b = torch.zeros(co, device=dev) if bias is None else bias.detach().float()
    return QuantConv(
        w=_kernel_layout(w4.permute(3, 0, 1, 2)),
        scale=(sx.to(dev) * sw).repeat_interleave(4),
        bias=b.repeat_interleave(4).contiguous(),
        inv_sx=inv.reshape(1).to(dev),
        cin=ci, cout=co, kh=2, kw=2, stride=1, pad=(0, 1, 0, 1),
        reflect=False, phases=4,
    )


# ------------------------------------------------------------ plain path --


@dataclass(frozen=True, slots=True)
class Pending:
    """A norm its block did not apply: the per-(sample, channel) affine
    ``scale``, ``shift`` (B, C) f32, then with ``relu`` max(y, alpha y)
    (relu or leaky relu). The int8 convs and the head (``head.py``) apply it
    in their prologue, any other consumer inline (:meth:`apply`)."""

    scale: torch.Tensor
    shift: torch.Tensor
    relu: bool
    alpha: float

    def apply(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The affine and activation on NCHW x in f32, rounded once to
        ``dtype``: the plain version of every prologue."""
        y = x.float() * self.scale[:, :, None, None] + self.shift[:, :, None, None]
        if self.relu:
            y = torch.maximum(y, self.alpha * y)
        return y.to(dtype)

    def __getitem__(self, name: str) -> torch.Tensor:
        """A field by name, as ``portbench/work.py`` reads scale and shift."""
        return getattr(self, name)


def prologue_plain(x: torch.Tensor, pending: Optional[Pending]) -> torch.Tensor:
    """x as an int8 conv quantizes it, in f32: after ``pending`` if any."""
    return x.float() if pending is None else pending.apply(x)


def padded_size(qc: QuantConv, h: int, w: int) -> tuple[int, int]:
    """(Hp, Wp) of ``qc``'s padded int8 input for an (h, w) map: the pads,
    and for a stride-2 conv one more zero row or column where that leaves
    an odd count (the kernel reads the padded rows and columns in pairs; no
    output reads the extra one)."""
    t, b, l, r = qc.pad
    hp, wp = h + t + b, w + l + r
    if qc.stride == 2:
        hp, wp = hp + hp % 2, wp + wp % 2
    return hp, wp


def quant_pad_plain(x: torch.Tensor, qc: QuantConv,
                    pending: Optional[Pending] = None) -> torch.Tensor:
    """NCHW float -> padded NHWC int8 (B, Hp, Wp, Cp), as the kernel writes it."""
    q = _quantize(prologue_plain(x, pending), qc.inv_sx)
    t, b, l, r = qc.pad
    hp, wp = padded_size(qc, x.shape[2], x.shape[3])
    # integers up to 127 are exact in f32, which reflect padding needs
    q = F.pad(q.float(), (l, r, t, b), mode="reflect" if qc.reflect else "constant")
    q = F.pad(q.permute(0, 2, 3, 1), (0, qc.cp - qc.cin, 0, wp - q.shape[3], 0, hp - q.shape[2]))
    return q.to(torch.int8).contiguous()


def conv_acc_plain(xq: torch.Tensor, qc: QuantConv) -> torch.Tensor:
    """Padded NHWC int8 -> int32 accumulators (B, R, Ho, Wo), exact via f64."""
    r = qc.w.shape[0]
    w = qc.w.reshape(r, qc.kh, qc.kw, qc.cp).permute(0, 3, 1, 2).double()
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w, stride=qc.stride)
    return acc.to(torch.int32)


def _interleave(y: torch.Tensor, phases: int) -> torch.Tensor:
    """(B, 4Co, H, W) in phase rows (:func:`phase_row`) -> (B, Co, 2H, 2W);
    the identity for 1 phase."""
    if phases == 1:
        return y
    b, r, h, w = y.shape
    co = r // 4
    # (b, co, py, px, oy, ox) -> (b, co, oy, py, ox, px)
    return y.reshape(b, co, 2, 2, h, w).permute(0, 1, 4, 2, 5, 3).reshape(b, co, 2 * h, 2 * w)


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
    co = torch.arange(qc.cout, device=acc.device)
    s = q = torch.zeros((acc.shape[0], qc.cout), dtype=torch.float64, device=acc.device)
    for ph in range(qc.phases):
        rows = co if qc.phases == 1 else phase_row(ph >> 1, co, ph & 1)
        s = s + s_rows[:, rows]
        q = q + q_rows[:, rows]
    return s.float(), q.float()


def conv_padded_plain(xq: torch.Tensor, qc: QuantConv, with_stats: bool = False,
                      out_dtype: torch.dtype = torch.float32):
    """Padded int8 -> dequantized NCHW y (f32, rounded once to ``out_dtype``),
    and (sum, sumsq) (B, Co) f32 of y before that rounding."""
    acc = conv_acc_plain(xq, qc)
    y = acc.float() * qc.scale[:, None, None]
    if qc.bias is not None:
        y = y + qc.bias[:, None, None]
    y = _interleave(y, qc.phases).to(out_dtype).contiguous()
    if not with_stats:
        return y
    return (y, *stats_plain(acc, qc))


def conv_plain(x: torch.Tensor, qc: QuantConv, pending: Optional[Pending] = None,
               with_stats: bool = False):
    """The quantize-and-pad and the conv; y in x's dtype."""
    return conv_padded_plain(quant_pad_plain(x, qc, pending), qc, with_stats, x.dtype)


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
    """x + round(h * a + b) in x's dtype: the affine in f32 rounded to x's
    dtype, then the sum rounded (the JAX package's ``x + y.astype(x.dtype)``)."""
    y = h.float() * a[:, :, None, None] + b[:, :, None, None]
    return x + y.to(x.dtype)


def resblock_plain(x, q1: QuantConv, q2: QuantConv, gamma, beta, relu_mid: bool = True,
                   eps: float = 1e-5):
    """x + norm(conv2(relu(norm(conv1(x))))), both norms (1 + gamma, beta);
    h1 and h2 in x's dtype, as the JAX package's composed block keeps them."""
    n = x.shape[2] * x.shape[3]
    h1, s1, sq1 = conv_plain(x, q1, None, True)
    a1, b1 = norm_affine_plain(s1, sq1, n, gamma, beta, eps)
    h2, s2, sq2 = conv_plain(h1, q2, Pending(a1, b1, relu_mid, 0.0), True)
    a2, b2 = norm_affine_plain(s2, sq2, n, gamma, beta, eps)
    return residual_plain(x, h2, a2, b2)


# ------------------------------------------------------------ the kernels --


# the C entry points of csrc/int8_conv.cu: name -> (argument types, result type)
SIGNATURES = {
    "mt_int8_quant_pad": ([_P, _P, _P, _P, _P, _I32, _F32] + [_I64] * 9 + [_I32, _I32, _P], _I32),
    "mt_int8_quant_pad_nhwc": ([_P, _P, _P, _P, _P, _I32, _F32] + [_I64] * 9 + [_I32, _I32, _P],
                               _I32),
    "mt_int8_stat_tiles": ([_I64, _I32, _I64, _I64, _I64, _P], _I64),
    "mt_int8_n_tile": ([_I64, _I32], _I64),
    "mt_int8_conv_launches": ([_I64, _I32, _I64, _P], _I32),
    "mt_int8_y_by_tma": ([_I64, _I32, _I64, _I32], _I32),
    "mt_int8_conv": ([_P] * 7 + [_I64] * 12 + [_I32, _I32, _I32, _P], _I32),
    "mt_int8_stats": ([_P] * 10 + [_I64] * 5 + [_F32, _F32, _P], _I32),
    "mt_int8_residual_nhwc": ([_P] * 5 + [_I64] * 3 + [_I32, _P], _I32),
}


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/int8_conv.cu``) with its entry points typed."""
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The typed library, once per process: the wrappers run on every conv
    of a forward."""
    return typed(build.load("int8_conv"))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_f32(what: str, t: torch.Tensor, shape, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(
            f"{what}: needs a contiguous f32 {tuple(shape)} tensor on {device}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device} contiguous={t.is_contiguous()}"
        )


def _check_act(what: str, x: torch.Tensor) -> None:
    if x.dtype not in ACT_DTYPES or not x.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous f32 or bf16 tensor, got {x.dtype} "
                         f"contiguous={x.is_contiguous()}")


def _check_input(what: str, x: torch.Tensor, qc: QuantConv) -> None:
    if x.dim() != 4 or x.shape[1] != qc.cin:
        raise ValueError(f"{what}: x must be (B, {qc.cin}, H, W), got {tuple(x.shape)}")
    _check_act(what, x)
    for name, t in (("weights", qc.w), ("scale", qc.scale), ("bias", qc.bias),
                    ("inv_sx", qc.inv_sx)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
    t, b, l, r = qc.pad
    if qc.reflect and (x.shape[2] <= max(t, b) or x.shape[3] <= max(l, r)):
        raise ValueError(f"{what}: reflect padding needs H, W > 1, got {tuple(x.shape)}")


def quant_pad_cuda(x: torch.Tensor, qc: QuantConv, pending: Optional[Pending] = None,
                   nhwc: bool = False) -> torch.Tensor:
    """The quantize-and-pad launch: :func:`quant_pad_plain` on the card, of
    NCHW ``x``, or with ``nhwc`` of (B, H, W, C) ``x`` (what
    :func:`quant_pad_plain` gives for ``x.permute(0, 3, 1, 2)``); ``x`` f32
    or bf16."""
    _check_act("int8 quantize-and-pad", x)
    if nhwc:
        b, h, w, c = x.shape
    else:
        b, c, h, w = x.shape
    t, _, l, _ = qc.pad
    hp, wp = padded_size(qc, h, w)
    out = torch.empty((b, hp, wp, qc.cp), device=x.device, dtype=torch.int8)
    pa, pb, relu, alpha = _op_args(pending)
    if pending is not None:
        _check_f32("prologue scale", pa, (b, c), x.device)
        _check_f32("prologue shift", pb, (b, c), x.device)
    lib = _library()
    launch = lib.mt_int8_quant_pad_nhwc if nhwc else lib.mt_int8_quant_pad
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), out.data_ptr(), qc.inv_sx.data_ptr(), _ptr(pa), _ptr(pb), relu, alpha,
            b, c, h, w, qc.cp, hp, wp, t, l, int(qc.reflect), int(x.dtype == torch.bfloat16),
            build.stream_of(x),
        )
    build.check(lib, err, "int8 quantize-and-pad")
    return out


@functools.cache
def _tiling(stride: int, phases: int, ho: int, wo: int, wp: int) -> tuple[int, int]:
    rows = ctypes.c_int64()
    tiles = _library().mt_int8_stat_tiles(stride, phases, ho, wo, wp, ctypes.byref(rows))
    return tiles, rows.value


def conv_tiling(qc: QuantConv, hp: int, wp: int) -> tuple[int, int]:
    """(M tiles per image, most output pixels per tile) of ``qc``'s conv
    launch on a (hp, wp) padded input, as the library tiles it: the tiles
    are the rows of its per-tile statistics partials. Loads the library."""
    ho, wo = (hp - qc.kh) // qc.stride + 1, (wp - qc.kw) // qc.stride + 1
    return _tiling(qc.stride, int(qc.phases == 4), ho, wo, wp)


@functools.cache
def _launches(stride: int, phases: int, r: int) -> tuple[int, ...]:
    rows = (ctypes.c_int64 * 2)()
    n = _library().mt_int8_conv_launches(stride, phases, r, rows)
    return tuple(rows[:n])


def conv_launches(qc: QuantConv) -> tuple[int, ...]:
    """The output rows of each conv launch of ``qc``, in launch order, as
    the library splits its N tiles: the full tiles in one launch, a tail
    tile in another. Loads the library."""
    return _launches(qc.stride, int(qc.phases == 4), qc.w.shape[0])


@functools.cache
def _tail_launches(stride: int, phases: int, r: int) -> int:
    tile = _library().mt_int8_n_tile(stride, phases)
    return sum(1 for rows in _launches(stride, phases, r) if rows % tile)


def tail_launches(qc: QuantConv) -> int:
    """How many of ``qc``'s conv launches (:func:`conv_launches`) run a tail
    N tile: a launch whose rows are not a multiple of the library's N tile.
    Loads the library."""
    return _tail_launches(qc.stride, int(qc.phases == 4), qc.w.shape[0])


@functools.cache
def _y_by_tma(stride: int, phases: int, wo: int, y_bf16: int) -> bool:
    return bool(_library().mt_int8_y_by_tma(stride, phases, wo, y_bf16))


def y_store(qc: QuantConv, w: int, dtype: torch.dtype) -> str:
    """How the card stores y of ``qc``'s conv of a map ``w`` wide, in
    ``dtype``: "tma" (TMA box stores) or "threads", by the library's rule.
    Loads the library."""
    _, wp = padded_size(qc, 1, w)
    wo = (wp - qc.kw) // qc.stride + 1
    tma = _y_by_tma(qc.stride, int(qc.phases == 4), wo, int(dtype == torch.bfloat16))
    return "tma" if tma else "threads"


def conv_padded_cuda(xq: torch.Tensor, qc: QuantConv, with_stats: bool = False,
                     gamma=None, beta=None, eps: float = 1e-5, nhwc: bool = False,
                     out_dtype: torch.dtype = torch.float32):
    """The implicit-GEMM launch (and the stats launch): y in ``out_dtype``
    (f32 or bf16), and with stats (sum, sumsq), or with ``gamma``/``beta``
    the norm affine (a, b) of :func:`norm_affine_plain` computed from them
    in the stats launch. With ``nhwc`` (stride-1 convs only) y is (B, H, W,
    Co)."""
    if out_dtype not in ACT_DTYPES:
        raise ValueError(f"int8 conv: y is f32 or bf16, not {out_dtype}")
    b, hp, wp, cp = xq.shape
    if xq.dtype != torch.int8 or not xq.is_contiguous() or cp != qc.cp:
        raise ValueError(f"int8 conv: padded input must be contiguous int8 (B, Hp, Wp, {qc.cp})")
    if nhwc and (qc.stride != 1 or qc.phases != 1):
        raise ValueError("int8 conv: an NHWC output is for stride-1 convs only")
    ho, wo = (hp - qc.kh) // qc.stride + 1, (wp - qc.kw) // qc.stride + 1
    f = 2 if qc.phases == 4 else 1
    r = qc.w.shape[0]
    shape = (b, ho, wo, qc.cout) if nhwc else (b, qc.cout, f * ho, f * wo)
    y = torch.empty(shape, device=xq.device, dtype=out_dtype)
    tiles, tile_rows = conv_tiling(qc, hp, wp)
    if b * tiles >= 2**31 or ho * wp >= 2**31 or 4 * ho * wo >= 2**31:
        raise ValueError("int8 conv: output exceeds the grid")
    if qc.stride == 2 and (hp % 2 or wp % 2):
        raise ValueError(f"int8 conv: a stride-2 input needs an even padded size, got {hp} x {wp} "
                         "(see padded_size)")
    psum = psq = None
    if with_stats:
        # a tile's sum of squared accumulators must fit in int64
        if tile_rows * (qc.kh * qc.kw * qc.cp * 127**2) ** 2 >= 2**63:
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
            qc.cout, tiles, int(qc.phases == 4), int(nhwc), int(out_dtype == torch.bfloat16),
            stream,
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


# op name -> (wrapper name, what errors call it, stride, phases)
_CONV_OPS = {
    "int8_conv3x3": ("conv3x3", "int8 conv3x3", 1, 1),
    "int8_downconv": ("downconv", "int8 downconv", 2, 1),
    "int8_deconv": ("deconv", "int8 deconv", 1, 4),
}
# [y], or with with_stats [y, sum, sumsq]
_CONV_SCHEMA = ("(Tensor x, Tensor w, Tensor scale, Tensor? bias, Tensor inv_sx, "
                "Tensor? pre_scale, Tensor? pre_shift, bool relu, float alpha, bool reflect, "
                "bool with_stats) -> Tensor[]")


def _op_quant(stride: int, phases: int, x, w, scale, bias, inv_sx, reflect: bool) -> QuantConv:
    """The QuantConv that a conv op of ``stride`` and ``phases`` was given
    as tensors and flags."""
    if phases == 4:
        return QuantConv(w, scale, bias, inv_sx, x.shape[1], w.shape[0] // 4, 2, 2, 1,
                         (0, 1, 0, 1), False, 4)
    return QuantConv(w, scale, bias, inv_sx, x.shape[1], w.shape[0], 3, 3, stride, (1, 1, 1, 1),
                     reflect, 1)


def _op_args(pending: Optional[Pending]) -> tuple:
    """(pre_scale, pre_shift, relu, alpha): a deferred norm, or none, as the ops take it."""
    if pending is None:
        return None, None, False, 0.0
    return pending.scale, pending.shift, pending.relu, pending.alpha


def _op_pending(pre_scale, pre_shift, relu: bool, alpha: float) -> Optional[Pending]:
    """The deferred norm that a conv op was given as its four arguments."""
    return None if pre_scale is None else Pending(pre_scale, pre_shift, relu, alpha)


def _conv_impls(op: str):
    """The op's CPU, CUDA and fake implementations."""
    wrapper, what, stride, phases = _CONV_OPS[op]
    span = f"mt.k.{op}"

    def cpu(x, w, scale, bias, inv_sx, pre_scale, pre_shift, relu, alpha, reflect, with_stats):
        qc = _op_quant(stride, phases, x, w, scale, bias, inv_sx, reflect)
        out = conv_plain(x, qc, _op_pending(pre_scale, pre_shift, relu, alpha), with_stats)
        return list(out) if with_stats else [out]

    def cuda(x, w, scale, bias, inv_sx, pre_scale, pre_shift, relu, alpha, reflect, with_stats):
        with profiling.span(span):
            qc = _op_quant(stride, phases, x, w, scale, bias, inv_sx, reflect)
            _check_input(what, x, qc)
            out = conv_padded_cuda(
                quant_pad_cuda(x, qc, _op_pending(pre_scale, pre_shift, relu, alpha)), qc,
                with_stats, out_dtype=x.dtype)
            globals()[wrapper].launches += 1
            if profiling.ON:
                profiling.add(f"{op}.tail_launches", tail_launches(qc))
            return list(out) if with_stats else [out]

    def fake(x, w, scale, bias, inv_sx, pre_scale, pre_shift, relu, alpha, reflect, with_stats):
        qc = _op_quant(stride, phases, x, w, scale, bias, inv_sx, reflect)
        hp, wp = padded_size(qc, x.shape[2], x.shape[3])
        f = 2 if qc.phases == 4 else 1
        ho, wo = (hp - qc.kh) // qc.stride + 1, (wp - qc.kw) // qc.stride + 1
        y = x.new_empty((x.shape[0], qc.cout, f * ho, f * wo))
        if not with_stats:
            return [y]
        return [y, x.new_empty((x.shape[0], qc.cout), dtype=torch.float32),
                x.new_empty((x.shape[0], qc.cout), dtype=torch.float32)]

    return cpu, cuda, fake


def _conv(op: str, x: torch.Tensor, qc: QuantConv, pending, with_stats: bool):
    what = _CONV_OPS[op][1]
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{what} has no backward; call it under torch.inference_mode()")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {x.device}")
    if x.dim() != 4 or x.shape[1] != qc.cin:  # the op takes C from x
        raise ValueError(f"{what}: x must be (B, {qc.cin}, H, W), got {tuple(x.shape)}")
    out = library.call(op, x, qc.w, qc.scale, qc.bias, qc.inv_sx, *_op_args(pending), qc.reflect,
                       with_stats)
    return tuple(out) if with_stats else out[0]


def conv3x3(x: torch.Tensor, qc: QuantConv, pending: Optional[Pending] = None,
            with_stats: bool = False):
    """3x3/s1/p1 int8 conv of NCHW f32 or bf16 ``x`` -> y (B, Co, H, W) in x's dtype, and with
    ``with_stats`` its per-(sample, channel) (sum, sumsq). ``pending`` as in
    :func:`downconv`. The channel padding to a multiple of 32 is the
    template's own, so any C and Co run on the kernel."""
    if qc.stride != 1 or qc.phases != 1:
        raise ValueError("conv3x3 takes a stride-1 QuantConv from quant_conv")
    return _conv("int8_conv3x3", x, qc, pending, with_stats)


def downconv(x: torch.Tensor, qc: QuantConv, pending: Optional[Pending] = None,
             with_stats: bool = False):
    """3x3/s2/p1 int8 conv of NCHW f32 or bf16 ``x`` -> y (B, Co, H/2, W/2) in x's dtype, and
    with ``with_stats`` its per-(sample, channel) (sum, sumsq). ``pending``:
    a deferred norm (:class:`Pending`), applied before quantizing."""
    if qc.stride != 2 or qc.phases != 1:
        raise ValueError("downconv takes a stride-2 QuantConv")
    return _conv("int8_downconv", x, qc, pending, with_stats)


def deconv(x: torch.Tensor, qc: QuantConv, pending: Optional[Pending] = None,
           with_stats: bool = False):
    """ConvTranspose(3, 2, 1, 1) in int8: NCHW f32 or bf16 (B, C, H, W) -> y
    (B, Co, 2H, 2W) in x's dtype, and with ``with_stats`` (sum, sumsq) (B, Co) over
    all four phases. ``pending`` as in :func:`downconv`."""
    if qc.phases != 4:
        raise ValueError("deconv takes a QuantConv from quant_deconv")
    return _conv("int8_deconv", x, qc, pending, with_stats)


def resblock(x: torch.Tensor, q1: QuantConv, q2: QuantConv, gamma: torch.Tensor,
             beta: torch.Tensor, relu_mid: bool = True, eps: float = 1e-5) -> torch.Tensor:
    """The int8 residual block on NCHW f32 or bf16 x (out, h1 and h2 in its
    dtype); gamma, beta (B, C) f32 (zeros for the encoder's instance-norm
    blocks).

    On the card: seven launches, in order quantize-pad, conv1 (h1 stored
    NHWC, as the GEMM holds it), stats (which also forms conv2's prologue
    affine), quantize-pad of NHWC h1 with that affine and relu, conv2 (h2
    NHWC too), stats, and the residual apply, which turns h2 to NCHW through
    shared-memory tiles. h1 and h2 go through device memory: at 64x64x256
    f32 an image's h1 (4 MB) is far above a block's 227 KB of shared memory.
    """
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("int8 resblock has no backward; call it under torch.inference_mode()")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 resblock runs on CPU or CUDA tensors, not {x.device}")
    for qc in (q1, q2):
        if qc.stride != 1 or qc.phases != 1 or qc.cin != x.shape[1] or qc.cout != x.shape[1]:
            raise ValueError("int8 resblock takes two stride-1 C->C QuantConvs")
    return library.call(
        "int8_resblock", x, q1.w, q1.scale, q1.bias, q1.inv_sx, q1.reflect, q2.w, q2.scale,
        q2.bias, q2.inv_sx, q2.reflect, gamma, beta, relu_mid, float(eps))


def _resblock_quants(x, w1, scale1, bias1, inv1, reflect1, w2, scale2, bias2, inv2, reflect2):
    return (_op_quant(1, 1, x, w1, scale1, bias1, inv1, reflect1),
            _op_quant(1, 1, x, w2, scale2, bias2, inv2, reflect2))


def _resblock_cpu(x, w1, scale1, bias1, inv1, reflect1, w2, scale2, bias2, inv2, reflect2,
                  gamma, beta, relu_mid, eps):
    q1, q2 = _resblock_quants(x, w1, scale1, bias1, inv1, reflect1, w2, scale2, bias2, inv2,
                              reflect2)
    return resblock_plain(x, q1, q2, gamma, beta, relu_mid, eps)


def resblock_cuda(x, w1, scale1, bias1, inv1, reflect1, w2, scale2, bias2, inv2, reflect2,
                  gamma, beta, relu_mid, eps):
    """The seven launches of :func:`resblock` on a CUDA tensor, its convs as
    the op passes them."""
    with profiling.span("mt.k.int8_resblock"):
        q1, q2 = _resblock_quants(x, w1, scale1, bias1, inv1, reflect1, w2, scale2, bias2, inv2,
                                  reflect2)
        for qc in (q1, q2):
            _check_input("int8 resblock", x, qc)
        h1, a1, b1 = conv_padded_cuda(quant_pad_cuda(x, q1), q1, True, gamma, beta, eps,
                                      nhwc=True, out_dtype=x.dtype)
        mid = Pending(a1, b1, relu_mid, 0.0)
        h2, a2, b2 = conv_padded_cuda(quant_pad_cuda(h1, q2, mid, nhwc=True), q2, True, gamma,
                                      beta, eps, nhwc=True, out_dtype=x.dtype)
        out = torch.empty_like(x)
        b, c, h, w = x.shape
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.mt_int8_residual_nhwc(
                x.data_ptr(), h2.data_ptr(), a2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                b, c, h * w, int(x.dtype == torch.bfloat16), build.stream_of(x),
            )
        build.check(lib, err, "int8 residual")
        resblock.launches += 1
        if profiling.ON:
            profiling.add("int8_resblock.tail_launches", tail_launches(q1) + tail_launches(q2))
        return out


def _resblock_fake(x, *args):
    return torch.empty_like(x)


def with_unit_scale(qc: QuantConv) -> QuantConv:
    """The same conv dequantizing with scale 1 and no bias, so that y holds
    the int32 accumulators (exactly, while they stay below 2^24)."""
    return replace(qc, scale=torch.ones_like(qc.scale), bias=None)


conv3x3.launches = 0
downconv.launches = 0
deconv.launches = 0
resblock.launches = 0
for _op in _CONV_OPS:
    library.register(_op, _CONV_SCHEMA, *_conv_impls(_op))
library.register(
    "int8_resblock", "(Tensor x, Tensor w1, Tensor scale1, Tensor? bias1, Tensor inv_sx1, "
    "bool reflect1, Tensor w2, Tensor scale2, Tensor? bias2, Tensor inv_sx2, bool reflect2, "
    "Tensor gamma, Tensor beta, bool relu_mid, float eps) -> Tensor",
    _resblock_cpu, resblock_cuda, _resblock_fake)
