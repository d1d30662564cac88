"""The whole residual block of the training step, forward and backward.

    out = x + norm2(conv2(relu(norm1(conv1(pad(x)))))),
    norm_i(h) = (1 + gamma) * (h - mean_i) * rstd_i + beta

with centered two-pass f32 statistics over the rounded conv outputs and
(gamma, beta) shared by both norms: zeros for the content encoder's instance
norm, the style projection for an AdaIN block.

- :func:`resblock_fwd` replaces ``masterthesis_tpu/ops/pallas/resblock_bf16.py``
  ``pallas_resblock_fwd`` and returns ``(out, h1, h2, stats)``;
- :func:`resblock_bwd` replaces ``pallas_resblock_bwd``: the analytic VJP
  from ``(x, h1, h2, g, stats)``, with dW summed over the batch;
- :class:`FusedResblock` is the ``torch.autograd.Function`` around the two,
  and :func:`fused_resblock` its entry point.

Both wrappers take the port's NCHW activations and OIHW weights; h1, h2 are
NHWC and stats (B, 4, C) f32 (mean1, rstd1, mean2, rstd2), as the JAX
package's. On a CPU tensor a wrapper runs its plain version (torch ops, the
same arithmetic: T operands with f32 sums in the convs, f64 statistics, the
backward's casts to T); on a CUDA tensor it launches ``csrc/resblock_bf16.cu``
(7 launches forward, 12 backward, over NHWC intermediates; bf16 convs and
wgrads on the tensor cores through wgmma and TMA) or raises. The passes that
meet the NCHW activations change the layout on the way (the first pads read
x, the residual and dx write NCHW; the backward copies g to NHWC with its
own tiled pass).
``<wrapper>.launches`` counts the calls that launch the kernels,
``<plain>.calls`` the plain versions' calls.

Routing (``models/blocks.py``) follows the JAX package: a resblock takes this
path inside :func:`fused_train_trace` (the main training step), when the
mode asks for it ("auto": on the card; "on": also on the CPU, through the
plain versions), and when :func:`resblock_train_eligible` passes, the JAX
gate ``resblock_train_eligible``/``_train_fits`` (resblock_bf16.py:107-125).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.ops.kernels import build
from masterthesis_tpu_torch.utils import profiling

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float
MODES = ("auto", "on", "off")

_train_mode = None  # the fused_resblock mode inside a training step, else None


@contextlib.contextmanager
def fused_train_trace(mode: str):
    """Mark a training step: inside it, eligible resblocks route through
    :func:`fused_resblock` per ``mode`` (the JAX package's context of the same
    name, around its main step only)."""
    global _train_mode
    if mode not in MODES:
        raise ValueError(f"unknown fused_resblock mode {mode!r}; one of {MODES}")
    prev, _train_mode = _train_mode, mode
    try:
        yield
    finally:
        _train_mode = prev


def fused_train_active(x: torch.Tensor) -> bool:
    return _train_mode == "on" or (_train_mode == "auto" and x.is_cuda)


def _train_fits(h: int, w: int, c: int) -> bool:
    per_buf = (h + 4) * (w + 4) * c * 2
    return (
        h >= 8 and w >= 8 and h * w * c * 2 <= 4_700_000
        and 8 * per_buf + 2 * 9 * c * c * 4 <= 60_000_000
    )


def resblock_train_eligible(x: torch.Tensor) -> bool:
    """The JAX gate on an NCHW input: c % 128 == 0, h, w >= 8, a byte cap."""
    if x.dim() != 4:
        return False
    _, c, h, w = x.shape
    return c % 128 == 0 and _train_fits(h, w, c)


# ------------------------------------------------------------ plain versions --


def _pad(x: torch.Tensor, padding_type: str) -> torch.Tensor:
    if padding_type == "reflect":
        return F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.pad(x, (1, 1, 1, 1))


def _conv(xp: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """3x3 VALID conv of T operands, summed in f32, rounded to T."""
    return F.conv2d(xp.float(), w.to(dtype).float()).to(dtype)


def _stats(h: torch.Tensor, eps: float):
    """Centered mean and rstd (B, C) f32 of NCHW h: f64 sums rounded once,
    rstd = 1 / sqrt(var + eps) with the sum in f32 and the rest in f64."""
    h64 = h.double()
    mean = h64.mean(dim=(2, 3))
    var = (h64 - mean[:, :, None, None]).square().mean(dim=(2, 3)).float()
    rstd = (1.0 / torch.sqrt((var + eps).double())).float()
    return mean.float(), rstd


def _affine(mean, rstd, gamma, beta):
    a = (1.0 + gamma) * rstd
    return a[:, :, None, None], (beta - mean * a)[:, :, None, None]


def _fold(p: torch.Tensor, padding_type: str) -> torch.Tensor:
    """The adjoint of the pad on a (B, C, H+2, W+2) f32 gradient: reflect
    folds the border columns, then the border rows (interior columns), onto
    the reflected interior; zero drops the border. Returns (B, C, H, W)."""
    p = p.clone()
    h, w = p.shape[2] - 2, p.shape[3] - 2
    if padding_type == "reflect":
        p[:, :, :, 2] += p[:, :, :, 0]
        p[:, :, :, w - 1] += p[:, :, :, w + 1]
        p[:, :, 2, 1:w + 1] += p[:, :, 0, 1:w + 1]
        p[:, :, h - 1, 1:w + 1] += p[:, :, h + 1, 1:w + 1]
    return p[:, :, 1:h + 1, 1:w + 1]


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def resblock_fwd_plain(x, w1, w2, gamma, beta, padding_type="reflect", relu_mid=True, eps=1e-5):
    """The kernel's arithmetic with torch ops; see :func:`resblock_fwd`."""
    resblock_fwd_plain.calls += 1
    dtype = x.dtype
    gamma, beta = gamma.float(), beta.float()
    h1 = _conv(_pad(x, padding_type), w1, dtype)
    m1, r1 = _stats(h1, eps)
    a, b = _affine(m1, r1, gamma, beta)
    n1 = h1.float() * a + b
    a1 = (n1.clamp_min(0.0) if relu_mid else n1).to(dtype)
    h2 = _conv(_pad(a1, padding_type), w2, dtype)
    m2, r2 = _stats(h2, eps)
    a, b = _affine(m2, r2, gamma, beta)
    out = (x.float() + (h2.float() * a + b)).to(dtype)
    return out, _nhwc(h1), _nhwc(h2), torch.stack([m1, r1, m2, r2], dim=1)


resblock_fwd_plain.calls = 0


def _norm_bwd_plain(d, h, mean, rstd, gamma, beta, relu, dtype):
    """(dh in T, sum d, sum d * yhat) of one norm, d the f32 upstream gradient."""
    n = h.shape[2] * h.shape[3]
    h32 = h.float()
    if relu:
        a, b = _affine(mean, rstd, gamma, beta)
        d = torch.where(h32 * a + b > 0.0, d, torch.zeros_like(d))
    yh = (h32 - mean[:, :, None, None]) * rstd[:, :, None, None]
    s1 = d.double().sum(dim=(2, 3)).float()
    s2 = (d.double() * yh.double()).sum(dim=(2, 3)).float()
    coef = ((1.0 + gamma) * rstd)[:, :, None, None]
    t = (d - (s1 / n)[:, :, None, None]) - yh * (s2 / n)[:, :, None, None]
    return (coef * t).to(dtype), s1, s2


def resblock_bwd_plain(x, h1, h2, g, stats, w1, w2, gamma, beta, padding_type="reflect",
                       relu_mid=True, eps=1e-5):
    """The kernel's arithmetic with torch ops; see :func:`resblock_bwd`."""
    resblock_bwd_plain.calls += 1
    dtype = x.dtype
    gamma, beta = gamma.float(), beta.float()
    h1, h2 = _nchw(h1), _nchw(h2)
    m1, r1, m2, r2 = stats.unbind(dim=1)
    g32 = g.to(dtype).float()
    dh2, sg, sgy = _norm_bwd_plain(g32, h2, m2, r2, gamma, beta, False, dtype)
    a, b = _affine(m1, r1, gamma, beta)
    n1 = h1.float() * a + b
    a1 = (n1.clamp_min(0.0) if relu_mid else n1).to(dtype)
    wshape = tuple(w1.shape)
    dw2 = torch.nn.grad.conv2d_weight(_pad(a1, padding_type).float(), wshape, dh2.float())
    da1 = _fold(F.conv_transpose2d(dh2.float(), w2.to(dtype).float()).to(dtype).float(),
                padding_type)
    dh1, sd, sdy = _norm_bwd_plain(da1, h1, m1, r1, gamma, beta, relu_mid, dtype)
    dw1 = torch.nn.grad.conv2d_weight(_pad(x, padding_type).float(), wshape, dh1.float())
    dp = F.conv_transpose2d(dh1.float(), w1.to(dtype).float()).to(dtype).float()
    dx = (g32 + _fold(dp, padding_type)).to(dtype)
    return dx, dw1, dw2, sgy + sdy, sg + sd


resblock_bwd_plain.calls = 0


# ------------------------------------------------------------------ kernels --

@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("resblock_bf16")
    sigs = {
        "pad": [_P, _P, _P, _P, _P, _P, _I32, _I64, _I64, _I64, _I64, _I32, _I32, _I32, _P],
        "conv": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P],
        "stats": [_P, _P, _P, _I64, _I64, _I64, _F32, _P],
        "residual": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
        "norm_bwd": [_P, _I32, _I32, _P, _P, _P, _P, _P, _I32, _P, _P, _P,
                     _I64, _I64, _I64, _I64, _P],
        "wgrad": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P],
        "dx": [_P, _P, _P, _I64, _I64, _I64, _I64, _I32, _P],
        "nhwc": [_P, _P, _I64, _I64, _I64, _I64, _P],
    }
    for suffix in _DTYPES.values():
        for name, argtypes in sigs.items():
            fn = getattr(lib, f"mt_rb_{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.mt_rb_wgrad_splits.argtypes = [_I64] * 5
    lib.mt_rb_wgrad_splits.restype = ctypes.c_int
    return lib


def wgrad_splits(b: int, c: int, h: int, w: int) -> int:
    """The cluster size (K splits) of the bf16 wgrad at an NCHW shape: the
    most, up to 8, whose clusters all run at once on this card."""
    return _library().mt_rb_wgrad_splits(b, h, w, c, c)


class _Launcher:
    """Calls ``mt_rb_<name>_<dtype>`` with tensors passed as pointers."""

    def __init__(self, dtype, device):
        self.lib = _library()
        self.suffix = _DTYPES[dtype]
        self.stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

    def __call__(self, name, *args):
        fn = getattr(self.lib, f"mt_rb_{name}_{self.suffix}")
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        build.check(self.lib, fn(*ptrs, self.stream), f"resblock {name}")


def _check(x, w1, w2, gamma, beta, padding_type):
    if x.device.type != "cuda":
        raise ValueError(f"the resblock kernels run on CPU or CUDA tensors, not {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"resblock: x must be 4-D f32 or bf16, got {tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    if c % 128 or h < 8 or w < 8:
        raise ValueError(f"resblock: needs C % 128 == 0 and H, W >= 8, got {tuple(x.shape)}")
    for name, t in (("w1", w1), ("w2", w2)):
        if tuple(t.shape) != (c, c, 3, 3) or t.device != x.device:
            raise ValueError(f"resblock: {name} must be ({c}, {c}, 3, 3) on {x.device}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (b, c) or t.device != x.device:
            raise ValueError(f"resblock: {name} must be ({b}, {c}) on {x.device}")
    if padding_type not in ("reflect", "zero", None):
        raise ValueError(f"resblock: padding {padding_type!r}; reflect or zero only")


def _taps(w: torch.Tensor, dtype) -> torch.Tensor:
    """OIHW -> (Co, 9, Ci) in T: the conv template's weight layout."""
    c = w.shape[0]
    return w.permute(0, 2, 3, 1).reshape(c, 9, c).to(dtype).contiguous()


def _taps_flipped(w: torch.Tensor, dtype) -> torch.Tensor:
    """OIHW -> (Ci, 9, Co) in T, spatially flipped: the full correlation
    whose output is the conv's input gradient (flipT, resblock_bf16.py:647)."""
    c = w.shape[0]
    return w.flip(2, 3).permute(1, 2, 3, 0).reshape(c, 9, c).to(dtype).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def resblock_fwd(x, w1, w2, gamma, beta, padding_type="reflect", relu_mid=True, eps=1e-5):
    """x (B, C, H, W) f32 or bf16, w1/w2 (C, C, 3, 3), gamma/beta (B, C) ->
    (out (B, C, H, W) in x's dtype, h1, h2 (B, H, W, C), stats (B, 4, C) f32)."""
    if padding_type == "replicate":
        raise ValueError("the fused resblock supports reflect/zero padding only")
    if x.device.type == "cpu":
        return resblock_fwd_plain(x, w1, w2, gamma, beta, padding_type, relu_mid, eps)
    with profiling.span("mt.k.resblock_fwd"):
        _check(x, w1, w2, gamma, beta, padding_type)
        dtype = x.dtype
        b, c, h, w = x.shape
        reflect = int(padding_type == "reflect")
        gamma, beta = _f32(gamma), _f32(beta)
        run = _Launcher(dtype, x.device)
        with torch.cuda.device(x.device):
            x = x.detach().contiguous()
            pad = torch.empty((b, h + 2, w + 2, c), device=x.device, dtype=dtype)
            h1, h2 = (torch.empty((b, h, w, c), device=x.device, dtype=dtype) for _ in range(2))
            out = torch.empty_like(x)
            m1, r1, m2, r2 = (torch.empty((b, c), device=x.device) for _ in range(4))
            run("pad", x, pad, None, None, None, None, 0, b, h, w, c, reflect, 0, 1)
            run("conv", pad, _taps(w1, dtype), h1, b, h + 2, w + 2, c, c)
            run("stats", h1, m1, r1, b, h * w, c, float(eps))
            run("pad", h1, pad, m1, r1, gamma, beta, int(relu_mid), b, h, w, c, reflect, 0, 0)
            run("conv", pad, _taps(w2, dtype), h2, b, h + 2, w + 2, c, c)
            run("stats", h2, m2, r2, b, h * w, c, float(eps))
            run("residual", x, h2, m2, r2, gamma, beta, out, b, h * w, c)
        resblock_fwd.launches += 1
        return out, h1, h2, torch.stack([m1, r1, m2, r2], dim=1)


resblock_fwd.launches = 0


def resblock_bwd(x, h1, h2, g, stats, w1, w2, gamma, beta, padding_type="reflect",
                 relu_mid=True, eps=1e-5):
    """The VJP of :func:`resblock_fwd` at g (B, C, H, W) -> (dx (B, C, H, W)
    in x's dtype, dw1, dw2 (C, C, 3, 3) f32 summed over the batch, dgamma,
    dbeta (B, C) f32, each the sum over both norms)."""
    if x.device.type == "cpu":
        return resblock_bwd_plain(x, h1, h2, g, stats, w1, w2, gamma, beta, padding_type,
                                  relu_mid, eps)
    with profiling.span("mt.k.resblock_bwd"):
        _check(x, w1, w2, gamma, beta, padding_type)
        dtype = x.dtype
        b, c, h, w = x.shape
        reflect = int(padding_type == "reflect")
        relu = int(relu_mid)
        gamma, beta = _f32(gamma), _f32(beta)
        m1, r1, m2, r2 = (t.contiguous() for t in stats.unbind(dim=1))
        run = _Launcher(dtype, x.device)
        with torch.cuda.device(x.device):
            x = x.detach().contiguous()
            g = g.detach().to(dtype).contiguous()
            gh = torch.empty((b, h, w, c), device=x.device, dtype=dtype)
            run("nhwc", g, gh, b, c, h, w)
            sg, sgy, sd, sdy = (torch.empty((b, c), device=x.device) for _ in range(4))
            # dh and the wgrad's conv inputs (padded, in a zero ring) share the
            # (H+4, W+4) grid
            dh = torch.empty((b, h + 4, w + 4, c), device=x.device, dtype=dtype)
            wide = torch.empty_like(dh)
            dp = torch.empty((b, h + 2, w + 2, c), device=x.device, dtype=dtype)
            dw1, dw2 = (torch.empty((c, c, 3, 3), device=x.device) for _ in range(2))
            dx = torch.empty_like(x)
            # norm2: dh2 (padded by 2) from g
            run("norm_bwd", gh, 0, reflect, h2, m2, r2, gamma, beta, 0, sg, sgy, None, b, h, w, c)
            run("norm_bwd", gh, 0, reflect, h2, m2, r2, gamma, beta, 0, sg, sgy, dh, b, h, w, c)
            # dW2 from a1 = relu(norm1(h1)), padded; da1 = dgrad of dh2, unfolded
            run("pad", h1, wide, m1, r1, gamma, beta, relu, b, h, w, c, reflect, 1, 0)
            run("wgrad", wide, dh, dw2, b, h, w, c, c)
            run("conv", dh, _taps_flipped(w2, dtype), dp, b, h + 4, w + 4, c, c)
            # norm1 through the pad adjoint and the relu mask: dh1 (padded by 2)
            run("norm_bwd", dp, 1, reflect, h1, m1, r1, gamma, beta, relu, sd, sdy, None,
                b, h, w, c)
            run("norm_bwd", dp, 1, reflect, h1, m1, r1, gamma, beta, relu, sd, sdy, dh, b, h, w, c)
            # dW1 from pad(x); dx = g + the folded dgrad of dh1
            run("pad", x, wide, None, None, None, None, 0, b, h, w, c, reflect, 1, 1)
            run("wgrad", wide, dh, dw1, b, h, w, c, c)
            run("conv", dh, _taps_flipped(w1, dtype), dp, b, h + 4, w + 4, c, c)
            run("dx", g, dp, dx, b, h, w, c, reflect)
        resblock_bwd.launches += 1
        return dx, dw1, dw2, sgy + sdy, sg + sd


resblock_bwd.launches = 0


class FusedResblock(torch.autograd.Function):
    """The block with its analytic VJP (the JAX package's custom_vjp
    ``_fused_fn``): forward saves (x, h1, h2, stats), backward is kernel 10."""

    @staticmethod
    def forward(ctx, x, w1, w2, gamma, beta, padding_type, relu_mid, eps):
        out, h1, h2, stats = resblock_fwd(x, w1, w2, gamma, beta, padding_type, relu_mid, eps)
        ctx.save_for_backward(x, w1, w2, gamma, beta, h1, h2, stats)
        ctx.config = (padding_type, relu_mid, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w1, w2, gamma, beta, h1, h2, stats = ctx.saved_tensors
        dx, dw1, dw2, dgamma, dbeta = resblock_bwd(x, h1, h2, g, stats, w1, w2, gamma, beta,
                                                   *ctx.config)
        return (dx, dw1.to(w1.dtype), dw2.to(w2.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None, None, None)


def fused_resblock(x, w1, w2, gamma, beta, padding_type="reflect", relu_mid=True, eps=1e-5):
    """The whole block in x's dtype; differentiable in x, w1, w2, gamma and
    beta. Without a gradient to keep, only the forward runs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, w2, gamma, beta)):
        return FusedResblock.apply(x, w1, w2, gamma, beta, padding_type, bool(relu_mid),
                                   float(eps))
    return resblock_fwd(x, w1, w2, gamma, beta, padding_type, relu_mid, eps)[0]
