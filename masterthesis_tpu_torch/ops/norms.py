"""Normalization ops for NCHW feature maps.

The port of ``masterthesis_tpu/ops/norms.py``:

- ``instance_norm``: per-sample, per-channel over (H, W); eps 1e-5, no affine.
- ``layer_norm``: per-sample over (C, H, W) with a per-channel affine (the
  original's custom LayerNorm, not ``torch.nn.LayerNorm``).
- ``adain``: instance norm modulated by a style-predicted ``(1 + gamma, beta)``.

Statistics are f32 whatever the input dtype, and the result is cast back to
it. Every statistics pass is one launch of the moments kernel
(``ops/kernels/moments.py``), as the JAX package runs with
``MT_PALLAS_MOMENTS=1``: mean and the one-pass variance max(E[x^2] - mean^2, 0)
come from its f32 sums. AdaIN is one launch of the AdaIN kernel
(``ops/kernels/adain.py``), as with ``MT_ENABLE_PALLAS=1``. The normalize
itself is plain torch.

Gradients. Statistics are a ``torch.autograd.Function`` whose backward is the
JAX package's ``_moments_bwd`` (``ops/pallas/moments.py:267-277``):
dx = (dmean + 2 (x - mean) dvar) / N; autograd through the normalize then
gives the analytic instance- and layer-norm VJPs of ``ops/norms.py``. That
backward is itself differentiable (torch ops on x and the saved mean), so
WGAN-GP's double backward runs through it; on the CPU an f64 input keeps
f64 statistics, for ``gradgradcheck``. AdaIN
is a Function whose backward is ``_fused_adain_bwd`` (``ops/pallas/adain.py``),
over centered statistics. Both backwards are elementwise torch, as in the JAX
package, where they are jnp and no Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import moments as kmoments

EPS = 1e-5


class _Moments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, per_sample):
        s1, s2 = kmoments.moments(x)
        b, c, h, w = x.shape
        n = h * w
        if per_sample:
            s1 = s1.sum(dim=1, keepdim=True)
            s2 = s2.sum(dim=1, keepdim=True)
            n *= c
        mean = (s1 / n)[:, :, None, None]
        var = (s2 / n)[:, :, None, None] - mean.square()
        ctx.save_for_backward(x, mean)
        ctx.n = n
        return mean, var.clamp_min(0.0)

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        dx = (dmean + 2.0 * (x.to(mean.dtype) - mean) * dvar) / ctx.n
        return dx.to(x.dtype), None


def moments(x: torch.Tensor, per_sample: bool = False):
    """f32 (f64 for f64 ``x``) mean and variance of NCHW ``x`` over (H, W),
    shaped (B, C, 1, 1), or over (C, H, W) when ``per_sample``, shaped
    (B, 1, 1, 1)."""
    return _Moments.apply(x, per_sample)


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    mean, var = moments(x)
    return ((x.to(mean.dtype) - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale=None, bias=None, eps: float = EPS) -> torch.Tensor:
    """Normalize each sample over (C, H, W); ``scale``/``bias`` are (C,)."""
    mean, var = moments(x, per_sample=True)
    y = (x.to(mean.dtype) - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()[:, None, None]
    if bias is not None:
        y = y + bias.float()[:, None, None]
    return y.to(x.dtype)


class _AdaIN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return kadain.adain(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        x32, g32 = x.float(), g.float()
        mean = x32.mean(dim=(2, 3), keepdim=True)
        rstd = torch.rsqrt((x32 - mean).square().mean(dim=(2, 3), keepdim=True) + ctx.eps)
        x_hat = (x32 - mean) * rstd
        gx = g32 * x_hat
        scale = (1.0 + gamma)[:, :, None, None] * rstd
        dx = scale * (g32 - g32.mean(dim=(2, 3), keepdim=True)
                      - x_hat * gx.mean(dim=(2, 3), keepdim=True))
        return dx.to(x.dtype), gx.sum(dim=(2, 3)), g32.sum(dim=(2, 3)), None


def adain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = EPS):
    """``(1 + gamma) * IN(x) + beta``; gamma and beta are (B, C)."""
    return _AdaIN.apply(x, gamma.float().contiguous(), beta.float().contiguous(), eps)


class InstanceNorm(nn.Module):
    """Parameter-free instance normalization."""

    def __init__(self, eps: float = EPS):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return instance_norm(x, self.eps)


class LayerNorm(nn.Module):
    """The original's LayerNorm: normalize over (C, H, W), per-channel affine."""

    def __init__(self, num_features: int, affine: bool = True, eps: float = EPS):
        super().__init__()
        self.eps = eps
        if affine:
            self.scale = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("scale", None)
            self.register_parameter("bias", None)

    def forward(self, x, stats=None, defer: bool = False):
        """``stats``: f32 per-(sample, channel) (sum, sumsq) of x, (B, C)
        each, from the int8 serving conv that made x; they replace the
        moments pass. ``defer`` (needs ``stats``): return the whole norm as a
        per-(sample, channel) affine (a, b), for the next kernel's prologue,
        instead of applying it."""
        if stats is None:
            if defer:
                raise ValueError("LayerNorm(defer=True) needs the stats of x")
            return layer_norm(x, self.scale, self.bias, self.eps)
        b, c, h, w = x.shape
        n = float(c * h * w)
        mean = stats[0].sum(dim=1) / n
        var = (stats[1].sum(dim=1) / n - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + self.eps)
        g = self.scale.float() if self.scale is not None else torch.ones(c, device=x.device)
        beta = self.bias.float() if self.bias is not None else torch.zeros(c, device=x.device)
        a = g[None, :] * inv[:, None]
        shift = beta[None, :] - mean[:, None] * a
        if defer:
            return a, shift
        y = x.float() * a[:, :, None, None] + shift[:, :, None, None]
        return y.to(x.dtype)


class AdaptiveInstanceNorm(nn.Module):
    """AdaIN with a style -> (gamma, beta) projection.

    Calling one instance twice, as ``AdaINResnetBlock`` does, shares the
    projection between its two norms.
    """

    def __init__(self, num_features: int, style_dim: int, eps: float = EPS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.style_proj = nn.Linear(style_dim, 2 * num_features)

    def forward(self, x, s):
        p = self.style_proj
        h = F.linear(s.to(self.dtype), p.weight.to(self.dtype), p.bias.to(self.dtype))
        gamma, beta = h.chunk(2, dim=-1)
        return adain(x, gamma, beta, self.eps)
