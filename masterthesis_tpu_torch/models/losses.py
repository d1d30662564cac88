"""Loss functions: the port of ``masterthesis_tpu/models/losses.py:34-129``.

Every loss computes in f32 whatever its inputs' dtype, and reduces by the
mean over all elements, except :func:`kl_divergence`, which sums, as the
reference does. The VGG perceptual loss is not ported: it needs VGG weights,
which the repository does not hold.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

GAN_MODES = ("vanilla", "bce", "lsgan", "wgangp", "hinge")


def bce_logits_loss(logits: torch.Tensor, targets) -> torch.Tensor:
    """Mean binary cross entropy with logits, max(x, 0) - x t + log1p(exp(-|x|))."""
    x = logits.float()
    t = torch.as_tensor(targets, dtype=torch.float32, device=x.device)
    return (x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def bce_loss(probs: torch.Tensor, targets, eps: float = 1e-12) -> torch.Tensor:
    """Mean binary cross entropy on probabilities."""
    p = probs.float().clamp(eps, 1.0 - eps)
    t = torch.as_tensor(targets, dtype=torch.float32, device=p.device)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()


def mse_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float() - y.float()).square().mean()


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float() - y.float()).abs().mean()


def gan_loss(pred: torch.Tensor, target_is_real: bool, mode: str = "vanilla") -> torch.Tensor:
    """Adversarial loss against a constant real or fake target."""
    pred = pred.float()
    if mode == "wgangp":
        return -pred.mean() if target_is_real else pred.mean()
    if mode == "hinge":
        return F.relu(1.0 - pred).mean() if target_is_real else F.relu(1.0 + pred).mean()
    target = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
    if mode == "vanilla":
        return bce_logits_loss(pred, target)
    if mode == "bce":
        return bce_loss(pred, target)
    if mode == "lsgan":
        return mse_loss(pred, target)
    raise NotImplementedError(f"Loss {mode} is not implemented")


def hinge_d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor) -> torch.Tensor:
    return F.relu(1.0 - pred_real.float()).mean() + F.relu(1.0 + pred_fake.float()).mean()


def hinge_g_loss(pred_fake: torch.Tensor) -> torch.Tensor:
    return -pred_fake.float().mean()


def ragan_loss(pred_real, pred_fake, real_is_target: bool, mode: str) -> torch.Tensor:
    """Relativistic average GAN loss; ``real_is_target`` is the D direction."""
    r, f = pred_real.float(), pred_fake.float()
    rel_r, rel_f = r - f.mean(), f - r.mean()
    if real_is_target:
        return (gan_loss(rel_r, True, mode) + gan_loss(rel_f, False, mode)) / 2
    return (gan_loss(rel_r, False, mode) + gan_loss(rel_f, True, mode)) / 2


def l2_regularize(x: torch.Tensor) -> torch.Tensor:
    return x.float().square().mean()


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Summed VAE KL: -0.5 * sum(1 + logvar - mu^2 - exp(logvar))."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * (1.0 + logvar - mu.square() - torch.exp(logvar)).sum()
