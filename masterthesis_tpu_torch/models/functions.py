"""Initialization, the lr schedule and the optimizer.

The port of ``masterthesis_tpu/models/functions.py``:

- :func:`init_net` draws every parameter by the JAX package's scheme;
- :func:`make_lr_schedule`: 'step' (x0.1 every ``n_iter_decay``), 'lambda'
  (linear decay after ``n_iter_decay``) or 'constant', read once per update
  from the global step, in f32 as the JAX schedule computes;
- :func:`apply_updates`: the optax chain of ``make_optimizer``, global-norm
  clip (optional) -> + wd * p -> Adam moments (bias-corrected, eps 1e-8) ->
  x (-lr), written out as tensor code. optax updates every parameter, one
  whose gradient is zero too (decay and the moments still move it), where
  ``torch.optim`` would skip a parameter whose ``.grad`` is None; here a
  missing gradient is a zero gradient.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from masterthesis_tpu_torch.models.blocks import BatchNorm2d, Conv2d, ConvTranspose2d
from masterthesis_tpu_torch.models.state import AdamState
from masterthesis_tpu_torch.ops.initializers import conv_kernel, uniform_fan_in
from masterthesis_tpu_torch.ops.norms import LayerNorm
from masterthesis_tpu_torch.ops.spectral import SpectralNorm, l2_normalize


@torch.no_grad()
def init_net(net: nn.Module, generator: torch.Generator, init_type=None,
             init_gain: float = 0.02) -> None:
    """Draw every parameter of ``net`` by the JAX package's scheme, in module
    order, and each spectral norm's ``u`` as Flax does: a normalized normal draw."""
    for m in net.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.weight.copy_(conv_kernel(m.weight.shape, generator, init_type, init_gain,
                                       transposed=isinstance(m, ConvTranspose2d)))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.copy_(uniform_fan_in(m.weight.shape, m.in_features, generator))
            if m.bias is not None:
                m.bias.copy_(uniform_fan_in(m.bias.shape, m.in_features, generator))
        elif isinstance(m, (LayerNorm, BatchNorm2d)) and m.scale is not None:
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, SpectralNorm):
            m.u.copy_(l2_normalize(torch.randn(m.u.shape, generator=generator)))


def make_lr_schedule(lr: float, lr_policy: str = "step", n_iters: int = 1_000_000,
                     n_iter_decay: int = 600_000) -> Callable[[int], float]:
    """lr(step) as an f32 value (returned as a Python float)."""
    lr32 = np.float32(lr)
    if lr_policy == "step":
        def schedule(step: int) -> float:
            return float(lr32 * np.power(np.float32(0.1), np.float32(step // n_iter_decay)))
    elif lr_policy == "lambda":
        def schedule(step: int) -> float:
            over = np.maximum(np.float32(0.0), np.float32(step) - np.float32(n_iter_decay))
            return float(lr32 * (np.float32(1.0) - over / np.float32(n_iters - n_iter_decay + 1)))
    elif lr_policy == "constant":
        def schedule(step: int) -> float:
            return float(lr32)
    else:
        raise NotImplementedError(f"Learning rate policy {lr_policy} is not implemented")
    return schedule


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
                  state: AdamState, lr: float, beta1: float = 0.5, beta2: float = 0.999,
                  weight_decay: float = 1e-4, clip_norm: Optional[float] = None,
                  eps: float = 1e-8) -> None:
    """One optimizer step, in place on ``params`` and ``state``; a None
    gradient is a zero one. Without a host sync: the clip is a select."""
    params = list(params)
    grads = [torch.zeros_like(p) if g is None else g.float() for p, g in zip(params, grads)]
    if clip_norm is not None:
        g_norm = torch.sqrt(sum(g.square().sum() for g in grads))
        keep = g_norm < clip_norm
        grads = [torch.where(keep, g, (g / g_norm) * clip_norm) for g in grads]
    if weight_decay:
        grads = [g + weight_decay * p for g, p in zip(grads, params)]
    state.count += 1
    bc1 = float(np.float32(1.0) - np.power(np.float32(beta1), np.float32(state.count)))
    bc2 = float(np.float32(1.0) - np.power(np.float32(beta2), np.float32(state.count)))
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        mu.copy_((1 - beta1) * g + beta1 * mu)
        nu.copy_((1 - beta2) * g.square() + beta2 * nu)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        p.add_((update * -1.0) * lr)
