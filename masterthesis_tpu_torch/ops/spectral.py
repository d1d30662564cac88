"""Spectral normalization of conv kernels (``--dis_sn``).

The port of ``masterthesis_tpu/ops/spectral.py``: the kernel is divided by
its leading singular value, estimated by one f32 power iteration (eps 1e-12)
on the (out, rest) matricization, from a stored vector ``u`` of shape
(out,). ``u`` and ``v`` carry no gradient. The port's OIHW kernel gives the
JAX package's (out, kh*kw*in) matrix with its columns permuted, which
changes neither sigma nor ``u``; ``v`` is never stored.

``u`` is a buffer of :class:`SpectralNorm` (``<conv>.sn.u`` in a
state_dict, ``<conv>/sn/u`` in the JAX state's ``extra`` tree). Every
forward iterates from the stored ``u``; only a forward inside
:func:`recording` keeps its new ``u`` (and a second call there iterates
from it), which :func:`commit` then stores, as
the JAX package stores the ``spectral`` collection of the D update's
combined forward once the update's loss is taken: the gradient penalty's D
forward and the generators' D forwards iterate from the stored ``u`` and
store nothing.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

EPS = 1e-12


def l2_normalize(v: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class SpectralNorm(nn.Module):
    """kernel / sigma(kernel), with the power iteration's ``u`` as a buffer."""

    def __init__(self, out_features: int):
        super().__init__()
        self.register_buffer("u", torch.zeros(out_features))
        self.record = False
        self.new_u = None  # the last recorded forward's u, until commit

    def forward(self, kernel: torch.Tensor) -> torch.Tensor:
        w = kernel.float().reshape(kernel.shape[0], -1)
        # a recording net called again (the multi-scale trunk, once per
        # scale) iterates on from its last u, as a mutable Flax variable does
        u = self.new_u if self.record and self.new_u is not None else self.u
        with torch.no_grad():
            v = l2_normalize(w.t() @ u)
            u = l2_normalize(w @ v)
        if self.record:
            self.new_u = u
        sigma = u @ w @ v
        return (kernel.float() / sigma).to(kernel.dtype)


def _modules(net: nn.Module):
    return [m for m in net.modules() if isinstance(m, SpectralNorm)]


@contextlib.contextmanager
def recording(net: nn.Module):
    """Inside the block, ``net``'s spectral norms keep their new ``u``."""
    mods = _modules(net)
    for m in mods:
        m.record, m.new_u = True, None
    try:
        yield
    finally:
        for m in mods:
            m.record = False


@torch.no_grad()
def commit(net: nn.Module) -> None:
    """Store each recorded ``u`` of ``net``."""
    for m in _modules(net):
        if m.new_u is not None:
            m.u.copy_(m.new_u)
            m.new_u = None
