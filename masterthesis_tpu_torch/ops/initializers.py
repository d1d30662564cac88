"""Weight initializers with the JAX package's init semantics.

The scheme (``masterthesis_tpu/ops/initializers.py``, after the original's
init_weights): conv kernels are built with torch's default
kaiming-uniform, variance 1/(3*fan_in), and then, when an ``init_type`` is
given, drawn again from it with their biases zeroed; linear layers keep
torch's default U(+-1/sqrt(fan_in)) weight and bias. ``fan_in`` of a conv is
k*k*in_channels, for a transposed conv too.

Draws come from an explicit ``torch.Generator`` and are made on the CPU, so
a seed gives the same weights on any device. The streams differ from
``jax.random``'s: tests carry the JAX weights across instead
(``tools/convert_jax.py``).
"""
from __future__ import annotations

import math

import torch


def uniform_fan_in(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """U(+-1/sqrt(fan_in)): torch's default Linear weight and bias, and its
    default conv kernel (variance 1/(3*fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def conv_kernel(shape, fan_in: int, generator: torch.Generator,
                init_type: str | None = None, init_gain: float = 0.02) -> torch.Tensor:
    """A conv kernel of ``shape`` drawn by ``init_type``."""
    if init_type is None:
        return uniform_fan_in(shape, fan_in, generator)
    if init_type == "normal":
        return torch.empty(shape).normal_(0.0, init_gain, generator=generator)
    raise NotImplementedError(f"initialization method [{init_type}] is not ported yet")
