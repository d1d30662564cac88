"""Weight initializers with the JAX package's init semantics.

The scheme (``masterthesis_tpu/ops/initializers.py``, after the original's
init_weights): conv kernels are built with torch's default
kaiming-uniform, variance 1/(3*fan_in), and then, when an ``init_type`` is
given, drawn again from it with their biases zeroed; linear layers keep
torch's default U(+-1/sqrt(fan_in)) weight and bias.

Fans are those of the JAX kernel shape (k, k, in, out), for the transposed
conv too: fan_in = k*k*in, fan_out = k*k*out. ``xavier`` and ``kaiming`` are
``jax.nn.initializers``' ``variance_scaling`` with a normal truncated at
+-2 sigma (its std divided by 0.87962566, the std of a unit normal cut
there), not torch's untruncated ``xavier_normal_``/``kaiming_normal_``;
``orthogonal`` makes the ``out`` columns of the (k*k*in, out) matrix
orthonormal (its rows when there are fewer of them), scaled by the gain.
Those three and ``xavier_normal_exact`` draw the kernel in the JAX layout
and carry it into the port's (conv HWIO -> OIHW; transposed conv HWIO ->
IOHW, spatially flipped, as ``tools/convert_jax.py`` does), so that a
property of the JAX matrix holds of the port's kernel read back that way.

Draws come from an explicit ``torch.Generator`` and are made on the CPU, so
a seed gives the same weights on any device. The streams differ from
``jax.random``'s: tests carry the JAX weights across instead
(``tools/convert_jax.py``).
"""
from __future__ import annotations

import math

import torch

# the std of a unit normal truncated to (-2, 2), as jax.nn.initializers uses it
TRUNCATED_STD = 0.87962566103423978


def uniform_fan_in(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """U(+-1/sqrt(fan_in)): torch's default Linear weight and bias, and its
    default conv kernel (variance 1/(3*fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def hwio_shape(shape, transposed: bool = False) -> tuple[int, int, int, int]:
    """The JAX kernel shape (k, k, in, out) of a port weight: OIHW, or IOHW
    for a transposed conv."""
    a, b, kh, kw = shape
    return (kh, kw, a, b) if transposed else (kh, kw, b, a)


def hwio_to_port(kernel: torch.Tensor, transposed: bool = False) -> torch.Tensor:
    if transposed:
        return kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()
    return kernel.permute(3, 2, 0, 1).contiguous()


def _truncated(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    t = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * (std / TRUNCATED_STD)


def _orthogonal(shape, gain: float, generator: torch.Generator) -> torch.Tensor:
    """``jax.nn.initializers.orthogonal(scale=gain)`` on the HWIO ``shape``."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    a = torch.empty(max(n_rows, n_cols), min(n_rows, n_cols)).normal_(generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.t()
    return (gain * q).reshape(shape)


def hwio_kernel(shape, generator: torch.Generator, init_type: str,
                init_gain: float = 0.02) -> torch.Tensor:
    """A kernel of the JAX shape (k, k, in, out) drawn by ``init_type``, as
    ``get_conv_init`` of the JAX package draws it."""
    receptive = shape[0] * shape[1]
    fan_in, fan_out = receptive * shape[2], receptive * shape[3]
    if init_type == "xavier":
        return _truncated(shape, math.sqrt(init_gain ** 2 / ((fan_in + fan_out) / 2)), generator)
    if init_type == "kaiming":
        return _truncated(shape, math.sqrt(2.0 / fan_in), generator)
    if init_type == "xavier_normal_exact":
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return torch.empty(shape).normal_(0.0, 1.0, generator=generator) * std
    if init_type == "orthogonal":
        return _orthogonal(shape, init_gain, generator)
    raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


def conv_kernel(shape, generator: torch.Generator, init_type: str | None = None,
                init_gain: float = 0.02, transposed: bool = False) -> torch.Tensor:
    """A port conv weight of ``shape`` (OIHW; IOHW when ``transposed``)
    drawn by ``init_type``."""
    if init_type is None:
        hwio = hwio_shape(shape, transposed)
        return uniform_fan_in(shape, hwio[0] * hwio[1] * hwio[2], generator)
    if init_type == "normal":
        return torch.empty(shape).normal_(0.0, init_gain, generator=generator)
    return hwio_to_port(hwio_kernel(hwio_shape(shape, transposed), generator, init_type,
                                    init_gain), transposed)
