"""The nets of AdaINModel's inference path (NCHW).

Ports of ``masterthesis_tpu/models/networks.py``: ``ContentEncoder``,
``ReparameterizedStyleEncoder``, ``_StyleMLP``, ``_DecoderTail`` and
``AdaINDecoder``, with the Flax child names (``stem``, ``down0``, ``res0``,
``linear.fc0``, ``dec1_0``, ``dec2.up0``, ``dec2.head``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from masterthesis_tpu_torch.models.blocks import (
    AdaINResnetBlock,
    ConvBlock,
    Dense,
    DownResnetBlock,
    GaussianNoise,
    ResnetBlock,
    UpsampleBlock,
    apply_pending,
    get_activation,
    global_avg_pool,
    split_pending,
)

MAX_FILTER_SIZE = 256


def concat_label(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Broadcast one-hot domain labels (N, K) over H, W and concat on channels."""
    n, _, h, w = x.shape
    c_map = c[:, :, None, None].expand(n, c.shape[1], h, w).to(x.dtype)
    return torch.cat([x, c_map], dim=1)


class ContentEncoder(nn.Module):
    """7x7 stem -> num_downs stride-2 convs -> n_blocks resblocks.
    Output channels: dim * 2**num_downs."""

    def __init__(self, input_dim: int = 3, dim: int = 64, num_downs: int = 2, n_blocks: int = 4,
                 norm: Optional[str] = "instance", padding_type: str = "reflect",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        common = dict(use_bias=use_bias, norm=norm, padding_type=padding_type, dtype=dtype)
        self.stem = ConvBlock(input_dim, dim, 7, 1, 3, activation="lrelu", **common)
        d = dim
        for i in range(num_downs):
            setattr(self, f"down{i}", ConvBlock(d, 2 * d, 3, 2, 1, activation="relu", **common))
            d *= 2
        self.num_downs, self.n_blocks, self.output_dim = num_downs, n_blocks, d
        for i in range(n_blocks):
            setattr(self, f"res{i}", ResnetBlock(d, norm=norm, activation="relu", dtype=dtype))
        self.noise = GaussianNoise()

    def forward(self, x, serving: bool = False):
        """``serving``: the int8 chain. The stem and the downs defer their
        instance norm and activation into the next down conv's quantize
        prologue, with the downs' statistics from their kernels; the last
        down's is applied inline before the resblocks."""
        h, pending = split_pending(self.stem(x, defer_norm=serving))
        for i in range(self.num_downs):
            h, pending = split_pending(getattr(self, f"down{i}")(h, pending, defer_norm=serving))
        if pending is not None:
            h = apply_pending(h, pending, h.dtype)
        for i in range(self.n_blocks):
            h = getattr(self, f"res{i}")(h)
        return self.noise(h)


class ReparameterizedStyleEncoder(nn.Module):
    """VAE style encoder returning (z, mu, logvar).

    The JAX module draws its eps from a flax rng stream; here the caller hands
    eps in (``None`` gives z = mu, the deterministic path).
    """

    def __init__(self, input_dim: int = 3, output_dim: int = 8, dim: int = 64, n_blocks: int = 4,
                 num_domains: int = 2, norm: Optional[str] = None, activation: str = "lrelu",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        # the stem is a 4x4/s2/p1 reflect conv with neither norm nor activation
        self.stem = ConvBlock(input_dim + num_domains, dim, 4, 2, 1, use_bias=use_bias,
                              padding_type="reflect", dtype=dtype)
        d = dim
        for i in range(1, n_blocks):
            out_d = min(MAX_FILTER_SIZE, d * 2)
            setattr(self, f"down{i}", DownResnetBlock(
                min(MAX_FILTER_SIZE, d), out_d, norm=norm, activation=activation,
                use_bias=use_bias, dtype=dtype,
            ))
            d *= 2
        self.n_blocks = n_blocks
        self.act = get_activation(activation)
        self.fc = Dense(min(MAX_FILTER_SIZE, d), output_dim, dtype=dtype)
        self.fcVar = Dense(min(MAX_FILTER_SIZE, d), output_dim, dtype=dtype)

    def forward(self, x, c, eps: Optional[torch.Tensor] = None):
        h = self.stem(concat_label(x, c))
        for i in range(1, self.n_blocks):
            h = getattr(self, f"down{i}")(h)
        h = global_avg_pool(self.act(h))
        mu, logvar = self.fc(h), self.fcVar(h)
        z = mu if eps is None else mu + eps.to(mu.dtype) * torch.exp(0.5 * logvar)
        return z, mu, logvar


class _StyleMLP(nn.Module):
    """(z, c) -> style vector: three Dense layers on [c, z] (that order)."""

    def __init__(self, in_features: int, out_features: int, hidden: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc0 = Dense(in_features, hidden, dtype=dtype)
        self.fc1 = Dense(hidden, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, out_features, dtype=dtype)

    def forward(self, z, c):
        h = torch.cat([c.to(z.dtype), z], dim=-1)
        h = torch.relu(self.fc0(h))
        h = torch.relu(self.fc1(h))
        return self.fc2(h)


class _DecoderTail(nn.Module):
    """num_ups transposed-conv upsamples with norm + activation, then a 1x1
    tanh head (no bias)."""

    def __init__(self, output_dim: int, dim: int, num_ups: int = 2, up_type: str = "transpose",
                 norm: Optional[str] = "layer", activation: Optional[str] = "relu",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if "transpose" not in up_type:
            raise NotImplementedError(f"up_type '{up_type}' is not ported yet")
        d = dim
        for i in range(num_ups):
            setattr(self, f"up{i}", UpsampleBlock(
                d, d // 2, 3, 2, 1, 1, use_bias=use_bias, norm=norm, activation=activation,
                up_type=up_type, dtype=dtype,
            ))
            d //= 2
        self.num_ups, self.norm_type, self.activation = num_ups, norm, activation
        self.head = UpsampleBlock(d, output_dim, 1, 1, 0, activation="tanh", dtype=dtype)

    def forward(self, h):
        # int8 serving: each upsample hands its LayerNorm + relu to the next
        # kernel's prologue, the last one to the head's (inert on the float
        # path: only an int8 upsample returns the statistics to defer)
        fusible = self.norm_type == "layer" and self.activation in ("relu", None)
        pending = None
        for i in range(self.num_ups):
            h, pending = split_pending(getattr(self, f"up{i}")(h, pending, defer_norm=fusible))
        return self.head(h, pending)


class AdaINDecoder(nn.Module):
    """One style code from the style MLP modulates n_blocks AdaIN resblocks,
    then the upsampling tail."""

    def __init__(self, output_dim: int = 3, dim: int = 256, n_blocks: int = 4,
                 num_domains: int = 2, num_ups: int = 2, latent_dim: int = 8,
                 up_type: str = "transpose", norm: Optional[str] = "layer",
                 activation: Optional[str] = "relu", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = _StyleMLP(latent_dim + num_domains, dim, dtype=dtype)
        for i in range(n_blocks):
            setattr(self, f"dec1_{i}", AdaINResnetBlock(dim, dim, dtype=dtype))
        self.n_blocks = n_blocks
        self.dec2 = _DecoderTail(output_dim, dim, num_ups, up_type, norm, activation,
                                 use_bias, dtype=dtype)

    def forward(self, x, z, c):
        style = self.linear(z, c)
        h = x
        for i in range(self.n_blocks):
            h = getattr(self, f"dec1_{i}")(h, style)
        return self.dec2(h)
