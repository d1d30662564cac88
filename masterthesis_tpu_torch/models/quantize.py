"""Post-training quantization helpers (int8 serving).

The port of ``masterthesis_tpu/models/quantize.py``, over the port's module
names. An amax tree is one flat dict per net, ``{"down0.conv.amax_in":
scalar tensor, ...}``: the key is the conv's module path, as the JAX quant
collection's leaf ``down0/conv/amax_in`` is its Flax path.
"""
from __future__ import annotations

import torch
from torch import nn

from masterthesis_tpu_torch.models.blocks import Conv2d, ConvTranspose2d

LEAF = "amax_in"


def int8_convs(net: nn.Module) -> dict[str, nn.Module]:
    """Every conv of ``net`` that calibration measures, by module path: each
    Conv2d and each k3/s2/p1/op1 transposed conv, as the JAX convs sow."""
    return {
        name: m for name, m in net.named_modules()
        if isinstance(m, (Conv2d, ConvTranspose2d)) and m.calibrates
    }


def merge_amax(acc, new):
    """Elementwise max of two amax trees of one net (None-safe)."""
    if acc is None:
        return new
    if set(acc) != set(new):
        raise KeyError(f"amax trees differ: {sorted(set(acc) ^ set(new))}")
    return {k: torch.maximum(acc[k], new[k]) for k in acc}


def extract_amax(net: nn.Module) -> dict[str, torch.Tensor]:
    """The amax tree that one calibration pass over ``net`` recorded."""
    return {f"{name}.{LEAF}": m.calib_amax.clone() for name, m in int8_convs(net).items()}
