"""Abstract model: the net registry, its device and its weights.

The inference subset of ``masterthesis_tpu/models/model.py``: nets are
``nn.Module``s on one device, built with the JAX package's init scheme from
a seeded ``torch.Generator`` (:meth:`Model.initialize`) or loaded from
converted JAX params (:meth:`Model.load_params`, ``tools/convert_jax.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from masterthesis_tpu_torch.arguments import AttributeDict
from masterthesis_tpu_torch.models.blocks import Conv2d, ConvTranspose2d
from masterthesis_tpu_torch.ops.initializers import conv_kernel, uniform_fan_in
from masterthesis_tpu_torch.ops.norms import LayerNorm


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one that is an error, not the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        device = "cuda"
    return torch.device(device)


@torch.no_grad()
def init_net(net: nn.Module, generator: torch.Generator, init_type=None,
             init_gain: float = 0.02) -> None:
    """Draw every parameter of ``net`` by the JAX package's scheme, in module order."""
    for m in net.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.weight.copy_(conv_kernel(m.weight.shape, m.fan_in, generator, init_type, init_gain))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            m.weight.copy_(uniform_fan_in(m.weight.shape, m.in_features, generator))
            if m.bias is not None:
                m.bias.copy_(uniform_fan_in(m.bias.shape, m.in_features, generator))
        elif isinstance(m, LayerNorm) and m.scale is not None:
            m.scale.fill_(1.0)
            m.bias.zero_()


class Model:
    """Base model: nets by name on ``self.device``."""

    def __init__(self, args, device=None):
        self.args = args
        self.device = resolve_device(device)
        self.nets: dict[str, nn.Module] = AttributeDict()

    def initialize(self, seed=None) -> None:
        """Seeded init of every net (``args.seed`` unless ``seed`` is given)."""
        a = self.args
        if seed is None:
            seed = getattr(a, "seed", None) or 0
        g = torch.Generator().manual_seed(int(seed))
        init_type = getattr(a, "init_type", "normal")
        init_gain = float(getattr(a, "init_gain", None) or 0.02)
        for net in self.nets.values():
            init_net(net, g, init_type, init_gain)

    def load_params(self, state_dicts: dict) -> None:
        """Load one state_dict per net; every net and every key must be there."""
        if set(state_dicts) != set(self.nets):
            raise KeyError(f"state_dicts for {sorted(state_dicts)}, nets are {sorted(self.nets)}")
        for name, net in self.nets.items():
            net.load_state_dict(state_dicts[name], strict=True)
