"""Training state: the global step and each net's Adam moments.

The port of ``masterthesis_tpu/models/state.py``. The parameters themselves
live in the nets (``nn.Module``s) and are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class AdamState:
    """optax ``scale_by_adam``'s state of one net: the update count and the
    first and second moments, one per parameter, in ``parameters()`` order."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]

    @classmethod
    def zeros(cls, params) -> "AdamState":
        params = list(params)
        return cls(0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


@dataclass
class TrainState:
    step: int = 0  # global iteration, read by the lr schedule
    opt_state: dict[str, AdamState] = field(default_factory=dict)
