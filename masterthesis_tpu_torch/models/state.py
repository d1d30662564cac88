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

    def state_dict(self) -> dict:
        """The checkpoint's form: ``{"count": int, "mu": [...], "nu": [...]}``."""
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, saved: dict) -> None:
        """Copy a :meth:`state_dict` in; every moment must match its
        parameter's shape, in order."""
        for key in ("mu", "nu"):
            mine, theirs = getattr(self, key), saved[key]
            shapes = [tuple(t.shape) for t in mine], [tuple(t.shape) for t in theirs]
            if shapes[0] != shapes[1]:
                raise ValueError(f"Adam {key}: saved shapes {shapes[1]} do not match {shapes[0]}")
        with torch.no_grad():
            for mine, theirs in zip(self.mu + self.nu, list(saved["mu"]) + list(saved["nu"])):
                mine.copy_(theirs)
        self.count = int(saved["count"])


@dataclass
class TrainState:
    step: int = 0  # global iteration, read by the lr schedule
    opt_state: dict[str, AdamState] = field(default_factory=dict)
