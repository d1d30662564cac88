"""Abstract model: the net registry, its device, its weights and, for
training, its optimizer state.

The port of ``masterthesis_tpu/models/model.py``: nets are ``nn.Module``s on
one device, built with the JAX package's init scheme from a seeded
``torch.Generator`` (:meth:`Model.initialize`) or loaded from converted JAX
params (:meth:`Model.load_params`, ``tools/convert_jax.py``). A training
model (``args.mode`` "train") also holds a :class:`TrainState` (the global
step and each net's Adam moments), the lr schedule, and a generator on its
device from which its training steps draw.
"""
from __future__ import annotations

import torch
from torch import nn

from masterthesis_tpu_torch.arguments import AttributeDict
from masterthesis_tpu_torch.models.functions import init_net, make_lr_schedule
from masterthesis_tpu_torch.models.state import AdamState, TrainState


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


class Model:
    """Base model: nets by name on ``self.device``."""

    def __init__(self, args, device=None):
        self.args = args
        self.device = resolve_device(device)
        self.nets: dict[str, nn.Module] = AttributeDict()
        self.state: TrainState | None = None
        self.generator: torch.Generator | None = None
        self.loss: dict = {}  # the last iteration's logs
        self.print_loss: list[str] = []  # the names print_losses reports
        self.schedule = make_lr_schedule(
            lr=args.lr or 1e-4, lr_policy=args.lr_policy or "step",
            n_iters=args.n_iters or 1_000_000, n_iter_decay=args.n_iter_decay or 600_000,
        )

    def is_train(self) -> bool:
        return "train" in (self.args.mode or "train")

    def initialize(self, seed=None) -> None:
        """Seeded init of every net (``args.seed`` unless ``seed`` is given);
        for training also fresh optimizer state at step 0 and the step's
        generator, on the model's device, seeded likewise."""
        a = self.args
        if seed is None:
            seed = getattr(a, "seed", None) or 0
        g = torch.Generator().manual_seed(int(seed))
        init_type = getattr(a, "init_type", "normal")
        init_gain = float(getattr(a, "init_gain", None) or 0.02)
        for net in self.nets.values():
            init_net(net, g, init_type, init_gain)
        if self.is_train():
            self.state = TrainState(0, {
                name: AdamState.zeros(net.parameters()) for name, net in self.nets.items()
            })
            self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def optimizer_config(self, name: str) -> dict:
        """Adam's settings for net ``name``: the content discriminator's
        gradients are clipped to global norm 5, as in the JAX package."""
        a = self.args
        return dict(
            beta1=0.5 if a.beta1 is None else float(a.beta1),
            beta2=0.999 if a.beta2 is None else float(a.beta2),
            weight_decay=1e-4 if a.wd is None else float(a.wd),
            clip_norm=5.0 if name == "content_discriminator" else None,
        )

    def print_losses(self) -> dict[str, float]:
        """The last iteration's losses named in ``print_loss``, as floats."""
        return {k: float(v) for k, v in self.loss.items() if k in self.print_loss}

    def load_params(self, state_dicts: dict) -> None:
        """Load one state_dict per net; every net and every key must be there."""
        if set(state_dicts) != set(self.nets):
            raise KeyError(f"state_dicts for {sorted(state_dicts)}, nets are {sorted(self.nets)}")
        for name, net in self.nets.items():
            net.load_state_dict(state_dicts[name], strict=True)
