"""Metrics base class and the flat-npz weight loader of the metric nets.

The port of ``masterthesis_tpu/metrics/metrics.py``: the reset / update /
compute contract with its feature-extractor plumbing. The extractor runs on
the metric's device (``device=None`` is the card, and without one that is
an error; ``device="cpu"`` runs there): :meth:`Metrics.features` puts NHWC
numpy arrays or tensors on it and returns the extractor's tensor without
waiting for it, :meth:`Metrics._extract_features` brings the features to
the host as numpy, checked.

:func:`load_flat_params` fills a module from the flat dict that the JAX
package's metric npz files hold (``"a/b/c"`` keys, HWIO conv kernels), so
that one file serves both packages.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from masterthesis_tpu_torch.models.model import resolve_device


def load_flat_params(module: nn.Module, flat: dict) -> None:
    """Fill ``module`` from ``flat``, a dict of ``"a/b/c"`` paths to arrays:
    the path with dots for slashes names the parameter, a conv ``kernel``
    (HWIO) becomes its ``weight`` (OIHW; a (1, 7) kernel stays (1, 7)),
    every other leaf (biases, the frozen batch-norm statistics, LPIPS's
    ``lin{i}`` heads) is taken as it is. Raises on a key that names no
    parameter of ``module``, on a parameter that no key sets and on a shape
    that differs."""
    want = module.state_dict()
    sd = {}
    for path, value in flat.items():
        parts = path.split("/")
        kernel = parts[-1] == "kernel"
        name = ".".join(parts[:-1] + ["weight"] if kernel else parts)
        if name not in want:
            raise KeyError(f"{type(module).__name__}: {path!r} names no parameter")
        value = np.asarray(value, np.float32)
        if kernel and value.ndim == 4:
            value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
        if tuple(value.shape) != tuple(want[name].shape):
            raise ValueError(f"{type(module).__name__}: {path!r} has shape {value.shape}, "
                             f"the parameter {tuple(want[name].shape)}")
        sd[name] = torch.from_numpy(np.ascontiguousarray(value))
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"{type(module).__name__}: no value for {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''} ({len(missing)} parameters)")
    module.load_state_dict(sd)


def load_npz(npz_path: str) -> dict:
    with np.load(npz_path) as data:
        return {k: data[k] for k in data.files}


def seeded_init(module: nn.Module) -> nn.Module:
    """Random weights from a CPU ``torch.Generator`` seeded with 0, so that
    a module built for the card and one built for the CPU hold the same:
    conv and linear weights normal with variance 1 / fan_in (Flax's lecun
    init, untruncated), biases 0; parameters that are not a conv's or a
    linear's keep their constructor's values."""
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
                if m.bias is not None:
                    m.bias.zero_()
    return module


class Metrics(ABC):
    """reset/update/compute contract with feature-extractor plumbing."""

    def __init__(
        self,
        num_features: int,
        feature_extractor: Optional[Callable] = None,
        output_transform: Callable = lambda x: x,
        device=None,
    ):
        self._num_features = num_features
        self._feature_extractor = feature_extractor
        self._output_transform = output_transform
        self.device = resolve_device(device)
        self.reset()

    def _check_feature_shapes(self, samples) -> None:
        if samples.ndim != 2:
            raise ValueError(
                f"expected (batch, features) from the feature extractor, "
                f"got a rank-{samples.ndim} array"
            )
        if samples.shape[0] == 0:
            raise ValueError("feature extractor returned an empty batch")
        if samples.shape[1] != self._num_features:
            raise ValueError(
                f"feature width mismatch: metric was built for "
                f"{self._num_features} features, extractor produced {samples.shape[1]}"
            )

    def features(self, inputs) -> torch.Tensor:
        """The extractor on ``inputs`` (NHWC numpy or tensor) as f32 on the
        metric's device; returns its tensor without waiting for it."""
        if isinstance(inputs, torch.Tensor):
            x = inputs.to(self.device, torch.float32)
        else:
            x = torch.as_tensor(np.asarray(inputs, np.float32), device=self.device)
        with torch.inference_mode():
            return self._feature_extractor(x)

    def _extract_features(self, inputs) -> np.ndarray:
        outputs = self.features(inputs)
        if isinstance(outputs, torch.Tensor):
            outputs = outputs.float().cpu().numpy()
        outputs = np.asarray(outputs)
        self._check_feature_shapes(outputs)
        return outputs

    @abstractmethod
    def reset(self) -> None:
        ...

    @abstractmethod
    def update(self, output) -> None:
        ...

    @abstractmethod
    def compute(self):
        ...
