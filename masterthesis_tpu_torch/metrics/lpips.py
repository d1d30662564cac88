"""LPIPS (AlexNet backbone) perceptual distance.

The port of ``masterthesis_tpu/metrics/lpips.py`` (the reference's offline
LPIPS tool, src/misc/compute_lpips.py, with the lpips package's
net='alex'): the scaling layer, AlexNet's five conv + relu stacks (max
pools after the first two), per-layer unit norm over channels (eps 1e-10
outside the norm), the relu'd 1x1 ``lin{i}`` heads (initialised to ones),
the spatial mean, summed over the layers. NCHW inside, NHWC in [-1, 1] at
the entry; both images of a pair go through one AlexNet pass. Weights load
from the JAX package's flat npz (``alex/conv{i}/kernel|bias``, ``lin{i}``);
without them the metric is a random-projection distance, seeded from a
``torch.Generator`` (pipeline tests only).
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from masterthesis_tpu_torch.metrics.metrics import load_flat_params, load_npz, seeded_init
from masterthesis_tpu_torch.models.model import resolve_device

# AlexNet feature config: (features, kernel, stride, padding)
_ALEX_LAYERS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
# maxpool after these conv indices (torchvision alexnet.features)
_POOL_AFTER = {0, 1}


class AlexNetFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        c = 3
        for i, (f, k, s, p) in enumerate(_ALEX_LAYERS):
            self.add_module(f"conv{i}", nn.Conv2d(c, f, k, stride=s, padding=p))
            c = f

    def forward(self, x):
        outs = []
        for i in range(len(_ALEX_LAYERS)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            outs.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return outs


class LPIPS(nn.Module):
    """Learned perceptual distance; inputs in [-1, 1] NHWC, (N,) out."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1),
                             persistent=False)
        self.alex = AlexNetFeatures()
        for i, (f, _, _, _) in enumerate(_ALEX_LAYERS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(f)))

    def forward(self, x, y):
        n = x.shape[0]
        xy = torch.cat([x, y]).permute(0, 3, 1, 2)
        feats = self.alex((xy - self.shift) / self.scale)
        total = 0.0
        for i, f in enumerate(feats):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            diff = torch.square(f[:n] - f[n:])
            w = F.relu(getattr(self, f"lin{i}")).view(1, -1, 1, 1)
            # learned 1x1 head (non-negative weights in lpips) then spatial mean
            total = total + (diff * w).sum(dim=1).mean(dim=(1, 2))
        return total


def load_lpips_params(npz_path: str, model: Optional[LPIPS] = None) -> LPIPS:
    """``model`` (a new LPIPS if None) filled from the JAX package's flat npz."""
    model = LPIPS() if model is None else model
    load_flat_params(model, load_npz(npz_path))
    return model


def make_lpips_fn(weights_path: Optional[str] = None, device=None):
    """Return a fn: ([-1,1] imgs, imgs) NHWC -> per-sample LPIPS, on ``device``."""
    device = resolve_device(device)
    model = LPIPS()
    if weights_path:
        load_lpips_params(weights_path, model)
    else:
        warnings.warn(
            "LPIPS running with RANDOM weights (no pretrained npz provided); "
            "values will not match the lpips package."
        )
        seeded_init(model)
    model = model.to(device).eval().requires_grad_(False)

    def dist(x, y):
        x, y = (torch.as_tensor(a, dtype=torch.float32).to(device) for a in (x, y))
        with torch.inference_mode():
            return model(x, y)

    return dist


def compute_lpips_from_dirs(dir0: str, dir1: str, out: Optional[str] = None,
                            weights_path: Optional[str] = None, device=None) -> float:
    """Directory-pair LPIPS scorer writing a txt report
    (reference misc/compute_lpips.py:1-39)."""
    from masterthesis_tpu_torch.data.transforms import load_rgb, normalize, to_array

    fn = make_lpips_fn(weights_path, device)
    files = sorted(os.listdir(dir0))
    scores = []
    lines = []
    for fname in files:
        p1 = os.path.join(dir1, fname)
        if not os.path.exists(p1):
            continue
        img0 = normalize(to_array(load_rgb(os.path.join(dir0, fname))))[None]
        img1 = normalize(to_array(load_rgb(p1)))[None]
        d = float(fn(img0, img1)[0])
        scores.append(d)
        lines.append("%s: %.3f" % (fname, d))
        print(lines[-1])
    avg = float(np.mean(scores)) if scores else float("nan")
    if out:
        with open(out, "w") as f:
            f.write("%s: %.6f\n" % (files[-1] if files else "", avg))
    return avg
