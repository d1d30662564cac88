"""Loss functions: the port of ``masterthesis_tpu/models/losses.py``.

Every loss computes in f32 whatever its inputs' dtype, and reduces by the
mean over all elements, except :func:`kl_divergence`, which sums, as the
reference does.

The VGG perceptual loss (``--vgg_loss``): :class:`VGGPerceptualLoss` runs in
f32 whatever the training dtype, as the JAX package builds it without one,
and is frozen (no gradient into its parameters, no optimizer state). Without
``--vgg_weights`` its weights are random, as in the JAX package;
:func:`load_vgg_params` reads an npz of HWIO kernels.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from masterthesis_tpu_torch.models.blocks import Conv2d
from masterthesis_tpu_torch.ops.norms import instance_norm

GAN_MODES = ("vanilla", "bce", "lsgan", "wgangp", "hinge")


def bce_logits_loss(logits: torch.Tensor, targets) -> torch.Tensor:
    """Mean binary cross entropy with logits, max(x, 0) - x t + log1p(exp(-|x|))."""
    x = logits.float()
    t = torch.as_tensor(targets, dtype=torch.float32, device=x.device)
    return (x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def bce_loss(probs: torch.Tensor, targets, eps: float = 1e-12) -> torch.Tensor:
    """Mean binary cross entropy on probabilities."""
    p = probs.float().clamp(eps, 1.0 - eps)
    t = torch.as_tensor(targets, dtype=torch.float32, device=p.device)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)).mean()


def mse_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float() - y.float()).square().mean()


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float() - y.float()).abs().mean()


def gan_loss(pred: torch.Tensor, target_is_real: bool, mode: str = "vanilla") -> torch.Tensor:
    """Adversarial loss against a constant real or fake target."""
    pred = pred.float()
    if mode == "wgangp":
        return -pred.mean() if target_is_real else pred.mean()
    if mode == "hinge":
        return F.relu(1.0 - pred).mean() if target_is_real else F.relu(1.0 + pred).mean()
    target = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
    if mode == "vanilla":
        return bce_logits_loss(pred, target)
    if mode == "bce":
        return bce_loss(pred, target)
    if mode == "lsgan":
        return mse_loss(pred, target)
    raise NotImplementedError(f"Loss {mode} is not implemented")


def hinge_d_loss(pred_real: torch.Tensor, pred_fake: torch.Tensor) -> torch.Tensor:
    return F.relu(1.0 - pred_real.float()).mean() + F.relu(1.0 + pred_fake.float()).mean()


def hinge_g_loss(pred_fake: torch.Tensor) -> torch.Tensor:
    return -pred_fake.float().mean()


def ragan_loss(pred_real, pred_fake, real_is_target: bool, mode: str,
               batch_mean=torch.mean) -> torch.Tensor:
    """Relativistic average GAN loss; ``real_is_target`` is the D direction.
    ``batch_mean`` takes the mean over the batch (data parallel: over the
    global batch, ``TranslationModel._batch_mean``)."""
    r, f = pred_real.float(), pred_fake.float()
    rel_r, rel_f = r - batch_mean(f), f - batch_mean(r)
    if real_is_target:
        return (gan_loss(rel_r, True, mode) + gan_loss(rel_f, False, mode)) / 2
    return (gan_loss(rel_r, False, mode) + gan_loss(rel_f, True, mode)) / 2


def l2_regularize(x: torch.Tensor) -> torch.Tensor:
    return x.float().square().mean()


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Summed VAE KL: -0.5 * sum(1 + logvar - mu^2 - exp(logvar))."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * (1.0 + logvar - mu.square() - torch.exp(logvar)).sum()


VGG_CONFIGS = {
    # channels per conv, "M" a max pool: the standard VGG feature stacks
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"],
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_layer_names(vgg_type: str) -> list[str]:
    """conv1_1, relu1_1, ..., pool1, conv2_1, ...: the layers in order."""
    names, block, idx = [], 1, 1
    for v in VGG_CONFIGS[vgg_type]:
        if v == "M":
            names.append(f"pool{block}")
            block, idx = block + 1, 1
        else:
            names += [f"conv{block}_{idx}", f"relu{block}_{idx}"]
            idx += 1
    return names


class VGGFeatureExtractor(nn.Module):
    """The VGG stack up to the deepest of ``feature_layers`` (3x3 convs with
    zero padding 1 and bias, relu), returning each feature layer's output in
    the order of the stack. Input NCHW in [-1, 1], mapped to [0, 1] and
    normalized by the ImageNet mean and std; f32 throughout.
    ``remove_pooling`` skips the max pools, the default."""

    def __init__(self, feature_layers: Sequence[str], vgg_type: str = "vgg19",
                 remove_pooling: bool = True, input_dim: int = 3):
        super().__init__()
        names = vgg_layer_names(vgg_type)
        for name in feature_layers:
            if name not in names:
                raise ValueError(f"unknown vgg layer {name} for {vgg_type}")
        self.names = names[:max(names.index(n) for n in feature_layers) + 1]
        self.wanted = set(feature_layers)
        self.remove_pooling = remove_pooling
        widths = iter(v for v in VGG_CONFIGS[vgg_type] if v != "M")
        d = input_dim
        for name in self.names:
            if name.startswith("conv"):
                w = next(widths)
                setattr(self, name, Conv2d(d, w, 3, 1, 1, use_bias=True))
                d = w
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN)[:, None, None], persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD)[:, None, None], persistent=False)

    def forward(self, x):
        x = ((x.float() + 1.0) / 2.0 - self.mean) / self.std
        outputs = []
        for name in self.names:
            if name.startswith("conv"):
                x = getattr(self, name)(x)
            elif name.startswith("relu"):
                x = F.relu(x)
            elif not self.remove_pooling:
                x = F.max_pool2d(x, 2, 2)
            if name in self.wanted:
                outputs.append(x)
        return outputs


class VGGPerceptualLoss(nn.Module):
    """sum_i w_i d(f_i(x), f_i(y)) over the feature layers, d the mean
    squared (``loss_fn`` with "l2" or "mse") or absolute difference, the
    features instance-normed first with ``norm_feat``."""

    def __init__(self, layers: Sequence[str] = ("conv5_4",),
                 layer_weights: Sequence[float] = (1.0,), vgg_type: str = "vgg19",
                 loss_fn: str = "l2", norm_feat: bool = False, input_dim: int = 3):
        super().__init__()
        self.vgg = VGGFeatureExtractor(layers, vgg_type, input_dim=input_dim)
        self.layers, self.vgg_type = tuple(layers), vgg_type
        self.layer_weights = tuple(layer_weights)
        self.mse = "mse" in loss_fn or "l2" in loss_fn
        self.norm_feat = norm_feat

    def forward(self, x, y):
        total = 0.0
        for w, a, b in zip(self.layer_weights, self.vgg(x), self.vgg(y)):
            if self.norm_feat:
                a, b = instance_norm(a), instance_norm(b)
            total = total + w * (mse_loss(a, b) if self.mse else l1_loss(a, b))
        return total


def load_vgg_params(npz_path: str, extractor: VGGFeatureExtractor) -> dict[str, torch.Tensor]:
    """A state_dict for ``extractor`` from an npz of ``{layer}/kernel`` (HWIO)
    and ``{layer}/bias`` arrays, as the JAX package's ``load_vgg_params``
    reads; the npz must hold every conv of the extractor, and may hold more."""
    sd = {}
    with np.load(npz_path) as data:
        for name in extractor.names:
            if name.startswith("conv"):
                kernel = np.transpose(data[f"{name}/kernel"], (3, 2, 0, 1))  # HWIO -> OIHW
                sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel, np.float32))
                sd[f"{name}.bias"] = torch.from_numpy(np.asarray(data[f"{name}/bias"], np.float32))
    return sd
