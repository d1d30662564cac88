"""InceptionV3 feature extractor for FID.

The port of ``masterthesis_tpu/metrics/inception.py``: the FID-standard
InceptionV3 (torchvision's with the TF-FID patches: InceptionA/C/E_1
average-pool branches with ``count_include_pad=False``, E_2 with a max
pool), inputs resized to 299² (bilinear, ``align_corners=False``, with
antialiasing, as ``jax.image.resize`` does when it downsamples) and
rescaled to (-1, 1), the 2048-d global average pool out. The modules are
NCHW inside and take NHWC in [0, 1] at the entry; a ``BasicConv`` is a conv
without bias, the frozen-statistics batch norm ``(x - mean) * rsqrt(var +
1e-3) * scale + bias`` and relu. Module and parameter names follow the Flax
ones (``Mixed_5b.branch1x1.conv.weight``, ``...bn_scale``), so the JAX
package's flat npz loads by path (``load_inception_params``).

No weights ship with the repository: without an npz the extractor warns
and runs with random weights, seeded from a ``torch.Generator`` (valid for
pipeline tests, NOT for reporting FID).
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from masterthesis_tpu_torch.metrics.metrics import load_flat_params, load_npz, seeded_init
from masterthesis_tpu_torch.models.blocks import avg_pool2d
from masterthesis_tpu_torch.models.model import resolve_device


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW ``x`` to ``size`` (H, W): ``jax.image.resize(..., "bilinear")``,
    which antialiases when it downsamples (a triangle kernel widened by the
    scale) and is plain bilinear with half-pixel centres when it upsamples."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


class BasicConv(nn.Module):
    """conv -> batchnorm (eps 1e-3, frozen statistics) -> relu."""

    def __init__(self, in_features: int, features: int, kernel_size, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(features))
        self.bn_bias = nn.Parameter(torch.zeros(features))
        self.bn_mean = nn.Parameter(torch.zeros(features))
        self.bn_var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        x = self.conv(x)

        def col(p):
            return p.view(1, -1, 1, 1)

        x = (x - col(self.bn_mean)) * torch.rsqrt(col(self.bn_var) + 1e-3) * col(self.bn_scale) \
            + col(self.bn_bias)
        return F.relu(x)


def _max_pool(x, window=3, stride=2, padding=0):
    return F.max_pool2d(x, window, stride, padding)  # pads with -inf


def _avg_pool(x):
    return avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(c, 64, 1)
        self.branch5x5_1 = BasicConv(c, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(c, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(c, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x))  # FID patch (reference inception.py:107-112)
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.branch3x3 = BasicConv(c, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(c, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(c, 192, 1)
        self.branch7x7_1 = BasicConv(c, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(c, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(c, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for name in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"):
            bd = getattr(self, name)(bd)
        bp = self.branch_pool(_avg_pool(x))  # FID patch (reference inception.py:130-141)
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(c, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(c, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for name in ("branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"):
            b7 = getattr(self, name)(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """E block; ``pool='avg'`` (E_1, count_include_pad=False) or ``'max'``
    (E_2) — reference inception.py:144-211."""

    def __init__(self, c: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv(c, 320, 1)
        self.branch3x3_1 = BasicConv(c, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(c, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(c, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = _max_pool(x, 3, 1, padding=1) if self.pool == "max" else _avg_pool(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3(nn.Module):
    """FID InceptionV3 trunk: NHWC [0, 1] -> (N, 2048) pooled features
    (reference inception.py:20-92). The trunk takes 75 x 75 and up without
    the resize."""

    def __init__(self, resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if self.resize_input:
            x = resize_bilinear(x, (299, 299))
        x = 2.0 * x - 1.0  # [0,1] -> (-1,1) (reference inception.py:62-66)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # (N, 2048)


def load_inception_params(npz_path: str, model: Optional[InceptionV3] = None) -> InceptionV3:
    """``model`` (a new InceptionV3 if None) filled from the flat npz of
    ``'path/to/param'`` arrays (HWIO conv kernels) that the JAX package's
    ``load_inception_params`` reads."""
    model = InceptionV3() if model is None else model
    load_flat_params(model, load_npz(npz_path))
    return model


def make_inception_extractor(weights_path: Optional[str] = None, resize_input: bool = True,
                             device=None):
    """Return a fn: [0,1] NHWC images on ``device`` -> (N, 2048) features
    there. ``resize_input=False`` expects pre-resized 299x299 input (the
    clean-fid protocol resizes on the host with PIL bicubic instead). f32;
    on the card TF32 is the caller's setting (``chip_smoke.py`` turns it off)."""
    device = resolve_device(device)
    model = InceptionV3(resize_input=resize_input)
    if weights_path:
        load_inception_params(weights_path, model)
    else:
        warnings.warn(
            "InceptionV3 running with RANDOM weights (no pretrained npz provided); "
            "FID values will not match the TF-FID reference."
        )
        seeded_init(model)
    model = model.to(device).eval().requires_grad_(False)

    def extract(x):
        if x.dim() == 3:
            x = x[None]
        with torch.inference_mode():
            return model(x)

    return extract
