"""On-device image preprocessing: crop, flip and normalize on the card.

The port of ``masterthesis_tpu/data/device_preproc.py``. The host keeps only
JPEG decode and resize (:class:`RawResizeTransform`); uint8 batches cross to
the device (a quarter of float32's bytes), and :func:`preprocess` crops and
flips every sample with one gather, then rescales [0, 255] to [-1, 1] as the
JAX package does. The JAX package has no Pallas kernel here (one read and
one write of a 3-channel uint8 batch, which XLA fuses), and neither has the
port: this is plain torch on the model's device.

Crop and flip draws come from a ``torch.Generator`` on that device, which the
trainer seeds per iteration, so a step's preprocessing is reproducible.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def sample_crop_params(
    generator: torch.Generator,
    n: int,
    load_size: int,
    crop_size: int,
    train: bool = True,
    no_flip: bool = False,
) -> Dict[str, torch.Tensor]:
    """Per-sample crop origins and flip decisions on ``generator``'s device:
    uniform origins and a flip with probability 1/2 for training (the host
    ``TrainTransform``'s distribution), the centre and no flip otherwise."""
    span = load_size - crop_size
    dev = generator.device
    if train and span > 0:
        tops = torch.randint(0, span + 1, (n,), generator=generator, device=dev)
        lefts = torch.randint(0, span + 1, (n,), generator=generator, device=dev)
    else:
        tops = torch.full((n,), span // 2, dtype=torch.int64, device=dev)
        lefts = torch.full((n,), span // 2, dtype=torch.int64, device=dev)
    if train and not no_flip:
        flips = torch.rand((n,), generator=generator, device=dev) < 0.5
    else:
        flips = torch.zeros((n,), dtype=torch.bool, device=dev)
    return {"tops": tops, "lefts": lefts, "flips": flips}


def preprocess(
    images_u8: torch.Tensor,
    params: Dict[str, torch.Tensor],
    crop_size: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> (N, crop, crop, 3) in [-1, 1]: one gather of
    every sample's crop, mirrored where ``flips``, then ``x * (2/255) - 1``."""
    n = images_u8.shape[0]
    dev = images_u8.device
    ar = torch.arange(crop_size, device=dev)
    tops, lefts = params["tops"].to(dev), params["lefts"].to(dev)
    rows = tops[:, None] + ar
    cols = lefts[:, None] + torch.where(params["flips"].to(dev)[:, None], crop_size - 1 - ar, ar)
    idx = torch.arange(n, device=dev)[:, None, None]
    crops = images_u8[idx, rows[:, :, None], cols[:, None, :]]
    return crops.to(dtype) * (2.0 / 255.0) - 1.0


def preprocess_pair_batch(
    batch: Dict[str, torch.Tensor],
    generator: torch.Generator,
    load_size: int,
    crop_size: int,
    train: bool = True,
    no_flip: bool = False,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """:func:`preprocess` on a PairedDataset batch's uint8 ``x1`` and
    ``x2`` (raw resized images), each with its own draws from ``generator``,
    x1's first; anything else, and images already preprocessed, as they are."""
    out = dict(batch)
    for key in ("x1", "x2"):
        x = batch[key]
        if x.dtype != torch.uint8:
            continue  # already preprocessed on the host
        params = sample_crop_params(generator, x.shape[0], load_size, crop_size, train, no_flip)
        out[key] = preprocess(x, params, crop_size=crop_size, dtype=dtype)
    return out


class RawResizeTransform:
    """Host side of the on-device pipeline: decode and antialiased bicubic
    resize to (load, load) uint8, native C++ for JPEG, PIL otherwise."""

    def __init__(self, load_size: int = 286, use_native: bool = True):
        self.load_size = load_size
        self.use_native = use_native

    def __call__(self, img, rng=None) -> np.ndarray:
        from masterthesis_tpu_torch.data.transforms import resize

        return np.asarray(resize(img, (self.load_size, self.load_size)), dtype=np.uint8)

    def load_file(self, path: str, rng=None) -> np.ndarray:
        if self.use_native and path.lower().endswith((".jpg", ".jpeg")):
            from masterthesis_tpu_torch import native

            if native.available():
                with open(path, "rb") as f:
                    data = f.read()
                try:
                    return native.decode_resize_jpeg(data, self.load_size)
                except ValueError:
                    pass
        from masterthesis_tpu_torch.data.transforms import load_rgb

        return self(load_rgb(path), rng)
