"""Image grid and save helpers on NHWC arrays in [-1, 1].

The port of ``masterthesis_tpu/utils/images.py``: inputs are numpy arrays or
torch tensors (on any device), NHWC as the JAX package's; PIL is imported by
the functions that write or resize.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def make_grid(images, nrow: int = 1) -> np.ndarray:
    """Tile a batch of NHWC images into one HWC image, ``nrow`` images per row."""
    x = _to_numpy(images)
    if x.ndim == 3:
        x = x[None]
    if x.ndim != 4:
        raise ValueError(f"expected NHWC batch, got shape {x.shape}")
    n, h, w, c = x.shape
    ncols = min(nrow, n)
    nrows = int(np.ceil(n / ncols))
    grid = np.zeros((h * nrows, w * ncols, c), dtype=x.dtype)
    for k in range(n):
        r, col = divmod(k, ncols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = x[k]
    return grid


def tensor_to_image(images, nrow: int = 1) -> np.ndarray:
    """[-1, 1] NHWC batch -> uint8 HWC grid."""
    grid = make_grid(images, nrow=nrow)
    grid = grid / 2.0 + 0.5
    grid = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    return grid


def save_image(image, image_path: str, nrow: int = 1) -> None:
    """Save a [-1, 1] NHWC image (or a batch, as a grid)."""
    from PIL import Image

    arr = tensor_to_image(image, nrow=nrow)
    os.makedirs(os.path.dirname(os.path.abspath(image_path)), exist_ok=True)
    Image.fromarray(arr).save(image_path)


def save_images(images, names) -> None:
    """Save each image of a batch under its name."""
    x = _to_numpy(images)
    for img, name in zip(x, names):
        save_image(img, name)


def tensor_to_mask(mask, imtype=np.uint8) -> np.ndarray:
    """[0, 1] NHWC segmentation mask -> uint8 image."""
    grid = make_grid(_to_numpy(mask))
    return np.clip(grid * 255.0, 0, 255).astype(imtype)


def resize_image(img: np.ndarray, size) -> np.ndarray:
    """Resize an HWC uint8 image to ``size`` (width, height), as PIL takes it."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(size))


def param_to_str(**kwargs) -> str:
    """'key: value, ...' formatting helper."""
    return str([f"{key}: {value}" for key, value in kwargs.items()]).strip("[]")
