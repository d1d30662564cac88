"""Host-side image transforms (PIL + numpy), NHWC float32 in [-1, 1].

The port of ``masterthesis_tpu/data/transforms.py``: Resize((load, load),
BICUBIC) -> random/center crop -> random horizontal flip -> [0, 1] ->
normalize (0.5, 0.5), the reference's torchvision pipeline. Randomness is an
explicit ``numpy.random.Generator``, drawn in the JAX package's order, so
that the same generator gives the same crops and flips in both packages.
PIL is imported by the functions that use it, not with the module.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

if TYPE_CHECKING:
    from PIL import Image


def load_rgb(path: str) -> "Image.Image":
    from PIL import Image

    return Image.open(path).convert("RGB")


def resize(img: "Image.Image", size: Tuple[int, int]) -> "Image.Image":
    """``size`` is (height, width), as torchvision's."""
    from PIL import Image

    return img.resize((size[1], size[0]), Image.BICUBIC)


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top : top + size, left : left + size]


def random_crop(arr: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    h, w = arr.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return arr[top : top + size, left : left + size]


def hflip(arr: np.ndarray) -> np.ndarray:
    return arr[:, ::-1]


def to_array(img: "Image.Image") -> np.ndarray:
    """PIL -> float32 HWC in [0, 1] (ToTensor without the CHW permute)."""
    return np.asarray(img, dtype=np.float32) / 255.0


def normalize(arr: np.ndarray, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    return (arr - mean) / std


class TrainTransform:
    """The train/eval pipeline. ``load_file`` takes the native C++ route
    (``masterthesis_tpu_torch.native``) for JPEG files where its library
    built; other formats, ``use_native=False`` and a library that did not
    build take PIL's. Both routes draw the same crop and flip from ``rng``.
    """

    def __init__(
        self,
        load_size: int = 286,
        crop_size: int = 256,
        train: bool = True,
        no_flip: bool = False,
        use_native: bool = True,
    ):
        self.load_size = load_size
        self.crop_size = crop_size
        self.train = train
        self.no_flip = no_flip
        self.use_native = use_native

    def _draw(self, rng: np.random.Generator):
        """Crop origin and flip decision, shared by both routes."""
        span = self.load_size - self.crop_size
        if self.train:
            top = int(rng.integers(0, span + 1))
            left = int(rng.integers(0, span + 1))
        else:
            top = left = span // 2
        flip = bool(self.train and not self.no_flip and rng.random() < 0.5)
        return top, left, flip

    def __call__(self, img: "Image.Image", rng: Optional[np.random.Generator] = None) -> np.ndarray:
        if rng is None:
            rng = np.random.default_rng()
        top, left, flip = self._draw(rng)
        img = resize(img, (self.load_size, self.load_size))
        arr = to_array(img)
        arr = arr[top : top + self.crop_size, left : left + self.crop_size]
        if flip:
            arr = hflip(arr)
        return np.ascontiguousarray(normalize(arr))

    def load_file(self, path: str, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        if rng is None:
            rng = np.random.default_rng()
        if self.use_native and path.lower().endswith((".jpg", ".jpeg")):
            from masterthesis_tpu_torch import native

            if native.available():
                top, left, flip = self._draw(rng)
                with open(path, "rb") as f:
                    data = f.read()
                try:
                    return native.preprocess_jpeg(
                        data, self.load_size, self.crop_size, top, left, flip
                    )
                except ValueError:
                    pass  # a JPEG libjpeg refuses: PIL's route, as in the JAX package
        return self(load_rgb(path), rng)


class EvalTransform:
    """Sampler-time pipeline: Resize((540, 960)) -> normalize."""

    def __init__(self, size: Tuple[int, int] = (540, 960)):
        self.size = size

    def __call__(self, img: "Image.Image", rng=None) -> np.ndarray:
        img = resize(img, self.size)
        return np.ascontiguousarray(normalize(to_array(img)))


class ToTensorTransform:
    """Plain decode -> [0, 1] float array."""

    def __call__(self, img: "Image.Image", rng=None) -> np.ndarray:
        return to_array(img)


class CleanResize:
    """cleanfid's 'clean' resize: per-channel float32 PIL bicubic resize to
    ``size`` x ``size`` with no re-quantization, float32 HWC in [0, 1]."""

    def __init__(self, size: int = 299):
        self.size = size

    def __call__(self, img: "Image.Image", rng=None) -> np.ndarray:
        from PIL import Image

        x = np.asarray(img.convert("RGB"), np.float32)
        chans = [
            np.asarray(
                Image.fromarray(x[:, :, c], mode="F").resize(
                    (self.size, self.size), Image.BICUBIC
                ),
                np.float32,
            )
            for c in range(x.shape[2])
        ]
        return np.ascontiguousarray(np.stack(chans, axis=-1)) / 255.0
