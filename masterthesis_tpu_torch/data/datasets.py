"""Datasets (host side, numpy NHWC).

The port of ``masterthesis_tpu/data/datasets.py``: ``ImageList``,
``ImageFolder``, ``SingleDataset``, ``PairedDataset``,
``PairedImageDataset`` and ``VideoDataset``. Items are dicts of numpy
arrays: images float32 NHWC in [-1, 1] ([0, 1] for the raw readers, uint8
under ``--device_preproc``), labels one-hot float32 (int64 for
``PairedImageDataset``). Each dataset owns one numpy ``Generator`` (seeded
from ``args.seed`` for the training datasets) and draws from it in the JAX
package's order, so that both packages give the same items: the domain
choice, then each image's crop and flip, x1's before x2's.

The training datasets also have ``skip(index)``, which draws what
``dataset[index]`` draws and loads nothing: the trainer resumes the data
stream where a run stopped with it (``DataLoader.fast_forward``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from masterthesis_tpu_torch.data.transforms import ToTensorTransform, TrainTransform, load_rgb

IMG_EXTENSIONS = [".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm", ".PPM", ".bmp", ".BMP"]


def is_image_file(filename: str) -> bool:
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


class ImageList:
    """Recursive flat list of images."""

    def __init__(self, root, return_paths=False, transform=None):
        self.root = root
        self.return_paths = return_paths
        self.dataset = self._make_dataset(root)
        self.transforms = transform if transform is not None else ToTensorTransform()
        self.rng = np.random.default_rng(0)

    @staticmethod
    def _make_dataset(root):
        return sorted(
            os.path.join(fdir, fname)
            for fdir, _, fnames in os.walk(root)
            for fname in fnames
            if is_image_file(fname)
        )

    def load_image(self, img_name):
        return self.transforms(load_rgb(img_name), self.rng)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        path = self.dataset[index]
        img = self.load_image(path)
        if self.return_paths:
            return img, path
        return img


class ImageFolder:
    """root/domain_i/img.jpg -> (img, class index)."""

    def __init__(self, args, return_paths=False, transforms=None):
        self.args = args
        self.root = args.dataroot
        self.dataset = self._make_dataset(self.root)
        self.transforms = transforms if transforms is not None else ToTensorTransform()
        self.return_paths = return_paths
        self.rng = np.random.default_rng(0)

    @staticmethod
    def _make_dataset(root):
        dataset = []
        for i, d in enumerate(sorted(os.listdir(root))):
            ddir = os.path.join(root, d)
            if not os.path.isdir(ddir):
                continue
            dataset += [(os.path.join(ddir, f), i) for f in sorted(os.listdir(ddir))]
        return dataset

    def __getitem__(self, index):
        path, y = self.dataset[index]
        x = self.transforms(load_rgb(path), self.rng)
        if self.return_paths:
            return x, y, path
        return x, y

    def __len__(self):
        return len(self.dataset)


class SingleDataset:
    """Random-domain single-image sampler with a one-hot label; its length
    is the largest domain's size."""

    def __init__(self, args, return_paths=False, seed: Optional[int] = None):
        self.args = args
        self.root = os.path.join(args.dataroot, args.mode)
        self.dataset, self.targets, self.target_names = self._make_dataset(
            self.root, getattr(args, "select_domains", None)
        )
        if args.num_domains != len(self.targets):
            raise ValueError(f"--num_domains {args.num_domains} != {len(self.targets)} domain dirs")
        self.return_paths = return_paths
        self.size = max(map(len, self.dataset.values()))
        if getattr(args, "device_preproc", False):
            # the host decodes and resizes only; crop, flip and normalize run
            # on the device (device_preproc.preprocess_pair_batch, in the trainer)
            from masterthesis_tpu_torch.data.device_preproc import RawResizeTransform

            self.transforms = RawResizeTransform(load_size=args.load_size)
        else:
            self.transforms = TrainTransform(
                load_size=args.load_size,
                crop_size=args.crop_size,
                train=args.mode == "train",
                no_flip=getattr(args, "no_flip", False),
            )
        self.rng = np.random.default_rng(getattr(args, "seed", 0) if seed is None else seed)

    @staticmethod
    def _make_dataset(root, select_domains=None):
        listing = sorted(os.listdir(root))
        if select_domains is not None:
            missing = set(select_domains) - set(listing)
            if missing:
                raise FileNotFoundError(
                    f"Provided domain directories could not be found: {missing}")
            domains = list(select_domains)
        else:
            domains = listing
        dataset = {}
        for i, domain in enumerate(sorted(domains)):
            ddir = os.path.join(root, domain)
            dataset[i] = sorted(
                os.path.join(ddir, f) for f in os.listdir(ddir) if is_image_file(f)
            )
        return dataset, sorted(dataset.keys()), domains

    def load_image(self, path, dim=3):
        # the native route for JPEGs where the transform has one, PIL otherwise
        if hasattr(self.transforms, "load_file"):
            arr = self.transforms.load_file(path, self.rng)
        else:
            arr = self.transforms(load_rgb(path), self.rng)
        if dim == 1:
            arr = arr[..., 0:1] * 0.299 + arr[..., 1:2] * 0.587 + arr[..., 2:3] * 0.114
        return arr

    def _skip_image(self) -> None:
        """Draw what loading one image draws (only ``TrainTransform`` draws)."""
        if isinstance(self.transforms, TrainTransform):
            self.transforms._draw(self.rng)

    def get_onehot(self, index, shape):
        v = np.zeros(shape, dtype=np.float32)
        v[index] = 1.0
        return v

    def __len__(self):
        return self.size

    def skip(self, index) -> None:
        self.rng.choice(self.targets)
        self._skip_image()

    def __getitem__(self, index):
        y_src = int(self.rng.choice(self.targets))
        y = self.get_onehot(y_src, (self.args.num_domains,))
        x_src = self.dataset[y_src][index % len(self.dataset[y_src])]
        x = self.load_image(x_src)
        if self.return_paths:
            return {"x": x, "y": y, "x_path": x_src}
        return {"x": x, "y": y}


class PairedDataset(SingleDataset):
    """Two distinct random domains per item: the training dataset."""

    def __init__(self, args, return_paths=False, seed: Optional[int] = None):
        super().__init__(args, return_paths, seed)
        if getattr(self.args, "select_domains", None) is not None and len(self.args.select_domains) < 2:
            raise ValueError("PairedDataset needs at least 2 --select_domains")

    def skip(self, index) -> None:
        self.rng.choice(self.targets, 2, replace=False)
        self._skip_image()
        self._skip_image()

    def __getitem__(self, index):
        y1_src, y2_src = self.rng.choice(self.targets, 2, replace=False)
        y1 = self.get_onehot(int(y1_src), (self.args.num_domains,))
        y2 = self.get_onehot(int(y2_src), (self.args.num_domains,))
        x1_src = self.dataset[int(y1_src)][index % len(self.dataset[int(y1_src)])]
        x2_src = self.dataset[int(y2_src)][index % len(self.dataset[int(y2_src)])]
        x1 = self.load_image(x1_src)
        x2 = self.load_image(x2_src)
        if self.return_paths:
            return {"x1": x1, "x2": x2, "y1": y1, "y2": y2, "x1_path": x1_src, "x2_path": x2_src}
        return {"x1": x1, "x2": x2, "y1": y1, "y2": y2}


class PairedImageDataset(SingleDataset):
    """Like PairedDataset, with integer labels."""

    skip = PairedDataset.skip

    def __getitem__(self, index):
        y1, y2 = (int(v) for v in self.rng.choice(self.targets, 2, replace=False))
        x1_src = self.dataset[y1][index % len(self.dataset[y1])]
        x2_src = self.dataset[y2][index % len(self.dataset[y2])]
        x1 = self.load_image(x1_src)
        x2 = self.load_image(x2_src)
        out = {"x1": x1, "x2": x2, "y1": np.int64(y1), "y2": np.int64(y2)}
        if self.return_paths:
            out.update({"x1_path": x1_src, "x2_path": x2_src})
        return out


class VideoDataset:
    """Random-access video frames through cv2 (imported when one is made)."""

    def __init__(self, root, transform=None):
        import cv2

        self.filepath = root
        self.transforms = transform if transform is not None else ToTensorTransform()
        self.cam = cv2.VideoCapture(self.filepath)
        self._cv2 = cv2
        self.rng = np.random.default_rng(0)

    def __len__(self):
        return int(self.cam.get(self._cv2.CAP_PROP_FRAME_COUNT)) - 1

    @property
    def fps(self) -> float:
        """Source frame rate (25 where the container does not say)."""
        fps = float(self.cam.get(self._cv2.CAP_PROP_FPS) or 0.0)
        return fps if fps > 0 else 25.0

    def __getitem__(self, index):
        from PIL import Image

        index = index % len(self)
        if not self.cam.isOpened():
            raise RuntimeError("Camera is not opened")
        self.cam.set(1, index)
        ok, frame = self.cam.read()
        if not ok:
            raise RuntimeError("Frame not read. Please check the frame number")
        frame = self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)
        return self.transforms(Image.fromarray(frame), self.rng)
