"""Streaming Fréchet Inception Distance.

The port of ``masterthesis_tpu/metrics/fid.py``: online mean and
outer-product accumulation in float64 on the host (one ``f.T @ f`` per
batch), covariance assembly, the scipy ``sqrtm`` Fréchet distance with its
imaginary-part check and eps fallback, and a dir-vs-dir helper. Feature
extraction runs on the metric's device (``Metrics``); given the same
features, the two packages' FID agree to f64 rounding. :meth:`FID.accumulate`
takes features already on the host, which is how ``evaluate`` keeps the
extraction on the device's stream ahead of the host.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np

from masterthesis_tpu_torch.metrics.metrics import Metrics


def fid_score(mu1, mu2, sigma1, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (reference fid.py:30-63)."""
    import scipy.linalg

    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    # the JAX package passes disp=False, which scipy 1.18 removed; without it
    # sqrtm returns the same root, alone
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError("Imaginary component {}".format(m))
        covmean = covmean.real
    tr_covmean = np.trace(covmean)
    if not np.isfinite(covmean).all():
        tr_covmean = np.sum(
            np.sqrt(((np.diag(sigma1) * eps) * (np.diag(sigma2) * eps)) / (eps * eps))
        )
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


class FID(Metrics):
    """Online FID over paired (train, test) batches (reference fid.py:66-179).
    With neither ``num_features`` nor ``feature_extractor``: the 2048-d
    InceptionV3 (``weights_path``'s npz, else seeded random weights)."""

    def __init__(
        self,
        num_features: Optional[int] = None,
        feature_extractor: Optional[Callable] = None,
        output_transform=lambda x: x,
        weights_path: Optional[str] = None,
        device=None,
    ):
        if num_features is None and feature_extractor is None:
            from masterthesis_tpu_torch.metrics.inception import make_inception_extractor

            num_features = 2048
            feature_extractor = make_inception_extractor(weights_path, device=device)
        elif num_features is not None and feature_extractor is None:
            feature_extractor = lambda x: x  # noqa: E731
        self._eps = 1e-6
        super().__init__(
            num_features=num_features,
            feature_extractor=feature_extractor,
            output_transform=output_transform,
            device=device,
        )

    def _online_update(self, features: np.ndarray, total: np.ndarray, sigma: np.ndarray):
        """Batched mean/outer-product accumulation (fid.py:119-125, batched)."""
        f = features.astype(np.float64)
        total += f.sum(axis=0)
        sigma += f.T @ f

    def _get_covariance(self, sigma: np.ndarray, total: np.ndarray) -> np.ndarray:
        """Covariance from sum and sum-of-outer-products (fid.py:127-136)."""
        if self._num_examples < 2:
            raise ValueError(
                "FID needs at least 2 examples per side to estimate a covariance "
                f"(got {self._num_examples}); call update() with more data."
            )
        sub = np.outer(total, total) / self._num_examples
        return (sigma - sub) / (self._num_examples - 1)

    def reset(self) -> None:
        n = self._num_features
        self._train_sigma = np.zeros((n, n), np.float64)
        self._train_total = np.zeros((n,), np.float64)
        self._test_sigma = np.zeros((n, n), np.float64)
        self._test_total = np.zeros((n,), np.float64)
        self._num_examples = 0

    def update(self, output) -> None:
        train, test = self._output_transform(output)
        self.accumulate(self._extract_features(train), self._extract_features(test))

    def accumulate(self, train_features: np.ndarray, test_features: np.ndarray) -> None:
        """Add a batch of host features of each side (``update`` after the
        extraction)."""
        for f in (train_features, test_features):
            self._check_feature_shapes(f)
        if train_features.shape != test_features.shape:
            raise ValueError(
                "Number of Training Features and Testing Features should be equal "
                f"({train_features.shape} != {test_features.shape})"
            )
        self._online_update(train_features, self._train_total, self._train_sigma)
        self._online_update(test_features, self._test_total, self._test_sigma)
        self._num_examples += train_features.shape[0]

    def accumulators(self) -> dict:
        """The running f64 sums: examples, and per side the feature sum and
        the sum of outer products."""
        return dict(n=self._num_examples, train_total=self._train_total,
                    train_sigma=self._train_sigma, test_total=self._test_total,
                    test_sigma=self._test_sigma)

    def compute(self) -> float:
        fid = fid_score(
            mu1=self._train_total / self._num_examples,
            mu2=self._test_total / self._num_examples,
            sigma1=self._get_covariance(self._train_sigma, self._train_total),
            sigma2=self._get_covariance(self._test_sigma, self._test_total),
            eps=self._eps,
        )
        if not np.isfinite(fid):
            warnings.warn("The product of covariance of train and test features is out of bounds.")
        return fid


def compute_fid_from_dirs(
    dirpath1: str,
    dirpath2: str,
    batch_size: int = 8,
    feature_extractor=None,
    num_features=None,
    weights_path: Optional[str] = None,
    mode: str = "plain",
    device=None,
) -> float:
    """dir-vs-dir FID (reference fid.py:17-28).

    ``mode='clean'`` applies cleanfid's resize protocol (host-side
    unquantized PIL-bicubic resize to 299, ``data/transforms.py``
    ``CleanResize``); 'plain' resizes on the device with bilinear
    (antialiased, as ``jax.image.resize``) inside the InceptionV3.
    """
    from masterthesis_tpu_torch.data.datasets import ImageList
    from masterthesis_tpu_torch.data.loader import DataLoader

    transform = None
    if mode == "clean":
        from masterthesis_tpu_torch.data.transforms import CleanResize
        from masterthesis_tpu_torch.metrics.inception import make_inception_extractor

        transform = CleanResize()
        if feature_extractor is None and num_features is None:
            num_features = 2048
            feature_extractor = make_inception_extractor(weights_path, resize_input=False,
                                                         device=device)
    elif mode != "plain":
        raise ValueError(f"unknown FID mode {mode!r}; use 'plain' or 'clean'")
    fid = FID(
        num_features=num_features,
        feature_extractor=feature_extractor,
        weights_path=weights_path,
        device=device,
    )
    loader1 = DataLoader(ImageList(dirpath1, transform=transform), batch_size=batch_size)
    loader2 = DataLoader(ImageList(dirpath2, transform=transform), batch_size=batch_size)
    for img1, img2 in zip(loader1, loader2):
        n = min(len(img1), len(img2))
        fid.update((img1[:n], img2[:n]))
    return fid.compute()
