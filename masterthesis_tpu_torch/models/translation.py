"""Content/style translation model: the inference subset.

Ports ``encode_content``, ``encode_style``, ``decode``, ``get_z_random`` and
the two serving forwards of ``masterthesis_tpu/models/translation.py``.
Layout at the public entry points is the JAX package's: images NHWC f32 in
[-1, 1], ``z`` (B, latent), ``c`` one-hot (B, K). Inside, tensors are NCHW
and contiguous: images are permuted once on entry and once on exit.
"""
from __future__ import annotations

import time

import torch

from masterthesis_tpu_torch.models.model import Model


def _nchw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 3, 1, 2).contiguous()


def _nhwc(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 2, 3, 1).contiguous()


class TranslationModel(Model):
    """Shared inference logic; subclasses build the nets."""

    def __init__(self, args, device=None):
        super().__init__(args, device)
        self.latent_dim = int(args.latent_dim)

    # NCHW building blocks
    def encode_content(self, img: torch.Tensor) -> torch.Tensor:
        return self.nets.content_encoder(img)

    def encode_style(self, img: torch.Tensor, c: torch.Tensor, eps=None):
        """(z, mu, logvar); ``eps`` None gives z = mu."""
        return self.nets.style_encoder(img, c, eps)

    def decode(self, z_c: torch.Tensor, z: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return self.nets.decoder(z_c, z, c)

    def get_z_random(self, batch_size: int, generator: torch.Generator | None = None):
        device = self.device if generator is None else generator.device
        z = torch.randn((batch_size, self.latent_dim), generator=generator, device=device)
        return z.to(self.device)

    # NHWC forwards
    def _forward_random_impl(self, img, z_r, c_trg):
        z_c = self.encode_content(_nchw(img))
        return _nhwc(self.decode(z_c, z_r, c_trg))

    def _forward_reference_impl(self, img_src, img_ref, c_trg, eps):
        z_c = self.encode_content(_nchw(img_src))
        z_s, _, _ = self.encode_style(_nchw(img_ref), c_trg, eps)
        return _nhwc(self.decode(z_c, z_s, c_trg))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _timed(self, fn, *args):
        start = time.perf_counter()
        with torch.inference_mode():
            out = fn(*(self._tensor(a) for a in args))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, time.perf_counter() - start, self._device_memory_gb()

    def _device_memory_gb(self) -> float:
        if self.device.type != "cuda":
            return 0.0
        return torch.cuda.memory_reserved(self.device) / 1024**3

    def forward_random(self, img, z_r, c_trg):
        """Translate with a given style code; returns (images, seconds, device_mem_GB)."""
        return self._timed(self._forward_random_impl, img, z_r, c_trg)

    def forward_reference(self, img_src, img_ref, c_trg, eps=None, generator=None):
        """Translate with a reference image's style; returns (images, seconds,
        device_mem_GB). The VAE draw is ``eps`` (B, latent) if given, else
        normal draws from ``generator`` (default: seed 0 on the model's device)."""
        if eps is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            eps = self.get_z_random(len(img_src), generator)
        return self._timed(self._forward_reference_impl, img_src, img_ref, c_trg, eps)
