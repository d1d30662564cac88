"""Content/style translation model: the inference subset.

Ports ``encode_content``, ``encode_style``, ``decode``, ``get_z_random``,
the two serving forwards and int8 serving (``calibrate_int8``,
``disable_int8``) of ``masterthesis_tpu/models/translation.py``.
Layout at the public entry points is the JAX package's: images NHWC f32 in
[-1, 1], ``z`` (B, latent), ``c`` one-hot (B, K). Inside, tensors are NCHW
and contiguous: images are permuted once on entry and once on exit.
"""
from __future__ import annotations

import time

import torch

from masterthesis_tpu_torch.models.model import Model
from masterthesis_tpu_torch.models.quantize import LEAF, extract_amax, int8_convs, merge_amax

INT8_NETS = ("content_encoder", "decoder")


def _nchw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 3, 1, 2).contiguous()


def _nhwc(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 2, 3, 1).contiguous()


class TranslationModel(Model):
    """Shared inference logic; subclasses build the nets."""

    def __init__(self, args, device=None):
        super().__init__(args, device)
        self.latent_dim = int(args.latent_dim)
        # the installed amax tree per net, or None: the float path
        self.quant: dict | None = None

    # NCHW building blocks
    def encode_content(self, img: torch.Tensor) -> torch.Tensor:
        serving = bool(self.quant and self.quant.get("content_encoder"))
        return self.nets.content_encoder(img, serving=serving)

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

    # int8 serving
    def calibrate_int8(self, images, c_trgs, zs) -> dict:
        """Measure every conv's input range and switch inference to int8.

        Runs the content encoder and the decoder on the float path over the
        calibration batches (NHWC images, one-hot targets ``c_trgs`` and
        styles ``zs``, one each per batch: the draws are the caller's),
        records each conv's max |input|, merges the batches by max and
        installs the result (:meth:`load_int8`). Returns the amax tree.
        """
        if self.compute_dtype != torch.float32:
            raise NotImplementedError("int8 serving runs at compute dtype float32 only")
        self.disable_int8()
        convs = [m for name in INT8_NETS for m in int8_convs(self.nets[name]).values()]
        cols = {name: None for name in INT8_NETS}
        try:
            with torch.inference_mode():
                for img, c, z in zip(images, c_trgs, zs):
                    img = self._tensor(img)
                    if img.shape[0] == 0:
                        continue
                    for m in convs:
                        m.calib_amax = torch.zeros((), device=self.device)
                    z_c = self.nets.content_encoder(_nchw(img))
                    self.nets.decoder(z_c, self._tensor(z), self._tensor(c))
                    for name in INT8_NETS:
                        cols[name] = merge_amax(cols[name], extract_amax(self.nets[name]))
        finally:
            for m in convs:
                m.calib_amax = None
        if cols["content_encoder"] is None:
            raise ValueError("calibrate_int8: no calibration batch had any images")
        self.load_int8(cols)
        return self.quant

    def load_int8(self, quant: dict) -> None:
        """Install an amax tree (one flat dict per net, e.g. from
        ``tools.convert_jax.quant_from_jax``); every conv that calibration
        measures in those nets needs its leaf."""
        for name, tree in quant.items():
            convs = int8_convs(self.nets[name])
            want = {f"{path}.{LEAF}" for path in convs}
            if set(tree) != want:
                raise KeyError(f"{name}: amax leaves {sorted(set(tree) ^ want)} do not match its convs")
        self.disable_int8()
        for name, tree in quant.items():
            for path, m in int8_convs(self.nets[name]).items():
                m.set_amax(tree[f"{path}.{LEAF}"])
        self.quant = {name: dict(tree) for name, tree in quant.items()}

    def disable_int8(self) -> None:
        """Back to the float inference path."""
        for net in self.nets.values():
            for m in int8_convs(net).values():
                m.set_amax(None)
        self.quant = None

    def load_params(self, state_dicts: dict) -> None:
        """Load weights; an int8 model keeps its amax tree and quantizes the
        new weights at its next forward."""
        super().load_params(state_dicts)
        for net in self.nets.values():
            for m in int8_convs(net).values():
                m.drop_quant()

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
