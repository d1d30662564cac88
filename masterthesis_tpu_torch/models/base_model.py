"""BaseModel: style injected by concatenation and 1x1 mixing in the decoder.

The port of ``masterthesis_tpu/models/base_model.py``: the content encoder,
the plain or (``--reparam``) reparameterized style encoder, ``Decoder`` or
(``--concat``) ``DecoderConcat``, and for training two discriminators and
the optional content discriminator. It serves and trains as
:class:`TranslationModel` does.
"""
from __future__ import annotations

import torch

from masterthesis_tpu_torch.models import networks
from masterthesis_tpu_torch.models.translation import TranslationModel


class BaseModel(TranslationModel):
    def __init__(self, args, device=None):
        """Builds the nets on ``device`` (default the card; raises without one
        unless ``device="cpu"``) and draws their weights from ``args.seed``."""
        super().__init__(args, device)
        a = args
        self.reparam = bool(a.reparam)
        dtype = torch.bfloat16 if getattr(a, "compute_dtype", "float32") == "bfloat16" else torch.float32
        self.compute_dtype = dtype
        self.nets.content_encoder = networks.ContentEncoder(
            a.input_dim, dim=a.dim, norm=a.enc_norm, dtype=dtype
        )
        if self.reparam:
            self.nets.style_encoder = networks.ReparameterizedStyleEncoder(
                a.input_dim, output_dim=a.latent_dim, dim=a.dim, num_domains=a.num_domains,
                norm=None, activation="lrelu", dtype=dtype,
            )
        else:
            self.nets.style_encoder = networks.StyleEncoder(
                a.input_dim, output_dim=a.latent_dim, dim=a.dim, num_domains=a.num_domains,
                activation="lrelu", dtype=dtype,
            )
        content_dim = self.nets.content_encoder.output_dim
        dec = dict(output_dim=a.input_dim, dim=content_dim, num_domains=a.num_domains,
                   latent_dim=a.latent_dim, up_type=a.up_type, norm=a.dec_norm,
                   dropout=bool(a.use_dropout), dtype=dtype)
        if a.concat:
            self.nets.decoder = networks.DecoderConcat(**dec)
        else:
            self.nets.decoder = networks.Decoder(**dec)
        if self.is_train():
            self._add_training_nets(dtype)
        for net in self.nets.values():
            net.to(self.device)
            if not self.is_train():
                net.requires_grad_(False)
        self.initialize()
