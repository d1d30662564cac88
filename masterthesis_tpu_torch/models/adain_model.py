"""AdaINModel: style injected by AdaIN in the decoder's residual blocks.

The generators of ``masterthesis_tpu/models/adain_model.py`` (inference
only: no discriminators).
"""
from __future__ import annotations

import torch

from masterthesis_tpu_torch.models import networks
from masterthesis_tpu_torch.models.translation import TranslationModel


class AdaINModel(TranslationModel):
    def __init__(self, args, device=None):
        """Builds the nets on ``device`` (default the card; raises without one
        unless ``device="cpu"``) and draws their weights from ``args.seed``."""
        super().__init__(args, device)
        a = args
        dtype = torch.bfloat16 if getattr(a, "compute_dtype", "float32") == "bfloat16" else torch.float32
        self.compute_dtype = dtype
        self.nets.content_encoder = networks.ContentEncoder(
            a.input_dim, dim=a.dim, norm=a.enc_norm, dtype=dtype
        )
        self.nets.style_encoder = networks.ReparameterizedStyleEncoder(
            a.input_dim, output_dim=a.latent_dim, dim=a.dim, num_domains=a.num_domains,
            norm=None, activation="lrelu", dtype=dtype,
        )
        self.nets.decoder = networks.AdaINDecoder(
            output_dim=a.input_dim, dim=self.nets.content_encoder.output_dim,
            num_domains=a.num_domains, latent_dim=a.latent_dim, up_type=a.up_type,
            norm=a.dec_norm, dtype=dtype,
        )
        for net in self.nets.values():
            net.requires_grad_(False).to(self.device)
        self.initialize()
