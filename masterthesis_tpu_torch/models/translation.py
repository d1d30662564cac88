"""Content/style translation model: serving and the training step.

Ports ``encode_content``, ``encode_style``, ``decode``, ``get_z_random``,
the two serving forwards, int8 serving (``calibrate_int8``,
``disable_int8``) and the training step (``optimize_parameters``: the main
step of D1, D2, G phase 1 and G phase 2, and the content-discriminator step
on the ``d_iter`` schedule) of ``masterthesis_tpu/models/translation.py``.
Layout at the public entry points is the JAX package's: images NHWC f32 in
[-1, 1], ``z`` (B, latent), ``c`` one-hot (B, K). Inside, tensors are NCHW
and contiguous: images are permuted once on entry and once on exit.

Training updates the nets' parameters in place: each phase takes the
gradients of its loss with ``torch.autograd.grad`` over its nets'
parameters, at the parameters the previous phase left, then applies the
optax chain of ``models/functions.py``. The order is the JAX package's: D1,
D2, then G phase 1 on the three generator nets, then G phase 2 on the
content encoder and the decoder. The main step runs inside
``resblock_train.fused_train_trace``, so that its resblocks take kernels 9
and 10 (``--fused_resblock auto``: on the card); the content step, as in the
JAX package, does not. Random draws come from :class:`StepDraws`, the
dropout masks of ``--use_dropout`` too. Without ``reparam`` (BaseModel's
plain style encoder) the step takes the JAX package's other branches: the
style code's L2 in place of the KL term, and phase 2 regresses the style
code itself in place of mu.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from masterthesis_tpu_torch.models import losses as L
from masterthesis_tpu_torch.models import networks
from masterthesis_tpu_torch.models.blocks import DROPOUT_RATE
from masterthesis_tpu_torch.models.functions import apply_updates
from masterthesis_tpu_torch.models.model import Model
from masterthesis_tpu_torch.models.quantize import LEAF, extract_amax, int8_convs, merge_amax
from masterthesis_tpu_torch.ops.kernels.resblock_train import fused_train_trace

INT8_NETS = ("content_encoder", "decoder")
GEN_NETS = ("content_encoder", "style_encoder", "decoder")

# flags of the JAX package whose branches the port does not have yet, with
# the ROADMAP item that holds them
_UNPORTED = (
    (lambda a: a.gan_step == "fused", "--gan_step fused", "A.6"),
    (lambda a: a.ms_dis, "--ms_dis", "A.6"),
    (lambda a: a.dis_sn, "--dis_sn", "A.6"),
    (lambda a: a.use_ragan, "--use_ragan", "A.6"),
    (lambda a: "hinge" in (a.gan_mode or ""), "--gan_mode hinge", "A.6"),
    (lambda a: "wgangp" in (a.gan_mode or "") and (a.lambda_gp or 0.0) > 0.0,
     "--gan_mode wgangp with --lambda_gp > 0", "A.6"),
    (lambda a: a.vgg_loss is not None, "--vgg_loss", "A.6 (VGG weights)"),
    (lambda a: a.remat, "--remat", "A.6"),
    (lambda a: a.int8_train, "--int8_train", "A.6"),
)


class StepDraws:
    """The random draws of one training step, by name.

    A draw that the caller passed (``given``) is used as it is; any other is
    drawn from ``generator`` on first use, or, without a generator, left out:
    no content noise, z = mu from the style encoder and no dropout, the
    deterministic step that the JAX package evaluates with ``ks=None,
    train=False``. The styles ``z_sr`` and ``z_sr2`` (B, latent) are needed
    either way. Normal draws: ``{d,g1,g2,c}.noise`` and ``g1.noise_rec``
    (content noise, the code's shape), ``{d,g1,g2}.eps`` and ``g1.eps_rec``
    (VAE eps, (2B, latent)), ``z_sr``, ``z_sr2``. Dropout keep masks (bool,
    kept with probability 1/2), one set per decode, as the JAX step gives
    each decode its own rng: ``{d,g1,g2}.drop.<block>`` and
    ``g1.drop_rec.<block>``, one per dropout block of the decoder, of that
    block's output shape.
    """

    def __init__(self, generator: Optional[torch.Generator] = None, **given):
        self.generator = generator
        self.given = dict(given)

    def normal(self, name: str, shape, required: bool = False) -> Optional[torch.Tensor]:
        t = self.given.get(name)
        if t is None and self.generator is not None:
            t = torch.randn(tuple(shape), generator=self.generator, device=self.generator.device)
            self.given[name] = t
        if t is None and required:
            raise ValueError(f"draw {name!r} is needed: pass it, or a generator")
        return t

    def masks(self, name: str) -> networks.MaskSource:
        """The mask source of one decode: ``source(block, shape)`` gives the
        keep mask ``<name>.<block>`` as given, or drawn from the generator on
        first use, or None (no dropout) without either."""
        def source(block: str, shape) -> Optional[torch.Tensor]:
            key = f"{name}.{block}"
            t = self.given.get(key)
            if t is None and self.generator is not None:
                g = self.generator
                t = torch.rand(tuple(shape), generator=g, device=g.device) < 1.0 - DROPOUT_RATE
                self.given[key] = t
            return t
        return source


def _nchw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 3, 1, 2).contiguous()


def _nhwc(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 2, 3, 1).contiguous()


class TranslationModel(Model):
    """Shared inference logic; subclasses build the nets. ``reparam``: the
    style encoder returns (z, mu, logvar) and takes a VAE draw; without it,
    z alone."""

    reparam = True

    def __init__(self, args, device=None):
        super().__init__(args, device)
        self.latent_dim = int(args.latent_dim)
        # the installed amax tree per net, or None: the float path
        self.quant: dict | None = None

    # NCHW building blocks
    def encode_content(self, img: torch.Tensor, noise=None) -> torch.Tensor:
        serving = bool(self.quant and self.quant.get("content_encoder"))
        return self.nets.content_encoder(img, serving=serving, noise=noise)

    def encode_style(self, img: torch.Tensor, c: torch.Tensor, eps=None):
        """(z, mu, logvar); ``eps`` None gives z = mu. The plain encoder
        (``reparam`` off) ignores ``eps`` and gives (z, None, None)."""
        if not self.reparam:
            return self.nets.style_encoder(img, c), None, None
        return self.nets.style_encoder(img, c, eps)

    def decode(self, z_c: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
               masks: Optional[networks.MaskSource] = None) -> torch.Tensor:
        """``masks``: the dropout mask source of this decode (training), or None."""
        return self.nets.decoder(z_c, z, c, masks)

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

    # training
    def _check_train_flags(self) -> None:
        for selected, flag, item in _UNPORTED:
            if selected(self.args):
                raise NotImplementedError(
                    f"{flag} is not ported to masterthesis_tpu_torch yet (ROADMAP {item})")

    def _add_training_nets(self, dtype: torch.dtype) -> None:
        """The nets beside the generators: ``discriminator1``,
        ``discriminator2`` and, with ``use_dis_content``, the
        ``content_discriminator`` on the content codes, as both JAX models
        build them; a flag whose branch is not ported raises first."""
        self._check_train_flags()
        a = self.args
        self.nets.discriminator1, self.nets.discriminator2 = (networks.Discriminator(
            a.input_dim, dim=a.dim, norm=a.dis_norm, num_domains=a.num_domains,
            image_size=a.crop_size, n_layers=a.dis_n_layers or 6, dtype=dtype,
        ) for _ in range(2))
        if a.use_dis_content:
            content_dim = self.nets.content_encoder.output_dim
            self.nets.content_discriminator = networks.ContentDiscriminator(
                content_dim, dim=content_dim, num_domains=a.num_domains,
                n_layers=a.dis_content_layers or 3, kernel_size=a.dis_content_kernel or 7,
                final_kernel=a.dis_content_final_kernel or 4, dtype=dtype,
            )

    def _batch(self, batch):
        """(img NCHW f32, c_org f32, b) from a batch of NHWC x1, x2 and one-hot y1, y2."""
        img = torch.cat([self._tensor(batch["x1"]), self._tensor(batch["x2"])], dim=0)
        c_org = torch.cat([self._tensor(batch["y1"]), self._tensor(batch["y2"])], dim=0)
        return _nchw(img), c_org, len(batch["x1"])

    def _content(self, img, draws: StepDraws, name: str):
        shape = self.nets.content_encoder.code_shape(img.shape)
        return self.encode_content(img, draws.normal(name, shape))

    def _style(self, img, c, draws: StepDraws, name: str):
        eps = draws.normal(name, (img.shape[0], self.latent_dim)) if self.reparam else None
        return self.encode_style(img, c, eps)

    def _update(self, names, loss: torch.Tensor, lr: float) -> None:
        """Gradients of ``loss`` over the nets ``names`` (all taken before any
        update), then one optimizer step per net."""
        params = {n: list(self.nets[n].parameters()) for n in names}
        grads = torch.autograd.grad(loss, [p for n in names for p in params[n]],
                                    allow_unused=True)
        i = 0
        for n in names:
            k = len(params[n])
            apply_updates(params[n], grads[i:i + k], self.state.opt_state[n], lr,
                          **self.optimizer_config(n))
            i += k

    def _make_d_fakes(self, img, c_org, b, z_sr, draws):
        """The D phase's fakes: one 4b decode, no gradient."""
        with torch.no_grad():
            cls_a, cls_b = c_org[:b], c_org[b:]
            z_c = self._content(img, draws, "d.noise")
            z_s, _, _ = self._style(img, c_org, draws, "d.eps")
            z_ca, z_cb, z_sa, z_sb = z_c[:b], z_c[b:], z_s[:b], z_s[b:]
            fakes = self.decode(
                torch.cat([z_cb, z_cb, z_ca, z_ca]),
                torch.cat([z_sa, z_sr.to(z_s.dtype), z_sb, z_sr.to(z_s.dtype)]),
                torch.cat([cls_a, cls_a, cls_b, cls_b]), draws.masks("d.drop"),
            )
            img_ba, img_br, img_ab, img_ar = fakes.chunk(4)
            return torch.cat([img_ba, img_ab]), torch.cat([img_br, img_ar])

    def _d_loss(self, d_name, real, fake, c_org):
        """One D forward over concat(fake, real): the adversarial terms on
        each half, the domain classification on the real half."""
        a = self.args
        b_f = fake.shape[0]
        pred, cls = self.nets[d_name](torch.cat([fake, real.to(fake.dtype)]))
        adv = L.gan_loss(pred[:b_f], False, a.gan_mode) + L.gan_loss(pred[b_f:], True, a.gan_mode)
        cls = L.bce_logits_loss(cls[b_f:], c_org)
        total = adv + a.lambda_cls * cls
        return total, {"d_adv": adv, "d_cls": cls, "d_total": total}

    def _update_d(self, d_name, img, fake, c_org, lr, logs, prefix):
        total, d_logs = self._d_loss(d_name, img, fake, c_org)
        self._update((d_name,), total, lr)
        d_logs = {k: v.detach() for k, v in d_logs.items()}
        logs.update({f"{prefix}_{k}": v for k, v in d_logs.items()})
        logs.update(d_logs)  # the JAX package's keys: the last write (d2) wins

    def _g_adv_loss(self, fake, c_org, d_name):
        pred, cls = self.nets[d_name](fake)
        return (L.gan_loss(pred, True, self.args.gan_mode),
                L.bce_logits_loss(cls, c_org) * self.args.lambda_cls_G)

    def _g1_loss(self, img, c_org, b, draws):
        """G phase 1: translation, self and cycle reconstruction, the KL
        terms (the style code's L2 without ``reparam``), the content
        adversary and D1's terms. Returns (total, logs)."""
        a = self.args
        cls_a, cls_b = c_org[:b], c_org[b:]
        z_c = self._content(img, draws, "g1.noise")
        z_s, mu, logvar = self._style(img, c_org, draws, "g1.eps")
        z_ca, z_cb, z_sa, z_sb = z_c[:b], z_c[b:], z_s[:b], z_s[b:]
        fakes = self.decode(torch.cat([z_cb, z_ca, z_ca, z_cb]),
                            torch.cat([z_sa, z_sa, z_sb, z_sb]),
                            torch.cat([cls_a, cls_a, cls_b, cls_b]), draws.masks("g1.drop"))
        img_ba, img_aa, img_ab, img_bb = fakes.chunk(4)
        img_fake = torch.cat([img_ba, img_ab])
        img_self = torch.cat([img_aa, img_bb])
        z_c_rec = self._content(img_fake, draws, "g1.noise_rec")
        z_s_rec, _, _ = self._style(img_fake, c_org, draws, "g1.eps_rec")
        img_recon = self.decode(torch.cat([z_c_rec[b:], z_c_rec[:b]]),
                                torch.cat([z_s_rec[:b], z_s_rec[b:]]), c_org,
                                draws.masks("g1.drop_rec"))
        logs = dict(
            l1_self_rec=L.l1_loss(img, img_self) * a.lambda_rec,
            l1_cc_rec=L.l1_loss(img, img_recon) * a.lambda_rec,
            kl_zc=L.l2_regularize(z_c) * 0.01,
            kl_zs=(L.kl_divergence(mu, logvar) if self.reparam else L.l2_regularize(z_s)) * 0.01,
        )
        total = logs["l1_self_rec"] + logs["l1_cc_rec"] + logs["kl_zc"] + logs["kl_zs"]
        if a.use_dis_content:
            logs["g_content"] = L.bce_logits_loss(self.nets.content_discriminator(z_c), 1.0 - c_org)
            total = total + logs["g_content"]
        adv, cls = self._g_adv_loss(img_fake, c_org, "discriminator1")
        total = total + adv + cls
        logs.update(g_adv=adv, g_cls=cls, total_g=total)
        return total, logs

    def _g2_loss(self, img, c_org, b, z_sr2, draws):
        """G phase 2: decode with a random style, regress it back (on mu, or
        on the style code itself without ``reparam``), and D2's terms.
        Returns (total, logs)."""
        z_c = self._content(img, draws, "g2.noise")
        img_random = self.decode(torch.cat([z_c[b:], z_c[:b]]), torch.cat([z_sr2, z_sr2]), c_org,
                                 draws.masks("g2.drop"))
        z_rec, mu2, _ = self._style(img_random, c_org, draws, "g2.eps")
        target = mu2 if self.reparam else z_rec
        loss_z = (L.l1_loss(target[:b], z_sr2) + L.l1_loss(target[b:], z_sr2)) * 10.0
        adv2, cls2 = self._g_adv_loss(img_random, c_org, "discriminator2")
        return loss_z + adv2 + cls2, dict(l1_recon_z=loss_z, gan2=adv2, gan2_cls=cls2)

    def main_step(self, batch, draws: Optional[StepDraws] = None) -> dict:
        """D1, D2, G phase 1, G phase 2; returns the logged losses (0-dim
        tensors on the device) and ``lr``."""
        img, c_org, b = self._batch(batch)
        draws = draws or StepDraws(self.generator)
        lr = self.schedule(self.state.step)
        logs = {}
        with fused_train_trace(self.args.fused_resblock or "off"):
            z_sr = draws.normal("z_sr", (b, self.latent_dim), required=True)
            img_fake, img_random = self._make_d_fakes(img, c_org, b, z_sr, draws)
            self._update_d("discriminator1", img, img_fake, c_org, lr, logs, "d1")
            self._update_d("discriminator2", img, img_random, c_org, lr, logs, "d2")
            total, g_logs = self._g1_loss(img, c_org, b, draws)
            self._update(GEN_NETS, total, lr)
            logs.update({k: v.detach() for k, v in g_logs.items()})
            z_sr2 = draws.normal("z_sr2", (b, self.latent_dim), required=True)
            total, g_logs = self._g2_loss(img, c_org, b, z_sr2, draws)
            self._update(("content_encoder", "decoder"), total, lr)
            logs.update({k: v.detach() for k, v in g_logs.items()})
        logs["lr"] = lr
        self.state.step += 1
        return logs

    def content_step(self, batch, draws: Optional[StepDraws] = None) -> dict:
        """The content discriminator alone, at lr / 2.5 with its gradients
        clipped, on the content codes of the batch (no gradient into the
        encoder, composed resblocks)."""
        img, c_org, _ = self._batch(batch)
        draws = draws or StepDraws(self.generator)
        lr = float(torch.tensor(self.schedule(self.state.step)) / 2.5)
        with torch.no_grad():
            z_c = self._content(img, draws, "c.noise")
        loss = L.bce_logits_loss(self.nets.content_discriminator(z_c), c_org)
        self._update(("content_discriminator",), loss, lr)
        self.state.step += 1
        return {"d_content_cls": loss.detach()}

    def optimize_parameters(self, batch, global_iter: int, draws: Optional[StepDraws] = None):
        """One iteration: the content step where ``use_dis_content`` and
        ``global_iter % d_iter != 0``, else the main step. Returns its logs."""
        a = self.args
        if a.use_dis_content and global_iter % a.d_iter != 0:
            self.loss = self.content_step(batch, draws)
        else:
            self.loss = self.main_step(batch, draws)
        return self.loss

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _timed(self, fn, *args):
        start = time.perf_counter()
        with torch.inference_mode():
            out = fn(*(None if a is None else self._tensor(a) for a in args))
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
        normal draws from ``generator`` (default: seed 0 on the model's
        device); a model without ``reparam`` draws nothing and ignores ``eps``."""
        if not self.reparam:
            eps = None
        elif eps is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            eps = self.get_z_random(len(img_src), generator)
        return self._timed(self._forward_reference_impl, img_src, img_ref, c_trg, eps)
