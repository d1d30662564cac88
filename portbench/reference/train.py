"""The plain reference's training iterations, a library: the
content-discriminator step and the fused GAN main step (``--gan_step
fused``, ``--use_dis_content``, the vanilla GAN loss), with the clip ->
weight decay -> Adam chain, written out in plain PyTorch in f32 from the
published equations and optimised by plain autograd.

It imports nothing of the program. The benchmark hands it the seeded
weights, the batches and every random draw of the checked steps (content
noise, VAE eps, random styles), and it keeps its own parameters and Adam
state from there.

:class:`Step` takes its generator's decoder and style encoder from its
subclass: a configuration's training reference is the file
``reference/<reference>.train.py`` that its ``configs/<config>.json``
names, which sets them (AdaINModel: :func:`portbench.reference.nets.adain_decoder`
and the VAE style encoder here). The other nets are shared: the content
encoder of :mod:`portbench.reference.nets`, the VAE style encoder (a 4x4/s2
stem over [x, c], pre-activation residual downs whose shortcut sees the
activated input, mu and logvar heads), the two patch discriminators with
their domain heads and the content discriminator on the content codes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.nets import Arith, content_encoder, instance_norm, lrelu

GEN_NETS = ("content_encoder", "style_encoder", "decoder")


def concat_label(x, c):
    n, _, h, w = x.shape
    return torch.cat([x, c[:, :, None, None].expand(n, c.shape[1], h, w)], dim=1)


def _count(p: dict, prefix: str, start: int = 0) -> int:
    n = start
    while any(k.startswith(f"{prefix}{n}.") for k in p):
        n += 1
    return n


def style_encoder(p: dict, x, c, eps, A: Arith):
    """(z, mu, logvar): a 4x4/s2 reflect stem over [x, c] with bias, then
    residual downs: lrelu(x) -> 3x3 conv, lrelu -> 3x3 conv -> 2x2 average
    pool, plus a 1x1 conv of the pooled activated input; lrelu, global mean,
    the mu and logvar heads, z = mu + eps exp(logvar / 2)."""
    h = A.conv("se.stem", concat_label(x, c), p["stem.conv.weight"], p["stem.conv.bias"],
               2, 1, True)
    for i in range(1, _count(p, "down", 1)):
        pre = f"down{i}"
        a = lrelu(h)
        r = lrelu(A.conv(f"se.{pre}.c1", a, p[f"{pre}.conv1.conv.weight"],
                         p[f"{pre}.conv1.conv.bias"], 1, 1, True))
        r = A.conv(f"se.{pre}.c2", r, p[f"{pre}.conv2.conv.weight"], p[f"{pre}.conv2.conv.bias"],
                   1, 1, True)
        s = A.conv(f"se.{pre}.sc", F.avg_pool2d(a, 2, 2), p[f"{pre}.shortcut.weight"],
                   p[f"{pre}.shortcut.bias"])
        h = F.avg_pool2d(r, 2, 2) + s
    h = lrelu(h).mean(dim=(2, 3))
    mu = A.linear(h, p["fc.weight"], p["fc.bias"])
    logvar = A.linear(h, p["fcVar.weight"], p["fcVar.bias"])
    z = mu if eps is None else mu + eps * torch.exp(0.5 * logvar)
    return z, mu, logvar


def discriminator(p: dict, x, A: Arith):
    """(patch logits, class logits): stride-2 3x3 reflect convs with bias and
    lrelu, a 1x1 patch head with zero padding 1, a class head whose kernel
    covers the last map, averaged."""
    h = x
    for i in range(_count(p, "layer")):
        h = lrelu(A.conv(f"d.layer{i}", h, p[f"layer{i}.conv.weight"], p[f"layer{i}.conv.bias"],
                         2, 1, True))
    patch = A.conv("d.patch", h, p["patch_head.weight"], None, 1, 1)
    return patch, A.conv("d.cls", h, p["cls_head.weight"]).mean(dim=(2, 3))


def content_discriminator(p: dict, x, A: Arith):
    """Domain logits of content codes: stride-2 7x7 reflect convs (pad 1)
    with instance norm and lrelu, a VALID 4x4 conv with lrelu, a 1x1 head."""
    h = x
    n = min(_count(p, "layer"), 3)  # the VALID final conv is always layer3
    for i in range(n):
        h = lrelu(instance_norm(A.conv(f"cd.layer{i}", h, p[f"layer{i}.conv.weight"],
                                       p[f"layer{i}.conv.bias"], 2, 1, True)))
    h = lrelu(A.conv("cd.last", h, p["layer3.conv.weight"], p["layer3.conv.bias"]))
    return A.conv("cd.head", h, p["head.weight"], p["head.bias"]).mean(dim=(2, 3))


def bce_logits(x, t):
    return (x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def gan_loss(pred, real: bool):
    return bce_logits(pred, torch.ones_like(pred) if real else torch.zeros_like(pred))


def l1(a, b):
    return (a - b).abs().mean()


def kl(mu, logvar):
    return -0.5 * (1.0 + logvar - mu.square() - torch.exp(logvar)).sum()


class Adam:
    """optax's clip_by_global_norm (optional) -> add_decayed_weights ->
    scale_by_adam (eps 1e-8, bias-corrected, f32 corrections) -> -lr, one
    state per net; a missing gradient is a zero one."""

    def __init__(self, params: dict, beta1=0.5, beta2=0.999, wd=1e-4):
        self.b1, self.b2, self.wd = beta1, beta2, wd
        self.count = {n: 0 for n in params}
        self.mu = {n: {k: torch.zeros_like(v) for k, v in p.items()} for n, p in params.items()}
        self.nu = {n: {k: torch.zeros_like(v) for k, v in p.items()} for n, p in params.items()}
        self.first_mu: dict = {}  # net -> {leaf: mu after the net's first update}
        self.first_grad: dict = {}  # net -> {leaf: |gradient| (0-dim) at its first update}

    @torch.no_grad()
    def step(self, net: str, params: dict, grads: dict, lr: float, clip=None) -> None:
        g = {k: torch.zeros_like(v) if grads.get(k) is None else grads[k] for k, v in params.items()}
        if clip is not None:
            norm = torch.sqrt(sum(t.square().sum() for t in g.values()))
            keep = norm < clip
            g = {k: torch.where(keep, t, (t / norm) * clip) for k, t in g.items()}
        raw = {k: t.norm() for k, t in g.items()}
        g = {k: t + self.wd * params[k] for k, t in g.items()}
        self.count[net] += 1
        c = self.count[net]
        bc1 = float(np.float32(1.0) - np.power(np.float32(self.b1), np.float32(c)))
        bc2 = float(np.float32(1.0) - np.power(np.float32(self.b2), np.float32(c)))
        for k, p in params.items():
            mu, nu = self.mu[net][k], self.nu[net][k]
            mu.copy_((1 - self.b1) * g[k] + self.b1 * mu)
            nu.copy_((1 - self.b2) * g[k].square() + self.b2 * nu)
            p.add_(((mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)) * -lr)
        if c == 1:
            self.first_mu[net] = {k: v.clone() for k, v in self.mu[net].items()}
            self.first_grad[net] = raw


class Step:
    """The reference's training state: parameters by net and Adam. A
    subclass sets ``decoder`` (p, content codes, styles, targets, Arith) ->
    NCHW images and ``style_encoder`` (p, images, targets, eps, Arith) ->
    (z, mu, logvar)."""

    decoder = None
    style_encoder = None

    def __init__(self, weights: dict, A: Arith, lr: float = 1e-4, lambda_cls=1.0,
                 lambda_cls_g=5.0, lambda_rec=10.0, clip_content=5.0):
        self.params = {n: {k: v.detach().float().clone().requires_grad_(True)
                           for k, v in sd.items() if v.is_floating_point()}
                       for n, sd in weights.items()}
        self.adam = Adam(self.params)
        self.A, self.lr = A, lr
        self.lambda_cls, self.lambda_cls_g, self.lambda_rec = lambda_cls, lambda_cls_g, lambda_rec
        self.clip_content = clip_content
        self.step_count = 0

    def _update(self, names, loss, lr, grad_outputs=None) -> None:
        leaves = [(n, k, v) for n in names for k, v in self.params[n].items()]
        grads = torch.autograd.grad(loss, [v for _, _, v in leaves], grad_outputs=grad_outputs,
                                    allow_unused=True)
        for n in names:
            g = {k: gr for (m, k, _), gr in zip(leaves, grads) if m == n}
            clip = self.clip_content if n == "content_discriminator" else None
            self.adam.step(n, self.params[n], g, lr, clip)

    def _enc(self, img, noise):
        return content_encoder(self.params["content_encoder"], img, self.A, noise)

    def _style(self, img, c, eps):
        return type(self).style_encoder(self.params["style_encoder"], img, c, eps, self.A)

    def _dec(self, z_c, z, c):
        return type(self).decoder(self.params["decoder"], z_c, z, c, self.A)

    def _disc(self, name, x):
        return discriminator(self.params[name], x, self.A)

    @staticmethod
    def _batch(batch):
        img = torch.cat([batch["x1"], batch["x2"]]).float().permute(0, 3, 1, 2).contiguous()
        return img, torch.cat([batch["y1"], batch["y2"]]).float(), batch["x1"].shape[0]

    def content_step(self, batch, draws: dict) -> dict:
        img, c_org, _ = self._batch(batch)
        lr = float(torch.tensor(self.lr) / 2.5)
        with torch.no_grad():
            z_c = self._enc(img, draws["c.noise"])
        loss = bce_logits(content_discriminator(self.params["content_discriminator"], z_c,
                                                self.A), c_org)
        self._update(("content_discriminator",), loss, lr)
        self.step_count += 1
        return {"d_content_cls": loss.detach()}

    def _update_d(self, name, img, fake, c_org, logs, prefix) -> None:
        b_f = fake.shape[0]
        pred, cls = self._disc(name, torch.cat([fake, img]))
        adv = gan_loss(pred[:b_f], False) + gan_loss(pred[b_f:], True)
        cls_loss = bce_logits(cls[b_f:], c_org)
        total = adv + self.lambda_cls * cls_loss
        self._update((name,), total, self.lr)
        d = {"d_adv": adv.detach(), "d_cls": cls_loss.detach(), "d_total": total.detach()}
        logs.update({f"{prefix}_{k}": v for k, v in d.items()})
        logs.update(d)

    def _g_adv(self, name, fake, c_org):
        pred, cls = self._disc(name, fake)
        return gan_loss(pred, True), bce_logits(cls, c_org) * self.lambda_cls_g

    def main_step(self, batch, draws: dict) -> dict:
        """The fused main step: G phase 1's forward at the pre-update params,
        D1 on its detached fakes, D2 on a random-style decode of its detached
        content codes, then the generators' gradient of phase 1 with D1's
        terms against the updated D1 taken through the saved fakes, then G
        phase 2 against D2."""
        img, c_org, b = self._batch(batch)
        cls_a, cls_b = c_org[:b], c_org[b:]
        logs = {}
        # G phase 1 forward
        z_c = self._enc(img, draws["g1.noise"])
        z_s, mu, logvar = self._style(img, c_org, draws["g1.eps"])
        z_ca, z_cb, z_sa, z_sb = z_c[:b], z_c[b:], z_s[:b], z_s[b:]
        fakes = self._dec(torch.cat([z_cb, z_ca, z_ca, z_cb]), torch.cat([z_sa, z_sa, z_sb, z_sb]),
                          torch.cat([cls_a, cls_a, cls_b, cls_b]))
        img_ba, img_aa, img_ab, img_bb = fakes.chunk(4)
        img_fake, img_self = torch.cat([img_ba, img_ab]), torch.cat([img_aa, img_bb])
        z_c_rec = self._enc(img_fake, draws["g1.noise_rec"])
        z_s_rec, _, _ = self._style(img_fake, c_org, draws["g1.eps_rec"])
        img_recon = self._dec(torch.cat([z_c_rec[b:], z_c_rec[:b]]),
                              torch.cat([z_s_rec[:b], z_s_rec[b:]]), c_org)
        g = {
            "l1_self_rec": l1(img, img_self) * self.lambda_rec,
            "l1_cc_rec": l1(img, img_recon) * self.lambda_rec,
            "kl_zc": z_c.square().mean() * 0.01,
            "kl_zs": kl(mu, logvar) * 0.01,
            "g_content": bce_logits(content_discriminator(self.params["content_discriminator"], z_c,
                                                          self.A), 1.0 - c_org),
        }
        aux = g["l1_self_rec"] + g["l1_cc_rec"] + g["kl_zc"] + g["kl_zs"] + g["g_content"]
        # D1, D2
        self._update_d("discriminator1", img, img_fake.detach(), c_org, logs, "d1")
        z_sr = draws["z_sr"]
        with torch.no_grad():
            img_random = self._dec(torch.cat([z_cb, z_ca]).detach(), torch.cat([z_sr, z_sr]), c_org)
        self._update_d("discriminator2", img, img_random, c_org, logs, "d2")
        # G phase 1 backward against the updated D1
        fake = img_fake.detach().requires_grad_(True)
        adv, cls = self._g_adv("discriminator1", fake, c_org)
        (cot,) = torch.autograd.grad(adv + cls, fake)
        self._update(GEN_NETS, [aux, img_fake], self.lr, [torch.ones_like(aux), cot])
        g.update(g_adv=adv, g_cls=cls, total_g=aux + adv + cls)
        logs.update({k: v.detach() for k, v in g.items()})
        # G phase 2
        z_sr2 = draws["z_sr2"]
        z_c2 = self._enc(img, draws["g2.noise"])
        img_rand2 = self._dec(torch.cat([z_c2[b:], z_c2[:b]]), torch.cat([z_sr2, z_sr2]), c_org)
        _, mu2, _ = self._style(img_rand2, c_org, draws["g2.eps"])
        loss_z = (l1(mu2[:b], z_sr2) + l1(mu2[b:], z_sr2)) * 10.0
        adv2, cls2 = self._g_adv("discriminator2", img_rand2, c_org)
        self._update(("content_encoder", "decoder"), loss_z + adv2 + cls2, self.lr)
        logs.update(l1_recon_z=loss_z.detach(), gan2=adv2.detach(), gan2_cls=cls2.detach())
        self.step_count += 1
        return logs


def draw_shapes(b: int, latent: int, code_shape) -> dict:
    """Every draw of one content step and one fused main step, by the
    program's names: content noise at the code's shape, the VAE eps of the
    2b images, the random styles of the b pairs."""
    two = (2 * b, *code_shape[1:])
    return {
        "c.noise": two, "g1.noise": two, "g1.noise_rec": two, "g2.noise": two,
        "g1.eps": (2 * b, latent), "g1.eps_rec": (2 * b, latent), "g2.eps": (2 * b, latent),
        "z_sr": (b, latent), "z_sr2": (b, latent),
    }
