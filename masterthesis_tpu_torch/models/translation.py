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
optax chain of ``models/functions.py``. ``--gan_step`` picks the main step:
"reference" (D fakes from their own forward; D1, D2, then G phase 1 on the
three generator nets, then G phase 2 on the content encoder and the
decoder) or "fused" (G phase 1's forward first, whose fakes and content
codes feed D1 and D2, then its backward against the updated D1; the
JAX package's ``_main_step_fused_body``, which ``bench.py`` times). The
main step runs inside ``resblock_train.fused_train_trace``, so that its
resblocks take kernels 9 and 10 (``--fused_resblock auto``: on the card);
the content step, as in the JAX package, does not. Random draws come from
:class:`StepDraws`, the dropout masks of ``--use_dropout`` and WGAN-GP's
eps too. Without ``reparam`` (BaseModel's plain style encoder) the step
takes the JAX package's other branches: the style code's L2 in place of the
KL term, and phase 2 regresses the style code itself in place of mu.

The loss variants are the JAX package's: ``--gan_mode hinge`` (hinge's D
and G forms), ``--use_ragan``, ``--gan_mode wgangp --lambda_gp > 0`` (the
gradient penalty, a double backward through D), ``--dis_sn`` (spectral
norm on the discriminators' convs, ``ops/spectral.py``), ``--ms_dis`` (the
multi-scale discriminator), ``--vgg_loss`` (the perceptual terms ``g_p`` and
``g_p2``, in f32) and ``--remat`` (``torch.utils.checkpoint`` around the
content encoder and the decoder) and ``--int8_train`` (below).
WGAN-GP's penalty takes its discriminator forward and the gradient at the
interpolates without cuDNN on the card: cuDNN's f32 4x4/s2 convs there move
the penalty by 1.9e-4 from an f64 evaluation (the CPU's f32 by 1.3e-8;
``tools/wgangp_card_vs_cpu.py``), ATen's own conv by 2e-7. The double
backward into D's params keeps cuDNN, which is accurate there.

``--int8_train`` (quantization-aware training, ``ops/qat.py``):
:meth:`TranslationModel.calibrate_quant_train` measures every conv's input
range over one batch of the content encoder and the decoder and installs
it as the convs' ``train_amax``; while one is installed the main step runs
inside ``qat.qat_trace`` instead of ``fused_train_trace``: the eligible
convs of the content encoder and the decoder whose kind is in
``--int8_train_scope`` take their int8 forward (kernels 4, 7, 5) with the
float conv's gradient, and the whole-block kernels 9 and 10 stay off, as
the JAX package's ``_with_qat`` routes its step
(``masterthesis_tpu/models/translation.py:627-657``). The content step and
the serving forwards stay float. Under data parallelism each rank
calibrates on its rows and the ranks' maxima are all-reduced with MAX, so
that every rank installs one device's tree and, from identical weights,
quantizes alike.

``compute_visuals`` (through ``forward``) gives the trainer's 2x4 image grid.

Data parallelism (``parallel.replicate`` hands the model a mesh): each rank
runs the step on its rows of the global batch, and every loss is written so
that the MEAN over the data ranks of a rank's loss is the one-device loss
on the global batch. Terms that average over the batch need nothing (the
ranks hold equal shares); the KL term, a sum over the batch, is taken times
the number of ranks; the terms that couple the batch (RaGAN's means, batch
norm's statistics) see the global batch through an all-reduce that autograd
goes through. The gradient of the global loss is then the mean of the
ranks' gradients: ``_update`` all-reduces them, once per net, before the
optimizer step (so the content step's clip sees the global gradient), and
the logged losses are the mean of the ranks'. The draws are the one-device
step's (``StepDraws.shard``). The nets are not wrapped in
``DistributedDataParallel``: the phases take their gradients with
``torch.autograd.grad``, which fills no ``.grad`` for its hooks.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from masterthesis_tpu_torch.models import losses as L
from masterthesis_tpu_torch.models import networks
from masterthesis_tpu_torch.models.blocks import DROPOUT_RATE, Conv2d
from masterthesis_tpu_torch.models.functions import apply_updates
from masterthesis_tpu_torch.models.model import Model
from masterthesis_tpu_torch.models.quantize import LEAF, extract_amax, int8_convs, merge_amax
from masterthesis_tpu_torch.ops import qat, spectral
from masterthesis_tpu_torch.ops.kernels.resblock_train import fused_train_trace
from masterthesis_tpu_torch.parallel import mesh as pmesh
from masterthesis_tpu_torch.utils import profiling

INT8_NETS = ("content_encoder", "decoder")
GEN_NETS = ("content_encoder", "style_encoder", "decoder")


class StepDraws:
    """The random draws of one training step, by name.

    A draw that the caller passed (``given``) is used as it is; any other is
    drawn from ``generator`` on first use, or, without a generator, left out:
    no content noise, z = mu from the style encoder and no dropout, the
    deterministic step that the JAX package evaluates with ``ks=None,
    train=False``. The styles ``z_sr`` and ``z_sr2`` (B, latent) are needed
    either way. Normal draws: ``{d,g1,g2,c}.noise`` and ``g1.noise_rec``
    (content noise, the code's shape), ``{d,g1,g2}.eps`` and ``g1.eps_rec``
    (VAE eps, (2B, latent)), ``z_sr``, ``z_sr2``. Uniform draws: WGAN-GP's
    interpolation ``{d1,d2}.gp_eps`` (2B, 1, 1, 1). Dropout keep masks
    (bool, kept with probability 1/2), one set per decode, as the JAX step
    gives each decode its own rng: ``{d,g1,g2}.drop.<block>`` and
    ``g1.drop_rec.<block>`` (the fused step: ``d2.drop.<block>`` for its D2
    decode, and no ``d.*``), one per dropout block of the decoder, of that
    block's output shape.
    """

    def __init__(self, generator: Optional[torch.Generator] = None, **given):
        self.generator = generator
        self.given = dict(given)
        self.rows = None  # (rank, ranks, rows) after shard()

    def shard(self, rank: int, ranks: int, rows: int) -> "StepDraws":
        """Data parallelism: from here on every draw is made (or given) at
        the global batch, and this rank keeps its rows. A draw's leading
        dimension is k chunks of the batch (k x ``rows`` locally, k x
        ``ranks`` x ``rows`` globally: [a; b] for the codes, four or six
        chunks for a decode); the rank views the global draw as (k,
        ``ranks``, ``rows``, ...) and takes index ``rank`` of the second
        axis, so that the ranks together use the one-device step's draws.
        Returns self."""
        self.rows = (rank, ranks, rows) if ranks > 1 else None
        return self

    def _global_shape(self, name: str, shape) -> tuple:
        shape = tuple(shape)
        if self.rows is None:
            return shape
        _, ranks, rows = self.rows
        if shape[0] % rows:
            raise ValueError(f"draw {name!r}: {shape[0]} rows are no whole chunks of {rows}")
        return (shape[0] * ranks, *shape[1:])

    def _local(self, t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
        if t is None or self.rows is None:
            return t
        rank, ranks, rows = self.rows
        k = shape[0] // rows
        return t.reshape(k, ranks, rows, *t.shape[1:])[:, rank].reshape(tuple(shape))

    def _draw(self, name: str, shape, sample) -> Optional[torch.Tensor]:
        t = self.given.get(name)
        if t is None and self.generator is not None:
            t = sample(self._global_shape(name, shape), generator=self.generator,
                       device=self.generator.device)
            self.given[name] = t
        return self._local(t, shape)

    def normal(self, name: str, shape, required: bool = False) -> Optional[torch.Tensor]:
        t = self._draw(name, shape, torch.randn)
        if t is None and required:
            raise ValueError(f"draw {name!r} is needed: pass it, or a generator")
        return t

    def uniform(self, name: str, shape) -> Optional[torch.Tensor]:
        """U[0, 1) draw ``name``, or None without it or a generator."""
        return self._draw(name, shape, torch.rand)

    def masks(self, name: str) -> networks.MaskSource:
        """The mask source of one decode: ``source(block, shape)`` gives the
        keep mask ``<name>.<block>`` as given, or drawn from the generator on
        first use, or None (no dropout) without either."""
        def source(block: str, shape) -> Optional[torch.Tensor]:
            key = f"{name}.{block}"
            t = self.given.get(key)
            if t is None and self.generator is not None:
                g = self.generator
                t = torch.rand(self._global_shape(key, shape), generator=g,
                               device=g.device) < 1.0 - DROPOUT_RATE
                self.given[key] = t
            return self._local(t, shape)
        return source


@contextlib.contextmanager
def _without_cudnn(on: bool):
    """cuDNN off inside the block where ``on`` (``torch.backends.cudnn.flags``
    would also turn TF32 on for every flag it is not given)."""
    old = torch.backends.cudnn.enabled
    if on:
        torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = old


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
        self.perceptual: L.VGGPerceptualLoss | None = None  # --vgg_loss, training
        # --int8_train: the installed amax tree per net (None: plain steps),
        # the conv kinds it quantizes and each net's int8 convs
        self._train_quant: dict | None = None
        self._qat_scope: frozenset | None = None
        self._qat_convs: dict = {}
        self.print_loss = ["g_adv", "g_cls", "l1_cc_rec"]

    # NCHW building blocks
    def encode_content(self, img: torch.Tensor, noise=None) -> torch.Tensor:
        with profiling.span("mt.encode_content"):
            return self.nets.content_encoder(img, noise=noise)

    def encode_style(self, img: torch.Tensor, c: torch.Tensor, eps=None):
        """(z, mu, logvar); ``eps`` None gives z = mu. The plain encoder
        (``reparam`` off) ignores ``eps`` and gives (z, None, None)."""
        with profiling.span("mt.encode_style"):
            if not self.reparam:
                return self.nets.style_encoder(img, c), None, None
            return self.nets.style_encoder(img, c, eps)

    def decode(self, z_c: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
               masks: Optional[networks.MaskSource] = None) -> torch.Tensor:
        """``masks``: the dropout mask source of this decode (training), or None."""
        with profiling.span("mt.decode"):
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
        The pass runs in the compute dtype, as the JAX package's does; at
        bf16 the int8 convs then take and give bf16 activations.
        """
        with profiling.span("mt.setup.calibrate_int8"):
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
        """Load weights; an int8 model keeps its amax tree (serving's and
        ``--int8_train``'s) and quantizes the new weights at its next int8
        forward."""
        super().load_params(state_dicts)
        self._drop_quants()

    def load(self, checkpoint=None, opt_ckpt=None) -> None:
        """``Model.load``; the int8 weights are quantized again, as after
        :meth:`load_params`."""
        super().load(checkpoint, opt_ckpt)
        self._drop_quants()

    def _drop_quants(self) -> None:
        for net in self.nets.values():
            for m in int8_convs(net).values():
                m.drop_quant()

    # int8 training (--int8_train)
    def calibrate_quant_train(self, batch, c, z) -> dict:
        """Measure the ``--int8_train`` activation ranges on one batch and
        install them (``masterthesis_tpu/models/translation.py:295-340``).

        Runs the content encoder and the decoder on the float path, without
        noise or dropout, over ``batch`` (NHWC images, or a dict whose
        ``x1`` (else ``x``) are), with one-hot targets ``c`` and styles ``z``
        (B, latent): the draws are the caller's, as :meth:`calibrate_int8`
        takes them. Records each conv's max |input| and installs it as the
        conv's ``train_amax`` (the serving ``amax_in`` stays as it is, so
        the serving forwards stay float). Returns the per-net amax tree.

        Data parallel (every rank calls it, with its rows of the global
        batch and of the global draws): each rank measures its own rows,
        where a batch norm takes the global batch's statistics, and the
        ranks' maxima are all-reduced with MAX, so that every rank installs
        the one tree that one device measures over the global batch, as the
        JAX package's calibration pass reduces over every device's rows."""
        if isinstance(batch, dict):
            batch = batch.get("x1", batch.get("x"))
        convs = [m for name in INT8_NETS for m in int8_convs(self.nets[name]).values()]
        try:
            with torch.no_grad():
                for m in convs:
                    m.calib_amax = torch.zeros((), device=self.device)
                z_c = self.nets.content_encoder(_nchw(self._tensor(batch)))
                self.nets.decoder(z_c, self._tensor(z), self._tensor(c))
                group = self._data_group()
                if group is not None:
                    amax = pmesh.all_reduce_max(torch.stack([m.calib_amax for m in convs]), group)
                    for m, a in zip(convs, amax):
                        m.calib_amax = a
                cols = {name: extract_amax(self.nets[name]) for name in INT8_NETS}
        finally:
            for m in convs:
                m.calib_amax = None
        self.load_int8_train(cols)
        return cols

    def load_int8_train(self, quant: dict) -> None:
        """Install an ``--int8_train`` amax tree (one flat dict per net of
        ``INT8_NETS``, as :meth:`calibrate_quant_train` returns)."""
        for name, tree in quant.items():
            convs = int8_convs(self.nets[name])
            if set(tree) != {f"{path}.{LEAF}" for path in convs}:
                raise KeyError(f"{name}: the amax tree does not match its convs")
            for path, m in convs.items():
                m.set_train_amax(tree[f"{path}.{LEAF}"])
            self._qat_convs[name] = list(convs.values())
        self._train_quant = {name: dict(tree) for name, tree in quant.items()}

    @property
    def int8_train_installed(self) -> bool:
        """Whether an ``--int8_train`` calibration is installed: the main
        steps then run under QAT."""
        return self._train_quant is not None

    def disable_int8_train(self) -> None:
        """Back to plain training steps."""
        for name in INT8_NETS:
            for m in int8_convs(self.nets[name]).values():
                m.set_train_amax(None)
        self._train_quant = None
        self._qat_convs = {}

    # training
    def _check_train_flags(self) -> None:
        a = self.args
        if a.int8_train and a.remat:
            raise ValueError("--int8_train is incompatible with --remat, as in the JAX package")

    def _add_training_nets(self, dtype: torch.dtype) -> None:
        """The nets beside the generators: ``discriminator1``,
        ``discriminator2`` (``Discriminator``, or with ``ms_dis`` the
        ``MultiScaleDiscriminator`` at its own width 64, as both JAX models
        build it; spectrally normalized with ``dis_sn``) and, with
        ``use_dis_content``, the ``content_discriminator`` on the content
        codes; with ``vgg_loss`` the frozen f32 ``perceptual`` loss, outside
        ``nets``. ``--int8_train`` with ``--remat`` raises first, as in the
        JAX package."""
        self._check_train_flags()
        a = self.args
        if a.int8_train:
            self._qat_scope = qat.parse_qat_scope(a.int8_train_scope)
        common = dict(norm=a.dis_norm, num_domains=a.num_domains, n_layers=a.dis_n_layers or 6,
                      sn=bool(a.dis_sn), dtype=dtype)
        if a.ms_dis:
            make = lambda: networks.MultiScaleDiscriminator(  # noqa: E731
                a.input_dim, num_scales=a.num_scales or 3, **common)
        else:
            make = lambda: networks.Discriminator(  # noqa: E731
                a.input_dim, dim=a.dim, image_size=a.crop_size, **common)
        self.nets.discriminator1, self.nets.discriminator2 = make(), make()
        if a.use_dis_content:
            content_dim = self.nets.content_encoder.output_dim
            self.nets.content_discriminator = networks.ContentDiscriminator(
                content_dim, dim=content_dim, num_domains=a.num_domains,
                n_layers=a.dis_content_layers or 3, kernel_size=a.dis_content_kernel or 7,
                final_kernel=a.dis_content_final_kernel or 4, dtype=dtype,
            )
        if a.vgg_loss is not None:
            self.perceptual = L.VGGPerceptualLoss(
                a.vgg_layers, a.layer_weights, a.vgg_type, a.vgg_loss, bool(a.norm_feat),
                a.input_dim).to(self.device).requires_grad_(False)
            self.print_loss += ["g_p", "g_p2"]

    def initialize(self, seed=None) -> None:
        """:meth:`Model.initialize`, then the perceptual loss's VGG: from
        ``args.vgg_weights`` (:func:`losses.load_vgg_params`) or, without,
        random as in the JAX package, N(0, 1 / fan_in) kernels and zero
        biases from the seed."""
        super().initialize(seed)
        if self.perceptual is None:
            return
        vgg = self.perceptual.vgg
        if self.args.vgg_weights:
            vgg.load_state_dict(L.load_vgg_params(self.args.vgg_weights, vgg))
            return
        if seed is None:
            seed = self.args.seed or 0
        g = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in vgg.modules():
                if isinstance(m, Conv2d):
                    m.weight.copy_(torch.randn(m.weight.shape, generator=g) * m.fan_in ** -0.5)
                    m.bias.zero_()

    def _batch(self, batch):
        """(img NCHW f32, c_org f32, b) from a batch of NHWC x1, x2 and one-hot y1, y2."""
        img = torch.cat([self._tensor(batch["x1"]), self._tensor(batch["x2"])], dim=0)
        c_org = torch.cat([self._tensor(batch["y1"]), self._tensor(batch["y2"])], dim=0)
        return _nchw(img), c_org, len(batch["x1"])

    def _remat(self, fn, *args):
        """``fn(*args)``, rematerialized in backward under ``--remat`` (the
        JAX package's ``jax.checkpoint`` of the content encoder and the
        decoder). Draws are made outside ``fn`` or cached by name
        (:class:`StepDraws`), so the recompute sees the same ones; none comes
        from torch's global generators, whose state is not kept."""
        if self.args.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def _content(self, img, draws: StepDraws, name: str):
        shape = self.nets.content_encoder.code_shape(img.shape)
        return self._remat(self.encode_content, img, draws.normal(name, shape))

    def _style(self, img, c, draws: StepDraws, name: str):
        eps = draws.normal(name, (img.shape[0], self.latent_dim)) if self.reparam else None
        return self.encode_style(img, c, eps)

    def _decode(self, z_c, z, c, draws: StepDraws, name: str):
        return self._remat(self.decode, z_c, z, c, draws.masks(name))

    # data parallelism (see the module docstring)
    def _data_group(self):
        return None if self.mesh is None else self.mesh.group("data")

    def _ranks(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size("data")

    def _batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the global batch (its own mean on one device)."""
        group = self._data_group()
        if group is None:
            return t.mean()
        return pmesh.all_reduce_sum(t.sum(), group) / (t.numel() * self._ranks())

    def _step_draws(self, draws: Optional[StepDraws], b: int) -> StepDraws:
        draws = draws or StepDraws(self.generator)
        if self._ranks() > 1:
            draws.shard(self.mesh.index("data"), self._ranks(), b)
        return draws

    def _update(self, names, loss, lr: float, grad_outputs=None) -> None:
        """Gradients of ``loss`` (a tensor, or tensors with their
        ``grad_outputs``) over the nets ``names``, all taken before any
        update, then per net their mean over the data ranks and one
        optimizer step."""
        params = {n: list(self.nets[n].parameters()) for n in names}
        with profiling.span("mt.opt.grad"):
            grads = torch.autograd.grad(loss, [p for n in names for p in params[n]],
                                        grad_outputs=grad_outputs, allow_unused=True)
        group = self._data_group()
        i = 0
        for n in names:
            k = len(params[n])
            g = grads[i:i + k]
            if group is not None:
                with profiling.span("mt.opt.allreduce"):
                    g = pmesh.mean_gradients(g, group)
            with profiling.span("mt.opt.adam", profiling.ON and {"net": n, "leaves": k}):
                apply_updates(params[n], g, self.state.opt_state[n], lr,
                              **self.optimizer_config(n))
            for m in self._qat_convs.get(n, ()):
                m.drop_quant()  # QAT quantizes the new weights at its next forward
            i += k

    def _make_d_fakes(self, img, c_org, b, z_sr, draws):
        """The reference step's D fakes: one 4b decode, no gradient."""
        with torch.no_grad():
            cls_a, cls_b = c_org[:b], c_org[b:]
            z_c = self._content(img, draws, "d.noise")
            z_s, _, _ = self._style(img, c_org, draws, "d.eps")
            z_ca, z_cb, z_sa, z_sb = z_c[:b], z_c[b:], z_s[:b], z_s[b:]
            fakes = self._decode(
                torch.cat([z_cb, z_cb, z_ca, z_ca]),
                torch.cat([z_sa, z_sr.to(z_s.dtype), z_sb, z_sr.to(z_s.dtype)]),
                torch.cat([cls_a, cls_a, cls_b, cls_b]), draws, "d.drop",
            )
            img_ba, img_br, img_ab, img_ar = fakes.chunk(4)
            return torch.cat([img_ba, img_ab]), torch.cat([img_br, img_ar])

    def _gradient_penalty(self, d_name, real, fake, eps):
        """WGAN-GP: mean((|grad_x sum D(x)[patch]| - 1)^2) at x = eps real +
        (1 - eps) fake, interpolated in f32 and cast to the real images'
        dtype; the first scale's patch under ``ms_dis``. The gradient keeps
        its graph, so the penalty's own gradient reaches D's parameters (a
        double backward through D), from the stored spectral ``u``. On the
        card, D's forward and the gradient at x run without cuDNN (see the
        module docstring)."""
        x = (eps * real.float() + (1.0 - eps) * fake.float()).detach().requires_grad_(True)
        with _without_cudnn(x.is_cuda):
            out = self.nets[d_name](x.to(real.dtype))
            pred = out[0][0] if isinstance(out, list) else out[0]
            (g,) = torch.autograd.grad(pred.float().sum(), x, create_graph=True)
        norms = torch.sqrt(g.square().sum(dim=(1, 2, 3)) + 1e-12)
        return (norms - 1.0).square().mean()

    def _d_loss(self, d_name, real, fake, c_org, gp_eps=None):
        """One D forward over concat(fake, real), recording the spectral
        ``u`` it reaches: the adversarial terms (hinge's D form, RaGAN's, or
        ``gan_loss`` per half; under ``ms_dis`` ``gan_loss`` per half and
        scale, whatever the mode), the domain classification on the real
        half, and with ``gp_eps`` under WGAN-GP the penalty."""
        a = self.args
        mode = a.gan_mode
        b_f = fake.shape[0]
        net = self.nets[d_name]
        with spectral.recording(net):
            out = net(torch.cat([fake, real.to(fake.dtype)]))
        if a.ms_dis:
            adv = sum(L.gan_loss(p[:b_f], False, mode) + L.gan_loss(p[b_f:], True, mode)
                      for p, _ in out)
            cls = sum(L.bce_logits_loss(c[b_f:], c_org) for _, c in out)
        else:
            pred_fake, pred_real = out[0][:b_f], out[0][b_f:]
            if a.use_ragan:
                adv = L.ragan_loss(pred_real, pred_fake, True, mode, self._batch_mean)
            elif "hinge" in mode:
                adv = L.hinge_d_loss(pred_real, pred_fake)
            else:
                adv = L.gan_loss(pred_fake, False, mode) + L.gan_loss(pred_real, True, mode)
            cls = L.bce_logits_loss(out[1][b_f:], c_org)
        total = adv + a.lambda_cls * cls
        logs = {"d_adv": adv, "d_cls": cls, "d_total": total}
        if gp_eps is not None:
            gp = self._gradient_penalty(d_name, real, fake, gp_eps)
            total = total + float(a.lambda_gp) * gp
            logs.update(d_gp=gp, d_total=total)
        return total, logs

    def _update_d(self, d_name, img, fake, c_org, lr, logs, prefix, draws):
        """One discriminator's update; its spectral ``u`` is stored after.
        Under WGAN-GP the penalty's eps is the draw ``<prefix>.gp_eps``
        (2b, 1, 1, 1); without it (no generator), no penalty, as the JAX
        package's step without an rng."""
        a = self.args
        gp_eps = None
        if "wgangp" in a.gan_mode and float(a.lambda_gp or 0.0) > 0.0:
            gp_eps = draws.uniform(f"{prefix}.gp_eps", (fake.shape[0], 1, 1, 1))
        total, d_logs = self._d_loss(d_name, img, fake, c_org, gp_eps)
        self._update((d_name,), total, lr)
        spectral.commit(self.nets[d_name])
        d_logs = {k: v.detach() for k, v in d_logs.items()}
        logs.update({f"{prefix}_{k}": v for k, v in d_logs.items()})
        logs.update(d_logs)  # the JAX package's keys: the last write (d2) wins

    def _g_adv_loss(self, img, fake, c_org, d_fake, d_real=None):
        """(adversarial, weighted classification) terms of the generator on
        ``d_fake``'s logits of ``fake``: ``gan_loss`` per scale under
        ``ms_dis``; RaGAN's against ``d_real``'s (default ``d_fake``) logits
        of the real images; hinge's G form; else ``gan_loss``."""
        a = self.args
        mode = a.gan_mode
        if a.ms_dis:
            outs = self.nets[d_fake](fake)
            return (sum(L.gan_loss(p, True, mode) for p, _ in outs),
                    sum(L.bce_logits_loss(c, c_org) for _, c in outs) * a.lambda_cls_G)
        pred_fake, cls = self.nets[d_fake](fake)
        if a.use_ragan:
            pred_real, _ = self.nets[d_real or d_fake](img)
            adv = L.ragan_loss(pred_real, pred_fake, False, mode, self._batch_mean)
        elif "hinge" in mode:
            adv = L.hinge_g_loss(pred_fake)
        else:
            adv = L.gan_loss(pred_fake, True, mode)
        return adv, L.bce_logits_loss(cls, c_org) * a.lambda_cls_G

    def _perceptual_term(self, img, fake):
        return self.perceptual(img, fake) * self.args.lambda_perceptual

    def _g1_forward(self, img, c_org, b, draws):
        """G phase 1 without D1's terms: translation, self and cycle
        reconstruction, the KL terms (the style code's L2 without
        ``reparam``), the content adversary and the perceptual term ``g_p``
        on [img_ab, img_ba]. Returns (total, img_fake, the detached content
        codes (z_ca, z_cb), logs)."""
        a = self.args
        cls_a, cls_b = c_org[:b], c_org[b:]
        z_c = self._content(img, draws, "g1.noise")
        z_s, mu, logvar = self._style(img, c_org, draws, "g1.eps")
        z_ca, z_cb, z_sa, z_sb = z_c[:b], z_c[b:], z_s[:b], z_s[b:]
        fakes = self._decode(torch.cat([z_cb, z_ca, z_ca, z_cb]),
                             torch.cat([z_sa, z_sa, z_sb, z_sb]),
                             torch.cat([cls_a, cls_a, cls_b, cls_b]), draws, "g1.drop")
        img_ba, img_aa, img_ab, img_bb = fakes.chunk(4)
        img_fake = torch.cat([img_ba, img_ab])
        img_self = torch.cat([img_aa, img_bb])
        z_c_rec = self._content(img_fake, draws, "g1.noise_rec")
        z_s_rec, _, _ = self._style(img_fake, c_org, draws, "g1.eps_rec")
        img_recon = self._decode(torch.cat([z_c_rec[b:], z_c_rec[:b]]),
                                 torch.cat([z_s_rec[:b], z_s_rec[b:]]), c_org, draws,
                                 "g1.drop_rec")
        logs = dict(
            l1_self_rec=L.l1_loss(img, img_self) * a.lambda_rec,
            l1_cc_rec=L.l1_loss(img, img_recon) * a.lambda_rec,
            kl_zc=L.l2_regularize(z_c) * 0.01,
            kl_zs=(L.kl_divergence(mu, logvar) * self._ranks() if self.reparam
                   else L.l2_regularize(z_s)) * 0.01,
        )
        total = logs["l1_self_rec"] + logs["l1_cc_rec"] + logs["kl_zc"] + logs["kl_zs"]
        if a.use_dis_content:
            logs["g_content"] = L.bce_logits_loss(self.nets.content_discriminator(z_c), 1.0 - c_org)
            total = total + logs["g_content"]
        if self.perceptual is not None:
            logs["g_p"] = self._perceptual_term(img, torch.cat([img_ab, img_ba]))
            total = total + logs["g_p"]
        return total, img_fake, (z_ca.detach(), z_cb.detach()), logs

    def _g1_loss(self, img, c_org, b, draws):
        """G phase 1 with D1's terms. Returns (total, logs)."""
        with profiling.span("mt.g1.forward"):
            total, img_fake, _, logs = self._g1_forward(img, c_org, b, draws)
        with profiling.span("mt.g.adv"):
            adv, cls = self._g_adv_loss(img, img_fake, c_org, "discriminator1")
        total = total + adv + cls
        logs.update(g_adv=adv, g_cls=cls, total_g=total)
        return total, logs

    def _g2_forward(self, img, c_org, b, z_sr2, draws):
        """G phase 2 without the adversary: decode with a random style,
        regress it back (on mu, or on the style code itself without
        ``reparam``), and the perceptual term ``g_p2`` on [img_ar, img_br].
        Returns (total, img_random, logs)."""
        z_c = self._content(img, draws, "g2.noise")
        img_random = self._decode(torch.cat([z_c[b:], z_c[:b]]), torch.cat([z_sr2, z_sr2]),
                                  c_org, draws, "g2.drop")
        z_rec, mu2, _ = self._style(img_random, c_org, draws, "g2.eps")
        target = mu2 if self.reparam else z_rec
        loss_z = (L.l1_loss(target[:b], z_sr2) + L.l1_loss(target[b:], z_sr2)) * 10.0
        logs = dict(l1_recon_z=loss_z)
        total = loss_z
        if self.perceptual is not None:
            logs["g_p2"] = self._perceptual_term(
                img, torch.cat([img_random[b:], img_random[:b]]))
            total = total + logs["g_p2"]
        return total, img_random, logs

    def _g2_phase(self, img, c_org, b, draws, lr, logs) -> None:
        """G phase 2 and its update of the content encoder and the decoder.
        The adversary is D2, except under ``ms_dis`` (D1) and RaGAN (D1's
        logits of the fakes against D2's of the real images), the JAX
        package's selection."""
        a = self.args
        z_sr2 = draws.normal("z_sr2", (b, self.latent_dim), required=True)
        total, img_random, g_logs = self._g2_forward(img, c_org, b, z_sr2, draws)
        if a.ms_dis:
            adv2, cls2 = self._g_adv_loss(img, img_random, c_org, "discriminator1")
        elif a.use_ragan:
            adv2, cls2 = self._g_adv_loss(img, img_random, c_org, "discriminator1",
                                          "discriminator2")
        else:
            adv2, cls2 = self._g_adv_loss(img, img_random, c_org, "discriminator2")
        self._update(("content_encoder", "decoder"), total + adv2 + cls2, lr)
        g_logs.update(gan2=adv2, gan2_cls=cls2)
        logs.update({k: v.detach() for k, v in g_logs.items()})

    def _reference_step(self, img, c_org, b, draws, lr, logs) -> None:
        """The reference GAN step: D fakes from their own forward, D1, D2,
        then G phase 1 against the updated D1, then G phase 2."""
        z_sr = draws.normal("z_sr", (b, self.latent_dim), required=True)
        with profiling.span("mt.d.fakes"):
            img_fake, img_random = self._make_d_fakes(img, c_org, b, z_sr, draws)
        with profiling.span("mt.d1.update"):
            self._update_d("discriminator1", img, img_fake, c_org, lr, logs, "d1", draws)
        with profiling.span("mt.d2.update"):
            self._update_d("discriminator2", img, img_random, c_org, lr, logs, "d2", draws)
        total, g_logs = self._g1_loss(img, c_org, b, draws)
        with profiling.span("mt.g.update"):
            self._update(GEN_NETS, total, lr)
        logs.update({k: v.detach() for k, v in g_logs.items()})
        with profiling.span("mt.g2.phase"):
            self._g2_phase(img, c_org, b, draws, lr, logs)

    def _fused_step(self, img, c_org, b, draws, lr, logs) -> None:
        """``--gan_step fused``: G phase 1's forward at the pre-update
        params, its graph kept; D1 on its detached fakes; D2 on one
        random-style 2b decode of its detached content codes (no gradient,
        dropout masks ``d2.drop``); then D1's terms against the updated D1,
        their gradient at the fakes, and the generators' gradients in one
        backward of (the phase-1 total, the fakes) with (1, that gradient),
        the saved vjp of the JAX package; then G phase 2. G1's graph holds
        nothing that D1 or D2 update (the content discriminator, which it
        does hold, is not updated here): autograd's version counters would
        say so at the backward."""
        with profiling.span("mt.g1.forward"):
            aux, img_fake, (z_ca, z_cb), g_logs = self._g1_forward(img, c_org, b, draws)
        with profiling.span("mt.d1.update"):
            self._update_d("discriminator1", img, img_fake.detach(), c_org, lr, logs, "d1",
                           draws)
        z_sr = draws.normal("z_sr", (b, self.latent_dim), required=True)
        with profiling.span("mt.d2.decode"), torch.no_grad():
            img_random = self._decode(torch.cat([z_cb, z_ca]), torch.cat([z_sr, z_sr]), c_org,
                                      draws, "d2.drop")
        with profiling.span("mt.d2.update"):
            self._update_d("discriminator2", img, img_random, c_org, lr, logs, "d2", draws)
        with profiling.span("mt.g.adv"):
            fake = img_fake.detach().requires_grad_(True)
            adv, cls = self._g_adv_loss(img, fake, c_org, "discriminator1")
            advcls = adv + cls
            (fake_cot,) = torch.autograd.grad(advcls, fake)
        with profiling.span("mt.g.update"):
            self._update(GEN_NETS, [aux, img_fake], lr, [torch.ones_like(aux), fake_cot])
        g_logs.update(g_adv=adv, g_cls=cls, total_g=aux + advcls)
        logs.update({k: v.detach() for k, v in g_logs.items()})
        with profiling.span("mt.g2.phase"):
            self._g2_phase(img, c_org, b, draws, lr, logs)

    def main_step(self, batch, draws: Optional[StepDraws] = None) -> dict:
        """D1, D2, G phase 1, G phase 2, by ``args.gan_step`` ("reference"
        or "fused"), under QAT where :meth:`calibrate_quant_train` installed
        a calibration; returns the logged losses (0-dim tensors on the
        device) and ``lr``."""
        img, c_org, b = self._batch(batch)
        draws = self._step_draws(draws, b)
        lr = self.schedule(self.state.step)
        logs = {}
        step = self._fused_step if self.args.gan_step == "fused" else self._reference_step
        if self.int8_train_installed:
            trace = qat.qat_trace(self._qat_scope)
        else:
            trace = fused_train_trace(self.args.fused_resblock or "off")
        with trace:
            step(img, c_org, b, draws, lr, logs)
        logs = pmesh.mean_logs(logs, self._data_group())
        logs["lr"] = lr
        self.state.step += 1
        return logs

    def content_step(self, batch, draws: Optional[StepDraws] = None) -> dict:
        """The content discriminator alone, at lr / 2.5 with its gradients
        clipped, on the content codes of the batch (no gradient into the
        encoder, composed resblocks)."""
        img, c_org, b = self._batch(batch)
        draws = self._step_draws(draws, b)
        lr = float(torch.tensor(self.schedule(self.state.step)) / 2.5)
        with torch.no_grad():
            z_c = self._content(img, draws, "c.noise")
        loss = L.bce_logits_loss(self.nets.content_discriminator(z_c), c_org)
        self._update(("content_discriminator",), loss, lr)
        self.state.step += 1
        return pmesh.mean_logs({"d_content_cls": loss.detach()}, self._data_group())

    def optimize_parameters(self, batch, global_iter: int, draws: Optional[StepDraws] = None):
        """One iteration: the content step where ``use_dis_content`` and
        ``global_iter % d_iter != 0``, else the main step. Returns its logs."""
        a = self.args
        attrs = profiling.ON and {"iter": global_iter}
        if a.use_dis_content and global_iter % a.d_iter != 0:
            with profiling.span("mt.train.content_step", attrs):
                self.loss = self.content_step(batch, draws)
        else:
            with profiling.span("mt.train.main_step", attrs):
                self.loss = self.main_step(batch, draws)
        return self.loss

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _timed(self, fn, *args):
        """``fn`` on ``args`` as tensors, under the span of one request."""
        start = time.perf_counter()
        with profiling.span("mt.serve.request", profiling.ON and {"images": len(args[0])}):
            with torch.inference_mode():
                out = fn(*(None if a is None else self._tensor(a) for a in args))
            if self.device.type == "cuda":
                with profiling.span("mt.serve.sync"):
                    torch.cuda.synchronize(self.device)
        return out, time.perf_counter() - start, self._device_memory_gb()

    def _device_memory_gb(self) -> float:
        if self.device.type != "cuda":
            return 0.0
        return torch.cuda.memory_reserved(self.device) / 1024**3

    def _forward_impl(self, img, c_org, eps, z_sr):
        """(img_fake, img_random, img_self), NCHW: from NCHW ``img`` = [a; b]
        (B = 2b images), the translations ba and ab, the random-style ones
        br and ar (style ``z_sr``, (b, latent)) and the self reconstructions
        aa and bb, in one 6b decode; ``eps`` (2b, latent) is the style
        encoder's VAE draw."""
        b = img.shape[0] // 2
        z_c = self.encode_content(img)
        z_s, _, _ = self.encode_style(img, c_org, eps)
        z_ca, z_cb, z_sa, z_sb = z_c[:b], z_c[b:], z_s[:b], z_s[b:]
        cls_a, cls_b = c_org[:b], c_org[b:]
        z_sr = z_sr.to(z_s.dtype)
        fakes = self.decode(torch.cat([z_cb, z_ca, z_cb, z_ca, z_cb, z_ca]),
                            torch.cat([z_sa, z_sa, z_sr, z_sb, z_sb, z_sr]),
                            torch.cat([cls_a, cls_a, cls_a, cls_b, cls_b, cls_b]))
        img_ba, img_aa, img_br, img_ab, img_bb, img_ar = fakes.chunk(6)
        return (torch.cat([img_ba, img_ab]), torch.cat([img_br, img_ar]),
                torch.cat([img_aa, img_bb]))

    def forward(self, img, c_org, generator=None, eps=None, z_sr=None):
        """:meth:`_forward_impl` on NHWC ``img`` (2b images) and one-hot
        ``c_org``, without gradients; NHWC out. The draws ``eps`` (2b,
        latent; only with ``reparam``) and ``z_sr`` (b, latent) are used as
        given, else drawn from ``generator`` (default: seed 0 on the model's
        device), eps first."""
        img, c_org = self._tensor(img), self._tensor(c_org)
        b = img.shape[0] // 2
        if generator is None and (z_sr is None or (self.reparam and eps is None)):
            generator = torch.Generator(device=self.device).manual_seed(0)
        if not self.reparam:
            eps = None
        elif eps is None:
            eps = self.get_z_random(2 * b, generator)
        if z_sr is None:
            z_sr = self.get_z_random(b, generator)
        eps = None if eps is None else self._tensor(eps)
        with torch.inference_mode():
            outs = self._forward_impl(_nchw(img), c_org, eps, self._tensor(z_sr))
        return tuple(_nhwc(o) for o in outs)

    def compute_visuals(self, batch, generator=None, eps=None, z_sr=None) -> torch.Tensor:
        """The 2x4 grid (2H, 4W, 3) of the first pair: per row, the real
        image, its translation, its random-style translation and its self
        reconstruction (a's row: real a, ab, ar, aa; b's: real b, ba, br,
        bb). Draws as :meth:`forward`'s."""
        img = torch.cat([self._tensor(batch["x1"]), self._tensor(batch["x2"])])
        c_org = torch.cat([self._tensor(batch["y1"]), self._tensor(batch["y2"])])
        b = len(batch["x1"])
        img_fake, img_random, img_self = self.forward(img, c_org, generator, eps, z_sr)
        row1 = torch.cat([img[0:1], img_fake[b:b + 1], img_random[b:b + 1], img_self[0:1]], dim=2)
        row2 = torch.cat([img[b:b + 1], img_fake[0:1], img_random[0:1], img_self[b:b + 1]], dim=2)
        return torch.cat([row1, row2], dim=1)[0]

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
