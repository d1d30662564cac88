"""Abstract model: the net registry, its device, its weights and, for
training, its optimizer state.

The port of ``masterthesis_tpu/models/model.py``: nets are ``nn.Module``s on
one device, built with the JAX package's init scheme from a seeded
``torch.Generator`` (:meth:`Model.initialize`) or loaded from converted JAX
params (:meth:`Model.load_params`, ``tools/convert_jax.py``). A training
model (``args.mode`` "train") also holds a :class:`TrainState` (the global
step and each net's Adam moments), the lr schedule, and a generator on its
device from which its training steps draw.

Checkpoints (``save``/``load``, ``checkpoint.py``): ``model_{it}.ckpt`` and
``opt_{it}.ckpt`` in ``args.checkpoint_dir`` (``model_{it}.orbax/`` and
``opt_{it}.orbax/`` directories under ``--ckpt_format orbax``, as the JAX
package names them), restored per net with the JAX package's messages;
``args.resume``/``resume_opt`` load at ``initialize``, and ``resume_opt``
with ``last_iter`` sets the step as the JAX package does. ``load`` also
takes a ``model_{it}`` that the JAX package wrote (a Flax msgpack file or
an orbax directory), net by net through
``tools/convert_jax.net_from_jax``, with the spectral ``u`` vectors of its
``extra`` tree, and a JAX ``opt_{it}``: each net's optax state, whose
``scale_by_adam`` moments are converted leaf by leaf as the params are
(:func:`adam_from_jax`).
Logging: ``get_current_lr``, ``save_images`` (``gen_{it}.jpg`` in
``args.display_dir``) and ``write_loss`` (a tensorboardX writer on
``args.logdir`` for training, or None where tensorboardX is missing).
"""
from __future__ import annotations

import os

import torch
from torch import nn

from masterthesis_tpu_torch import checkpoint as ckpt
from masterthesis_tpu_torch.arguments import AttributeDict
from masterthesis_tpu_torch.models.blocks import BatchNorm2d
from masterthesis_tpu_torch.models.functions import init_net, make_lr_schedule
from masterthesis_tpu_torch.models.state import AdamState, TrainState
from masterthesis_tpu_torch.utils import profiling


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one that is an error, not the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        device = "cuda"
    return torch.device(device)


class Model:
    """Base model: nets by name on ``self.device``."""

    def __init__(self, args, device=None):
        self.args = args
        # fail fast on a bad checkpoint path, before the nets are built
        for attr in ("resume", "resume_opt"):
            path = getattr(args, attr, None)
            if path is not None and not os.path.exists(path):
                raise FileNotFoundError(f"--{attr} checkpoint not found: {path}")
        self.device = resolve_device(device)
        self.nets: dict[str, nn.Module] = AttributeDict()
        self.state: TrainState | None = None
        self.generator: torch.Generator | None = None
        self.loss: dict = {}  # the last iteration's logs
        self.mesh = None  # the data-parallel mesh (set_mesh), or None: one device
        self.print_loss: list[str] = []  # the names print_losses reports
        self.schedule = make_lr_schedule(
            lr=args.lr or 1e-4, lr_policy=args.lr_policy or "step",
            n_iters=args.n_iters or 1_000_000, n_iter_decay=args.n_iter_decay or 600_000,
        )
        self.writer = None
        if self.is_train() and getattr(args, "logdir", None):
            try:
                from tensorboardX import SummaryWriter
            except ImportError:  # optional, as in the JAX package
                SummaryWriter = None
            if SummaryWriter is not None:
                self.writer = SummaryWriter(log_dir=args.logdir)

    def is_train(self) -> bool:
        return "train" in (self.args.mode or "train")

    def initialize(self, seed=None) -> None:
        """Seeded init of every net (``args.seed`` unless ``seed`` is given);
        for training also fresh optimizer state at step 0 and the step's
        generator, on the model's device, seeded likewise. Then the
        checkpoints of ``args.resume`` (and for training ``resume_opt``):
        with ``resume_opt`` and ``last_iter`` >= 0 the step is ``last_iter +
        1``, unless the optimizer file holds one."""
        with profiling.span("mt.setup.initialize"):
            a = self.args
            if seed is None:
                seed = getattr(a, "seed", None) or 0
            g = torch.Generator().manual_seed(int(seed))
            init_type = getattr(a, "init_type", "normal")
            init_gain = float(getattr(a, "init_gain", None) or 0.02)
            for net in self.nets.values():
                init_net(net, g, init_type, init_gain)
            if self.is_train():
                self.state = TrainState(0, {
                    name: AdamState.zeros(net.parameters()) for name, net in self.nets.items()
                })
                self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
                last_iter = int(getattr(a, "last_iter", -1) or -1)
                if getattr(a, "resume_opt", None) is not None and last_iter >= 0:
                    self.state.step = last_iter + 1
                self.load(getattr(a, "resume", None), getattr(a, "resume_opt", None))
            else:
                self.load(getattr(a, "resume", None))

    def set_mesh(self, mesh) -> None:
        """Train data parallel over ``mesh``'s "data" axis
        (``parallel.replicate`` calls it once the ranks hold the same
        weights): the steps average each net's gradients over the axis and
        log the global losses, and every batch norm takes the global
        batch's statistics. ``None`` goes back to one device."""
        self.mesh = mesh
        if not self.writes and self.writer is not None:
            self.writer.close()
            self.writer = None
        group = None if mesh is None else mesh.group("data")
        for net in self.nets.values():
            for m in net.modules():
                if isinstance(m, BatchNorm2d):
                    m.group = group

    @property
    def writes(self) -> bool:
        """Whether this process writes checkpoints, image grids and the loss
        log: on one device, or as rank 0 of its mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def save(self, it: int) -> None:
        """``model_{it}`` (every net's state_dict) and ``opt_{it}`` (every
        net's Adam state and the step) in ``args.checkpoint_dir``: ``.ckpt``
        files, or ``.orbax`` directories under ``--ckpt_format orbax``;
        data parallel, by rank 0 alone."""
        if not self.writes:
            return
        ckdir = self.args.checkpoint_dir
        ext = ".orbax" if getattr(self.args, "ckpt_format", None) == "orbax" else ".ckpt"
        ckpt.save_pytree({"params": {n: net.state_dict() for n, net in self.nets.items()}},
                         os.path.join(ckdir, f"model_{it}{ext}"))
        ckpt.save_pytree({"opt_state": {n: s.state_dict() for n, s in self.state.opt_state.items()},
                          "step": self.state.step},
                         os.path.join(ckdir, f"opt_{it}{ext}"))

    def load(self, checkpoint=None, opt_ckpt=None) -> None:
        """Restore the nets from ``checkpoint`` and the optimizer state and
        step from ``opt_ckpt`` (either may be None), per net: a net the file
        lacks keeps its weights, a net the model lacks is skipped, each
        with the JAX package's message. A ``checkpoint`` the JAX package
        wrote loads too (:meth:`_load_jax`), and so does its ``opt_ckpt``
        (:func:`adam_from_jax`), in either of its forms."""
        if checkpoint is not None:
            restored = ckpt.load_pytree(checkpoint, self.device)
            if ckpt.written_by_jax(checkpoint):
                self._load_jax(restored)
            else:
                ckpt.restore_matching(self.nets, restored.get("params", restored), "network")
        if opt_ckpt is not None:
            restored = ckpt.load_pytree(opt_ckpt, self.device)
            if ckpt.written_by_jax(opt_ckpt):
                restored = self._opt_from_jax(restored)
            ckpt.restore_matching(self.state.opt_state, restored.get("opt_state", {}), "optimizer")
            if "step" in restored:
                self.state.step = int(restored["step"])

    def _load_jax(self, restored: dict) -> None:
        """A JAX ``model_{it}.ckpt`` tree (``{"params": {net: tree}, "extra":
        {net: spectral collection}}``), net by net, with the messages of the
        JAX package's ``Model.load``: each net the model has is converted and
        loaded, each other is skipped; a net without a spectral collection
        in the file keeps its ``u`` buffers."""
        # imported here: tools.convert_jax imports the models package
        from masterthesis_tpu_torch.tools.convert_jax import net_from_jax

        params = restored.get("params", restored)
        extra = restored.get("extra") or {}
        for name, tree in params.items():
            if name not in self.nets:
                print(f"Checkpoint for {name} network is not found.")
                continue
            print(f"Loading checkpoint for : {name}")
            net, coll = self.nets[name], extra.get(name) or None
            # net_from_jax raises on any parameter it leaves unset; without a
            # spectral collection the state_dict lacks only the u buffers
            net.load_state_dict(net_from_jax(name, net, tree, coll), strict=coll is not None)
        for name, coll in extra.items():
            if name in self.nets and coll:
                print(f"Loading checkpoint for : {name}")

    def _opt_from_jax(self, restored: dict) -> dict:
        """A JAX ``opt_{it}.ckpt`` tree (``{"opt_state": {net: optax chain
        state}, "step": int}``) in the port's form: each net's Adam state
        converted (:func:`adam_from_jax`), a net the model lacks passed on
        as it is (``restore_matching`` then reports it)."""
        out = {name: adam_from_jax(self.nets[name], name, tree) if name in self.nets else tree
               for name, tree in restored.get("opt_state", {}).items()}
        return {"opt_state": out, **({"step": restored["step"]} if "step" in restored else {})}

    def optimizer_config(self, name: str) -> dict:
        """Adam's settings for net ``name``: the content discriminator's
        gradients are clipped to global norm 5, as in the JAX package."""
        a = self.args
        return dict(
            beta1=0.5 if a.beta1 is None else float(a.beta1),
            beta2=0.999 if a.beta2 is None else float(a.beta2),
            weight_decay=1e-4 if a.wd is None else float(a.wd),
            clip_norm=5.0 if name == "content_discriminator" else None,
        )

    def get_current_lr(self) -> dict[str, float]:
        """Each net's lr at the current step (the content discriminator's is
        divided by 2.5)."""
        base = float(self.schedule(self.state.step))
        return {n: base / 2.5 if n == "content_discriminator" else base for n in self.nets}

    def save_images(self, batch, it: int, generator=None) -> None:
        """``compute_visuals(batch, generator)`` as ``gen_{it}.jpg`` in
        ``args.display_dir``; data parallel, every rank computes it (a batch
        norm's statistics are a collective) and rank 0 writes it."""
        from masterthesis_tpu_torch.utils.images import save_image

        visuals = self.compute_visuals(batch, generator)
        if self.writes:
            save_image(visuals, os.path.join(self.args.display_dir, f"gen_{it}.jpg"))

    def write_loss(self, global_iter: int) -> None:
        if self.writer is None:
            return
        for name, value in self.loss.items():
            self.writer.add_scalar(name, float(value), global_iter)

    def print_losses(self) -> dict[str, float]:
        """The last iteration's losses named in ``print_loss``, as floats."""
        return {k: float(v) for k, v in self.loss.items() if k in self.print_loss}

    def load_params(self, state_dicts: dict) -> None:
        """Load one state_dict per net; every net and every key must be there."""
        if set(state_dicts) != set(self.nets):
            raise KeyError(f"state_dicts for {sorted(state_dicts)}, nets are {sorted(self.nets)}")
        with profiling.span("mt.setup.load_params"):
            for name, net in self.nets.items():
                net.load_state_dict(state_dicts[name], strict=True)


def find_adam(tree) -> dict:
    """The ``scale_by_adam`` state inside one net's serialized optax chain:
    the one node whose keys are ``count``, ``mu`` and ``nu``. Its place in
    the chain's tuple (serialized as ``{"0": ..., "1": ...}``) depends on
    the flags: ``clip_by_global_norm`` and ``add_decayed_weights`` come
    before it only when set."""
    found = []

    def walk(node):
        if not isinstance(node, dict):
            return
        if set(node) == {"count", "mu", "nu"}:
            found.append(node)
            return
        for v in node.values():
            walk(v)

    walk(tree)
    if len(found) != 1:
        raise KeyError(f"an optax state with {len(found)} scale_by_adam states, not one")
    return found[0]


def adam_from_jax(net: nn.Module, name: str, tree: dict) -> dict:
    """:meth:`AdamState.state_dict` of ``net`` from its JAX optax state:
    ``mu`` and ``nu`` through the converter of the param each belongs to
    (conv HWIO -> OIHW, the transposed conv's flip, the Dense transpose),
    listed in ``net.parameters()`` order, and ``count``."""
    # imported here: tools.convert_jax imports the models package
    from masterthesis_tpu_torch.tools.convert_jax import net_from_jax

    adam = find_adam(tree)
    moments = {k: net_from_jax(f"{name} Adam {k}", net, adam[k]) for k in ("mu", "nu")}
    keys = [k for k, _ in net.named_parameters()]
    return {"count": int(adam["count"]), **{k: [m[key] for key in keys] for k, m in moments.items()}}
