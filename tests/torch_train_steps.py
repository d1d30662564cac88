"""The training step of both packages on the same weights, draws and batch,
for tests/test_torch_train_step*.py (AdaINModel) and
tests/test_torch_base_train_*.py (BaseModel): a model class and its flags
select the model in both packages.

The JAX reference step is assembled from the JAX model's own pieces with
``ks=None, train=False`` (no content noise, z = mu), as
tests/test_fused_step.py evaluates them: ``_make_d_fakes``, then per
discriminator ``jax.value_and_grad(_d_loss)`` and ``apply_updates``, then
``_g1_loss`` over the generator nets and ``_g2_loss`` over the content
encoder and the decoder, with the same ``z_sr``/``z_sr2``. Its fused GAN
step (``gan_step="fused"``, ``_main_step_fused_body``) so too: G1's fakes and
content codes from ``_g1_forward`` at the step's first params, D1 on the
fakes, D2 on a random-style decode of the codes, then ``_g1_forward``'s vjp
at (1, the gradient of ``_g_adv_loss`` against the updated D1 at the
fakes), then G2. Under ``--dis_sn`` the D updates store the ``u`` that
``_d_loss(update_u=True)`` returns; WGAN-GP's penalty runs where a D's key
is given (``gp_keys``). With ``fused`` it runs inside
:func:`interpreted_kernels` (``set_fused_resblock("interpret")``, each kernel
call through its jitted kernel, so that a piece lowers each shape's
interpret-mode body once) and ``fused_train_trace()``. The weights are the
port's seeded init (biases redrawn small), carried into the JAX tree by the
inverse of ``params_from_jax`` (which the round trip checks), so that no
Flax init runs.
:func:`jax_kernel_calls` counts the JAX package's kernel 9/10 calls while it
traces, one per launch of the step it traces; :func:`jax_step_calls` counts
them over a trace of the fused step alone, which runs nothing, and
:func:`jax_body_calls` over a trace of the JAX package's whole main step
body, reference or fused.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from masterthesis_tpu.arguments import default_train_args as jax_train_args
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel
from masterthesis_tpu.models import BaseModel as JaxBaseModel
from masterthesis_tpu.models import losses as JL
from masterthesis_tpu.models.functions import apply_updates as jax_apply_updates
from masterthesis_tpu.models.state import TrainState
from masterthesis_tpu.ops.pallas import resblock_bf16 as jrb
from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import AdaINModel, BaseModel
from masterthesis_tpu_torch.models import translation
from masterthesis_tpu_torch.models.blocks import ConvTranspose2d
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb
from masterthesis_tpu_torch.ops.spectral import SpectralNorm
from masterthesis_tpu_torch.tools.convert_jax import _leaf, params_from_jax

B, SIZE, K, LATENT = 2, 32, 3, 4
SHAPE = dict(crop_size=SIZE, dim=32, latent_dim=LATENT, num_domains=K, batch_size=B,
             use_dis_content=True, dis_content_layers=1, dis_content_final_kernel=2)
GEN_NETS = ("content_encoder", "style_encoder", "decoder")
JAX_MODELS = {AdaINModel: JaxAdaINModel, BaseModel: JaxBaseModel}


def port_model(dtype: str, fused: str, seed: int = 0, model_cls=AdaINModel, shape=SHAPE,
               **flags):
    """The port's model (``model_cls`` with ``flags``, at ``shape``) at its
    seeded init, with every bias but a norm's redrawn small: the init's zero
    conv biases would get gradients of mere roundoff (they sit before a
    norm), whose Adam steps go either way."""
    model = model_cls(default_train_args(compute_dtype=dtype, fused_resblock=fused, seed=seed,
                                         **{**shape, **flags}), device="cpu")
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for net in model.nets.values():
            for name, p in net.named_parameters():
                if name.endswith(".bias") and not name.endswith("norm.bias"):
                    p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model


def _from_port(module, pname, value: np.ndarray) -> np.ndarray:
    if pname != "weight":
        return value
    if value.ndim == 2:
        return value.T
    if isinstance(module, ConvTranspose2d):
        return np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]
    return np.transpose(value, (2, 3, 1, 0))


def jax_tree_of(model, net_name: str, values: dict) -> dict:
    """One net's JAX tree of port tensors by state_dict key (params or
    gradients): params_from_jax inverted."""
    out = {}
    for mod_name, module in model.nets[net_name].named_modules():
        for pname, _ in module.named_parameters(recurse=False):
            key = f"{mod_name}.{pname}" if mod_name else pname
            path, _ = _leaf(module, mod_name.replace(".", "/"), pname)
            value = _from_port(module, pname, values[key].detach().float().numpy())
            node = out
            *parents, leaf = path.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = np.array(value, dtype=np.float32, copy=True)
    return out


def jax_tree(model) -> dict:
    """The JAX param tree of the port's weights: params_from_jax inverted."""
    return {n: jax_tree_of(model, n, dict(net.named_parameters()))
            for n, net in model.nets.items()}


def jax_extra(model) -> dict:
    """The JAX state's ``extra`` tree of the port's spectral ``u`` buffers
    ({} for a net without spectral norm)."""
    extra = {}
    for net_name, net in model.nets.items():
        out = extra.setdefault(net_name, {})
        for mod_name, module in net.named_modules():
            if isinstance(module, SpectralNorm):
                node = out
                for k in mod_name.split("."):
                    node = node.setdefault(k, {})
                node["u"] = module.u.detach().float().numpy().copy()
    return extra


def to_port(model, net: str, tree: dict, like: dict) -> dict:
    """A JAX-shaped tree of one net (params or grads) in the port's
    state_dict layout."""
    return params_from_jax({**like, net: tree}, model)[net]


def batch_and_draws(seed: int = 0):
    rng = np.random.default_rng(seed)
    batch = dict(
        x1=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        x2=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        y1=np.eye(K, dtype=np.float32)[[0, 2]],
        y2=np.eye(K, dtype=np.float32)[[1, 0]],
    )
    z_sr = rng.standard_normal((B, LATENT)).astype(np.float32)
    z_sr2 = rng.standard_normal((B, LATENT)).astype(np.float32)
    return batch, z_sr, z_sr2


@contextlib.contextmanager
def recording(model):
    """Record every optimizer step of the port inside the block: a list of
    (net, its gradients by state_dict key, the whole model's JAX tree and
    extra tree just before the step). A missing gradient is recorded as
    zeros."""
    names = {id(s): n for n, s in model.state.opt_state.items()}
    updates = []
    real = translation.apply_updates

    def record(params, grads, state, *a, **kw):
        net = names[id(state)]
        keys = [k for k, _ in model.nets[net].named_parameters()]
        updates.append((net, {k: (torch.zeros_like(p) if g is None else g.detach().float().clone())
                              for k, p, g in zip(keys, params, grads)}, jax_tree(model),
                        jax_extra(model)))
        return real(params, grads, state, *a, **kw)

    translation.apply_updates = record
    try:
        yield updates
    finally:
        translation.apply_updates = real


def run_port(model, batch, z_sr, z_sr2, extras=None, **given):
    """One main step without noise (``given``: further draws by name).
    Returns (logs, grads by phase, trees): grads as [{net: {key: tensor}}]
    for D1, D2, G1 (three nets), G2 (two), and trees the model's JAX trees
    before each phase and after the step; ``extras``, a list, gets the extra
    trees at the same points."""
    with recording(model) as updates:
        draws = StepDraws(z_sr=torch.from_numpy(z_sr), z_sr2=torch.from_numpy(z_sr2),
                          **{k: torch.as_tensor(v) for k, v in given.items()})
        logs = model.optimize_parameters(batch, 0, draws)
    phases, trees, i = [], [], 0
    for n in (1, 1, 3, 2):
        phases.append({net: g for net, g, *_ in updates[i:i + n]})
        trees.append(updates[i][2])
        if extras is not None:
            extras.append(updates[i][3])
        i += n
    assert i == len(updates), [u[0] for u in updates]
    if extras is not None:
        extras.append(jax_extra(model))
    return logs, phases, trees + [jax_tree(model)]


# the JAX package's kernels 9 and 10 as it defines them, and each under
# jax.jit (their Python-valued arguments static): a jitted piece that calls
# one kernel at one shape many times then lowers its interpret-mode body
# once, where each call site would lower it anew
_KERNELS = {"fwd": jrb.pallas_resblock_fwd, "bwd": jrb.pallas_resblock_bwd}
_JITTED = {
    "fwd": jax.jit(_KERNELS["fwd"], static_argnums=(4, 5, 6), static_argnames="interpret"),
    "bwd": jax.jit(_KERNELS["bwd"], static_argnums=(9, 10, 11), static_argnames="interpret"),
}
_COUNTERS: list = []  # the counts of the active jax_kernel_calls blocks


def _routed(kind):
    def call(*args, **kwargs):
        for calls in _COUNTERS:
            calls[kind] += 1
        return _JITTED[kind](*args, **kwargs)
    return call


@contextlib.contextmanager
def interpreted_kernels():
    """The JAX package's kernels 9 and 10 in interpret mode inside the block
    (``set_fused_resblock("interpret")``, back to "auto" after), each call
    through its jitted kernel and counted by :func:`jax_kernel_calls`."""
    saved = {k: getattr(jrb, f"pallas_resblock_{k}") for k in _KERNELS}
    jrb.set_fused_resblock("interpret")
    for k in _KERNELS:
        setattr(jrb, f"pallas_resblock_{k}", _routed(k))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(jrb, f"pallas_resblock_{k}", fn)
        jrb.set_fused_resblock("auto")


@contextlib.contextmanager
def jax_kernel_calls():
    """Count the JAX package's kernel 9 and 10 calls (``pallas_resblock_fwd``,
    ``pallas_resblock_bwd``) that code inside :func:`interpreted_kernels`
    makes inside the block: yields the counts, {"fwd": n, "bwd": n}. Counted
    while jitted code traces, so each piece that the block traces once
    counts its launches once."""
    calls = {"fwd": 0, "bwd": 0}
    _COUNTERS.append(calls)
    try:
        yield calls
    finally:
        _COUNTERS.remove(calls)


def jax_model(args_kw, model_cls=AdaINModel):
    """The JAX package's counterpart of the port's ``model_cls``, for training."""
    jm = JAX_MODELS[model_cls](jax_train_args(logdir=None, mode="train", **args_kw))
    jm._make_tx()
    return jm


def _jax_pieces(jm, batch, z_sr, z_sr2, aux=None):
    """The JAX step's pieces on one batch: (img, c_org, the D fakes of the
    params, G1's loss and G2's loss of (the updated nets' params, all
    params, the extra tree)); ``aux`` the perceptual params."""
    img = jnp.concatenate([batch["x1"], batch["x2"]])
    c_org = jnp.concatenate([batch["y1"], batch["y2"]])
    aux = aux or {}
    b = len(batch["x1"])

    def d_fakes(p):
        return jm._make_d_fakes(p, {}, img, c_org, b, jnp.asarray(z_sr), None, train=False)

    def g1(gp, params, extra=None):
        return jm._g1_loss({**params, **gp}, extra or {}, img, c_org, b, None, aux, train=False)

    def g2(gp, params, extra=None):
        return jm._g2_loss({**params, **gp}, extra or {}, img, c_org, b, jnp.asarray(z_sr2),
                           None, aux, train=False)

    return img, c_org, d_fakes, g1, g2


def jax_step_calls(args_kw, tree, batch, z_sr, z_sr2, model_cls=AdaINModel) -> tuple[int, int]:
    """The kernel 9 / 10 calls of the JAX package's fused main step, counted
    by tracing its pieces (``jax.make_jaxpr``: nothing runs) at ``tree``."""
    jm = jax_model(args_kw, model_cls)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    _, _, d_fakes, g1, g2 = _jax_pieces(jm, batch, z_sr, z_sr2)
    with interpreted_kernels(), jax_kernel_calls() as calls, jrb.fused_train_trace():
        jax.make_jaxpr(d_fakes)(params)
        for loss, nets in ((g1, GEN_NETS), (g2, ("content_encoder", "decoder"))):
            jax.make_jaxpr(jax.value_and_grad(loss, has_aux=True))(
                {n: params[n] for n in nets}, params)
    return calls["fwd"], calls["bwd"]


_UPDATES: dict = {}


def _jitted_update(jm, net: str):
    """The JAX package's ``apply_updates`` for ``net``'s optimizer under
    ``jax.jit``, as its training step runs it inside its jitted step: one
    compile per optimizer configuration and shapes, where eagerly each of its
    few hundred elementwise ops compiles on its own."""
    a = jm.args
    key = (a.beta1, a.beta2, a.wd, net == "content_discriminator")
    if key not in _UPDATES:
        _UPDATES[key] = jax.jit(functools.partial(jax_apply_updates, jm.tx[net]))
    return _UPDATES[key]


def run_jax(args_kw, trees, batch, z_sr, z_sr2, fused: bool, model_cls=AdaINModel,
            gan_step: str = "reference", extras=None, gp_keys=None, aux=None,
            spectral_out=None, opt=None):
    """The JAX main step (``gan_step`` "reference" or "fused"), each phase at
    the port's parameters at the start of that phase (``trees`` from
    :func:`run_port`, and ``extras``, its extra trees, under ``--dis_sn``), so
    that a difference in one phase does not carry into the next through
    Adam, whose first steps are about lr x sign(gradient). The Adam state is
    the JAX package's own. ``gp_keys``: {"d1" | "d2": key} for WGAN-GP's
    penalty; ``aux``: the perceptual params; ``spectral_out``, a dict, gets
    each D's stored ``u`` tree; ``opt``: the optax states to start from (a
    resumed run's), else fresh ones. Returns (logs, grads by phase, each phase's
    updated nets), grads and nets as [{net: tree}]. The optimizer steps run
    jitted (:func:`_jitted_update`), as inside the JAX package's step."""
    jm = jax_model(args_kw, model_cls)
    trees = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    extras = [jax.tree_util.tree_map(jnp.asarray, e) for e in (extras or [{}] * len(trees))]
    opt = dict(opt) if opt is not None else {n: jm.tx[n].init(trees[0][n]) for n in trees[0]}
    img, c_org, d_fakes, g1, g2 = _jax_pieces(jm, batch, z_sr, z_sr2, aux)
    b = len(batch["x1"])
    aux = aux or {}
    sn = bool(jm.args.dis_sn)
    gp_keys = gp_keys or {}
    lr = jm.schedule(jnp.zeros((), jnp.int32))
    logs, phases, updated = {}, [], []

    def update(params, nets, g):
        new = {}
        for n in nets:
            new[n], opt[n] = _jitted_update(jm, n)(g[n], opt[n], params[n], lr)
        phases.append(dict(g))
        updated.append(new)

    def update_d(i, d, f, prefix):
        (_, d_logs), g = jax.jit(jax.value_and_grad(
            lambda dp, p, ex, f, k: jm._d_loss(d, dp, p, ex, img, f, c_org, k, update_u=sn),
            has_aux=True))(trees[i][d], trees[i], extras[i], f, gp_keys.get(prefix))
        if sn and spectral_out is not None:
            spectral_out[d] = d_logs["_spectral"]
        d_logs.pop("_spectral", None)
        logs.update({f"{prefix}_{k}": v for k, v in d_logs.items()})
        logs.update(d_logs)
        update(trees[i], (d,), {d: g})

    def g1_fused(gp, p, ex):
        """G1 of the fused step: _g1_forward's vjp at (1, the gradient of D1's
        terms at the fakes); D1 in ``p`` is the updated one."""
        (aux_total, fake, z_pack, g_logs), vjp = jax.vjp(
            lambda gp_: jm._g1_forward({**p, **gp_}, ex, img, c_org, b, None, aux, train=False),
            gp)

        def adv1(f):
            adv, cls = jm._g_adv_loss(p, ex, img, f, c_org, "discriminator1")
            return adv + cls, (adv, cls)

        (advcls, (adv, cls)), cot = jax.value_and_grad(adv1, has_aux=True)(fake)
        (g,) = vjp((jnp.ones_like(aux_total), cot, jax.tree.map(jnp.zeros_like, z_pack),
                    jax.tree.map(jnp.zeros_like, g_logs)))
        return (aux_total + advcls, dict(g_logs, g_adv=adv, g_cls=cls,
                                         total_g=aux_total + advcls)), g

    # each piece jitted inside the context: the routing is read at trace time
    with interpreted_kernels() if fused else contextlib.nullcontext(), \
            jrb.fused_train_trace() if fused else contextlib.nullcontext():
        if gan_step == "fused":
            fake, (z_ca, z_cb) = jax.jit(lambda p: jax.tree.map(
                jax.lax.stop_gradient,
                jm._g1_forward(p, {}, img, c_org, b, None, aux, train=False)[1:3]))(trees[0])
            update_d(0, "discriminator1", fake, "d1")
            rand = jax.jit(lambda p: jm.decode(
                p, jnp.concatenate([z_cb, z_ca]), jnp.concatenate([z_sr, z_sr]), c_org,
                train=False))(trees[1])
            update_d(1, "discriminator2", rand, "d2")
            g1_grad = jax.jit(g1_fused)
        else:
            fake, rand = jax.jit(d_fakes)(trees[0])
            update_d(0, "discriminator1", fake, "d1")
            update_d(1, "discriminator2", rand, "d2")
            g1_grad = jax.jit(jax.value_and_grad(g1, has_aux=True))
        g2_grad = jax.jit(jax.value_and_grad(g2, has_aux=True))
        for i, grad, nets in ((2, g1_grad, GEN_NETS), (3, g2_grad, ("content_encoder", "decoder"))):
            (_, g_logs), g = grad({n: trees[i][n] for n in nets}, trees[i], extras[i])
            logs.update(g_logs)
            update(trees[i], nets, g)
    logs["lr"] = lr
    to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return to_np(logs), [to_np(p) for p in phases], [to_np(u) for u in updated]


def jax_body_calls(args_kw, model, batch, gan_step: str, model_cls=AdaINModel) -> tuple[int, int]:
    """The kernel 9 / 10 calls of the JAX package's whole main-step body
    (``_main_step_body`` or ``_main_step_fused_body``) at the port model's
    weights, counted over one trace (``jax.make_jaxpr``: nothing runs)."""
    jm = jax_model(args_kw, model_cls)
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree(model))
    state = TrainState.create(params, {n: jm.tx[n].init(params[n]) for n in params},
                              jax.tree_util.tree_map(jnp.asarray, jax_extra(model)))
    body = jm._main_step_fused_body if gan_step == "fused" else jm._main_step_body
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with interpreted_kernels(), jax_kernel_calls() as calls, jrb.fused_train_trace():
        jax.make_jaxpr(body)(state, jbatch, jax.random.PRNGKey(0), {})
    return calls["fwd"], calls["bwd"]


def _norm(tensors) -> float:
    return sum(t.double().square().sum().item() for t in tensors) ** 0.5


def assert_step_matches(model, port, ref, loss_rtol: float, net_tol: float = 2e-2,
                        check_params: bool = True, ref32=None, min_move: float = 0.0):
    """Hold one main step of the port to the JAX package's, phase by phase
    from the same params.

    - Every logged loss within ``loss_rtol``.
    - The D phases' gradients (well conditioned: the fakes come without
      gradient) per tensor within 1e-3 of its largest |JAX gradient|.
    - The G phases' gradients per net within ``net_tol`` in norm, and per
      tensor within 10 % of its norm plus 1e-3 of the net's. The G phase-1
      gradient of this model is ill-conditioned in f32: the cycle
      reconstruction's L1 runs back through two decodes and two encodes, and
      f32 gradients of either package part from an f64 evaluation of the same
      step by up to 2 % per tensor (its largest entry), measured on these
      draws; the two packages part by up to 1.2e-2 per net in norm.
    - With ``ref32`` (the JAX step at f32 from the same params), the
      gradients are bf16's: then per net the port's distance from the f32
      gradient is at most 1.25 x the JAX package's plus 2 % of the gradient's
      norm (bf16 G gradients of either package part from f32 by about half
      their norm here: the instance norms' backward cancels in bf16).
    - Each phase's updated params within 0.1 lr of the JAX update from the
      same params, wherever the decayed gradients (g + wd p) of every phase
      that moved the entry are not negligible and agree within 10 %
      (elsewhere Adam's first steps, about lr x sign(g + wd p), may go either
      way); and every entry that JAX moved by more than ``min_move`` x lr
      moved in the port. BaseModel's steps take ``min_move`` 0.1, the
      params' own tolerance: there G2's content-encoder and decoder steps
      are Adam's second (after G1's), whose moment m = (g1 + wd p) / 4 +
      (g2 + wd p) / 2 can cancel to within the G1 gradients' f32 noise, and
      a JAX step under 0.1 lr is within that tolerance of no step. On the
      step tests' own weights and batches (``port_model`` and
      ``batch_and_draws`` seed 0, config A fused; seed 1, A composed; none
      in B fused) 5 and 3 entries of G2's nets stayed put in the port where
      JAX moved them by 6e-5 to 7.6e-3 lr: there the port's m is 5e-12 to
      5e-10 against JAX's 1e-10 to 4e-7 (G1's gradient entries part by 0.01 to
      1.4 %), v agrees within 3 %, and the port's step, under half an ulp of
      the param, rounds away. A cancelled moment, not a skipped update.
    """
    logs, phases, trees = port
    jlogs, jphases, jupdated = ref
    assert set(logs) == set(jlogs), set(logs) ^ set(jlogs)
    for k, v in jlogs.items():
        got = float(logs[k])
        assert abs(got - float(v)) <= loss_rtol * max(abs(float(v)), 1e-6), (k, got, float(v))
    like = trees[0]
    assert [set(p) for p in phases] == [set(p) for p in jphases]
    masks = {}
    for i, (p, jp) in enumerate(zip(phases, jphases)):
        for net, g in jp.items():
            want = to_port(model, net, g, like)
            got = p[net]
            if ref32 is not None:
                w32 = to_port(model, net, ref32[1][i][net], like)
                ours = _norm(got[k] - w32[k] for k in w32)
                theirs = _norm(want[k] - w32[k] for k in w32)
                assert ours <= 1.25 * theirs + 0.02 * _norm(w32.values()), (i, net, ours, theirs)
                continue
            net_norm = _norm(want.values())
            if i < 2:
                # a conv bias right before a norm has no gradient in exact
                # arithmetic, only roundoff: held to 1e-4 of the net's largest
                floor = 1e-4 * max(w.abs().max().item() for w in want.values())
                for key, w in want.items():
                    err = (got[key] - w).abs().max().item()
                    assert err <= 1e-3 * max(w.abs().max().item(), floor), (i, net, key, err)
            else:
                err = _norm(got[k] - want[k] for k in want)
                assert err <= net_tol * net_norm, (i, net, err / net_norm)
                for key, w in want.items():
                    err = _norm([got[key] - w])
                    assert err <= 0.1 * _norm([w]) + 1e-3 * net_norm, (i, net, key, err)
            # Adam's direction is that of the decayed gradient g + wd p
            wd = model.optimizer_config(net)["weight_decay"]
            params = to_port(model, net, trees[i][net], like)
            for key, w in want.items():
                u, v = w + wd * params[key], got[key] + wd * params[key]
                m = (u.abs() > 1e-4 * u.abs().max()) & ((v - u).abs() <= 0.1 * u.abs())
                masks[(net, key)] = masks.get((net, key), m) & m
    if not check_params:
        return
    lr = float(jlogs["lr"])
    for i, new in enumerate(jupdated):
        for net, tree in new.items():
            want = to_port(model, net, tree, like)
            before = to_port(model, net, trees[i][net], like)
            after = to_port(model, net, trees[i + 1][net], like)
            for key, w in want.items():
                a, b0 = after[key], before[key]
                moved = (w - b0).abs() > min_move * lr
                assert bool(((a != b0) | ~moved).all()), (i, net, key, "did not move")
                err = ((a - w).abs() * masks[(net, key)]).max().item()
                assert err <= 0.1 * lr, (i, net, key, err)


def assert_content_step_matches(model, batch, args_kw, model_cls=AdaINModel) -> dict:
    """The iteration after the main step (global_iter 1, d_iter 3) updates
    the content discriminator alone, at lr / 2.5 with its gradients clipped
    to global norm 5, on composed resblocks; held to the JAX step from the
    same params: the loss within 1e-4, each gradient within 1e-3 of its
    largest entry, the updated params within 0.1 lr where the clipped,
    decayed gradients agree. Returns the port's logs."""
    d = "content_discriminator"
    f0 = krb.resblock_fwd_plain.calls
    step = model.state.step
    with recording(model) as updates:
        logs = model.optimize_parameters(batch, 1, StepDraws())
    assert krb.resblock_fwd_plain.calls == f0 and set(logs) == {"d_content_cls"}
    assert model.state.step == step + 1
    [(net, grads, tree, _)] = updates

    jm = jax_model(args_kw, model_cls)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    img = jnp.concatenate([batch["x1"], batch["x2"]])
    c_org = jnp.concatenate([batch["y1"], batch["y2"]])
    z_c = jax.jit(lambda p: jm.encode_content(p, {}, img, None, train=False))(params)

    def loss_fn(p):
        return JL.bce_logits_loss(jm.nets[d].apply({"params": p}, z_c), c_org)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(params[d])
    opt = jm.tx[d].init(params[d])
    lr = jm.schedule(jnp.full((), step, jnp.int32)) / 2.5
    new, _ = jax.jit(lambda g, o, p: jax_apply_updates(jm.tx[d], g, o, p, lr))(g, opt, params[d])
    assert net == d
    assert abs(float(logs["d_content_cls"]) - float(loss)) <= 1e-4 * abs(float(loss))
    want = to_port(model, d, jax.tree_util.tree_map(np.asarray, new), tree)
    jgrads = to_port(model, d, jax.tree_util.tree_map(np.asarray, g), tree)
    before = to_port(model, d, tree[d], tree)
    # Adam's direction is that of the clipped, decayed gradient
    clip = [min(1.0, 5.0 / _norm(g.values())) for g in (grads, jgrads)]
    # a conv bias right before its instance norm has a roundoff-only gradient
    floor = 1e-4 * max(g.abs().max().item() for g in jgrads.values())
    for k, w in want.items():
        jg = jgrads[k]
        assert (grads[k] - jg).abs().max().item() <= 1e-3 * max(jg.abs().max().item(), floor), k
        got = model.nets[d].state_dict()[k]
        assert bool((got != before[k]).all()), k
        u, v = (c * g[k] + 1e-4 * before[k] for c, g in zip(clip[::-1], (jgrads, grads)))
        m = (u.abs() > 1e-4 * u.abs().max()) & ((v - u).abs() <= 0.1 * u.abs())
        assert ((got - w).abs() * m).max().item() <= 0.1 * float(lr), k
    return logs
