"""The training step of both packages on the same weights, draws and batch,
for tests/test_torch_train_step*.py.

The JAX reference step is assembled from the JAX model's own pieces with
``ks=None, train=False`` (no content noise, z = mu), as
tests/test_fused_step.py evaluates them: ``_make_d_fakes``, then per
discriminator ``jax.value_and_grad(_d_loss)`` and ``apply_updates``, then
``_g1_loss`` over the generator nets and ``_g2_loss`` over the content
encoder and the decoder, with the same ``z_sr``/``z_sr2``. With ``fused`` it
runs inside ``set_fused_resblock("interpret")`` and ``fused_train_trace()``,
restored in ``finally``. The weights are the port's seeded init (biases
redrawn small), carried into the JAX tree by the inverse of
``params_from_jax`` (which the round trip checks), so that no Flax init runs.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from masterthesis_tpu.arguments import default_train_args as jax_train_args
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel
from masterthesis_tpu.models.functions import apply_updates as jax_apply_updates
from masterthesis_tpu.ops.pallas import resblock_bf16 as jrb
from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.models import translation
from masterthesis_tpu_torch.models.blocks import ConvTranspose2d
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.tools.convert_jax import _leaf, params_from_jax

B, SIZE, K, LATENT = 2, 32, 3, 4
SHAPE = dict(crop_size=SIZE, dim=32, latent_dim=LATENT, num_domains=K, batch_size=B,
             use_dis_content=True, dis_content_layers=1, dis_content_final_kernel=2)
GEN_NETS = ("content_encoder", "style_encoder", "decoder")


def port_model(dtype: str, fused: str, seed: int = 0) -> AdaINModel:
    """The port's model at its seeded init, with every bias but a norm's
    redrawn small: the init's zero conv biases would get gradients of mere
    roundoff (they sit before a norm), whose Adam steps go either way."""
    model = AdaINModel(default_train_args(compute_dtype=dtype, fused_resblock=fused, seed=seed,
                                          **SHAPE), device="cpu")
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


def jax_tree(model) -> dict:
    """The JAX param tree of the port's weights: params_from_jax inverted."""
    tree = {}
    for net_name, net in model.nets.items():
        out = tree.setdefault(net_name, {})
        for mod_name, module in net.named_modules():
            for pname, p in module.named_parameters(recurse=False):
                path, _ = _leaf(module, mod_name.replace(".", "/"), pname)
                value = _from_port(module, pname, p.detach().float().numpy())
                node = out
                *parents, leaf = path.split("/")
                for k in parents:
                    node = node.setdefault(k, {})
                node[leaf] = np.array(value, dtype=np.float32, copy=True)
    return tree


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
    (net, its gradients by state_dict key, the whole model's JAX tree just
    before the step). A missing gradient is recorded as zeros."""
    names = {id(s): n for n, s in model.state.opt_state.items()}
    updates = []
    real = translation.apply_updates

    def record(params, grads, state, *a, **kw):
        net = names[id(state)]
        keys = [k for k, _ in model.nets[net].named_parameters()]
        updates.append((net, {k: (torch.zeros_like(p) if g is None else g.detach().float().clone())
                              for k, p, g in zip(keys, params, grads)}, jax_tree(model)))
        return real(params, grads, state, *a, **kw)

    translation.apply_updates = record
    try:
        yield updates
    finally:
        translation.apply_updates = real


def run_port(model, batch, z_sr, z_sr2):
    """One main step without noise. Returns (logs, grads by phase, trees):
    grads as [{net: {key: tensor}}] for D1, D2, G1 (three nets), G2 (two),
    and trees the model's JAX trees before each phase and after the step."""
    with recording(model) as updates:
        draws = StepDraws(z_sr=torch.from_numpy(z_sr), z_sr2=torch.from_numpy(z_sr2))
        logs = model.optimize_parameters(batch, 0, draws)
    phases, trees, i = [], [], 0
    for n in (1, 1, 3, 2):
        phases.append({net: g for net, g, _ in updates[i:i + n]})
        trees.append(updates[i][2])
        i += n
    assert i == len(updates), [u[0] for u in updates]
    return logs, phases, trees + [jax_tree(model)]


def run_jax(args_kw, trees, batch, z_sr, z_sr2, fused: bool):
    """The JAX reference main step, each phase at the port's parameters at
    the start of that phase (``trees`` from :func:`run_port`), so that a
    difference in one phase does not carry into the next through Adam, whose
    first steps are about lr x sign(gradient). The Adam state is the JAX
    package's own. Returns (logs, grads by phase, each phase's updated nets),
    grads and nets as [{net: tree}]."""
    jm = JaxAdaINModel(jax_train_args(logdir=None, mode="train", **args_kw))
    jm._make_tx()
    trees = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    opt = {n: jm.tx[n].init(trees[0][n]) for n in trees[0]}
    img = jnp.concatenate([batch["x1"], batch["x2"]])
    c_org = jnp.concatenate([batch["y1"], batch["y2"]])
    lr = jm.schedule(jnp.zeros((), jnp.int32))
    logs, phases, updated = {}, [], []

    def update(params, nets, g):
        new = {}
        for n in nets:
            new[n], opt[n] = jax_apply_updates(jm.tx[n], g[n], opt[n], params[n], lr)
        phases.append(dict(g))
        updated.append(new)

    if fused:
        jrb.set_fused_resblock("interpret")
    try:
        # each piece jitted inside the context: the routing is read at trace time
        with jrb.fused_train_trace() if fused else contextlib.nullcontext():
            fake, rand = jax.jit(lambda p: jm._make_d_fakes(
                p, {}, img, c_org, B, jnp.asarray(z_sr), None, train=False))(trees[0])
            for i, (d, f, prefix) in enumerate((("discriminator1", fake, "d1"),
                                                ("discriminator2", rand, "d2"))):
                (_, d_logs), g = jax.jit(jax.value_and_grad(
                    lambda dp, p, f, d=d: jm._d_loss(d, dp, p, {}, img, f, c_org),
                    has_aux=True))(trees[i][d], trees[i], f)
                logs.update({f"{prefix}_{k}": v for k, v in d_logs.items()})
                logs.update(d_logs)
                update(trees[i], (d,), {d: g})

            def g1(gp, params):
                return jm._g1_loss({**params, **gp}, {}, img, c_org, B, None, {}, train=False)

            def g2(gp, params):
                return jm._g2_loss({**params, **gp}, {}, img, c_org, B, jnp.asarray(z_sr2), None,
                                   {}, train=False)

            for params, loss, nets in ((trees[2], g1, GEN_NETS),
                                       (trees[3], g2, ("content_encoder", "decoder"))):
                (_, g_logs), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                    {n: params[n] for n in nets}, params)
                logs.update(g_logs)
                update(params, nets, g)
    finally:
        jrb.set_fused_resblock("auto")
    logs["lr"] = lr
    to_np = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)  # noqa: E731
    return to_np(logs), [to_np(p) for p in phases], [to_np(u) for u in updated]


def _norm(tensors) -> float:
    return sum(t.double().square().sum().item() for t in tensors) ** 0.5


def assert_step_matches(model, port, ref, loss_rtol: float, net_tol: float = 2e-2,
                        check_params: bool = True, ref32=None):
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
      way); and every entry that moved in JAX moved in the port.
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
                assert bool(((a != b0) | (w == b0)).all()), (i, net, key, "did not move")
                err = ((a - w).abs() * masks[(net, key)]).max().item()
                assert err <= 0.1 * lr, (i, net, key, err)
