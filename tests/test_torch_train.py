"""The port's training pieces against the JAX package's, on the CPU.

- Kernels 9 and 10 through their plain versions (the path a CPU tensor
  takes) against ``ref_resblock_aux`` and ``jax.vjp(ref_resblock)``, and
  against the Pallas kernels in interpret mode. f32: out, h1, h2, stats, dx,
  dgamma and dbeta within 1e-4 of each tensor's largest magnitude, dW1/dW2
  within 1e-4 relative. bf16: all within 2e-2 relative: one or two bf16
  roundings placed in another order. The plain backward also equals torch
  autograd of the plain forward at f32 (1e-5).
- The norms' gradients (moments and AdaIN Functions, autograd through the
  normalize) against ``jax.grad`` through ``masterthesis_tpu.ops.norms`` at
  f32 (1e-5), the losses (1e-6), the lr schedule and the optimizer (three
  Adam steps, with and without the clip, and a zero gradient, 1e-7).
- Routing: a main step runs 32 whole-block forwards (the D phase's 4b
  decode: 4 encoder + 4 decoder blocks; G phase 1: two encodes and two
  decodes; G phase 2: one of each) and 24 backwards (G1 and G2 only); the
  content step none. And the draws: given ones are used as they are, and two
  steps from one generator seed are equal.
- Flags: each training flag (the fused GAN step, the multi-scale
  discriminator, spectral norm, RaGAN, hinge, WGAN-GP, the perceptual loss,
  remat) builds its nets in both models and takes a main step that moves
  every net but the content discriminator (``--int8_train``, alone and data
  parallel: tests/test_torch_qat.py, tests/test_torch_qat_parallel.py).

The whole step against the JAX package's is in tests/test_torch_train_step*.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_train_args as jax_train_args  # noqa: E402
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel  # noqa: E402
from masterthesis_tpu.models import functions as JF  # noqa: E402
from masterthesis_tpu.models import losses as JL  # noqa: E402
from masterthesis_tpu.ops import norms as jnorms  # noqa: E402
from masterthesis_tpu.ops.pallas import resblock_bf16 as jrb  # noqa: E402
from masterthesis_tpu.ops.pallas.adain import fused_adain  # noqa: E402
from masterthesis_tpu_torch.arguments import default_train_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel, BaseModel  # noqa: E402
from masterthesis_tpu_torch.models import functions as F  # noqa: E402
from masterthesis_tpu_torch.models import losses as L  # noqa: E402
from masterthesis_tpu_torch.models.state import AdamState  # noqa: E402
from masterthesis_tpu_torch.models.translation import StepDraws  # noqa: E402
from masterthesis_tpu_torch.ops import norms  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from tests.torch_jax_init import initialized  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import params_from_jax  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(shape, seed, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + offset).astype(np.float32)


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous().to(dtype)


def _np(t, nhwc=False):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if nhwc else t).numpy()


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# --------------------------------------------------------- kernels 9 and 10 --


def _block_inputs(shape, style, seed):
    b, h, w, c = shape
    x = _rand(shape, seed)
    w1, w2 = _rand((3, 3, c, c), seed + 1, 0.05), _rand((3, 3, c, c), seed + 2, 0.05)
    gamma = _rand((b, c), seed + 3, 0.3) if style else np.zeros((b, c), np.float32)
    beta = _rand((b, c), seed + 4, 0.3) if style else np.zeros((b, c), np.float32)
    g = _rand(shape, seed + 5)
    return x, w1, w2, gamma, beta, g


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def _port_block(x, w1, w2, gamma, beta, g, dtype, padding, relu_mid):
    xt = _nchw(x, TDT[dtype])
    out, h1, h2, stats = krb.resblock_fwd(xt, _oihw(w1), _oihw(w2), torch.from_numpy(gamma),
                                          torch.from_numpy(beta), padding, relu_mid)
    dx, dw1, dw2, dgamma, dbeta = krb.resblock_bwd(
        xt, h1, h2, _nchw(g, TDT[dtype]), stats, _oihw(w1), _oihw(w2),
        torch.from_numpy(gamma), torch.from_numpy(beta), padding, relu_mid)
    to_hwio = lambda t: t.permute(2, 3, 1, 0).numpy()  # noqa: E731
    return dict(out=_np(out, True), h1=_np(h1), h2=_np(h2), stats=_np(stats), dx=_np(dx, True),
                dw1=to_hwio(dw1), dw2=to_hwio(dw2), dgamma=_np(dgamma), dbeta=_np(dbeta))


def _jax_block(fn, x, w1, w2, gamma, beta, g, dtype, padding, relu_mid, aux):
    args = (jnp.asarray(x, JDT[dtype]), jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(gamma),
            jnp.asarray(beta))
    out = {}
    if aux:
        for k, v in zip(("out", "h1", "h2", "stats"),
                        jrb.ref_resblock_aux(*args, padding_type=padding, relu_mid=relu_mid)):
            out[k] = np.asarray(v.astype(jnp.float32))
    y, vjp = jax.vjp(lambda *a: fn(*a, padding_type=padding, relu_mid=relu_mid), *args)
    out.setdefault("out", np.asarray(y.astype(jnp.float32)))
    for k, v in zip(("dx", "dw1", "dw2", "dgamma", "dbeta"), vjp(jnp.asarray(g, JDT[dtype]))):
        out[k] = np.asarray(v.astype(jnp.float32))
    return out


def _compare(got, want, dtype):
    for k, w in want.items():
        tol = 1e-4 if dtype == "float32" else 2e-2
        _close(got[k], w, tol, k)


BLOCK_CASES = [("reflect", True, True), ("reflect", True, False), ("reflect", False, True),
               ("zero", True, True), ("zero", False, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (2, 16, 16, 128)])
@pytest.mark.parametrize("padding,relu_mid,style", BLOCK_CASES)
def test_resblock_plain_matches_the_jax_reference(dtype, shape, padding, relu_mid, style):
    inputs = _block_inputs(shape, style, 10)
    got = _port_block(*inputs, dtype, padding, relu_mid)
    want = _jax_block(jrb.ref_resblock, *inputs, dtype, padding, relu_mid, aux=True)
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype,shape,padding,relu_mid,style", [
    ("float32", (2, 8, 8, 128), "reflect", True, True),
    ("float32", (2, 16, 16, 128), "zero", False, False),
    ("bfloat16", (2, 8, 8, 128), "reflect", True, False),
])
def test_resblock_plain_matches_the_pallas_kernels(dtype, shape, padding, relu_mid, style):
    inputs = _block_inputs(shape, style, 20)
    got = _port_block(*inputs, dtype, padding, relu_mid)
    want = _jax_block(lambda *a, **kw: jrb.fused_resblock(*a, **kw, interpret=True), *inputs,
                      dtype, padding, relu_mid, aux=False)
    _compare(got, want, dtype)


@pytest.mark.parametrize("padding,relu_mid", [("reflect", True), ("zero", False)])
def test_resblock_plain_backward_is_autograd_of_the_plain_forward(padding, relu_mid):
    x, w1, w2, gamma, beta, g = (torch.from_numpy(a) for a in _block_inputs((2, 8, 8, 128), True, 30))
    x, g = x.permute(0, 3, 1, 2).contiguous(), g.permute(0, 3, 1, 2).contiguous()
    w1, w2 = w1.permute(3, 2, 0, 1).contiguous(), w2.permute(3, 2, 0, 1).contiguous()
    leaves = [t.requires_grad_() for t in (x, w1, w2, gamma, beta)]
    out, h1, h2, stats = krb.resblock_fwd_plain(*leaves, padding, relu_mid)
    want = torch.autograd.grad((out * g).sum(), leaves)
    got = krb.resblock_bwd_plain(*(t.detach() for t in (x, h1, h2)), g, stats.detach(),
                                 w1.detach(), w2.detach(), gamma.detach(), beta.detach(),
                                 padding, relu_mid)
    for name, a, b in zip(("dx", "dw1", "dw2", "dgamma", "dbeta"), got, want):
        _close(a.numpy(), b.numpy(), 1e-5, name)


def test_resblock_eligibility_and_routing_modes():
    assert krb.resblock_train_eligible(torch.zeros(1, 256, 64, 64))
    assert not krb.resblock_train_eligible(torch.zeros(1, 268, 64, 64))
    assert not krb.resblock_train_eligible(torch.zeros(1, 128, 4, 4))
    x = torch.zeros(1, 128, 8, 8)
    assert not krb.fused_train_active(x)
    with krb.fused_train_trace("auto"):
        assert not krb.fused_train_active(x)  # auto: the card only
    with krb.fused_train_trace("on"):
        assert krb.fused_train_active(x)
    with pytest.raises(ValueError):
        with krb.fused_train_trace("interpret"):
            pass
    with pytest.raises(ValueError):
        krb.fused_resblock(x, torch.zeros(128, 128, 3, 3), torch.zeros(128, 128, 3, 3),
                           torch.zeros(1, 128), torch.zeros(1, 128), padding_type="replicate")


# ------------------------------------------------------------------- norms --


def _grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    return [g.numpy() for g in torch.autograd.grad(fn(*ts), ts)]


@pytest.mark.parametrize("kind", ["instance", "layer", "adain", "adain_vjp"])
def test_norm_gradients_match_jax(kind):
    x = _rand((2, 6, 5, 16), 40, 1.5, 0.3)  # NHWC
    g = _rand(x.shape, 41)
    if kind == "instance":
        params = ()
        jfn = lambda x: jnorms.instance_norm(x)  # noqa: E731
        tfn = lambda x: norms.instance_norm(x)  # noqa: E731
    elif kind == "layer":
        params = (_rand((16,), 42, 0.5, 1.0), _rand((16,), 43, 0.5))
        jfn = jnorms.layer_norm
        tfn = norms.layer_norm
    else:
        params = (_rand((2, 16), 44, 0.3), _rand((2, 16), 45, 0.3))
        jfn = fused_adain if kind == "adain_vjp" else jnorms.adain
        tfn = norms.adain
    gj = jnp.asarray(g)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) * gj), argnums=tuple(range(1 + len(params))))(
        jnp.asarray(x), *(jnp.asarray(p) for p in params))
    gt = _nchw(g)
    got = _grads(lambda xt, *p: (tfn(xt.permute(0, 3, 1, 2), *p) * gt).sum(), x, *params)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(b).max())), err_msg=str(i))


# ------------------------------------------------------------------ losses --


LOSSES = {
    "bce_logits": (JL.bce_logits_loss, L.bce_logits_loss, "xt"),
    "bce": (JL.bce_loss, L.bce_loss, "pt"),
    "mse": (JL.mse_loss, L.mse_loss, "xy"),
    "l1": (JL.l1_loss, L.l1_loss, "xy"),
    "l2_regularize": (JL.l2_regularize, L.l2_regularize, "x"),
    "kl_divergence": (JL.kl_divergence, L.kl_divergence, "xy"),
    "hinge_d": (JL.hinge_d_loss, L.hinge_d_loss, "xy"),
    "hinge_g": (JL.hinge_g_loss, L.hinge_g_loss, "x"),
    **{f"gan_{m}_{r}": (lambda p, m=m, r=r: JL.gan_loss(p, r, m),
                        lambda p, m=m, r=r: L.gan_loss(p, r, m),
                        "p" if m == "bce" else "x")
       for m in JL.GAN_MODES for r in (True, False)},
    **{f"ragan_{r}": (lambda a, b, r=r: JL.ragan_loss(a, b, r, "vanilla"),
                      lambda a, b, r=r: L.ragan_loss(a, b, r, "vanilla"), "xy")
       for r in (True, False)},
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    jfn, tfn, kinds = LOSSES[name]
    rng = np.random.default_rng(50)
    make = {"x": lambda: rng.standard_normal((3, 4, 5)).astype(np.float32),
            "y": lambda: rng.standard_normal((3, 4, 5)).astype(np.float32),
            "t": lambda: rng.integers(0, 2, (3, 4, 5)).astype(np.float32),
            "p": lambda: rng.uniform(0.01, 0.99, (3, 4, 5)).astype(np.float32)}
    arrays = [make[k]() for k in kinds]
    want = float(jfn(*(jnp.asarray(a) for a in arrays)))
    got = float(tfn(*(torch.from_numpy(a) for a in arrays)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


# --------------------------------------------------------------- optimizer --


@pytest.mark.parametrize("policy", ["step", "lambda", "constant"])
def test_lr_schedule_matches_jax(policy):
    kw = dict(lr=2e-4, lr_policy=policy, n_iters=100, n_iter_decay=30)
    jsched, tsched = JF.make_lr_schedule(**kw), F.make_lr_schedule(**kw)
    for step in (0, 1, 29, 30, 31, 61, 99, 100):
        assert tsched(step) == float(jsched(jnp.asarray(step, jnp.int32))), step


@pytest.mark.parametrize("clip", [None, 5.0])
def test_three_adam_steps_match_optax(clip):
    rng = np.random.default_rng(60)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2)}
    params = {k: (rng.standard_normal(s) * 0.3).astype(np.float32) for k, s in shapes.items()}
    tx = JF.make_optimizer(clip_norm=clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    keys = sorted(shapes)
    tparams = [torch.from_numpy(params[k].copy()) for k in keys]
    state = AdamState.zeros(tparams)
    sched = JF.make_lr_schedule(1e-3, "constant")
    for step in range(3):
        # "c" has a zero gradient: decay and the moments still move it
        grads = {k: (rng.standard_normal(s) * 4.0).astype(np.float32) if k != "c"
                 else np.zeros(s, np.float32) for k, s in shapes.items()}
        lr = sched(jnp.asarray(step))
        jparams, jstate = JF.apply_updates(tx, {k: jnp.asarray(v) for k, v in grads.items()},
                                           jstate, jparams, lr)
        F.apply_updates(tparams, [None if k == "c" else torch.from_numpy(grads[k]) for k in keys],
                        state, float(lr), clip_norm=clip)
        for k, t in zip(keys, tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]), rtol=0, atol=1e-7,
                                       err_msg=f"{k} step {step}")
    assert state.count == 3
    assert not np.array_equal(tparams[keys.index("c")].numpy(), params["c"])


# ------------------------------------------------------- routing and draws --

TINY = dict(crop_size=32, dim=32, latent_dim=4, num_domains=3, batch_size=2,
            use_dis_content=True, dis_content_layers=1, dis_content_final_kernel=2)


def _model(fused="on", seed=0, **kw):
    return AdaINModel(default_train_args(fused_resblock=fused, seed=seed, **{**TINY, **kw}),
                      device="cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    y = np.eye(3, dtype=np.float32)
    return dict(x1=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                x2=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                y1=y[[0, 2]], y2=y[[1, 0]])


def _calls():
    return (krb.resblock_fwd_plain.calls, krb.resblock_bwd_plain.calls,
            krb.resblock_fwd.launches, krb.resblock_bwd.launches)


@pytest.mark.parametrize("fused,want", [("on", (32, 24)), ("auto", (0, 0)), ("off", (0, 0))])
def test_main_and_content_step_routing(fused, want):
    """On the CPU, "on" routes through the plain versions and launches no
    kernel; "auto" (the card only) and "off" compose."""
    model = _model(fused)
    before = _calls()
    logs = model.optimize_parameters(_batch(), 0)
    after = _calls()
    assert (after[0] - before[0], after[1] - before[1]) == want
    assert after[2:] == before[2:]
    assert all(np.isfinite(float(v)) for v in logs.values())
    before = _calls()
    assert set(model.optimize_parameters(_batch(), 1)) == {"d_content_cls"}
    assert _calls() == before
    assert model.state.step == 2


def test_given_draws_are_used_as_they_are():
    model = _model()
    rng = np.random.default_rng(70)
    code = (4, 128, 8, 8)
    given = {n: torch.from_numpy(rng.standard_normal(code).astype(np.float32))
             for n in ("d.noise", "g1.noise", "g1.noise_rec", "g2.noise")}
    given.update({n: torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
                  for n in ("d.eps", "g1.eps", "g1.eps_rec", "g2.eps")})
    given.update(z_sr=torch.zeros(2, 4), z_sr2=torch.ones(2, 4))
    seen = {"noise": [], "eps": []}
    hooks = [
        model.nets.content_encoder.noise.register_forward_hook(
            lambda m, inp, out: seen["noise"].append(inp[1])),
        model.nets.style_encoder.register_forward_hook(
            lambda m, inp, out: seen["eps"].append(inp[2])),
    ]
    try:
        model.main_step(_batch(), StepDraws(**given))
    finally:
        for h in hooks:
            h.remove()
    assert [id(t) for t in seen["noise"]] == [
        id(given[n]) for n in ("d.noise", "g1.noise", "g1.noise_rec", "g2.noise")]
    assert [id(t) for t in seen["eps"]] == [
        id(given[n]) for n in ("d.eps", "g1.eps", "g1.eps_rec", "g2.eps")]


def test_two_steps_from_one_generator_seed_are_equal():
    out = []
    for _ in range(2):
        model = _model()
        logs = model.main_step(_batch(), StepDraws(torch.Generator().manual_seed(5)))
        out.append((logs, {n: net.state_dict() for n, net in model.nets.items()}))
    (la, pa), (lb, pb) = out
    assert {k: float(v) for k, v in la.items()} == {k: float(v) for k, v in lb.items()}
    for net in pa:
        for k in pa[net]:
            assert torch.equal(pa[net][k], pb[net][k]), (net, k)
    with pytest.raises(ValueError, match="z_sr"):
        _model().main_step(_batch(), StepDraws())


PORTED_FLAGS = {
    "gan_step_fused": dict(gan_step="fused"),
    "ms_dis": dict(ms_dis=True, dis_n_layers=3, num_scales=2),
    "dis_sn": dict(dis_sn=True),
    "use_ragan": dict(use_ragan=True),
    "hinge": dict(gan_mode="hinge"),
    "wgangp": dict(gan_mode="wgangp", lambda_gp=10.0),
    "vgg_loss": dict(vgg_loss="l1", vgg_layers=["conv2_1"]),
    "remat": dict(remat=True),
}


@pytest.mark.parametrize("model_cls", [AdaINModel, BaseModel])
@pytest.mark.parametrize("name", list(PORTED_FLAGS))
def test_ported_train_flags_take_a_main_step_and_move_every_net(name, model_cls):
    """Each training flag that once raised here builds its nets and takes a
    main step with the model's own draws: finite losses (the flag's own
    among them), and every net but the content discriminator moved."""
    flags = PORTED_FLAGS[name]
    model = model_cls(default_train_args(fused_resblock="on", seed=0, **{**TINY, **flags}),
                      device="cpu")
    before = {n: [p.detach().clone() for p in net.parameters()] for n, net in model.nets.items()}
    logs = model.optimize_parameters(_batch(), 0)
    assert all(np.isfinite(float(v)) for v in logs.values())
    own = {"wgangp": {"d_gp"}, "vgg_loss": {"g_p", "g_p2"}}.get(name, set())
    assert own <= set(logs)
    for n, net in model.nets.items():
        moved = all(not torch.equal(p, q) for p, q in zip(net.parameters(), before[n]))
        assert moved == (n != "content_discriminator"), (name, n)


def test_params_from_jax_raises_on_an_unconsumed_discriminator_leaf():
    model = _model()
    tree = S.jax_tree(model)
    tree["discriminator1"]["extra"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(KeyError, match="extra/kernel"):
        params_from_jax(tree, model)


def test_discriminators_load_from_a_flax_init_and_match_it():
    """``params_from_jax`` on the JAX package's own initialized training tree:
    every leaf of the three discriminators is consumed, and their forwards
    agree with Flax's at f32 (1e-4 of the largest logit)."""
    jm = JaxAdaINModel(jax_train_args(logdir=None, mode="train", compute_dtype="float32", **TINY))
    tree = jax.tree_util.tree_map(np.asarray, initialized(jm).params)
    model = _model(fused="off")
    model.load_params(params_from_jax(tree, model))
    rng = np.random.default_rng(80)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    code = rng.standard_normal((2, 8, 8, 128)).astype(np.float32)
    for name, x in (("discriminator1", img), ("discriminator2", img),
                    ("content_discriminator", code)):
        want = jm.nets[name].apply({"params": tree[name]}, jnp.asarray(x))
        with torch.no_grad():
            got = model.nets[name](_nchw(x))
        if name == "content_discriminator":
            got, want = (got,), (want,)
        else:  # (patch logits, class logits); the port's patch map is NCHW
            got = (got[0].permute(0, 2, 3, 1), got[1])
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape), name
            _close(g.numpy(), w, 1e-4, name)
