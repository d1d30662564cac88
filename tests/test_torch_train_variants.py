"""The training loss variants and discriminators of the port against the JAX
package's, on the CPU: ``--gan_mode hinge``, ``--use_ragan``, WGAN-GP
(``--gan_mode wgangp --lambda_gp``), ``--dis_sn`` and ``--ms_dis``.

Crop 32, dim 8, latent 4, 3 domains, batch 2 per side (the multi-scale
discriminator at 3 layers and 2 scales, its trunk at its own width 64; an
instance-normed discriminator at 3 layers, where a sixth would normalize a
1x1 map to 0), f32
unless stated; the same weights in both packages (the port's seeded init
carried into JAX trees by ``torch_train_steps``, or a Flax init carried
into the port by ``params_from_jax``).

- Per variant, D's loss (``_d_loss``), G1's adversarial terms
  (``_g_adv_loss`` against D1) and G2's (D2, or the JAX package's quirks:
  RaGAN takes D1's logits of the fakes and D2's of the real images, the
  multi-scale discriminator D1's), and their gradients in D's and in the
  fakes: values within 1e-5 of their magnitude (at least 1e-3: WGAN's
  d_adv is a difference of means that can cancel), gradients in the fakes
  within 1e-4 of the largest, parameter gradients per tensor within 1e-5
  of the net's largest plus 1e-3 of the tensor's own (1e-4 for WGAN-GP's
  penalty, a double backward; its eps is JAX's ``uniform`` of a fixed key,
  handed to the port).
- Spectral norm: the normalized kernel and the new ``u`` against Flax's
  ``SpectralNorm`` (1e-6), its kernel gradient (1e-5); a discriminator's
  forward from a Flax init with its ``spectral`` collection, f32 (1e-4 of
  the largest logit) and bf16 (3e-2, bf16 convs summed in another order).
- The multi-scale discriminator's forward from a Flax init (1e-4).
- ``torch.autograd.gradgradcheck`` of the moments Function in f64, the
  double backward that WGAN-GP takes through every norm of D.

A whole main step of each variant is in tests/test_torch_train_variant_steps.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.ops.spectral import SpectralNorm as JaxSpectralNorm  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel  # noqa: E402
from masterthesis_tpu_torch.ops import norms, spectral  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import params_from_jax  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(S.SHAPE, dim=8)
MS = dict(ms_dis=True, dis_n_layers=3, num_scales=2)
F32 = dict(SMALL, compute_dtype="float32", fused_resblock="off")


def _nchw(a):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2).contiguous()


def _np(t, nhwc=False):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if nhwc else t).numpy()


def _close(got, want, tol, what, floor=1e-12):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _pair(model_cls=AdaINModel, dtype="float32", seed=0, **flags):
    port = S.port_model(dtype, "off", seed=seed, model_cls=model_cls, shape=SMALL, **flags)
    jm = S.jax_model(dict(F32, compute_dtype=dtype, **flags), model_cls)
    return port, jm


def _images(seed, n=4):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    fake = np.tanh(rng.standard_normal((n, 32, 32, 3))).astype(np.float32)
    c_org = np.eye(3, dtype=np.float32)[[0, 2, 1, 0]]
    return img, fake, c_org


def _gp_eps(key, n):
    """JAX's WGAN-GP draw of ``key`` (``_gradient_penalty``)."""
    return np.array(jax.random.uniform(key, (n, 1, 1, 1), jnp.float32))


# spectral norm's D loss is in the whole step below; plain WGAN-GP's penalty
# in test_gradient_penalty_matches_jax
VARIANTS = {
    "hinge": dict(gan_mode="hinge"),
    "ragan": dict(use_ragan=True),
    "ragan_lsgan": dict(use_ragan=True, gan_mode="lsgan"),
    "wgangp_instance": dict(gan_mode="wgangp", lambda_gp=10.0, dis_norm="instance",
                            dis_n_layers=3),
    "ms_dis_hinge": dict(MS, gan_mode="hinge"),
    "ms_dis_wgangp": dict(MS, gan_mode="wgangp", lambda_gp=10.0, dis_norm="instance"),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_adversarial_terms_and_gradients_match_jax(name):
    """D's loss and its gradient in D1's params; G1's and G2's adversarial
    terms and their gradients in the fakes."""
    flags = VARIANTS[name]
    port, jm = _pair(**flags)
    tree, extra = S.jax_tree(port), S.jax_extra(port)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jextra = jax.tree_util.tree_map(jnp.asarray, extra)
    img, fake, c_org = _images(1)
    key = jax.random.PRNGKey(7)
    wgangp = "lambda_gp" in flags
    d = "discriminator1"

    (j_total, j_logs), j_grad = jax.value_and_grad(
        lambda dp: jm._d_loss(d, dp, params, jextra, jnp.asarray(img), jnp.asarray(fake),
                              jnp.asarray(c_org), key if wgangp else None),
        has_aux=True)(params[d])
    eps = torch.from_numpy(_gp_eps(key, 4)) if wgangp else None
    total, logs = port._d_loss(d, _nchw(img), _nchw(fake), torch.from_numpy(c_org), eps)
    assert set(logs) == set(j_logs) - {"_spectral"}
    for k, v in logs.items():
        # WGAN's d_adv, mean(fake) - mean(real), can cancel to near 0
        _close(v.detach().numpy(), j_logs[k], 1e-5, f"{name} {k}", floor=1e-3)
    net = port.nets[d]
    grads = dict(zip((k for k, _ in net.named_parameters()),
                     torch.autograd.grad(total, list(net.parameters()), allow_unused=True)))
    want = S.to_port(port, d, jax.tree_util.tree_map(np.asarray, j_grad), tree)
    _grads_close(grads, want, 1e-4 if wgangp else 1e-5, name)

    # G1 against D1, G2 with its discriminator selection
    for label, port_fn, jax_fn in (
        ("g1", lambda f: port._g_adv_loss(_nchw(img), f, torch.from_numpy(c_org), d),
         lambda f: jm._g_adv_loss(params, jextra, jnp.asarray(img), f, jnp.asarray(c_org), d)),
        ("g2", lambda f: _port_g2_adv(port, _nchw(img), f, torch.from_numpy(c_org)),
         lambda f: jm._g2_adv(params, jextra, jnp.asarray(img), f, jnp.asarray(c_org))),
    ):
        j_adv, j_cls = jax_fn(jnp.asarray(fake))
        j_df = jax.grad(lambda f: sum(jax_fn(f)))(jnp.asarray(fake))
        f = _nchw(fake).requires_grad_(True)
        adv, cls = port_fn(f)
        (df,) = torch.autograd.grad(adv + cls, f)
        _close(adv.detach().numpy(), j_adv, 1e-5, f"{name} {label} adv", floor=1e-3)
        _close(cls.detach().numpy(), j_cls, 1e-5, f"{name} {label} cls", floor=1e-3)
        _close(_np(df, nhwc=True), j_df, 1e-4, f"{name} {label} d fake")


def _grads_close(grads, want, tol, what):
    """Per tensor within ``tol`` of the net's largest |JAX gradient| plus
    1e-3 of the tensor's own: a head's gradient can be a sum that cancels
    to far below the others, where f32 roundoff of the net's scale lands."""
    net_max = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        g = torch.zeros_like(w) if grads[k] is None else grads[k]
        err = float((g - w).abs().max())
        assert err <= tol * net_max + 1e-3 * float(w.abs().max()), (what, k, err)


def _port_g2_adv(port, img, fake, c_org):
    """G2's adversarial terms by the port's selection (``_g2_phase``)."""
    a = port.args
    if a.ms_dis:
        return port._g_adv_loss(img, fake, c_org, "discriminator1")
    if a.use_ragan:
        return port._g_adv_loss(img, fake, c_org, "discriminator1", "discriminator2")
    return port._g_adv_loss(img, fake, c_org, "discriminator2")


@pytest.mark.parametrize("flags", [{}, dict(dis_norm="instance", dis_n_layers=3), MS])
def test_gradient_penalty_matches_jax(flags):
    """The penalty alone, through JAX's ``_gradient_penalty`` on a fixed key
    (its eps handed to the port): value within 1e-5, its gradient in D's
    params (the double backward) per tensor within 1e-4 of the net's
    largest plus 1e-3 of the tensor's."""
    port, jm = _pair(**flags)
    tree = S.jax_tree(port)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    img, fake, _ = _images(2)
    key = jax.random.PRNGKey(11)
    d = "discriminator2"
    j_gp, j_grad = jax.value_and_grad(lambda dp: jm._gradient_penalty(
        d, {**params, d: dp}, {}, jnp.asarray(img), jnp.asarray(fake), key))(params[d])
    gp = port._gradient_penalty(d, _nchw(img), _nchw(fake), torch.from_numpy(_gp_eps(key, 4)))
    _close(gp.detach().numpy(), j_gp, 1e-5, "gp")
    net = port.nets[d]
    grads = torch.autograd.grad(gp, list(net.parameters()), allow_unused=True)
    want = S.to_port(port, d, jax.tree_util.tree_map(np.asarray, j_grad), tree)
    _grads_close(dict(zip((k for k, _ in net.named_parameters()), grads)), want, 1e-4, "gp")


@pytest.mark.parametrize("shape", [(16, 3, 3, 3), (32, 16, 4, 4)])
def test_spectral_norm_matches_flax(shape):
    """One power iteration from the same u: the normalized kernel, the new
    u (1e-6) and the kernel's gradient through sigma (1e-5)."""
    rng = np.random.default_rng(3)
    o, i, kh, kw = shape
    w = rng.standard_normal(shape).astype(np.float32) * 0.3
    u = rng.standard_normal(o).astype(np.float32)
    u /= np.linalg.norm(u)
    r = rng.standard_normal(shape).astype(np.float32)
    hwio = np.transpose(w, (2, 3, 1, 0))
    variables = {"spectral": {"u": jnp.asarray(u)}}

    def jax_sn(k):
        return JaxSpectralNorm().apply(variables, k, mutable=["spectral"])

    (k_bar, mut), vjp = jax.vjp(jax_sn, jnp.asarray(hwio))
    (j_dk,) = vjp((jnp.asarray(np.transpose(r, (2, 3, 1, 0))),
                   jax.tree.map(jnp.zeros_like, mut)))
    sn = spectral.SpectralNorm(o)
    sn.u.copy_(torch.from_numpy(u))
    wt = torch.from_numpy(w).requires_grad_(True)
    with spectral.recording(sn):
        out = sn(wt)
    (dk,) = torch.autograd.grad(out, wt, torch.from_numpy(r))
    _close(out.detach().permute(2, 3, 1, 0).numpy(), k_bar, 1e-6, "kernel / sigma")
    _close(sn.new_u.numpy(), mut["spectral"]["u"], 1e-6, "u")
    _close(dk.permute(2, 3, 1, 0).numpy(), j_dk, 1e-5, "d kernel")
    assert torch.equal(sn.u, torch.from_numpy(u))  # stored only by commit
    spectral.commit(sn)
    _close(sn.u.numpy(), mut["spectral"]["u"], 1e-6, "committed u")


def _flax_discriminators(jm, port, seed):
    """The JAX package's own init of both discriminators (params and
    spectral collection), inside the port model's tree."""
    tree, extra = S.jax_tree(port), S.jax_extra(port)
    for i, d in enumerate(("discriminator1", "discriminator2")):
        v = jm.nets[d].init(jax.random.PRNGKey(seed + i), jnp.zeros((2, 32, 32, 3)))
        tree[d] = jax.tree_util.tree_map(np.asarray, v["params"])
        extra[d] = jax.tree_util.tree_map(np.asarray, dict(v.get("spectral", {})))
    return tree, extra


@pytest.mark.parametrize("flags,dtype,tol", [
    (dict(dis_sn=True), "float32", 1e-4),
    (dict(dis_sn=True), "bfloat16", 3e-2),
    (MS, "float32", 1e-4),
    (dict(MS, dis_sn=True, dis_norm="instance"), "float32", 1e-4),
])
def test_discriminators_load_from_a_flax_init_and_match_it(flags, dtype, tol):
    """``params_from_jax`` carries a Flax init of the discriminators, the
    spectral ``u`` vectors from its extra tree among it (every leaf
    consumed); their forwards agree with Flax's, the stored u not moved."""
    port, jm = _pair(dtype=dtype, **flags)
    tree, extra = _flax_discriminators(jm, port, 20)
    port.load_params(params_from_jax(tree, port, extra))
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    for d in ("discriminator1", "discriminator2"):
        variables = {"params": tree[d]}
        if extra[d]:
            variables["spectral"] = extra[d]
        want = jm.nets[d].apply(variables, jnp.asarray(x))
        with torch.no_grad():
            got = port.nets[d](_nchw(x))
        if not isinstance(want, list):
            want, got = [want], [got]
        assert len(got) == len(want)
        for (gp, gc), (wp, wc) in zip(got, want):
            assert tuple(gp.shape) == (wp.shape[0], wp.shape[3], wp.shape[1], wp.shape[2])
            _close(_np(gp, nhwc=True), np.asarray(wp, np.float32), tol, f"{d} patch")
            _close(_np(gc), np.asarray(wc, np.float32), tol, f"{d} class")
    for d, ex in S.jax_extra(port).items():
        for a, b in zip(jax.tree_util.tree_leaves(ex), jax.tree_util.tree_leaves(extra[d])):
            assert np.array_equal(a, b), d
    if flags.get("dis_sn"):
        with pytest.raises(KeyError, match="sn/u"):
            params_from_jax(tree, port, {**extra, "discriminator1": {}})


@pytest.mark.parametrize("per_sample", [False, True])
def test_moments_function_double_backward(per_sample):
    """The moments Function's backward is differentiable (WGAN-GP takes the
    gradient of a gradient through every norm of D): gradgradcheck in f64."""
    x = torch.randn(2, 3, 4, 5, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    x.requires_grad_(True)
    assert torch.autograd.gradgradcheck(lambda t: norms.moments(t, per_sample), (x,))
    assert torch.autograd.gradgradcheck(norms.instance_norm, (x,))
