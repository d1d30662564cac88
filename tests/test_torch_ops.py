"""The port's kernels' plain versions and norms against the JAX package.

Inputs are made with numpy and passed to both frameworks as numpy; JAX runs
on the CPU (the moments Pallas kernel in interpret mode, the AdaIN kernel
through its jnp reference, as the JAX package's own tests run them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX side needs Flax: where it is missing these parity tests skip, and
# `-m gpu` still runs the gpu-marked tests of the other files.
unfreeze = pytest.importorskip("flax.core").unfreeze

from masterthesis_tpu.ops import norms as jnorms
from masterthesis_tpu.ops.pallas.adain import fused_adain
from masterthesis_tpu.ops.pallas.moments import pallas_moments
from masterthesis_tpu_torch.ops import norms
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import moments as kmoments

torch.set_num_threads(2)


def _nhwc(shape, seed, scale=1.5, offset=0.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + offset).astype(np.float32)


def _t(x_nhwc, dtype=torch.float32):
    """NHWC numpy -> NCHW contiguous torch."""
    return torch.from_numpy(np.array(x_nhwc)).permute(0, 3, 1, 2).contiguous().to(dtype)


def _np(t):
    """NCHW torch -> NHWC f32 numpy."""
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("layout", ["sbc", "bsc"])
@pytest.mark.parametrize("axes", [(1, 2), (1, 2, 3)])
def test_moments_plain_matches_pallas_moments(layout, axes):
    x = _nhwc((2, 32, 32, 64), seed=0)
    mean, var = pallas_moments(jnp.asarray(x), axes, interpret=True, layout=layout)
    t_mean, t_var = norms.moments(_t(x), per_sample=axes == (1, 2, 3))
    # both one-pass sums (the port's in f64, JAX's in f32), in another order:
    # the JAX package's own tolerances for this kernel against the two-pass
    # reference
    np.testing.assert_allclose(_np(t_mean), np.asarray(mean), atol=1e-5)
    np.testing.assert_allclose(_np(t_var), np.asarray(var), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("base,jitter", [(3.0, 1e-3), (-7.5, 1e-4), (0.25, 0.0), (120.0, 1e-2)])
def test_moments_plain_near_constant_input(base, jitter):
    """One-pass E[x^2] - mean^2 on near-constant bf16 maps: finite, var >= 0,
    and rsqrt(var + eps) close to the JAX kernel's and to the centered
    two-pass result (eps floors the denominator, so even full cancellation
    moves rstd by a bounded factor: rtol 0.15, as the JAX package's test)."""
    eps = 1e-5
    x32 = base + jitter * np.random.default_rng(6).standard_normal((2, 32, 32, 64))
    x = jnp.asarray(x32, jnp.bfloat16)
    mean, var = pallas_moments(x, (1, 2), interpret=True)
    t_mean, t_var = norms.moments(_t(np.asarray(x.astype(jnp.float32)), torch.bfloat16))
    assert torch.isfinite(t_mean).all() and (t_var >= 0).all()
    ref_mean, ref_var = jnorms._moments(x, (1, 2))
    t_rstd = _np(torch.rsqrt(t_var + eps))
    np.testing.assert_allclose(_np(t_mean), np.asarray(mean), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(t_mean), np.asarray(ref_mean), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(t_rstd, np.asarray(jax.lax.rsqrt(var + eps)), rtol=0.15)
    np.testing.assert_allclose(t_rstd, np.asarray(jax.lax.rsqrt(ref_var + eps)), rtol=0.15)


# f32: same arithmetic, other rounding order; bf16: one output rounding step
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_plain_matches_fused_adain(dtype):
    x = _nhwc((2, 8, 8, 16), seed=1, scale=2.0, offset=1.0)
    g = _nhwc((2, 16), seed=2, scale=0.3, offset=0.0)
    b = _nhwc((2, 16), seed=3, scale=0.3, offset=0.0)
    xj = jnp.asarray(x, JDT[dtype])
    ref = np.asarray(fused_adain(xj, jnp.asarray(g), jnp.asarray(b)).astype(jnp.float32))
    xt = _t(np.asarray(xj.astype(jnp.float32)), dtype)
    out = kadain.adain(xt, torch.from_numpy(g), torch.from_numpy(b))
    assert out.dtype == dtype
    np.testing.assert_allclose(_np(out), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["instance", "layer", "adain"])
def test_norm_modules_match_flax(kind, dtype):
    """InstanceNorm / LayerNorm / AdaptiveInstanceNorm on the same params.
    The port's one-pass variance against the JAX CPU path's two-pass one:
    f32 within 1e-4 on these O(1) outputs."""
    x = _nhwc((2, 8, 8, 16), seed=4, scale=2.0, offset=0.5)
    s = _nhwc((2, 12), seed=5)
    xj = jnp.asarray(x, JDT[dtype])
    if kind == "instance":
        ref = jnorms.InstanceNorm().apply({}, xj)
        mod = norms.InstanceNorm()
    elif kind == "layer":
        params = {"scale": _nhwc((16,), 6, 0.5, 1.0), "bias": _nhwc((16,), 7, 0.5, 0.0)}
        ref = jnorms.LayerNorm().apply({"params": params}, xj)
        mod = norms.LayerNorm(16)
        mod.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    else:
        jmod = jnorms.AdaptiveInstanceNorm(16, dtype=JDT[dtype])
        params = unfreeze(jmod.init(jax.random.PRNGKey(0), xj, jnp.asarray(s)))["params"]
        ref = jmod.apply({"params": params}, xj, jnp.asarray(s))
        mod = norms.AdaptiveInstanceNorm(16, 12, dtype=dtype)
        sp = params["style_proj"]
        mod.load_state_dict({
            "style_proj.weight": torch.from_numpy(np.asarray(sp["kernel"]).T.copy()),
            "style_proj.bias": torch.from_numpy(np.asarray(sp["bias"])),
        })
    xt = _t(np.asarray(xj.astype(jnp.float32)), dtype)
    with torch.inference_mode():
        out = mod(xt, torch.from_numpy(s)) if kind == "adain" else mod(xt)
    assert out.dtype == dtype
    tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else dict(atol=5e-2, rtol=0)
    np.testing.assert_allclose(_np(out), np.asarray(ref.astype(jnp.float32)), **tol)


def test_wrappers_take_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor goes to the plain version, and no launch is counted."""
    calls = []
    monkeypatch.setattr(kmoments, "moments_plain", lambda x: calls.append("m") or (x, x))
    monkeypatch.setattr(kadain, "adain_plain", lambda x, g, b, e: calls.append("a") or x)
    before = (kmoments.moments.launches, kadain.adain.launches)
    x = torch.zeros(1, 2, 4, 4)
    kmoments.moments(x)
    kadain.adain(x, torch.zeros(1, 2), torch.zeros(1, 2))
    assert calls == ["m", "a"]
    assert (kmoments.moments.launches, kadain.adain.launches) == before


def test_wrappers_raise_when_grad_is_required():
    """The serving-only head has no backward and says so; the moments and
    AdaIN wrappers take a gradient-carrying input, whose gradient the
    ``ops/norms.py`` Functions supply."""
    x = torch.zeros(1, 2, 4, 4, requires_grad=True)
    pending = kq.Pending(torch.ones(1, 2), torch.zeros(1, 2), True, 0.0)
    with pytest.raises(RuntimeError, match="backward"):
        khead.head(x, pending, torch.ones(3, 2))
    with torch.no_grad():
        khead.head(x, pending, torch.ones(3, 2))  # no grad wanted: fine
    kmoments.moments(x)
    kadain.adain(x, torch.zeros(1, 2), torch.zeros(1, 2))
    mean, var = norms.moments(x)
    (mean.sum() + var.sum()).backward()
    assert x.grad is not None and x.grad.shape == x.shape


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 2, 4, 4, device="meta")
    with pytest.raises(ValueError):
        kmoments.moments(x)
    with pytest.raises(ValueError):
        kadain.adain(x, torch.zeros(1, 2, device="meta"), torch.zeros(1, 2, device="meta"))
