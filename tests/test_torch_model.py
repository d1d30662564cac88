"""The port's AdaINModel against the JAX package's, on converted weights.

One JAX ``AdaINModel.initialize()`` tree per module (crop 32, dim 8,
latent 4, 4 domains, B=2), with biases and LayerNorm affines redrawn from a
numpy seed, carried into the port by ``params_from_jax``. The JAX side runs
on the CPU with its default norms (two-pass ``_jnp_moments``, AdaIN through
its jnp reference); the port runs its kernels' plain versions (one-pass
moments). Tolerances, in units of max(1, max|reference|) so that they mean
the same on the tanh outputs and on the unbounded content code: f32 within
1e-4, which covers the one-pass vs two-pass variance; bf16 within 5e-2, a
few bf16 rounding steps (2^-8 relative) carried through the net. On these
weights the JAX package's own bf16 forward is 4e-2 from its f32 forward.
"""
import jax
import numpy as np
import pytest
import torch

# The JAX side needs Flax: where it is missing these parity tests skip, and
# `-m gpu` still runs the gpu-marked tests of the other files.
pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_test_args as jax_test_args
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel
from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import moments as kmoments
from masterthesis_tpu_torch.tools.convert_jax import _flatten, params_from_jax

torch.set_num_threads(2)

SIZE, B, K, LATENT = 32, 2, 4, 4
SHAPE = dict(crop_size=SIZE, dim=8, latent_dim=LATENT, num_domains=K, batch_size=B, init_type=None)
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "bias":
            out[k] = (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def tree():
    jm = JaxAdaINModel(jax_test_args(**SHAPE))
    params = jax.tree_util.tree_map(np.asarray, jm.initialize().params)
    return _perturb(params, np.random.default_rng(0))


@pytest.fixture(scope="module")
def models(tree):
    """dtype -> (JAX model, port model on the CPU with the same weights)."""
    out = {}
    for dtype in DTYPES:
        jm = JaxAdaINModel(jax_test_args(compute_dtype=dtype, **SHAPE))
        tm = AdaINModel(default_test_args(compute_dtype=dtype, **SHAPE), device="cpu")
        tm.load_params(params_from_jax(tree, tm))
        out[dtype] = (jm, tm)
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return dict(
        img=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        ref=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        z=rng.standard_normal((B, LATENT)).astype(np.float32),
        c=np.eye(K, dtype=np.float32)[[1, 3]],
    )


def _f32(a):
    return np.asarray(a.astype(np.float32) if hasattr(a, "astype") else a, np.float32)


def _close(got, want, dtype):
    want = _f32(want)
    atol = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_f32(got), want, atol=atol, rtol=0)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------- params --


def _to_jax(net_sd, key, leaf_path, tm_net):
    """Inverse of params_from_jax for one port tensor (test-side oracle)."""
    a = net_sd[key].numpy()
    if leaf_path.endswith("kernel"):
        if a.ndim == 2:
            return a.T
        module = tm_net.get_submodule(key.rsplit(".", 1)[0])
        if type(module).__name__ == "ConvTranspose2d":
            return np.transpose(a, (2, 3, 0, 1))[::-1, ::-1]
        return np.transpose(a, (2, 3, 1, 0))
    return a


def test_params_from_jax_round_trips_every_leaf(tree, models):
    tm = models["float32"][1]
    sds = params_from_jax(tree, tm)
    for net, sd in sds.items():
        leaves = _flatten(tree[net])
        back = {}
        for key in sd:
            path = key.replace(".", "/").replace("/weight", "/kernel")
            module = tm.nets[net].get_submodule(key.rsplit(".", 1)[0])
            if type(module).__name__ == "Dense":
                path = path.rsplit("/", 1)
                path = f"{path[0]}/Dense_0/{path[1]}"
            back[path] = _to_jax(sd, key, path, tm.nets[net])
        assert set(back) == set(leaves), net
        for path, value in leaves.items():
            np.testing.assert_array_equal(back[path], value, err_msg=f"{net}/{path}")


def test_params_from_jax_raises_on_an_unconsumed_leaf(tree, models):
    bad = {**tree, "decoder": {**tree["decoder"], "extra": {"kernel": np.zeros((1, 1))}}}
    with pytest.raises(KeyError, match="extra/kernel"):
        params_from_jax(bad, models["float32"][1])


def test_params_from_jax_raises_on_an_unset_parameter(tree, models):
    dec = dict(tree["decoder"])
    del dec["dec2"]
    with pytest.raises(KeyError, match="dec2"):
        params_from_jax({**tree, "decoder": dec}, models["float32"][1])


def test_params_from_jax_raises_on_a_shape_mismatch(tree):
    tm = AdaINModel(default_test_args(**{**SHAPE, "dim": 16}), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, tm)


# ------------------------------------------------------------------ nets --


@pytest.mark.parametrize("dtype", DTYPES)
def test_content_encoder_matches_flax(tree, models, inputs, dtype):
    jm, tm = models[dtype]
    ref = jm.encode_content(tree, None, inputs["img"])
    with torch.inference_mode():
        out = tm.encode_content(_nchw(inputs["img"]))
    assert out.dtype == tm.compute_dtype
    _close(out.float().permute(0, 2, 3, 1).numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_style_encoder_mu_logvar_match_flax(tree, models, inputs, dtype):
    jm, tm = models[dtype]
    z, mu, logvar = jm.encode_style(tree, inputs["ref"], inputs["c"], sample=False)
    with torch.inference_mode():
        tz, tmu, tlogvar = tm.encode_style(_nchw(inputs["ref"]), torch.from_numpy(inputs["c"]))
    for got, want in ((tz, z), (tmu, mu), (tlogvar, logvar)):
        _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decoder_matches_flax(tree, models, inputs, dtype):
    jm, tm = models[dtype]
    zc = np.random.default_rng(2).standard_normal((B, SIZE // 4, SIZE // 4, 32)).astype(np.float32)
    ref = jm.decode(tree, zc, inputs["z"], inputs["c"])
    with torch.inference_mode():
        out = tm.decode(_nchw(zc), torch.from_numpy(inputs["z"]), torch.from_numpy(inputs["c"]))
    _close(out.float().permute(0, 2, 3, 1).numpy(), ref, dtype)


# ------------------------------------------------------------- the model --


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_random_matches_jax(tree, models, inputs, dtype):
    jm, tm = models[dtype]
    ref = jm._forward_random_impl(tree, inputs["img"], inputs["z"], inputs["c"])
    out, seconds, mem = tm.forward_random(inputs["img"], inputs["z"], inputs["c"])
    assert out.shape == (B, SIZE, SIZE, 3) and out.dtype == tm.compute_dtype
    assert seconds > 0 and mem == 0.0
    assert np.abs(_f32(ref)).max() > 0.3, "outputs must span the tanh range to test anything"
    _close(out.float().numpy(), ref, dtype)


def _jax_eps(jm, params, inputs, rng):
    """The VAE draw that _forward_reference_impl makes from ``rng``, recovered
    in f32 as (z - mu) / exp(logvar / 2); the draw does not depend on dtype."""
    z, mu, logvar = jm.encode_style(params, inputs["ref"], inputs["c"], rng, sample=True)
    return ((np.asarray(z) - np.asarray(mu)) / np.exp(0.5 * np.asarray(logvar))).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_reference_matches_jax(tree, models, inputs, dtype):
    rng = jax.random.PRNGKey(5)
    eps = _jax_eps(models["float32"][0], tree, inputs, rng)
    jm, tm = models[dtype]
    ref = jm._forward_reference_impl(
        tree, inputs["img"], inputs["ref"], inputs["c"], rng
    )
    out, _, _ = tm.forward_reference(inputs["img"], inputs["ref"], inputs["c"], eps=eps)
    assert out.shape == (B, SIZE, SIZE, 3)
    _close(out.float().numpy(), ref, dtype)


def test_forward_reference_draws_eps_from_the_generator(models, inputs):
    tm = models["float32"][1]
    args = (inputs["img"], inputs["ref"], inputs["c"])
    a, _, _ = tm.forward_reference(*args, generator=torch.Generator().manual_seed(3))
    b, _, _ = tm.forward_reference(*args, generator=torch.Generator().manual_seed(3))
    eps = tm.get_z_random(B, torch.Generator().manual_seed(3))
    c, _, _ = tm.forward_reference(*args, eps=eps)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["forward_random", "forward_reference"])
def test_every_norm_goes_through_the_kernel_wrappers(models, inputs, entry, monkeypatch):
    """13 moments and 8 AdaIN calls per forward: stem, two downs, eight
    resblock instance norms and two LayerNorms; two AdaINs in each of four
    decoder blocks. The style encoder has no norm."""
    calls = {"moments": 0, "adain": 0}
    real_m, real_a = kmoments.moments, kadain.adain

    def count_m(x):
        calls["moments"] += 1
        return real_m(x)

    def count_a(*a):
        calls["adain"] += 1
        return real_a(*a)

    monkeypatch.setattr(kmoments, "moments", count_m)
    monkeypatch.setattr(kadain, "adain", count_a)
    tm = models["float32"][1]
    if entry == "forward_random":
        tm.forward_random(inputs["img"], inputs["z"], inputs["c"])
    else:
        tm.forward_reference(inputs["img"], inputs["ref"], inputs["c"])
    assert calls == {"moments": 13, "adain": 8}
