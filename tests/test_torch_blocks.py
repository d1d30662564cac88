"""Each block on AdaINModel's inference path against its Flax counterpart,
on the same params carried over by ``params_from_jax``.

Params come from the Flax module's own init, with every bias and LayerNorm
affine redrawn from a numpy seed so that they are exercised. Inputs are
numpy, NHWC for JAX and NCHW for the port.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The JAX side needs Flax: where it is missing these parity tests skip, and
# `-m gpu` still runs the gpu-marked tests of the other files.
unfreeze = pytest.importorskip("flax.core").unfreeze

from masterthesis_tpu.models import blocks as jb
from masterthesis_tpu_torch.models import blocks as tb
from masterthesis_tpu_torch.tools.convert_jax import params_from_jax

torch.set_num_threads(2)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# f32: the same math in both frameworks, other summation orders, and the
# port's one-pass norm variance against JAX's two-pass one;
# bf16: a few rounding steps of 2^-8 relative on O(1) values
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


def _perturb(tree, rng):
    """Redraw biases and LayerNorm affines, which Flax inits to 0 and 1."""
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


def _compare(jmod, tmod, shape, dtype, style_dim=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, JDT[dtype])
    extra_j, extra_t = (), ()
    if style_dim is not None:
        s = rng.standard_normal((shape[0], style_dim)).astype(np.float32)
        extra_j, extra_t = (jnp.asarray(s, JDT[dtype]),), (torch.from_numpy(s).to(dtype),)
    params = unfreeze(jmod.init(jax.random.PRNGKey(seed), xj, *extra_j))["params"]
    params = _perturb(params, rng)
    ref = np.asarray(jmod.apply({"params": params}, xj, *extra_j).astype(jnp.float32))
    sd = params_from_jax({"net": params}, SimpleNamespace(nets={"net": tmod}))["net"]
    tmod.load_state_dict(sd, strict=True)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).permute(0, 3, 1, 2)
    with torch.inference_mode():
        out = tmod(xt.contiguous().to(dtype), *extra_t)
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().permute(0, 2, 3, 1).numpy(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "k,stride,pad,padding_type,bias",
    [
        (3, 1, 1, "reflect", False),  # resblock conv
        (3, 2, 1, "reflect", True),  # encoder down conv
        (7, 1, 3, "reflect", True),  # encoder stem
        (4, 2, 1, "reflect", True),  # style encoder stem
        (3, 1, 1, "replicate", True),
        (3, 1, 1, None, True),  # zero padding inside the conv
        (1, 1, 0, None, True),  # style encoder shortcut
    ],
)
def test_conv2d_matches_flax(k, stride, pad, padding_type, bias, dtype):
    _compare(
        jb.Conv2d(6, k, stride, pad, use_bias=bias, padding_type=padding_type, dtype=JDT[dtype]),
        tb.Conv2d(5, 6, k, stride, pad, use_bias=bias, padding_type=padding_type, dtype=dtype),
        (2, 12, 12, 5), dtype,
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,stride,pad,out_pad,bias", [(3, 2, 1, 1, True), (1, 1, 0, 0, False)])
def test_conv_transpose2d_matches_flax(k, stride, pad, out_pad, bias, dtype):
    """The k3/s2/p1/op1 upsample and the 1x1 head: HWIO -> IOHW with a flip."""
    _compare(
        jb.ConvTranspose2d(6, k, stride, pad, out_pad, use_bias=bias, dtype=JDT[dtype]),
        tb.ConvTranspose2d(5, 6, k, stride, pad, out_pad, use_bias=bias, dtype=dtype),
        (2, 7, 9, 5), dtype,
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_matches_flax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 10)).astype(np.float32)
    jmod = jb.Dense(7, dtype=JDT[dtype])
    params = _perturb(unfreeze(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"], rng)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    tmod = tb.Dense(10, 7, dtype=dtype)
    tmod.load_state_dict(params_from_jax({"n": params}, SimpleNamespace(nets={"n": tmod}))["n"])
    with torch.inference_mode():
        out = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(out.float().numpy(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm,act", [("instance", "lrelu"), ("instance", "relu"), ("layer", "relu")])
def test_conv_block_matches_flax(norm, act, dtype):
    _compare(
        jb.ConvBlock(8, 3, 2, 1, use_bias=True, norm=norm, activation=act,
                     padding_type="reflect", dtype=JDT[dtype]),
        tb.ConvBlock(4, 8, 3, 2, 1, use_bias=True, norm=norm, activation=act,
                     padding_type="reflect", dtype=dtype),
        (2, 16, 16, 4), dtype,
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_upsample_block_matches_flax(dtype):
    """Decoder tail upsample: transposed conv -> LayerNorm -> relu."""
    _compare(
        jb.UpsampleBlock(4, 3, 2, 1, 1, use_bias=True, norm="layer", activation="relu",
                         dtype=JDT[dtype]),
        tb.UpsampleBlock(8, 4, 3, 2, 1, 1, use_bias=True, norm="layer", activation="relu",
                         dtype=dtype),
        (2, 8, 8, 8), dtype,
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", [None, "instance"])
def test_down_resnet_block_matches_flax(norm, dtype):
    """norm=None is AdaINModel's style encoder: the shortcut takes the
    activated input (the original's in-place LeakyReLU quirk)."""
    _compare(
        jb.DownResnetBlock(8, norm=norm, dtype=JDT[dtype]),
        tb.DownResnetBlock(4, 8, norm=norm, dtype=dtype),
        (2, 16, 16, 4), dtype,
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_resnet_block_matches_flax(dtype):
    _compare(jb.ResnetBlock(8, dtype=JDT[dtype]), tb.ResnetBlock(8, dtype=dtype),
             (2, 12, 12, 8), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adain_resnet_block_matches_flax(dtype):
    """One AdaIN shared by both convs; no activation after the second."""
    _compare(jb.AdaINResnetBlock(8, dtype=JDT[dtype]), tb.AdaINResnetBlock(8, 6, dtype=dtype),
             (2, 12, 12, 8), dtype, style_dim=6)


def test_down_resnet_block_quirk_changes_the_result():
    """The quirk is observable: taking the raw input for the shortcut (as a
    pre-norm block does) gives another result, so the test above pins it."""
    torch.manual_seed(0)
    blk = tb.DownResnetBlock(4, 8, norm=None)
    torch.nn.init.normal_(blk.conv1.conv.weight)
    torch.nn.init.normal_(blk.conv2.conv.weight)
    torch.nn.init.normal_(blk.shortcut.weight)
    x = torch.randn(1, 4, 8, 8)
    with torch.inference_mode():
        got = blk(x)
        h = blk.conv2(blk.conv1(blk.act(x)))
        raw = tb.avg_pool2d(h, 2, 2) + blk.shortcut(tb.avg_pool2d(x, 2, 2))
    assert not torch.allclose(got, raw)


def test_pad2d_matches_jax():
    x = np.random.default_rng(1).standard_normal((1, 5, 6, 2)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for mode in ("reflect", "replicate"):
        ref = np.asarray(jb.pad2d(jnp.asarray(x), 2, mode))
        out = tb.pad2d(xt, 2, mode).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(out, ref)
    with pytest.raises(NotImplementedError):
        tb.pad2d(xt, 1, "circular")
