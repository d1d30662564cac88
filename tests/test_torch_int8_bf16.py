"""int8 serving at compute dtype bf16: the port's plain int8 chain against
the JAX package's CPU int8 path, and ``--dec_norm instance`` under int8.

The JAX side runs its off-TPU int8 path at ``compute_dtype="bfloat16"``
(``int8_conv3x3``, ``int8_deconv``, ``int8_resblock`` with bf16 x and
``out_dtype`` bf16, each op eager; the head as ``blocks.py``
``_packed_head``'s CPU route); the port runs its kernels' plain versions
on bf16 tensors. Inputs are bf16 values made from numpy seeds; the models
are crop 32, dim 8, latent 4, 4 domains, B=2, with one JAX param tree
carried over by ``params_from_jax`` and JAX's amax tree by
``quant_from_jax``.

Tolerances:
- int8 operands and int32 accumulators: exact, as at f32;
- each conv's bf16 y: bit-equal (JAX rounds the f32 ``acc * scale + bias``
  once to bf16, and so does the port);
- the statistics: as at f32 (``tests/test_torch_int8.py``), JAX summing
  its f32 y in f32;
- a resblock: its second conv's prologue affine comes from the statistics,
  so a value within an ulp of a .5 rounding boundary can round the other
  way, and the residual's bf16 rounding can land a step apart: at most 3 %
  of outputs move by more than one bf16 step of their value, none by more
  than 6e-2 (two bf16 steps at |x| ~ 4);
- the head: the two 1x1 convs sum the channels in another order, so an
  output can move by a bf16 step of the pre-tanh value: at most
  ``head.BF16_TOL``;
- the forwards: by JAX's own spread (below), and above 25 dB against the
  float bf16 forward of the same weights (the JAX test's bar);
- ``--dec_norm instance``: at f32 the bounds of ``tests/test_torch_int8.py``
  ``_forward_close``; at bf16 the bf16 forward bound above.

The bf16 int8 forwards spread: a bf16 rounding step that moves a value
across an int8 rounding boundary moves it by a whole int8 step. JAX's own
jitted forward (XLA keeps f32 between fused bf16 ops) and its eager one
(each op rounds, the CPU route's rounding points) differ by up to 0.18 at
these weights, so the port is held to JAX's eager forward by that spread
(``_spread_close``): PSNR within 1 dB of JAX's jitted-against-eager, the
largest difference within the larger of 5e-2 and 1.5 times JAX's.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_test_args as jax_test_args
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel
from masterthesis_tpu.models import BaseModel as JaxBaseModel
from masterthesis_tpu.models.blocks import apply_pending as jax_apply_pending
from masterthesis_tpu.ops.pallas import conv_int8 as jq
from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import AdaINModel, BaseModel
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from tests.torch_jax_init import initialized
from masterthesis_tpu_torch.tools.convert_jax import (
    _conv,
    _conv_transpose,
    params_from_jax,
    quant_from_jax,
)

torch.set_num_threads(2)

SIZE, B, K, LATENT = 32, 2, 4, 4
SHAPE = dict(crop_size=SIZE, dim=8, latent_dim=LATENT, num_domains=K, batch_size=B, init_type=None)
BF16_FORWARD_TOL = 5e-2  # tests/test_torch_model.py TOL["bfloat16"]


def _bf16(a) -> np.ndarray:
    """f32 numpy array of bf16 values (round to nearest even)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _nchw_bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2).contiguous().to(
        torch.bfloat16)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _pending(rng, b, c, relu, alpha):
    return {
        "scale": rng.uniform(0.5, 1.5, (b, c)).astype(np.float32),
        "shift": (rng.standard_normal((b, c)) * 0.3).astype(np.float32),
        "relu": relu, "alpha": alpha,
    }


def _torch_pending(p):
    if p is None:
        return None
    return kq.Pending(torch.from_numpy(p["scale"]), torch.from_numpy(p["shift"]), p["relu"],
                      p["alpha"])


def _prologue_kw(p, alpha=True):
    if p is None:
        return {}
    kw = dict(prologue_scale=p["scale"], prologue_shift=p["shift"], prologue_relu=p["relu"])
    if alpha:
        kw["prologue_alpha"] = p["alpha"]
    return kw


def _jax_prologue(x, p):
    x = jnp.asarray(x).astype(jnp.float32)
    if p is None:
        return x
    y = x * p["scale"][:, None, None, :] + p["shift"][:, None, None, :]
    return jnp.maximum(y, p["alpha"] * y) if p["relu"] else y


def _assert_stats(got, want, y):
    yy = np.asarray(y, np.float64)
    for g, w, scale in ((got[0], want[0], np.abs(yy).sum(axis=(1, 2))),
                        (got[1], want[1], (yy * yy).sum(axis=(1, 2)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5 * float(scale.max()) + 1e-6)


# ----------------------------------------------------------------- convs --

CONV_CASES = [  # (stride, pending relu, alpha, padding, C, Co)
    (1, None, 0.0, "reflect", 12, 20),
    (1, True, 0.0, "reflect", 40, 36),  # unaligned widths, as DecoderConcat's
    (2, None, 0.0, "reflect", 12, 20),
    (2, True, 0.01, "reflect", 12, 20),  # the stem's deferred IN + lrelu into down0
    (2, True, 0.0, None, 16, 24),  # zero padding
]


@pytest.mark.parametrize("stride,relu,alpha,padding,c,co", CONV_CASES)
def test_conv_bf16_matches_jax(stride, relu, alpha, padding, c, co):
    rng = np.random.default_rng(2)
    b, h, w = 2, 11, 10
    x = _bf16(rng.standard_normal((b, h, w, c)) * 1.5)
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.2).astype(np.float32)
    p = None if relu is None else _pending(rng, b, c, relu, alpha)
    amax = 2.6
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    yj, s1j, s2j = jq.int8_conv3x3(xj, jnp.asarray(k), amax, jnp.asarray(bias),
                                   padding_type=padding or "zero", stride=stride,
                                   with_stats=True, **_prologue_kw(p))
    assert yj.dtype == jnp.bfloat16
    xqj, _ = jq.quantize_act(_jax_prologue(xj, p), amax)
    accj = jq.jnp_int8_conv(xqj, jq.quantize_weight(jnp.asarray(k))[0], padding or "zero", stride)
    qc = kq.quant_conv(torch.from_numpy(_conv(k)), torch.from_numpy(bias), amax, stride, padding)
    xt, pt = _nchw_bf16(x), _torch_pending(p)
    xq = kq.quant_pad_plain(xt, qc, pt)
    np.testing.assert_array_equal(xq[:, 1:h + 1, 1:w + 1, :c].numpy(), np.asarray(xqj))
    np.testing.assert_array_equal(_nhwc(kq.conv_acc_plain(xq, qc)), np.asarray(accj))
    wrapper = kq.conv3x3 if stride == 1 else kq.downconv
    y, s1, s2 = wrapper(xt, qc, pt, with_stats=True)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(y), _f32(yj))
    _assert_stats((s1, s2), (s1j, s2j), _f32(yj))


@pytest.mark.parametrize("prologue", [False, True])
def test_deconv_bf16_matches_jax(prologue):
    rng = np.random.default_rng(3)
    b, h, w, c, co = 2, 7, 5, 16, 12  # an odd number of rows, as 540 px gives
    x = _bf16(rng.standard_normal((b, h, w, c)))
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.2).astype(np.float32)
    p = _pending(rng, b, c, True, 0.0) if prologue else None
    amax = 1.7
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    yj, s1j, s2j = jq.int8_deconv(xj, jnp.asarray(k), amax, jnp.asarray(bias), with_stats=True,
                                  **_prologue_kw(p, alpha=False))
    assert yj.dtype == jnp.bfloat16
    xqj, _ = jq.quantize_act(_jax_prologue(xj, p), amax)
    accj = jq.jnp_int8_deconv(xqj, jq.subpixel_weights(jq.quantize_weight(jnp.asarray(k))[0]))
    qc = kq.quant_deconv(torch.from_numpy(_conv_transpose(k).copy()), torch.from_numpy(bias), amax)
    xt, pt = _nchw_bf16(x), _torch_pending(p)
    xq = kq.quant_pad_plain(xt, qc, pt)
    np.testing.assert_array_equal(xq[:, :-1, :-1, :c].numpy(), np.asarray(xqj))
    acc = kq._interleave(kq.conv_acc_plain(xq, qc), 4)
    np.testing.assert_array_equal(_nhwc(acc), np.asarray(accj))
    y, s1, s2 = kq.deconv(xt, qc, pt, with_stats=True)
    assert y.dtype == torch.bfloat16 and y.shape == (b, co, 2 * h, 2 * w)
    np.testing.assert_array_equal(_nhwc(y), _f32(yj))
    want = [np.asarray(s).reshape(b, 4, co).sum(axis=1) for s in (s1j, s2j)]
    _assert_stats((s1, s2), want, _f32(yj))


@pytest.mark.parametrize("style", ["instance", "adain"])
def test_resblock_bf16_matches_jax(style):
    rng = np.random.default_rng(4)
    b, h, w, c = 2, 9, 8, 32
    x = _bf16(rng.standard_normal((b, h, w, c)))
    k1, k2 = ((rng.standard_normal((3, 3, c, c)) * 0.06).astype(np.float32) for _ in range(2))
    if style == "adain":
        gamma = (rng.standard_normal((b, c)) * 0.3).astype(np.float32)
        beta = (rng.standard_normal((b, c)) * 0.3).astype(np.float32)
    else:
        gamma = beta = np.zeros((b, c), np.float32)
    a1, a2 = 3.5, 2.9
    yj = jq.int8_resblock(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(k1), jnp.asarray(k2),
                          a1, a2, jnp.asarray(gamma), jnp.asarray(beta))
    assert yj.dtype == jnp.bfloat16
    q1 = kq.quant_conv(torch.from_numpy(_conv(k1)), None, a1, 1, "reflect")
    q2 = kq.quant_conv(torch.from_numpy(_conv(k2)), None, a2, 1, "reflect")
    y = kq.resblock(_nchw_bf16(x), q1, q2, torch.from_numpy(gamma), torch.from_numpy(beta))
    assert y.dtype == torch.bfloat16
    ref = _f32(yj)
    diff = np.abs(_nhwc(y) - ref)
    step = np.maximum(np.abs(ref), 2.0**-8) * 2.0**-7  # one bf16 step of each value
    assert (diff > step).mean() <= 0.03, f"{(diff > step).mean():.4f} of outputs differ"
    assert diff.max() <= 6e-2, diff.max()


@pytest.mark.parametrize("bias", [False, True])
def test_head_bf16_matches_jax(bias):
    """The head on JAX's CPU route in bf16: apply_pending to bf16, the bf16
    1x1 conv, the bf16 bias add and tanh."""
    rng = np.random.default_rng(5)
    b, h, w, c, co = 2, 6, 7, 24, 3
    x = _bf16(rng.standard_normal((b, h, w, c)))
    p = _pending(rng, b, c, True, 0.0)
    wt = (rng.standard_normal((c, co)) * 0.3).astype(np.float32)
    bb = (rng.standard_normal(co) * 0.2).astype(np.float32) if bias else None
    y = jax_apply_pending(jnp.asarray(x).astype(jnp.bfloat16), p, jnp.bfloat16)
    y = jax.lax.conv_general_dilated(y, jnp.asarray(wt)[None, None].astype(jnp.bfloat16), (1, 1),
                                     "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    if bias:
        y = y + jnp.asarray(bb).astype(jnp.bfloat16)
    ref = _f32(jnp.tanh(y))
    got = khead.head(_nchw_bf16(x), _torch_pending(p), torch.from_numpy(wt.T.copy()),
                     None if bb is None else torch.from_numpy(bb))
    assert got.dtype == torch.bfloat16
    diff = np.abs(_nhwc(got) - ref)
    assert diff.max() <= khead.BF16_TOL, diff.max()
    assert (diff > 0).mean() <= 0.05, (diff > 0).mean()


def test_head_bf16_plain_rounds_its_operands():
    """The f32 head keeps its f32 arithmetic; the bf16 one equals the f32
    arithmetic on bf16-rounded operands, rounded at each step."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 5, 4, 3)).astype(np.float32))
    p = _torch_pending(_pending(rng, 1, 5, True, 0.0))
    wt = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32) * 0.3)
    bb = torch.from_numpy(rng.standard_normal(2).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = khead.head_plain(xb, p, wt, bb)
    v = (xb.float() * p.scale[:, :, None, None] + p.shift[:, :, None, None]).relu()
    v = v.to(torch.bfloat16).float()
    s = torch.einsum("bchw,oc->bohw", v, wt.to(torch.bfloat16).float()).to(torch.bfloat16)
    want = torch.tanh(s + bb.to(torch.bfloat16)[:, None, None])
    torch.testing.assert_close(got, want, rtol=0, atol=khead.BF16_TOL / 2)
    assert khead.head_plain(x, p, wt, bb).dtype == torch.float32


# ------------------------------------------------------------- the models --


def _jax_int8(jm, params, inputs):
    quant = jm.calibrate_int8(SimpleNamespace(params=params), inputs.calib,
                              c_trgs=inputs.c_trgs, rng=jax.random.PRNGKey(9))
    return jax.tree_util.tree_map(np.asarray, quant)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    calib = [rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    c_trgs = [np.eye(K, dtype=np.float32)[[0, 2]], np.eye(K, dtype=np.float32)[[3, 1]]]
    key, zs = jax.random.PRNGKey(9), []
    for img in calib:  # the draws JAX's calibrate_int8 makes: split(rng, 3), z from kz
        key, kz, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(kz, (img.shape[0], LATENT), jnp.float32)))
    return SimpleNamespace(
        img=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        z=rng.standard_normal((B, LATENT)).astype(np.float32),
        c=np.eye(K, dtype=np.float32)[[1, 3]], calib=calib, c_trgs=c_trgs, zs=zs,
    )


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


MODELS = {
    "AdaINModel": (JaxAdaINModel, AdaINModel, {}),
    "BaseModel_B": (JaxBaseModel, BaseModel, dict(concat=True, reparam=True)),
}


@pytest.fixture(scope="module", params=list(MODELS))
def bf16_setup(request, inputs):
    """One model at bf16 in both packages on one JAX param tree, the JAX one
    calibrated to int8 and the port loaded with its amax tree; with JAX's
    float bf16 forward of ``inputs`` and its int8 one, eager (each op rounds
    to bf16: the CPU route's rounding points) and jitted (XLA may keep f32
    between fused bf16 ops)."""
    jax_cls, port_cls, flags = MODELS[request.param]
    jm = jax_cls(jax_test_args(compute_dtype="bfloat16", **flags, **SHAPE))
    params = _perturb(jax.tree_util.tree_map(np.asarray, initialized(jm).params),
                      np.random.default_rng(1))
    ref_float = _f32(jm._forward_random_jit(params, inputs.img, inputs.z, inputs.c))
    quant = _jax_int8(jm, params, inputs)
    ref_int8 = _f32(jm._forward_random_impl(params, inputs.img, inputs.z, inputs.c))
    ref_int8_jit = _f32(jm._forward_random_jit(params, inputs.img, inputs.z, inputs.c))
    tm = port_cls(default_test_args(compute_dtype="bfloat16", **flags, **SHAPE), device="cpu")
    tm.load_params(params_from_jax(params, tm))
    return SimpleNamespace(name=request.param, tm=tm, quant=quant, ref_float=ref_float,
                           ref_int8=ref_int8, ref_int8_jit=ref_int8_jit)


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(4.0 / max(mse, 1e-12))


def _spread_close(out, ref, ref_jit):
    """A bf16 int8 forward against JAX's eager one (``ref``), by the
    spread of JAX's own two evaluations (``ref_jit``, jitted): PSNR within
    1 dB of JAX's against itself, and the largest difference within the
    larger of the bf16 forward bound and 1.5 times JAX's (one pair of
    evaluations samples the largest difference of a few thousand outputs
    only roughly)."""
    spread = float(np.abs(ref_jit - ref).max())
    bound = max(BF16_FORWARD_TOL * max(1.0, float(np.abs(ref).max())), 1.5 * spread)
    assert np.abs(out - ref).max() <= bound, (np.abs(out - ref).max(), bound)
    assert _psnr(out, ref) >= min(_psnr(ref_jit, ref) - 1.0, 60.0), (
        _psnr(out, ref), _psnr(ref_jit, ref))


def test_bf16_int8_forward_matches_jax(bf16_setup, inputs):
    """The port's bf16 int8 forward against JAX's eager one. A bf16 rounding
    step that moves a value across an int8 rounding boundary changes it by
    a whole int8 step, so the forward spreads: JAX's own jitted and eager
    evaluations of the same forward differ by up to 0.18 here (about 39 dB
    for AdaINModel, 47 dB for BaseModel B); :func:`_spread_close` holds the
    port to that spread."""
    s = bf16_setup
    assert np.abs(s.ref_int8 - s.ref_float).max() > 1e-3, "the JAX forward must be int8"
    s.tm.load_int8(quant_from_jax(s.quant, s.tm))
    try:
        out, _, _ = s.tm.forward_random(inputs.img, inputs.z, inputs.c)
    finally:
        s.tm.disable_int8()
    assert out.dtype == torch.bfloat16 and out.shape == (B, SIZE, SIZE, 3)
    _spread_close(out.float().numpy(), s.ref_int8, s.ref_int8_jit)


def test_bf16_calibration_runs_in_bf16_and_beats_25_db(bf16_setup, inputs):
    """The port's own calibration at bf16 (the amax of bf16 activations),
    within four bf16 steps (2^-5 relative) of JAX's jitted calibration,
    whose forward keeps f32 between fused ops, and the int8 forward above
    the JAX test's 25 dB against the float bf16 forward."""
    s = bf16_setup
    ref, _, _ = s.tm.forward_random(inputs.img, inputs.z, inputs.c)
    tree = s.tm.calibrate_int8(inputs.calib, inputs.c_trgs, inputs.zs)
    try:
        out, _, _ = s.tm.forward_random(inputs.img, inputs.z, inputs.c)
    finally:
        s.tm.disable_int8()
    for net, want in quant_from_jax(s.quant, s.tm).items():
        for key, value in want.items():
            assert abs(tree[net][key].item() - value.item()) <= 2.0**-5 * value.item(), (net, key)
    assert out.dtype == torch.bfloat16
    assert _psnr(out.float().numpy(), ref.float().numpy()) > 25.0


# ------------------------------------------------------- --dec_norm instance --


@pytest.fixture(scope="module")
def instance_setups(inputs):
    """AdaINModel with ``--dec_norm instance`` in f32 and bf16: the JAX
    model calibrated to int8 on one param tree (its int8 forward jitted,
    and at bf16 also eager), the port with its amax."""
    out = {}
    params = None
    for dtype in ("float32", "bfloat16"):
        jm = JaxAdaINModel(jax_test_args(compute_dtype=dtype, dec_norm="instance", **SHAPE))
        if params is None:
            params = _perturb(jax.tree_util.tree_map(np.asarray, initialized(jm).params),
                              np.random.default_rng(2))
        ref_float = _f32(jm._forward_random_jit(params, inputs.img, inputs.z, inputs.c))
        quant = _jax_int8(jm, params, inputs)
        ref = _f32(jm._forward_random_jit(params, inputs.img, inputs.z, inputs.c))
        eager = None
        if dtype == "bfloat16":
            eager = _f32(jm._forward_random_impl(params, inputs.img, inputs.z, inputs.c))
        tm = AdaINModel(default_test_args(compute_dtype=dtype, dec_norm="instance", **SHAPE),
                        device="cpu")
        tm.load_params(params_from_jax(params, tm))
        tm.load_int8(quant_from_jax(quant, tm))
        out[dtype] = SimpleNamespace(tm=tm, ref=ref, eager=eager, ref_float=ref_float)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_instance_dec_norm_matches_jax(instance_setups, inputs, dtype, monkeypatch):
    s = instance_setups[dtype]
    assert np.abs(s.ref - s.ref_float).max() > 1e-3, "the JAX forward must be int8"
    calls, real = [], kq.deconv
    monkeypatch.setattr(kq, "deconv", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out, _, _ = s.tm.forward_random(inputs.img, inputs.z, inputs.c)
    assert len(calls) == 2, "the decoder tail's transposed convs run int8"
    out = out.float().numpy()
    diff = np.abs(out - s.ref)
    if dtype == "float32":  # tests/test_torch_int8.py _forward_close
        assert diff.max() <= 2e-2, diff.max()
        assert (diff > 1e-4).mean() <= 0.05, (diff > 1e-4).mean()
    else:
        _spread_close(out, s.eager, s.ref)
    assert _psnr(out, s.ref_float) > 25.0
