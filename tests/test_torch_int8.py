"""The port's int8 serving path against the JAX package's, on the CPU.

The JAX side runs its off-TPU int8 path (the jnp integer convs that its
Pallas kernels are held to); the port runs its kernels' plain versions.
Inputs and weights come from numpy seeds; the model tests use one JAX
``AdaINModel.initialize()`` tree (crop 32, dim 8, latent 4, 4 domains, B=2)
carried over by ``params_from_jax``, and JAX's calibrated amax tree carried
over by ``quant_from_jax``.

Tolerances:
- quantized operands and int32 accumulators: exact, given the same input
  and prologue affine;
- dequantized outputs of one conv: exact too when the accumulators are (the
  same two rounded f32 operations); their (sum, sumsq) within 2e-5 of
  sum(|y|) and sum(y^2), for sums taken in another order;
- a resblock and the whole forward: the second conv's prologue affine comes
  from those sums, so a value that lands within an ulp of a .5 rounding
  boundary can round the other way (a "flip": one int8 step). Each test
  counts the outputs that differ and bounds the largest difference.
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
from masterthesis_tpu.ops.pallas import conv_int8 as jq
from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import moments as kmoments
from masterthesis_tpu_torch.tools.convert_jax import (
    _conv,
    _conv_transpose,
    params_from_jax,
    quant_from_jax,
)

torch.set_num_threads(2)

SIZE, B, K, LATENT = 32, 2, 4, 4
SHAPE = dict(crop_size=SIZE, dim=8, latent_dim=LATENT, num_domains=K, batch_size=B, init_type=None)


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _pending(rng, b, c, relu, alpha):
    return {
        "scale": (rng.uniform(0.5, 1.5, (b, c))).astype(np.float32),
        "shift": (rng.standard_normal((b, c)) * 0.3).astype(np.float32),
        "relu": relu, "alpha": alpha,
    }


def _torch_pending(p):
    if p is None:
        return None
    return {**p, "scale": torch.from_numpy(p["scale"]), "shift": torch.from_numpy(p["shift"])}


def _jax_prologue(x, p):
    if p is None:
        return jnp.asarray(x)
    y = jnp.asarray(x) * p["scale"][:, None, None, :] + p["shift"][:, None, None, :]
    return jnp.maximum(y, p["alpha"] * y) if p["relu"] else y


def _assert_stats(got, want, y):
    """(sum, sumsq) in another summation order."""
    yy = np.asarray(y, np.float64)
    for g, w, scale in ((got[0], want[0], np.abs(yy).sum(axis=(1, 2))),
                        (got[1], want[1], (yy * yy).sum(axis=(1, 2)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5 * float(scale.max()) + 1e-6)


# ------------------------------------------------------------- quantize --


@pytest.mark.parametrize("amax", [0.37, 1.0, 3.3, 1e-20])
def test_quantize_act_matches_jax(amax):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32) * 1.3
    # values on the .5 boundaries of the grid, where rounding must be half-even
    x[0, 0, :, 0] = (np.arange(7) - 3 + 0.5) * np.float32(amax) / 127
    qj, sj = jq.quantize_act(jnp.asarray(x), amax)
    qt, st = kq.quantize_act(torch.from_numpy(x), amax)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt.dtype == torch.int8
    assert st.item() == float(sj)


@pytest.mark.parametrize("which", ["conv", "deconv"])
def test_quantize_weight_matches_jax(which):
    rng = np.random.default_rng(1)
    k = (rng.standard_normal((3, 3, 6, 5)) * 0.05).astype(np.float32)
    k[..., 2] = 0.0  # an all-zero output channel: amax clamps to 1e-12
    qj, sj = jq.quantize_weight(jnp.asarray(k))
    if which == "conv":
        qt, st = kq.quantize_weight(torch.from_numpy(_conv(k)), out_dim=0)
        back = qt.permute(2, 3, 1, 0).numpy()  # OIHW -> HWIO
    else:
        qt, st = kq.quantize_weight(torch.from_numpy(_conv_transpose(k).copy()), out_dim=1)
        back = qt.flip(2, 3).permute(2, 3, 0, 1).numpy()  # IOHW, flipped -> HWIO
    np.testing.assert_array_equal(back, np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# ----------------------------------------------------------------- convs --

DOWN_CASES = [  # (pending relu, alpha, padding)
    (None, 0.0, "reflect"),
    (True, 0.01, "reflect"),  # the stem's deferred IN + lrelu into down0
    (True, 0.0, None),  # zero padding
    (False, 0.0, "reflect"),
]


@pytest.mark.parametrize("relu,alpha,padding", DOWN_CASES)
def test_downconv_matches_jax(relu, alpha, padding):
    rng = np.random.default_rng(2)
    b, h, w, c, co = 2, 12, 10, 12, 20
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.2).astype(np.float32)
    p = None if relu is None else _pending(rng, b, c, relu, alpha)
    amax = 2.1
    # JAX: the off-TPU int8_conv3x3 with its accumulators
    pk = {} if p is None else dict(prologue_scale=p["scale"], prologue_shift=p["shift"],
                                   prologue_relu=relu, prologue_alpha=alpha)
    yj, s1j, s2j = jq.int8_conv3x3(jnp.asarray(x), jnp.asarray(k), amax, jnp.asarray(bias),
                                   padding_type=padding or "zero", out_dtype=jnp.float32,
                                   stride=2, with_stats=True, **pk)
    xqj, _ = jq.quantize_act(_jax_prologue(x, p), amax)
    accj = jq.jnp_int8_conv(xqj, jq.quantize_weight(jnp.asarray(k))[0], padding or "zero", 2)
    # the port
    qc = kq.quant_conv(torch.from_numpy(_conv(k)), torch.from_numpy(bias), amax, 2, padding)
    xt, pt = _nchw(x), _torch_pending(p)
    xq = kq.quant_pad_plain(xt, qc, pt)
    assert xq.shape == (b, h + 2, w + 2, qc.cp) and qc.cp == 32
    np.testing.assert_array_equal(xq[:, 1:-1, 1:-1, :c].numpy(), np.asarray(xqj))
    assert not xq[..., c:].any()
    acc = kq.conv_acc_plain(xq, qc)
    np.testing.assert_array_equal(_nhwc(acc), np.asarray(accj))
    y, s1, s2 = kq.downconv(xt, qc, pt, with_stats=True)
    np.testing.assert_array_equal(_nhwc(y), np.asarray(yj))
    _assert_stats((s1, s2), (s1j, s2j), yj)


@pytest.mark.parametrize("prologue", [False, True])
def test_deconv_matches_jax(prologue):
    rng = np.random.default_rng(3)
    b, h, w, c, co = 2, 6, 5, 16, 12
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.2).astype(np.float32)
    p = _pending(rng, b, c, True, 0.0) if prologue else None
    amax = 1.7
    pk = {} if p is None else dict(prologue_scale=p["scale"], prologue_shift=p["shift"],
                                   prologue_relu=True)
    yj, s1j, s2j = jq.int8_deconv(jnp.asarray(x), jnp.asarray(k), amax, jnp.asarray(bias),
                                  out_dtype=jnp.float32, with_stats=True, **pk)
    xqj, _ = jq.quantize_act(_jax_prologue(x, p), amax)
    accj = jq.jnp_int8_deconv(xqj, jq.subpixel_weights(jq.quantize_weight(jnp.asarray(k))[0]))
    qc = kq.quant_deconv(torch.from_numpy(_conv_transpose(k).copy()), torch.from_numpy(bias), amax)
    xt, pt = _nchw(x), _torch_pending(p)
    xq = kq.quant_pad_plain(xt, qc, pt)
    np.testing.assert_array_equal(xq[:, :-1, :-1, :c].numpy(), np.asarray(xqj))
    acc = kq._interleave(kq.conv_acc_plain(xq, qc), 4)
    np.testing.assert_array_equal(_nhwc(acc), np.asarray(accj))
    y, s1, s2 = kq.deconv(xt, qc, pt, with_stats=True)
    assert y.shape == (b, co, 2 * h, 2 * w)
    np.testing.assert_array_equal(_nhwc(y), np.asarray(yj))
    # JAX's per-phase (B, 4Co) sums, added over the phases
    want = [np.asarray(s).reshape(b, 4, co).sum(axis=1) for s in (s1j, s2j)]
    _assert_stats((s1, s2), want, yj)


@pytest.mark.parametrize("kind", ["conv", "deconv"])
def test_statistics_are_exact_and_order_free(kind):
    """(sum, sumsq) come from exact integer sums (the kernel's Numerics note):
    the same bits for any order of the pixels, and within an f32 rounding of
    the f64 moments of acc * scale + bias."""
    rng = np.random.default_rng(6)
    b, h, w, c, co = 2, 9, 7, 24, 10
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(co) * 0.5).astype(np.float32))
    if kind == "conv":
        qc = kq.quant_conv(torch.from_numpy((rng.standard_normal((co, c, 3, 3)) * 0.1).astype(
            np.float32)), bias, 2.0, 2, "reflect")
    else:
        qc = kq.quant_deconv(torch.from_numpy((rng.standard_normal((c, co, 3, 3)) * 0.1).astype(
            np.float32)), bias, 2.0)
    acc = kq.conv_acc_plain(kq.quant_pad_plain(x, qc), qc)
    s, sq = kq.stats_plain(acc, qc)
    perm = torch.from_numpy(rng.permutation(acc.shape[2] * acc.shape[3]))
    shuffled = acc.flatten(2)[:, :, perm].reshape(acc.shape)
    s2, sq2 = kq.stats_plain(shuffled, qc)
    assert torch.equal(s, s2) and torch.equal(sq, sq2)
    v = acc.double() * qc.scale.double()[:, None, None] + qc.bias.double()[:, None, None]
    want_s = v.sum(dim=(2, 3)).reshape(b, qc.phases, co).sum(dim=1)
    want_q = (v * v).sum(dim=(2, 3)).reshape(b, qc.phases, co).sum(dim=1)
    np.testing.assert_allclose(s.numpy(), want_s.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sq.numpy(), want_q.numpy(), rtol=1e-6)


@pytest.mark.parametrize("style", ["instance", "adain"])
def test_resblock_matches_jax(style):
    rng = np.random.default_rng(4)
    b, h, w, c = 2, 8, 8, 32
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k1, k2 = ((rng.standard_normal((3, 3, c, c)) * 0.06).astype(np.float32) for _ in range(2))
    if style == "adain":
        gamma = (rng.standard_normal((b, c)) * 0.3).astype(np.float32)
        beta = (rng.standard_normal((b, c)) * 0.3).astype(np.float32)
    else:
        gamma = beta = np.zeros((b, c), np.float32)
    a1, a2 = 3.5, 2.9
    yj = np.asarray(jq.int8_resblock(jnp.asarray(x), jnp.asarray(k1), jnp.asarray(k2), a1, a2,
                                     jnp.asarray(gamma), jnp.asarray(beta)))
    q1 = kq.quant_conv(torch.from_numpy(_conv(k1)), None, a1, 1, "reflect")
    q2 = kq.quant_conv(torch.from_numpy(_conv(k2)), None, a2, 1, "reflect")
    y = _nhwc(kq.resblock(_nchw(x), q1, q2, torch.from_numpy(gamma), torch.from_numpy(beta)))
    # O(1) outputs; a flip moves one value by about one int8 step through
    # conv2 and the norm: at most 2 % of the outputs and 0.05 each
    diff = np.abs(y - yj)
    assert (diff > 1e-4).mean() <= 0.02, f"{(diff > 1e-4).mean():.4f} of outputs differ"
    assert diff.max() <= 5e-2, diff.max()


# ----------------------------------------------------------- the model --


@pytest.fixture(scope="module")
def setup():
    """The JAX model calibrated on two batches, and the port on the same
    weights: (jax model, params, port model, inputs, jax draws)."""
    jm = JaxAdaINModel(jax_test_args(**SHAPE))
    params = jax.tree_util.tree_map(np.asarray, jm.initialize().params)
    rng = np.random.default_rng(0)
    params = _perturb(params, rng)
    tm = AdaINModel(default_test_args(**SHAPE), device="cpu")
    tm.load_params(params_from_jax(params, tm))
    inputs = dict(
        img=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        ref=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        z=rng.standard_normal((B, LATENT)).astype(np.float32),
        c=np.eye(K, dtype=np.float32)[[1, 3]],
    )
    calib = [rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    c_trgs = [np.eye(K, dtype=np.float32)[[0, 2]], np.eye(K, dtype=np.float32)[[3, 1]]]
    # the draws calibrate_int8 makes: split(rng, 3) per batch, z from kz
    key, zs = jax.random.PRNGKey(9), []
    for img in calib:
        key, kz, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jm.get_z_random(kz, img.shape[0])))
    ref_float = np.asarray(jm._forward_random_jit(params, inputs["img"], inputs["z"], inputs["c"]))
    quant = jm.calibrate_int8(SimpleNamespace(params=params), calib, c_trgs=c_trgs,
                              rng=jax.random.PRNGKey(9))
    quant = jax.tree_util.tree_map(np.asarray, quant)
    return SimpleNamespace(jm=jm, params=params, tm=tm, inputs=inputs, calib=calib,
                           c_trgs=c_trgs, zs=zs, quant=quant, ref_float=ref_float)


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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = float(np.asarray(v))
    return out


def test_calibrated_amax_tree_matches_jax(setup):
    s = setup
    tree = s.tm.calibrate_int8(s.calib, s.c_trgs, s.zs)
    try:
        assert set(tree) == set(s.quant) == {"content_encoder", "decoder"}
        for net in tree:
            want = _flat(s.quant[net])
            got = {k: v.item() for k, v in tree[net].items()}
            assert set(got) == set(want), net
            for key, value in want.items():
                assert value > 0
                assert abs(got[key] - value) <= 1e-5 * value, (net, key, got[key], value)
        assert len(tree["content_encoder"]) == 11 and len(tree["decoder"]) == 10
    finally:
        s.tm.disable_int8()


@pytest.fixture
def int8_model(setup):
    setup.tm.load_int8(quant_from_jax(setup.quant, setup.tm))
    yield setup.tm
    setup.tm.disable_int8()


def _forward_close(out, ref):
    """tanh outputs: a flip upstream moves an output by far less than an
    int8 step of the image; bound the largest difference and the share of
    outputs that differ at all."""
    diff = np.abs(out - ref)
    assert diff.max() <= 2e-2, diff.max()
    assert (diff > 1e-4).mean() <= 0.05, (diff > 1e-4).mean()


def test_int8_forward_random_matches_jax(setup, int8_model):
    s = setup
    ref = np.asarray(s.jm._forward_random_jit(s.params, s.inputs["img"], s.inputs["z"],
                                              s.inputs["c"]))
    out, _, _ = int8_model.forward_random(s.inputs["img"], s.inputs["z"], s.inputs["c"])
    assert out.shape == (B, SIZE, SIZE, 3)
    assert np.abs(ref - s.ref_float).max() > 1e-3, "the JAX forward must be int8 to test anything"
    _forward_close(out.numpy(), ref)


def test_int8_forward_reference_matches_jax(setup, int8_model):
    s = setup
    key = jax.random.PRNGKey(5)
    z, mu, logvar = s.jm.encode_style(s.params, s.inputs["ref"], s.inputs["c"], key, sample=True)
    eps = ((np.asarray(z) - np.asarray(mu)) / np.exp(0.5 * np.asarray(logvar))).astype(np.float32)
    ref = np.asarray(s.jm._forward_reference_jit(s.params, s.inputs["img"], s.inputs["ref"],
                                                 s.inputs["c"], key))
    out, _, _ = int8_model.forward_reference(s.inputs["img"], s.inputs["ref"], s.inputs["c"],
                                             eps=eps)
    _forward_close(out.numpy(), ref)


def test_int8_forward_is_close_to_float(setup):
    """The JAX test's bar (tests/test_int8_serving.py): > 25 dB PSNR against
    the float forward, with the port's own calibration."""
    s = setup
    ref, _, _ = s.tm.forward_random(s.inputs["img"], s.inputs["z"], s.inputs["c"])
    s.tm.calibrate_int8(s.calib, s.c_trgs, s.zs)
    try:
        out, _, _ = s.tm.forward_random(s.inputs["img"], s.inputs["z"], s.inputs["c"])
    finally:
        s.tm.disable_int8()
    mse = float(((out - ref) ** 2).mean())
    assert 10 * np.log10(4.0 / max(mse, 1e-12)) > 25.0


def test_int8_with_instance_dec_norm_serves(setup, monkeypatch):
    """``--dec_norm instance``: no LayerNorm to defer, so the decoder tail
    runs its int8 transposed convs with float norms and a float head; the
    JAX test's bar (tests/test_int8_serving.py:75), > 25 dB PSNR."""
    s = setup
    tm = AdaINModel(default_test_args(dec_norm="instance", seed=3, **SHAPE), device="cpu")
    args = (s.inputs["img"], s.inputs["z"], s.inputs["c"])
    ref, _, _ = tm.forward_random(*args)
    tm.calibrate_int8(s.calib, s.c_trgs, s.zs)
    calls, real = [], kq.deconv
    monkeypatch.setattr(kq, "deconv", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out, _, _ = tm.forward_random(*args)
    assert len(calls) == 2 and out.shape == ref.shape and torch.isfinite(out).all()
    mse = float(((out - ref) ** 2).mean())
    assert 10 * np.log10(4.0 / max(mse, 1e-12)) > 25.0


def test_disable_int8_restores_the_float_output(setup):
    s = setup
    args = (s.inputs["img"], s.inputs["z"], s.inputs["c"])
    ref, _, _ = s.tm.forward_random(*args)
    s.tm.calibrate_int8(s.calib, s.c_trgs, s.zs)
    q, _, _ = s.tm.forward_random(*args)
    s.tm.disable_int8()
    back, _, _ = s.tm.forward_random(*args)
    assert not torch.equal(q, ref)
    torch.testing.assert_close(back, ref, rtol=0, atol=0)
    np.testing.assert_allclose(ref.numpy(), s.ref_float, rtol=0, atol=1e-4)


def test_load_params_requantizes_the_new_weights(setup, int8_model):
    s = setup
    args = (s.inputs["img"], s.inputs["z"], s.inputs["c"])
    before, _, _ = int8_model.forward_random(*args)
    sds = params_from_jax(s.params, int8_model)
    sds["decoder"] = {k: v * 0.5 if k.endswith("dec1_0.conv2.conv.weight") else v
                      for k, v in sds["decoder"].items()}
    int8_model.load_params(sds)
    try:
        changed, _, _ = int8_model.forward_random(*args)
        assert int8_model.quant is not None and not torch.equal(before, changed)
    finally:
        int8_model.load_params(params_from_jax(s.params, int8_model))
    again, _, _ = int8_model.forward_random(*args)
    torch.testing.assert_close(again, before, rtol=0, atol=0)


def test_quant_from_jax_raises_on_a_missing_or_extra_leaf(setup):
    s = setup
    enc = dict(s.quant["content_encoder"])
    del enc["down1"]
    with pytest.raises(KeyError, match="down1"):
        quant_from_jax({**s.quant, "content_encoder": enc}, s.tm)
    extra = {**s.quant["decoder"], "head": {"conv": {"amax_in": np.float32(1.0)}}}
    with pytest.raises(KeyError, match="head/conv/amax_in"):
        quant_from_jax({**s.quant, "decoder": extra}, s.tm)


def test_int8_needs_compute_dtype_float32(setup):
    tm = AdaINModel(default_test_args(compute_dtype="bfloat16", **SHAPE), device="cpu")
    with pytest.raises(NotImplementedError, match="float32"):
        tm.calibrate_int8(setup.calib, setup.c_trgs, setup.zs)


@pytest.mark.parametrize("entry", ["forward_random", "forward_reference"])
def test_every_int8_conv_goes_through_the_kernel_wrappers(setup, int8_model, entry, monkeypatch):
    """Per int8 forward: 2 down convs, 8 resblocks (4 encoder, 4 AdaIN),
    2 transposed convs and 1 head go through the four int8 wrappers, and the
    only norm statistics pass left is the stem's, one moments call. The card
    counts the same launches (chip_smoke.py)."""
    calls = dict.fromkeys(("downconv", "resblock", "deconv", "head", "moments"), 0)

    def counting(module, name):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    for name in ("downconv", "resblock", "deconv"):
        counting(kq, name)
    counting(khead, "head")
    counting(kmoments, "moments")
    s = setup
    if entry == "forward_random":
        int8_model.forward_random(s.inputs["img"], s.inputs["z"], s.inputs["c"])
    else:
        int8_model.forward_reference(s.inputs["img"], s.inputs["ref"], s.inputs["c"])
    assert calls == {"downconv": 2, "resblock": 8, "deconv": 2, "head": 1, "moments": 1}
