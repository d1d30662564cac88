"""The port's BaseModel and its int8 stride-1 conv (kernel 4) against the JAX
package's, on the CPU.

Two configurations at a small size (crop 32, dim 8, latent 4, 4 domains,
B=2): A, the CLI default (plain style encoder, ``Decoder`` with
``DecResnetBlock``s), and B, ``--concat --reparam`` (``DecoderConcat``, whose
40/44/26/17-channel convs are not multiples of 32 here, as 268/276/146/81
are not at full width). One param tree per configuration (the port's
seeded init in the JAX layout, biases and LayerNorm affines redrawn from a
numpy seed) drives both packages, carried into the port by
``params_from_jax``; JAX's calibrated amax tree by ``quant_from_jax``.

Tolerances:
- kernel 4's plain version against JAX ``int8_conv3x3``: int8 operands and
  int32 sums equal; y within 1e-6 (the same two rounded f32 operations);
  (sum, sumsq) within 1e-5 of sum(|y|) and sum(y^2), JAX summing y in f32;
- float forwards as ``tests/test_torch_model.py``: f32 within 1e-4, bf16
  within 5e-2, of max(1, max|reference|);
- int8 forwards as ``tests/test_torch_int8.py`` ``_forward_close``: at most
  5 % of outputs moved by more than 1e-4, none by more than 2e-2 (a value
  at a .5 rounding boundary can flip between the packages' statistics);
  amax trees within 1e-5 relative.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_test_args as jax_test_args
from masterthesis_tpu.arguments import default_train_args as jax_train_args
from masterthesis_tpu.models import BaseModel as JaxBaseModel
from masterthesis_tpu.ops.pallas import conv_int8 as jq
from masterthesis_tpu_torch.arguments import default_test_args, default_train_args
from masterthesis_tpu_torch.models import BaseModel
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import moments as kmoments
from masterthesis_tpu_torch.tools.convert_jax import _conv, params_from_jax, quant_from_jax

torch.set_num_threads(2)

SIZE, B, K, LATENT = 32, 2, 4, 4
SHAPE = dict(crop_size=SIZE, dim=8, latent_dim=LATENT, num_domains=K, batch_size=B, init_type=None)
CONFIGS = {"A": {}, "B": dict(concat=True, reparam=True)}
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# kernel launches per forward, as the JAX package routes them, but for B's
# int8 head: the port hands dec3's LayerNorm and relu, and z's share of the
# 1x1 sum, to kernel 8, where the JAX package concatenates z before a float conv
ROUTES = {
    ("A", "float"): dict(moments=21, adain=0, downconv=0, resblock=0, conv3x3=0, deconv=0, head=0),
    ("A", "int8"): dict(moments=9, adain=0, downconv=2, resblock=4, conv3x3=8, deconv=2, head=1),
    ("B", "float"): dict(moments=21, adain=0, downconv=0, resblock=0, conv3x3=0, deconv=0, head=0),
    ("B", "int8"): dict(moments=1, adain=0, downconv=2, resblock=8, conv3x3=0, deconv=2, head=1),
}


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _f32(a):
    return np.asarray(a.astype(np.float32) if hasattr(a, "astype") else a, np.float32)


# ----------------------------------------------------------------- kernel 4 --

# (padding, prologue relu, alpha, with_stats, C, Co): the prologue cases are
# the deferred IN + relu / lrelu a composed block or chain hands on
CONV3X3_CASES = [
    ("reflect", None, 0.0, False, 32, 32),
    ("zero", None, 0.0, True, 32, 32),
    ("reflect", True, 0.0, True, 32, 64),
    ("reflect", True, 0.01, False, 32, 32),
    ("zero", False, 0.0, True, 32, 32),
    ("reflect", True, 0.0, True, 20, 10),  # unaligned: Cp 32, Co 10
]


def _assert_stats(got, want, y):
    yy = np.asarray(y, np.float64)
    for g, w, scale in ((got[0], want[0], np.abs(yy).sum(axis=(1, 2))),
                        (got[1], want[1], (yy * yy).sum(axis=(1, 2)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * float(scale.max()))


@pytest.mark.parametrize("padding,relu,alpha,stats,c,co", CONV3X3_CASES)
def test_conv3x3_plain_matches_jax(padding, relu, alpha, stats, c, co):
    rng = np.random.default_rng(10)
    b, h, w = 2, 9, 7
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.2).astype(np.float32)
    p = None if relu is None else {
        "scale": rng.uniform(0.5, 1.5, (b, c)).astype(np.float32),
        "shift": (rng.standard_normal((b, c)) * 0.3).astype(np.float32),
        "relu": relu, "alpha": alpha,
    }
    amax = 2.3
    pk = {} if p is None else dict(prologue_scale=p["scale"], prologue_shift=p["shift"],
                                   prologue_relu=relu, prologue_alpha=alpha)
    out_j = jq.int8_conv3x3(jnp.asarray(x), jnp.asarray(k), amax, jnp.asarray(bias),
                            padding_type=padding, out_dtype=jnp.float32, with_stats=stats, **pk)
    pre = jnp.asarray(x)
    if p is not None:
        pre = pre * p["scale"][:, None, None, :] + p["shift"][:, None, None, :]
        pre = jnp.maximum(pre, alpha * pre) if relu else pre
    xqj, _ = jq.quantize_act(pre, amax)
    accj = jq.jnp_int8_conv(xqj, jq.quantize_weight(jnp.asarray(k))[0], padding)

    qc = kq.quant_conv(torch.from_numpy(_conv(k)), torch.from_numpy(bias), amax, 1,
                       None if padding == "zero" else padding)
    tp = None if p is None else kq.Pending(torch.from_numpy(p["scale"]),
                                           torch.from_numpy(p["shift"]), relu, alpha)
    xq = kq.quant_pad_plain(_nchw(x), qc, tp)
    assert xq.shape == (b, h + 2, w + 2, 32)
    np.testing.assert_array_equal(xq[:, 1:-1, 1:-1, :c].numpy(), np.asarray(xqj))
    assert not xq[..., c:].any()
    np.testing.assert_array_equal(_nhwc(kq.conv_acc_plain(xq, qc)), np.asarray(accj))
    out = kq.conv3x3(_nchw(x), qc, tp, with_stats=stats)
    y, yj = (out[0], out_j[0]) if stats else (out, out_j)
    assert y.shape == (b, co, h, w)
    np.testing.assert_allclose(_nhwc(y), np.asarray(yj), rtol=0, atol=1e-6)
    if stats:
        _assert_stats(out[1:], out_j[1:], yj)


@pytest.mark.parametrize("padding,c,co", [("reflect", 32, 32), ("zero", 20, 10)])
def test_conv3x3_plain_matches_the_pallas_kernel(padding, c, co):
    """The TPU kernel in interpret mode (the unaligned case through its
    128-lane padding branch), with prologue and statistics."""
    rng = np.random.default_rng(11)
    b, h, w = 2, 8, 8
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.2).astype(np.float32)
    pa = rng.uniform(0.5, 1.5, (b, c)).astype(np.float32)
    pb = (rng.standard_normal((b, c)) * 0.3).astype(np.float32)
    amax = 1.9
    yj, s1j, s2j = jq.int8_conv3x3(
        jnp.asarray(x), jnp.asarray(k), amax, jnp.asarray(bias), padding_type=padding,
        out_dtype=jnp.float32, interpret=True, prologue_scale=jnp.asarray(pa),
        prologue_shift=jnp.asarray(pb), prologue_relu=True, with_stats=True)
    qc = kq.quant_conv(torch.from_numpy(_conv(k)), torch.from_numpy(bias), amax, 1,
                       None if padding == "zero" else padding)
    pend = kq.Pending(torch.from_numpy(pa), torch.from_numpy(pb), True, 0.0)
    y, s1, s2 = kq.conv3x3(_nchw(x), qc, pend, with_stats=True)
    np.testing.assert_allclose(_nhwc(y), np.asarray(yj), rtol=0, atol=1e-6)
    _assert_stats((s1, s2), (s1j, s2j), yj)


def test_conv3x3_refuses_other_convs():
    w = torch.zeros(4, 4, 3, 3)
    with pytest.raises(ValueError, match="stride-1"):
        kq.conv3x3(torch.zeros(1, 4, 8, 8), kq.quant_conv(w, None, 1.0, 2, "reflect"))


# ------------------------------------------------------------------ models --


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


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    calib = [rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    c_trgs = [np.eye(K, dtype=np.float32)[[0, 2]], np.eye(K, dtype=np.float32)[[3, 1]]]
    # the draws the JAX calibrate_int8 makes: split(rng, 3) per batch, z from kz
    key, zs = jax.random.PRNGKey(9), []
    for img in calib:
        key, kz, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(kz, (img.shape[0], LATENT), jnp.float32)))
    return SimpleNamespace(
        img=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        ref=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        z=rng.standard_normal((B, LATENT)).astype(np.float32),
        c=np.eye(K, dtype=np.float32)[[1, 3]], calib=calib, c_trgs=c_trgs, zs=zs,
    )


def _jax_tree(model) -> dict:
    """The JAX param tree of the port model's weights: ``params_from_jax``
    inverted (building the JAX nets' own init costs 10-30 s a model here)."""
    tree = {}
    for net_name, net in model.nets.items():
        for key, p in net.state_dict().items():
            mod_name, pname = key.rsplit(".", 1)
            kind = type(net.get_submodule(mod_name)).__name__
            path, a = [net_name, *mod_name.split(".")], p.numpy()
            if kind == "Dense":
                path.append("Dense_0")
            if pname == "weight":
                pname = "kernel"
                if kind == "Dense":
                    a = a.T
                elif kind == "ConvTranspose2d":
                    a = np.transpose(a, (2, 3, 0, 1))[::-1, ::-1]
                else:
                    a = np.transpose(a, (2, 3, 1, 0))
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[pname] = np.ascontiguousarray(a)
    return tree


@pytest.fixture(scope="module")
def setups(inputs):
    """config -> the JAX models (f32, bf16 and a calibrated f32 "int8" one),
    the params (the port's seeded init, biases and affines redrawn), the
    port models (f32, bf16) on the CPU with those weights, and JAX's amax
    tree."""
    out = {}
    for name, flags in CONFIGS.items():
        seeded = BaseModel(default_test_args(seed=3, **flags, **SHAPE), device="cpu")
        params = _perturb(_jax_tree(seeded), np.random.default_rng(0))
        jms = {d: JaxBaseModel(jax_test_args(compute_dtype=d, **flags, **SHAPE))
               for d in (*DTYPES, "int8")}
        tms = {}
        for d in DTYPES:
            tms[d] = BaseModel(default_test_args(compute_dtype=d, **flags, **SHAPE), device="cpu")
            tms[d].load_params(params_from_jax(params, tms[d]))
        ref_float = np.asarray(jms["float32"]._forward_random_impl(params, inputs.img, inputs.z,
                                                                   inputs.c))
        quant = jms["int8"].calibrate_int8(SimpleNamespace(params=params), inputs.calib,
                                           c_trgs=inputs.c_trgs, rng=jax.random.PRNGKey(9))
        quant = jax.tree_util.tree_map(np.asarray, quant)
        out[name] = SimpleNamespace(flags=flags, jms=jms, params=params, tms=tms, quant=quant,
                                    ref_float=ref_float)
    return out


def test_the_jax_tree_round_trips(setups):
    for s in setups.values():
        tm = s.tms["float32"]
        sds = params_from_jax(s.params, tm)
        assert set(s.params) == set(tm.nets)
        for name, net in tm.nets.items():
            assert all(torch.equal(v, sds[name][k]) for k, v in net.state_dict().items())


def _close(got, want, dtype):
    want = _f32(want)
    atol = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_f32(got), want, atol=atol, rtol=0)


def _jax_eps(jm, params, inputs, key):
    """The VAE draw the JAX reference forward makes from ``key``, recovered
    as (z - mu) / exp(logvar / 2)."""
    z, mu, logvar = jm.encode_style(params, inputs.ref, inputs.c, key, sample=True)
    return ((np.asarray(z) - np.asarray(mu)) / np.exp(0.5 * np.asarray(logvar))).astype(np.float32)


def _jax_forward(s, jm, inputs, entry, key=jax.random.PRNGKey(5), jit=False):
    if entry == "forward_random":
        fn = jm._forward_random_jit if jit else jm._forward_random_impl
        return fn(s.params, inputs.img, inputs.z, inputs.c)
    fn = jm._forward_reference_jit if jit else jm._forward_reference_impl
    return fn(s.params, inputs.img, inputs.ref, inputs.c, key)


def _port_forward(s, tm, inputs, entry, key=jax.random.PRNGKey(5)):
    if entry == "forward_random":
        out, _, _ = tm.forward_random(inputs.img, inputs.z, inputs.c)
    else:
        eps = _jax_eps(s.jms["float32"], s.params, inputs, key) if tm.reparam else None
        out, _, _ = tm.forward_reference(inputs.img, inputs.ref, inputs.c, eps=eps)
    return out


@pytest.mark.parametrize("entry", ["forward_random", "forward_reference"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_float_forward_matches_jax(setups, inputs, config, dtype, entry):
    s = setups[config]
    ref = _jax_forward(s, s.jms[dtype], inputs, entry)
    out = _port_forward(s, s.tms[dtype], inputs, entry)
    assert out.shape == (B, SIZE, SIZE, 3) and out.dtype == s.tms[dtype].compute_dtype
    assert np.abs(_f32(ref)).max() > 0.3, "outputs must span the tanh range to test anything"
    _close(out.float().numpy(), ref, dtype)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_only_the_reparameterized_encoder_takes_eps(setups, inputs, config):
    """A's plain style encoder gives (z, None, None) and ignores eps; B's
    gives (z, mu, logvar) and its z moves with eps."""
    tm = setups[config].tms["float32"]
    args = (inputs.img, inputs.ref, inputs.c)
    a, _, _ = tm.forward_reference(*args, eps=np.ones((B, LATENT), np.float32))
    b, _, _ = tm.forward_reference(*args, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        z, mu, logvar = tm.encode_style(_nchw(inputs.ref), torch.from_numpy(inputs.c))
    assert z.shape == (B, LATENT)
    if config == "A":
        assert torch.equal(a, b) and mu is None and logvar is None
    else:
        assert not torch.equal(a, b) and mu.shape == logvar.shape == (B, LATENT)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_calibrated_amax_tree_matches_jax(setups, inputs, config):
    s = setups[config]
    tm = s.tms["float32"]
    tree = tm.calibrate_int8(inputs.calib, inputs.c_trgs, inputs.zs)
    try:
        assert set(tree) == set(s.quant) == {"content_encoder", "decoder"}
        for net in tree:
            want = _flat(s.quant[net])
            got = {k: v.item() for k, v in tree[net].items()}
            assert set(got) == set(want), net
            for key, value in want.items():
                assert value > 0 and abs(got[key] - value) <= 1e-5 * value, (net, key)
        # A: six convs per DecResnetBlock (two 3x3, four 1x1 mix) and two ups;
        # B: two per resblock and two ups (the 1x1 dec4 does not calibrate)
        assert len(tree["decoder"]) == {"A": 26, "B": 10}[config]
    finally:
        tm.disable_int8()


@pytest.fixture
def int8_setup(setups, config):
    s = setups[config]
    s.tms["float32"].load_int8(quant_from_jax(s.quant, s.tms["float32"]))
    yield s
    s.tms["float32"].disable_int8()


@pytest.mark.parametrize("entry", ["forward_random", "forward_reference"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_int8_forward_matches_jax(int8_setup, inputs, config, entry):
    s = int8_setup
    ref = np.asarray(_jax_forward(s, s.jms["int8"], inputs, entry, jit=True))
    if entry == "forward_random":
        assert np.abs(ref - s.ref_float).max() > 1e-3, "the JAX forward must be int8"
    out = _port_forward(s, s.tms["float32"], inputs, entry).numpy()
    assert out.shape == (B, SIZE, SIZE, 3)
    diff = np.abs(out - ref)
    assert diff.max() <= 2e-2, diff.max()
    assert (diff > 1e-4).mean() <= 0.05, (diff > 1e-4).mean()


def _count(monkeypatch, calls, with_stats=None):
    def counting(module, name):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            if with_stats is not None and name == "conv3x3":
                with_stats.append(bool(kw.get("with_stats", a[3] if len(a) > 3 else False)))
            return real(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    for name in ("downconv", "resblock", "conv3x3", "deconv"):
        counting(kq, name)
    counting(khead, "head")
    counting(kmoments, "moments")
    counting(kadain, "adain")


@pytest.mark.parametrize("path", ["float", "int8"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_every_kernel_route_matches_the_jax_routing(setups, inputs, monkeypatch, config, path):
    """Launches per forward of each kernel wrapper, forward_random and
    forward_reference alike (the style encoders have no norm and no int8)."""
    s = setups[config]
    tm = s.tms["float32"]
    if path == "int8":
        tm.load_int8(quant_from_jax(s.quant, tm))
    try:
        for entry in ("forward_random", "forward_reference"):
            calls = dict.fromkeys(ROUTES[config, path], 0)
            _count(monkeypatch, calls)
            _port_forward(s, tm, inputs, entry)
            monkeypatch.undo()
            assert calls == ROUTES[config, path], entry
    finally:
        tm.disable_int8()


def test_int8_with_dropout_composes_through_kernel_4_with_statistics(setups, inputs,
                                                                     monkeypatch):
    """``--use_dropout`` (inert at serving) keeps DecoderConcat's three
    268-wide resblocks off the whole-block kernel, as in the JAX package:
    their six convs run kernel 4 with statistics; the JAX forward with the
    same flag is the reference."""
    s = setups["B"]
    flags = {**s.flags, "use_dropout": True}
    tm = BaseModel(default_test_args(**flags, **SHAPE), device="cpu")
    tm.load_params(params_from_jax(s.params, tm))
    tm.load_int8(quant_from_jax(s.quant, tm))
    jm = JaxBaseModel(jax_test_args(**flags, **SHAPE))
    jm.quant_cols = s.quant  # before the first call traces the jit
    ref = np.asarray(jm._forward_random_jit(s.params, inputs.img, inputs.z, inputs.c))
    calls, stats = dict.fromkeys(ROUTES["B", "int8"], 0), []
    _count(monkeypatch, calls, stats)
    out, _, _ = tm.forward_random(inputs.img, inputs.z, inputs.c)
    assert calls == {**ROUTES["B", "int8"], "resblock": 5, "conv3x3": 6}
    assert stats == [True] * 6
    diff = np.abs(out.numpy() - ref)
    assert diff.max() <= 2e-2 and (diff > 1e-4).mean() <= 0.05, diff.max()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_converters_raise_on_a_missing_or_extra_leaf(setups, config):
    s = setups[config]
    tm = s.tms["float32"]
    leaf = {"A": "dec1_0", "B": "dec_share"}[config]
    dec = dict(s.params["decoder"])
    del dec[leaf]
    with pytest.raises(KeyError, match=leaf):
        params_from_jax({**s.params, "decoder": dec}, tm)
    extra = {**s.params["style_encoder"], "head2": {"kernel": np.zeros((1, 1, 4, 4))}}
    with pytest.raises(KeyError, match="head2/kernel"):
        params_from_jax({**s.params, "style_encoder": extra}, tm)
    q = dict(s.quant["decoder"])
    del q[leaf]
    with pytest.raises(KeyError, match=leaf):
        quant_from_jax({**s.quant, "decoder": q}, tm)
    q = {**s.quant["decoder"], "dec9": {"conv": {"amax_in": np.float32(1.0)}}}
    with pytest.raises(KeyError, match="dec9/conv/amax_in"):
        quant_from_jax({**s.quant, "decoder": q}, tm)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_training_mode_builds_the_training_nets(config):
    """``mode="train"`` adds both discriminators and the content
    discriminator, trainable, with Adam state for every net;
    ``params_from_jax`` carries the JAX BaseModel's own init tree into all
    six nets (the discriminators then agree with JAX's within the f32
    forward tolerance) and raises on a leaf left over."""
    flags = dict(use_dis_content=True, dis_content_layers=1, dis_content_final_kernel=2,
                 **CONFIGS[config], **SHAPE)
    tm = BaseModel(default_train_args(**flags), device="cpu")
    assert list(tm.nets) == ["content_encoder", "style_encoder", "decoder", "discriminator1",
                             "discriminator2", "content_discriminator"]
    assert all(p.requires_grad for net in tm.nets.values() for p in net.parameters())
    assert set(tm.state.opt_state) == set(tm.nets) and tm.generator is not None
    jm = JaxBaseModel(jax_train_args(logdir=None, **flags))
    # the generators' tree from the port's own weights; the training nets' from
    # their Flax init (the two discriminators are one module config)
    params = _jax_tree(tm)
    for i, name in enumerate(("discriminator1", "discriminator2", "content_discriminator")):
        net = jm.nets["discriminator1" if i < 2 else name]
        init = jax.jit(net.init)
        tree = init(jax.random.PRNGKey(i), *jm._dummy_inputs(name)[0])["params"]
        params[name] = jax.tree_util.tree_map(np.asarray, tree)
    tm.load_params(params_from_jax(params, tm))
    img = np.random.default_rng(5).uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    pred, cls = jm.nets["discriminator1"].apply({"params": params["discriminator1"]}, img)
    with torch.no_grad():
        tpred, tcls = tm.nets.discriminator1(_nchw(img))
    _close(_nhwc(tpred), pred, "float32")
    _close(tcls.numpy(), cls, "float32")
    extra = {**params["discriminator1"], "layer9": {"conv": {"kernel": np.zeros((3, 3, 4, 4))}}}
    with pytest.raises(KeyError, match="layer9/conv/kernel"):
        params_from_jax({**params, "discriminator1": extra}, tm)
