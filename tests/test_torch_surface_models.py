"""The models with the rest of the flag surface, the port against the JAX
package on the CPU: ``--up_type nearest|pixelshuffle`` on AdaINModel and
BaseModel A and B, and ``--enc_norm batch --dec_norm batch``.

Small size: crop 32, dim 8, latent 4, 4 domains, B=2. One param tree per
configuration (the port's seeded init in the JAX layout, biases and norm
affines redrawn) drives both packages, carried by ``params_from_jax``; the
JAX calibration's amax tree by ``quant_from_jax``.

- Float forwards (``forward_random``) within 1e-4 of max(1, max|JAX|)
  (tests/test_torch_model.py's f32 bound).
- int8 forwards within tests/test_torch_int8.py's ``_forward_close`` bounds:
  at most 5 % of the outputs moved by more than 1e-4, none by more than 2e-2.
- A nearest or pixelshuffle up block's 3x3 conv is kernel 4 in int8 (JAX
  routes it through ``int8_conv3x3_ste``): its int8 operands and int32
  accumulators, from the input the port's forward gives it, equal
  ``jnp_int8_conv``'s (``ops/pallas/conv_int8.py:72``) exactly.
- Launches per int8 forward of kernels 4-7 equal the JAX package's calls of
  ``int8_conv3x3`` (stride 1 and 2, outside its resblocks), ``int8_resblock``
  and ``int8_deconv``, counted over a trace of its int8 forward; the
  moments and head launches are the JAX route's by its code: the stem's
  deferred instance norm, each up block's unfused norm, and the head only
  behind a transposed tail's deferred LayerNorm.

The training step with these flags is in tests/test_torch_surface_train.py.
"""
import contextlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_test_args as jax_test_args  # noqa: E402
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel  # noqa: E402
from masterthesis_tpu.models import BaseModel as JaxBaseModel  # noqa: E402
from masterthesis_tpu.ops.pallas import conv_int8 as jq  # noqa: E402
from masterthesis_tpu_torch.arguments import default_test_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel, BaseModel  # noqa: E402
from masterthesis_tpu_torch.models.blocks import BatchNorm2d  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import adain as kadain  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import head as khead  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import moments as kmoments  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import _conv, params_from_jax  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import quant_from_jax  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

SIZE, B, K, LATENT = 32, 2, 4, 4
SHAPE = dict(crop_size=SIZE, dim=8, latent_dim=LATENT, num_domains=K, batch_size=B, init_type=None)
MODELS = {"AdaIN": (AdaINModel, JaxAdaINModel, {}), "A": (BaseModel, JaxBaseModel, {}),
          "B": (BaseModel, JaxBaseModel, dict(concat=True, reparam=True))}
CONFIGS = {
    "AdaIN_nearest": ("AdaIN", dict(up_type="nearest")),
    "AdaIN_pixelshuffle": ("AdaIN", dict(up_type="pixelshuffle")),
    "A_nearest": ("A", dict(up_type="nearest")),
    "A_pixelshuffle": ("A", dict(up_type="pixelshuffle")),
    "B_nearest": ("B", dict(up_type="nearest")),
    "B_pixelshuffle": ("B", dict(up_type="pixelshuffle")),
    "AdaIN_batch": ("AdaIN", dict(enc_norm="batch", dec_norm="batch")),
    "A_batch": ("A", dict(enc_norm="batch", dec_norm="batch")),
    "B_batch_nearest": ("B", dict(enc_norm="batch", dec_norm="batch", up_type="nearest")),
}
TOL = 1e-4
KERNELS = ("downconv", "resblock", "conv3x3", "deconv")
# moments and head launches per int8 forward, the JAX route: the stem's
# deferred instance norm (none under --enc_norm batch), BaseModel A's two
# decoder-block norms each, and each up block's unfused norm (a transposed
# up's LayerNorm comes from its kernel's statistics); the head behind a
# transposed tail's deferred LayerNorm (AdaINModel and A)
OTHER = {
    "AdaIN_nearest": dict(moments=3, head=0), "AdaIN_pixelshuffle": dict(moments=3, head=0),
    "A_nearest": dict(moments=11, head=0), "A_pixelshuffle": dict(moments=11, head=0),
    "B_nearest": dict(moments=3, head=0), "B_pixelshuffle": dict(moments=3, head=0),
    "AdaIN_batch": dict(moments=0, head=0), "A_batch": dict(moments=8, head=0),
    "B_batch_nearest": dict(moments=0, head=0),
}


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous()


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
def inputs():
    rng = np.random.default_rng(1)
    calib = [rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    c_trgs = [np.eye(K, dtype=np.float32)[[0, 2]], np.eye(K, dtype=np.float32)[[3, 1]]]
    key, zs = jax.random.PRNGKey(9), []
    for img in calib:  # the draws the JAX calibrate_int8 makes
        key, kz, _ = jax.random.split(key, 3)
        zs.append(np.asarray(jax.random.normal(kz, (img.shape[0], LATENT), jnp.float32)))
    return SimpleNamespace(
        img=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        z=rng.standard_normal((B, LATENT)).astype(np.float32),
        c=np.eye(K, dtype=np.float32)[[1, 3]], calib=calib, c_trgs=c_trgs, zs=zs)


_SETUPS = {}


@pytest.fixture
def setup(inputs, config):
    """The config's port model (f32, CPU) and JAX model on one param tree,
    JAX's float output and amax tree, built once per config."""
    if config not in _SETUPS:
        model, flags = CONFIGS[config]
        tcls, jcls, mflags = MODELS[model]
        flags = {**mflags, **flags, **SHAPE}
        tm = tcls(default_test_args(seed=3, **flags), device="cpu")
        params = _perturb(S.jax_tree(tm), np.random.default_rng(0))
        tm.load_params(params_from_jax(params, tm))
        jm = jcls(jax_test_args(**flags))
        ref_float = np.asarray(jm._forward_random_jit(params, inputs.img, inputs.z, inputs.c))
        quant = jm.calibrate_int8(SimpleNamespace(params=params), inputs.calib,
                                  c_trgs=inputs.c_trgs, rng=jax.random.PRNGKey(9))
        quant = jax.tree_util.tree_map(np.asarray, quant)
        _SETUPS[config] = SimpleNamespace(tm=tm, jm=jm, params=params, quant=quant,
                                          ref_float=ref_float)
    return _SETUPS[config]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_float_forward_matches_jax(setup, inputs, config):
    s = setup
    out, _, _ = s.tm.forward_random(inputs.img, inputs.z, inputs.c)
    assert out.shape == (B, SIZE, SIZE, 3)
    assert np.abs(s.ref_float).max() > 0.3, "outputs must span the tanh range to test anything"
    atol = TOL * max(1.0, float(np.abs(s.ref_float).max()))
    np.testing.assert_allclose(out.numpy(), s.ref_float, atol=atol, rtol=0)


@contextlib.contextmanager
def _jax_calls():
    """Count the JAX package's int8 kernel calls while it traces: conv3x3 at
    stride 1 and 2 (outside its resblocks, which compose from it off the
    TPU), resblock and deconv, by the port's wrapper names."""
    calls = dict.fromkeys(KERNELS, 0)
    real = {n: getattr(jq, n) for n in ("int8_conv3x3", "int8_resblock", "int8_deconv")}
    depth = [0]

    def conv(*a, **kw):
        if depth[0] == 0:
            calls["conv3x3" if kw.get("stride", 1) == 1 else "downconv"] += 1
        return real["int8_conv3x3"](*a, **kw)

    def resblock(*a, **kw):
        calls["resblock"] += 1
        depth[0] += 1
        try:
            return real["int8_resblock"](*a, **kw)
        finally:
            depth[0] -= 1

    def deconv(*a, **kw):
        calls["deconv"] += 1
        return real["int8_deconv"](*a, **kw)

    jq.int8_conv3x3, jq.int8_resblock, jq.int8_deconv = conv, resblock, deconv
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(jq, n, fn)


@contextlib.contextmanager
def _port_calls(monkeypatch):
    calls = dict.fromkeys((*KERNELS, "head", "moments", "adain"), 0)

    def counting(module, name):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    for name in KERNELS:
        counting(kq, name)
    counting(khead, "head")
    counting(kmoments, "moments")
    counting(kadain, "adain")
    try:
        yield calls
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("config", list(CONFIGS))
def test_int8_forward_and_its_launches_match_jax(setup, inputs, monkeypatch, config):
    s = setup
    with _jax_calls() as jcalls:
        jax.make_jaxpr(s.jm._forward_random_impl)(s.params, inputs.img, inputs.z, inputs.c)
    ref = np.asarray(s.jm._forward_random_jit(s.params, inputs.img, inputs.z, inputs.c))
    assert np.abs(ref - s.ref_float).max() > 1e-3, "the JAX forward must be int8"
    s.tm.load_int8(quant_from_jax(s.quant, s.tm))
    try:
        with _port_calls(monkeypatch) as calls:
            out, _, _ = s.tm.forward_random(inputs.img, inputs.z, inputs.c)
    finally:
        s.tm.disable_int8()
    assert {k: calls[k] for k in KERNELS} == jcalls
    assert calls["adain"] == 0
    assert {k: calls[k] for k in ("moments", "head")} == OTHER[config]
    if "nearest" in config or "pixelshuffle" in config:
        assert calls["conv3x3"] >= 2  # the up blocks' convs on kernel 4
    diff = np.abs(out.numpy() - ref)
    assert diff.max() <= 2e-2, diff.max()
    assert (diff > 1e-4).mean() <= 0.05, (diff > 1e-4).mean()


@pytest.mark.parametrize("config", ["AdaIN_nearest", "AdaIN_pixelshuffle", "B_nearest",
                                    "B_pixelshuffle"])
def test_the_up_convs_int32_accumulators_equal_jaxs(setup, inputs, config):
    """Each up block's conv, on the input the int8 forward gives it: the
    quantized operand and the int32 sums of kernel 4's plain version against
    ``quantize_act`` / ``quantize_weight`` / ``jnp_int8_conv``."""
    s = setup
    dec = s.tm.nets.decoder
    ups = [dec.dec2.up0, dec.dec2.up1] if config.startswith("AdaIN") else [dec.dec2, dec.dec3]
    seen = []
    hooks = [u.conv.conv.register_forward_pre_hook(lambda m, a: seen.append((m, a[0])))
             for u in ups]
    s.tm.load_int8(quant_from_jax(s.quant, s.tm))
    try:
        s.tm.forward_random(inputs.img, inputs.z, inputs.c)
        assert [m for m, _ in seen] == [u.conv.conv for u in ups]
        for m, x in seen:
            qc = m.quant()
            xq = kq.quant_pad_plain(x, qc)
            acc = kq.conv_acc_plain(xq, qc)
            xn = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
            xqj, _ = jq.quantize_act(xn, float(m.amax_in))
            wq, _ = jq.quantize_weight(jnp.asarray(m.weight.detach().permute(2, 3, 1, 0).numpy()))
            accj = np.asarray(jq.jnp_int8_conv(xqj, wq, "zero"))
            c = x.shape[1]
            np.testing.assert_array_equal(xq[:, 1:-1, 1:-1, :c].numpy(), np.asarray(xqj))
            np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), accj)
            assert np.abs(accj).max() > 1000
    finally:
        for h in hooks:
            h.remove()
        s.tm.disable_int8()


@pytest.mark.parametrize("config", ["AdaIN_pixelshuffle"])
def test_the_up_conv_weight_is_the_flax_conv_conv_kernel(setup, config):
    s = setup
    kernel = s.params["decoder"]["dec2"]["up0"]["conv"]["conv"]["kernel"]
    w = s.tm.nets.decoder.dec2.up0.conv.conv.weight
    assert kernel.shape[-1] == 4 * 16  # pixelshuffle widens to 4 x features
    np.testing.assert_array_equal(w.detach().numpy(), _conv(kernel))
    head = s.params["decoder"]["dec2"]["head"]["conv"]["kernel"]
    assert head.shape == (7, 7, 8, 3)


@pytest.mark.parametrize("config", ["A_batch"])
def test_batch_norm_is_in_both_nets(setup, config):
    s = setup
    for name in ("content_encoder", "decoder"):
        bns = [m for m in s.tm.nets[name].modules() if isinstance(m, BatchNorm2d)]
        assert len(bns) >= 2, name
    assert "scale" in s.params["content_encoder"]["stem"]["norm"]
