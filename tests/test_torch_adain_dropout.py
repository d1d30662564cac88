"""``--use_dropout`` on AdaINModel, the port against the JAX package, on the CPU.

The flag is inert at serving (the JAX block's dropout is deterministic
there), but it routes: a dropout ``AdaINResnetBlock`` never takes the
whole-block int8 kernel (kernel 6) or the training kernels (9, 10), so in
int8 serving the decoder's four blocks compose through the stride-1 int8
conv (kernel 4) with an AdaIN after each conv, while the content encoder's
four blocks keep kernel 6. In training the step draws the blocks' dropout
masks (tests/test_torch_dropout.py holds the blocks' dropout against Flax).

One JAX ``AdaINModel.initialize()`` tree (crop 32, dim 8, latent 4, 4
domains, B=2) and its calibrated amax tree are carried into the port. The
int8 forwards are held to each other within the flip bound of
``tests/test_torch_int8.py``: a statistic summed in another order can move a
value across an int8 rounding boundary.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_test_args as jax_test_args
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel
from masterthesis_tpu_torch.arguments import default_test_args, default_train_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from tests.torch_jax_init import initialized
from masterthesis_tpu_torch.tools.convert_jax import params_from_jax, quant_from_jax

torch.set_num_threads(2)

SIZE, B, K, LATENT = 32, 2, 4, 4
SHAPE = dict(crop_size=SIZE, dim=8, latent_dim=LATENT, num_domains=K, batch_size=B, init_type=None)
FLAGS = dict(use_dropout=True)


@pytest.fixture(scope="module")
def setup():
    """The JAX model with the flag, calibrated on two batches, and the port
    on the same weights and amax tree, with and without the flag."""
    jm = JaxAdaINModel(jax_test_args(**FLAGS, **SHAPE))
    params = jax.tree_util.tree_map(np.asarray, initialized(jm).params)
    rng = np.random.default_rng(0)
    inputs = SimpleNamespace(
        img=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
        z=rng.standard_normal((B, LATENT)).astype(np.float32),
        c=np.eye(K, dtype=np.float32)[[1, 3]],
    )
    calib = [rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    c_trgs = [np.eye(K, dtype=np.float32)[[0, 2]], np.eye(K, dtype=np.float32)[[3, 1]]]
    ref_float = np.asarray(jm._forward_random_jit(params, inputs.img, inputs.z, inputs.c))
    quant = jm.calibrate_int8(SimpleNamespace(params=params), calib, c_trgs=c_trgs,
                              rng=jax.random.PRNGKey(9))
    quant = jax.tree_util.tree_map(np.asarray, quant)
    tms = {}
    for dropout in (True, False):
        tm = AdaINModel(default_test_args(use_dropout=dropout, **SHAPE), device="cpu")
        tm.load_params(params_from_jax(params, tm))
        tms[dropout] = tm
    return SimpleNamespace(jm=jm, params=params, tms=tms, inputs=inputs, quant=quant,
                           ref_float=ref_float)


def _jax_int8_routes(s, monkeypatch):
    """The JAX int8 forward, run eagerly, with its whole-block entry point
    (kernel 6) and its stride-1 conv entry points (kernel 4, with or without
    statistics) counted; a conv that the whole block composes off the TPU is
    part of that block's call. Returns the counts and the output."""
    from masterthesis_tpu.ops import qat
    from masterthesis_tpu.ops.pallas import conv_int8 as jq

    calls = {"resblock": 0, "conv3x3": 0}
    inside = []

    def counting(module, name, key):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            if not inside and kw.get("stride", 1) == 1:
                calls[key] += 1
            inside.append(name)
            try:
                return real(*a, **kw)
            finally:
                inside.pop()
        monkeypatch.setattr(module, name, wrapper)

    counting(jq, "int8_resblock", "resblock")
    counting(jq, "int8_conv3x3", "conv3x3")
    counting(qat, "int8_conv3x3_ste", "conv3x3")
    s.jm.quant_cols = s.quant
    try:
        with jax.disable_jit():
            out = np.asarray(s.jm._forward_random_impl(s.params, s.inputs.img, s.inputs.z,
                                                       s.inputs.c))
    finally:
        monkeypatch.undo()
    return calls, out


def _port_int8_routes(tm, s, monkeypatch):
    """The port's int8 forward with kernels 6 and 4 counted per net."""
    calls, where = {}, {"net": "content_encoder"}
    for name in ("resblock", "conv3x3"):
        real = getattr(kq, name)

        def wrapper(*a, _real=real, _name=name, **kw):
            key = (where["net"], _name)
            calls[key] = calls.get(key, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(kq, name, wrapper)
    dec = tm.nets.decoder
    hooks = [dec.register_forward_pre_hook(lambda *_: where.update(net="decoder")),
             dec.register_forward_hook(lambda *_: where.update(net="content_encoder"))]
    tm.load_int8(quant_from_jax(s.quant, tm))
    try:
        out, _, _ = tm.forward_random(s.inputs.img, s.inputs.z, s.inputs.c)
    finally:
        tm.disable_int8()
        for h in hooks:
            h.remove()
        monkeypatch.undo()
    return calls, out.numpy()


def test_int8_dropout_decoder_routes_through_kernel_4_as_jax(setup, monkeypatch):
    s = setup
    jax_calls, ref = _jax_int8_routes(s, monkeypatch)
    calls, out = _port_int8_routes(s.tms[True], s, monkeypatch)
    # JAX: the encoder's 4 blocks whole, the decoder's 4 as 8 stride-1 convs
    assert jax_calls == {"resblock": 4, "conv3x3": 8}
    assert calls == {("content_encoder", "resblock"): 4, ("decoder", "conv3x3"): 8}
    assert np.abs(ref - s.ref_float).max() > 1e-3, "the JAX forward must be int8 to test anything"
    # tanh outputs: the flip bound of tests/test_torch_int8.py
    diff = np.abs(out - ref)
    assert diff.max() <= 2e-2, diff.max()
    assert (diff > 1e-4).mean() <= 0.05, (diff > 1e-4).mean()


def test_int8_without_dropout_keeps_kernel_6_in_the_decoder(setup, monkeypatch):
    calls, _ = _port_int8_routes(setup.tms[False], setup, monkeypatch)
    assert calls == {("content_encoder", "resblock"): 4, ("decoder", "resblock"): 4}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_forward_is_unchanged_by_the_flag(setup, dtype):
    s = setup
    outs = []
    for dropout in (True, False):
        tm = AdaINModel(default_test_args(use_dropout=dropout, compute_dtype=dtype, **SHAPE),
                        device="cpu")
        tm.load_params(params_from_jax(s.params, tm))
        outs.append(tm.forward_random(s.inputs.img, s.inputs.z, s.inputs.c)[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    if dtype == "float32":
        np.testing.assert_allclose(outs[0].numpy(), s.ref_float, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fused_resblock", ["off", "on"])
def test_training_with_dropout_draws_and_applies_masks(fused_resblock):
    """Training with the flag builds, and a main step with the model's
    generator draws a keep mask per decoder block for each of its four
    decodes (4B images in the D fakes and G1's first decode, 2B in G1's
    cycle and G2), applies them (the losses differ from the same step
    without masks), and takes no training kernel (the blocks have dropout,
    the encoder's 32 channels fail the gate)."""
    from masterthesis_tpu_torch.models.translation import StepDraws
    from masterthesis_tpu_torch.ops.kernels import resblock_train as krb

    args = default_train_args(use_dropout=True, fused_resblock=fused_resblock, **SHAPE)
    rng = np.random.default_rng(4)
    batch = dict(x1=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
                 x2=rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
                 y1=np.eye(K, dtype=np.float32)[[0, 2]], y2=np.eye(K, dtype=np.float32)[[1, 3]])
    model = AdaINModel(args, device="cpu")
    calls = krb.resblock_fwd_plain.calls
    draws = StepDraws(model.generator)
    logs = model.main_step(batch, draws)
    masks = {k: tuple(v.shape) for k, v in draws.given.items() if ".drop" in k}
    assert masks == {f"{name}.dec1_{i}": (n, 32, 8, 8) for i in range(4)
                     for name, n in (("d.drop", 4 * B), ("g1.drop", 4 * B),
                                     ("g1.drop_rec", 2 * B), ("g2.drop", 2 * B))}
    assert krb.resblock_fwd_plain.calls == calls
    assert all(np.isfinite(float(v)) for v in logs.values())
    nodrop = {k: v for k, v in draws.given.items() if ".drop" not in k}
    again = AdaINModel(args, device="cpu").main_step(batch, StepDraws(**nodrop))
    assert float(logs["l1_self_rec"]) != float(again["l1_self_rec"])
