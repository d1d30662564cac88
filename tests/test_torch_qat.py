"""Quantization-aware training (``--int8_train``, ``ops/qat.py``) of the port
against the JAX package's, on the CPU.

The twin of ``tests/test_qat.py``, at its size (crop 32, dim 8, latent 4, 3
domains, batch 2 per side, f32):

- the straight-through Functions: the forward equals the serving conv and
  its int32 accumulators ``jnp_int8_conv``'s exactly; the gradients equal
  the float conv's (the port's autograd of its own float conv bit for bit,
  JAX's straight-through gradient within its test's rtol 1e-5 / atol 1e-6);
  amax gets a zero gradient; the transposed conv likewise;
- ``qat_trace`` restores the mode and the scope; ``parse_qat_scope``;
- the QAT main step, reference and fused, against JAX's QAT step from the
  same weights (``params_from_jax`` inverted), the same amax tree (JAX's
  ``calibrate_quant_train``, carried by ``quant_from_jax``) and the same
  draws (no noise, z = mu, given ``z_sr``/``z_sr2``). JAX's step is
  ``torch_train_steps.run_jax`` with every content-encoder and decoder
  forward of its pieces routed as ``_with_qat`` routes its step body
  (:func:`jax_qat`). Held by ``assert_step_matches`` at the f32 step tests'
  bounds; the int8 inputs of one QAT forward are compared first, and every
  rounding flip between the packages is counted (:func:`test_int8_flips`);
- the kernel 4 / 7 / 5 launches per main step equal a trace of the JAX
  package's whole QAT step body, and kernels 9/10 stay off;
- ``--remat`` and an unknown scope refused; ``calibrate_quant_train``'s
  amax within 1e-6 relative of JAX's; ``forward_random`` stays float after
  it; the ``Trainer`` calibrates at ``--int8_calib_freq`` and on a resume.
"""
import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytest.importorskip("flax")

from masterthesis_tpu.models.state import TrainState  # noqa: E402
from masterthesis_tpu.models.translation import TranslationModel as JaxModel  # noqa: E402
from masterthesis_tpu.ops import qat as jqat  # noqa: E402
from masterthesis_tpu.ops.pallas import conv_int8 as jq  # noqa: E402
from masterthesis_tpu_torch import data, models  # noqa: E402
from masterthesis_tpu_torch.arguments import default_train_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel  # noqa: E402
from masterthesis_tpu_torch.models.blocks import pad2d  # noqa: E402
from masterthesis_tpu_torch.models.translation import StepDraws  # noqa: E402
from masterthesis_tpu_torch.ops import qat  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import library  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import quant_from_jax  # noqa: E402
from masterthesis_tpu_torch.train import Trainer  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

from conftest import make_image_tree  # noqa: E402

torch.set_num_threads(2)

# tests/test_qat.py's model size (its tiny_args)
QAT_SHAPE = dict(crop_size=32, dim=8, latent_dim=4, num_domains=3, batch_size=2,
                 use_dis_content=False)
QAT_ARGS = dict(QAT_SHAPE, compute_dtype="float32", int8_train=True, fused_resblock="off")
INT8_OPS = ("int8_conv3x3", "int8_downconv", "int8_deconv")
# kernel 4 / 7 / 5 calls per QAT main step (every scope on): the reference
# step decodes and encodes 4 times each (D fakes, G1 twice, G2), the fused
# step encodes 3 times and decodes 4 (G1 twice, D2's decode, G2); an
# encode is 8 stride-1 convs (4 resblocks) and 2 down convs, a decode 8
# stride-1 convs and 2 transposed convs. chip_smoke.py holds the card's
# launches to the same numbers.
QAT_CALLS = {"reference": {"int8_conv3x3": 64, "int8_downconv": 8, "int8_deconv": 8},
             "fused": {"int8_conv3x3": 56, "int8_downconv": 6, "int8_deconv": 8}}
NORM_OPS = ("moments", "adain")
# kernel 1 / 3 calls per QAT main step at the launch test's shape: the
# plain step's with kernels 9/10 off (the composed blocks' norms), as
# chip_smoke.py holds the card's QAT step to the plain one's
QAT_NORM_CALLS = {"reference": {"moments": 53, "adain": 32},
                  "fused": {"moments": 42, "adain": 32}}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def _iohw(k):
    """JAX's transposed-conv HWIO kernel (applied unflipped) as the port's
    IOHW weight."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]))


def _pad_mode(padding_type):
    return None if padding_type == "zero" else padding_type


def _float_conv(x, w, b, padding_type, stride):
    """The port's float Conv2d branch (``models/blocks.py``)."""
    pad = 1
    if padding_type == "reflect":
        x = F.pad(x, (1, 1, 1, 1), mode="reflect")
        pad = 0
    return F.conv2d(x, w, b, stride, pad)


# ----------------------------------------------------------------- ops --

CONV_CASES = [("reflect", 1, True), ("zero", 1, False), ("zero", 2, True)]


@pytest.mark.parametrize("padding_type,stride,bias", CONV_CASES)
def test_ste_conv_forward_matches_serving(padding_type, stride, bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 6, 5)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(5) * 0.1).astype(np.float32) if bias else None
    amax = float(np.abs(x).max())
    xt, wt = _nchw(x), _oihw(k)
    bt = None if b is None else torch.from_numpy(b)
    got = qat.int8_conv3x3_ste(xt, wt, bt, torch.tensor(amax), _pad_mode(padding_type), stride,
                               torch.float32)
    qc = kq.quant_conv(wt, bt, amax, stride, _pad_mode(padding_type))
    serving = (kq.conv3x3 if stride == 1 else kq.downconv)(xt, qc)
    assert torch.equal(got, serving)
    # the int32 accumulators are jnp_int8_conv's, exactly
    xqj, _ = jq.quantize_act(jnp.asarray(x), amax)
    accj = jq.jnp_int8_conv(xqj, jq.quantize_weight(jnp.asarray(k))[0], padding_type, stride)
    acc = kq.conv_acc_plain(kq.quant_pad_plain(xt, qc), qc)
    np.testing.assert_array_equal(_nhwc(acc), np.asarray(accj))
    # and y is JAX's straight-through forward
    want = jqat.int8_conv3x3_ste(jnp.asarray(x), jnp.asarray(k), None if b is None else
                                 jnp.asarray(b), amax, padding_type=padding_type, stride=stride,
                                 out_dtype=jnp.float32)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("padding_type,stride", [("reflect", 1), ("zero", 2)])
def test_ste_conv_grad_is_float_conv_grad(padding_type, stride):
    """The backward is the float conv's at the unquantized inputs: the
    port's autograd of its own float conv bit for bit, and JAX's
    straight-through gradient within rtol 1e-5 (tests/test_qat.py's) and
    1e-6 of each gradient's largest magnitude (the two packages' f32 sums
    run in other orders; its atol 1e-6 held one package to itself)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 6, 5)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(5) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, 8 // stride, 8 // stride, 5)).astype(np.float32)
    amax = float(np.abs(x).max())

    def port_grads(fn):
        xt, wt, bt = (t.requires_grad_(True) for t in (_nchw(x), _oihw(k), torch.from_numpy(b)))
        (fn(xt, wt, bt) * _nchw(g)).sum().backward()
        return xt.grad, wt.grad, bt.grad

    ste = port_grads(lambda xt, wt, bt: qat.int8_conv3x3_ste(
        xt, wt, bt, torch.tensor(amax), _pad_mode(padding_type), stride, torch.float32))
    ref = port_grads(lambda xt, wt, bt: _float_conv(xt, wt, bt, padding_type, stride))
    for a, r in zip(ste, ref):
        assert torch.equal(a, r)

    def jax_loss(xx, kk, bb):
        y = jqat.int8_conv3x3_ste(xx, kk, bb, amax, padding_type=padding_type, stride=stride,
                                  out_dtype=jnp.float32)
        return jnp.sum(y * g)

    gj = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    _close(_nhwc(ste[0]), gj[0])
    _close(ste[1].permute(2, 3, 1, 0).numpy(), gj[1])
    _close(ste[2].numpy(), gj[2])


def _close(got, want):
    """Gradients of the two packages: rtol 1e-5, atol 1e-6 of the largest."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_ste_conv_amax_gets_zero_grad():
    rng = np.random.default_rng(2)
    x = _nchw(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))
    w = _oihw((rng.standard_normal((3, 3, 4, 4)) * 0.2).astype(np.float32))
    amax = torch.tensor(1.5, requires_grad=True)
    y = qat.int8_conv3x3_ste(x, w, None, amax, None, 1, torch.float32)
    (y.square().sum()).backward()
    assert amax.grad is not None and float(amax.grad) == 0.0


def test_ste_deconv_forward_and_grad():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 8, 4)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(4) * 0.1).astype(np.float32)
    amax = float(np.abs(x).max())
    g = rng.standard_normal((2, 12, 12, 4)).astype(np.float32)
    xt, wt, bt = (t.requires_grad_(True) for t in (_nchw(x), _iohw(k), torch.from_numpy(b)))
    got = qat.int8_deconv_ste(xt, wt, bt, torch.tensor(amax), torch.float32)
    with torch.no_grad():
        serving = kq.deconv(xt.detach(), kq.quant_deconv(wt, bt, amax))
    assert torch.equal(got.detach(), serving)
    want = jqat.int8_deconv_ste(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), amax,
                                out_dtype=jnp.float32)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    (got * _nchw(g)).sum().backward()
    xr, wr, br = (t.detach().clone().requires_grad_(True) for t in (xt, wt, bt))
    (F.conv_transpose2d(xr, wr, br, 2, 1, 1) * _nchw(g)).sum().backward()
    for a, r in ((xt, xr), (wt, wr), (bt, br)):
        assert torch.equal(a.grad, r.grad)

    def jax_loss(xx, kk, bb):
        return jnp.sum(jqat.int8_deconv_ste(xx, kk, bb, amax, out_dtype=jnp.float32) * g)

    gj = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    _close(_nhwc(xt.grad), gj[0])
    _close(wt.grad.flip(2, 3).permute(2, 3, 0, 1).numpy(), gj[1])
    _close(bt.grad.numpy(), gj[2])


def test_qat_trace_context_restores():
    assert not qat.qat_trace_mode() and qat.qat_scope() == qat.KINDS
    with qat.qat_trace(frozenset({"deconv"})):
        assert qat.qat_trace_mode() and qat.qat_scope() == {"deconv"}
        with qat.qat_trace():
            assert qat.qat_scope() == {"deconv"}
    assert not qat.qat_trace_mode() and qat.qat_scope() == qat.KINDS


@pytest.mark.parametrize("scope", [None, "all", "", "conv", "stride2, deconv", "bad", "conv,x"])
def test_parse_qat_scope_matches_jax(scope):
    try:
        want = jqat.parse_qat_scope(scope)
    except ValueError as e:
        with pytest.raises(ValueError, match="unknown --int8_train_scope"):
            qat.parse_qat_scope(scope)
        assert "unknown" in str(e)
        return
    assert qat.parse_qat_scope(scope) == want


# --------------------------------------------------------------- steps --


@contextlib.contextmanager
def jax_qat(tree, scope=None):
    """Inside the block every content-encoder and decoder forward of a JAX
    model runs as its QAT step body runs them (``_with_qat``: the amax tree
    as ``_step_quant``, ``qat_trace``), whatever its ``train``: the test
    pieces run with ``train=False`` (no noise, z = mu), where the JAX
    package would stay float."""
    cls = JaxModel
    enc, dec = cls.encode_content, cls.decode

    def encode_content(self, *args, **kw):
        self._step_quant = tree
        return enc(self, *args, **{**kw, "quant": "train"})

    def decode(self, *args, **kw):
        self._step_quant = tree
        return dec(self, *args, **{**kw, "quant": "train"})

    cls.encode_content, cls.decode = encode_content, decode
    try:
        with jqat.qat_trace(scope):
            yield
    finally:
        cls.encode_content, cls.decode = enc, dec


@contextlib.contextmanager
def jax_int8_calls():
    """Count the JAX package's int8 conv calls by kind while code traces."""
    calls = dict.fromkeys(INT8_OPS, 0)
    conv, deconv = jq.int8_conv3x3, jq.int8_deconv

    def counted_conv(*args, **kw):
        calls["int8_downconv" if kw.get("stride", 1) == 2 else "int8_conv3x3"] += 1
        return conv(*args, **kw)

    def counted_deconv(*args, **kw):
        calls["int8_deconv"] += 1
        return deconv(*args, **kw)

    jq.int8_conv3x3, jq.int8_deconv = counted_conv, counted_deconv
    try:
        yield calls
    finally:
        jq.int8_conv3x3, jq.int8_deconv = conv, deconv


@contextlib.contextmanager
def port_int8_calls(names=INT8_OPS):
    """Count the port's calls of the ops ``names`` (the int8 convs by
    default; on the CPU no kernel launches, so the launch counters stay
    0)."""
    calls = dict.fromkeys(names, 0)
    saved = {name: library.CALLS[name] for name in names}

    def counted(name):
        def call(*args):
            calls[name] += 1
            return saved[name](*args)
        return call

    library.CALLS.update({name: counted(name) for name in names})
    try:
        yield calls
    finally:
        library.CALLS.update(saved)


def _jax_state(jm, model):
    params = jax.tree_util.tree_map(jnp.asarray, S.jax_tree(model))
    return TrainState.create(params, {n: jm.tx[n].init(params[n]) for n in params}, {})


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def calibrated():
    """JAX's ``calibrate_quant_train`` on the port's seeded weights and
    batch: (its amax tree, the batch, z_sr, z_sr2, its draws c and z)."""
    model = S.port_model("float32", "off", shape=QAT_SHAPE, int8_train=True)
    batch, z_sr, z_sr2 = S.batch_and_draws(0)
    jm = S.jax_model(QAT_ARGS)
    key = jax.random.PRNGKey(7)
    tree = jm.calibrate_quant_train(_jax_state(jm, model), _jbatch(batch), key)
    # the draws calibrate_quant_train made from its key
    kz, kc = jax.random.split(key)
    b, k = len(batch["x1"]), QAT_SHAPE["num_domains"]
    c = np.asarray(jax.nn.one_hot(jax.random.randint(kc, (b,), 0, k), k))
    z = np.asarray(jm.get_z_random(kz, b))
    return jax.tree_util.tree_map(np.asarray, tree), batch, z_sr, z_sr2, c, z


@pytest.fixture(scope="module", params=["reference", "fused"])
def qat_steps(request, calibrated):
    """One QAT main step of the port and of the JAX package from the same
    weights, amax tree and draws, per GAN step (one JAX reference per
    module, its pieces jitted)."""
    gan_step = request.param
    tree, batch, z_sr, z_sr2, _, _ = calibrated
    model = S.port_model("float32", "off", shape=QAT_SHAPE, int8_train=True, gan_step=gan_step)
    model.load_int8_train(quant_from_jax(tree, model))
    with port_int8_calls() as calls:
        port = S.run_port(model, batch, z_sr, z_sr2)
    with jax_qat(jax.tree_util.tree_map(jnp.asarray, tree)):
        ref = S.run_jax(dict(QAT_ARGS, gan_step=gan_step), port[2], batch, z_sr, z_sr2,
                        fused=False, gan_step=gan_step)
    return gan_step, model, port, ref, calls


def test_qat_step_matches_jax(qat_steps):
    """The QAT step against JAX's. Losses within 1e-4 relative, D gradients
    within 1e-3 of each tensor's largest and G2's within 2e-2 per net in
    norm: the f32 step tests' bounds (measured: 1e-6 and 1e-6). G1's
    gradients within 0.1 per net in norm (measured 5.7 % on the content
    encoder, 4.6 % on the decoder, 0.7 % on the style encoder) and per
    tensor within 10 % of its norm plus 1e-3 of the net's: G1's cycle
    encodes and decodes the fakes, where the two packages' int8 inputs part
    by rounding flips (:func:`test_int8_flips` counts them: 2 in the first
    decode's last transposed conv, from its LayerNorm's f32 sums, then 28
    at the cycle's first conv, growing to 1,500 of 8,192 per conv, up to 8
    steps, through its resblocks), and at this size the G1 gradient moves
    by 90 % between the QAT and the float step of either package, so that
    a flip's effect on it is not small. That the port's Functions are the
    straight-through estimator is held tighter, with no JAX, by
    :func:`test_qat_step_is_the_straight_through_step`."""
    gan_step, model, port, ref, calls = qat_steps
    assert calls == QAT_CALLS[gan_step]
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4, net_tol=0.1)
    like = port[2][0]
    for net, g in ref[1][3].items():
        want = S.to_port(model, net, g, like)
        err = S._norm(port[1][3][net][k] - w for k, w in want.items())
        assert err <= 2e-2 * S._norm(want.values()), (net, err)


def _detached_ste():
    """The straight-through estimator written as y_float + (y_int8 -
    y_float).detach(), in place of the port's Functions (a second, slower
    spelling of the same gradient)."""
    conv_apply, deconv_apply = qat.Int8ConvSTE.apply, qat.Int8DeconvSTE.apply

    def detach(b):
        return None if b is None else b.detach()

    def conv(x, w, b, amax, qc, padding_type, dtype):
        with torch.no_grad():
            yq = conv_apply(x.detach(), w.detach(), detach(b), amax, qc, padding_type, dtype)
        xx, pad = x.to(dtype), 1
        if padding_type in ("reflect", "replicate"):
            xx, pad = pad2d(xx, 1, padding_type), 0
        yf = F.conv2d(xx, w.to(dtype), None if b is None else b.to(dtype), qc.stride, pad)
        return yf + (yq - yf).detach()

    def deconv(x, w, b, amax, qc, dtype):
        with torch.no_grad():
            yq = deconv_apply(x.detach(), w.detach(), detach(b), amax, qc, dtype)
        yf = F.conv_transpose2d(x.to(dtype), w.to(dtype), None if b is None else b.to(dtype),
                                2, 1, 1)
        return yf + (yq - yf).detach()

    return conv, deconv


@pytest.mark.parametrize("gan_step", ["reference", "fused"])
def test_qat_step_is_the_straight_through_step(calibrated, gan_step, monkeypatch):
    """The port's QAT step against the same step with the estimator spelled
    y_float + (y_int8 - y_float).detach(): losses within 1e-6 relative and
    every phase's gradients within 1e-5 per net in norm (measured 9e-7:
    only the order of the float conv's backward sums differs)."""
    tree, batch, z_sr, z_sr2, _, _ = calibrated

    def step():
        model = S.port_model("float32", "off", shape=QAT_SHAPE, int8_train=True,
                             gan_step=gan_step)
        model.load_int8_train(quant_from_jax(tree, model))
        return S.run_port(model, batch, z_sr, z_sr2)

    logs, phases, _ = step()
    conv, deconv = _detached_ste()
    monkeypatch.setattr(qat.Int8ConvSTE, "apply", conv)
    monkeypatch.setattr(qat.Int8DeconvSTE, "apply", deconv)
    logs2, phases2, _ = step()
    for k, v in logs2.items():
        assert abs(float(logs[k]) - float(v)) <= 1e-6 * max(abs(float(v)), 1e-6), k
    for p, p2 in zip(phases, phases2):
        for net, g in p2.items():
            err = S._norm(p[net][k] - w for k, w in g.items())
            assert err <= 1e-5 * S._norm(g.values()), (net, err)


def test_int8_flips(calibrated):
    """One QAT forward (content encoder, then decoder) of each package from
    the same weights and amax tree: the int8 input of every conv, in call
    order, equal but for rounding flips of one step, each where an input
    sat within an f32 rounding of a quantization boundary. A flip comes from
    the float ops between the int8 convs (the 7x7 stem conv, the norms,
    the transposed convs' interleave), which the two packages sum in
    another order; the counts are printed and bounded at 1e-3 of the
    values."""
    tree, batch, _, _, c, z = calibrated
    model = S.port_model("float32", "off", shape=QAT_SHAPE, int8_train=True)
    model.load_int8_train(quant_from_jax(tree, model))
    got = []
    real = kq._quantize

    def record(x, inv):
        q = real(x, inv)
        got.append(q.permute(0, 2, 3, 1).numpy())
        return q

    kq._quantize = record
    try:
        with torch.no_grad(), qat.qat_trace():
            z_c = model.nets.content_encoder(_nchw(batch["x1"]))
            model.nets.decoder(z_c, torch.from_numpy(z), torch.from_numpy(c))
    finally:
        kq._quantize = real
    jm = S.jax_model(QAT_ARGS)
    params = jax.tree_util.tree_map(jnp.asarray, S.jax_tree(model))
    found = {}
    quantize = jq.quantize_act

    def record_jax(x, amax):
        q, s = quantize(x, amax)
        # keyed by trace order: the callbacks may run in any order
        jax.debug.callback(functools.partial(found.__setitem__, len(order)), q)
        order.append(len(order))
        return q, s

    order = []
    jq.quantize_act = record_jax
    try:
        with jax_qat(jax.tree_util.tree_map(jnp.asarray, tree)):
            jax.block_until_ready(jax.jit(lambda p: jm.decode(
                p, jm.encode_content(p, {}, jnp.asarray(batch["x1"])), jnp.asarray(z),
                jnp.asarray(c)))(params))
    finally:
        jq.quantize_act = quantize
    want = [np.asarray(found[i]) for i in order]
    assert len(got) == len(want) == 20
    flips = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        d = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert d.max() <= 1, (i, d.max())
        flips.append(int(d.sum()))
    total = sum(w.size for w in want)
    print(f"int8 flips per conv {flips}: {sum(flips)} of {total} int8 inputs")
    assert sum(flips) <= 1e-3 * total, flips


def test_qat_launches_match_jax_trace():
    """Both GAN steps at scope all, at dim 32 (the resblocks at 128
    channels, eligible for kernels 9/10 outside QAT), and the fused step at
    scope stride2 at dim 8: the port's int8 calls per main step equal a
    trace of the JAX package's whole QAT step body (``_main_step_impl`` /
    ``_main_step_fused_impl`` with the amax tree, as ``optimize_parameters``
    passes it), and neither package calls kernel 9 or 10, though the port
    runs with ``--fused_resblock on``. At scopes conv and deconv the port's
    calls are the scope's kinds of QAT_CALLS (each trace takes 7-9 s). At
    scope all the port's kernel 1 and 3 calls equal the plain step's with
    kernels 9/10 off: QAT keeps the norms as training runs them."""
    batch, z_sr, z_sr2 = S.batch_and_draws(1)
    c = np.eye(3, dtype=np.float32)[[1, 2]]
    kinds = {"conv": "int8_conv3x3", "stride2": "int8_downconv", "deconv": "int8_deconv"}
    for gan_step, scope, shape in (("reference", "all", S.SHAPE), ("fused", "all", S.SHAPE),
                                   ("fused", "stride2", QAT_SHAPE), ("fused", "conv", QAT_SHAPE),
                                   ("fused", "deconv", QAT_SHAPE)):
        flags = dict(int8_train=True, int8_train_scope=scope, gan_step=gan_step)
        model = S.port_model("float32", "on", seed=2, shape=shape, **flags)
        cols = model.calibrate_quant_train(batch, c, z_sr)
        on = {kinds[k] for k in qat.parse_qat_scope(scope)}
        calls = {k: (n if k in on else 0) for k, n in QAT_CALLS[gan_step].items()}
        k910 = {"fwd": 0, "bwd": 0}
        if scope in ("all", "stride2"):
            jm = S.jax_model(dict(shape, compute_dtype="float32", **flags))
            state = _jax_state(jm, model)
            jtree = {net: _nested(t) for net, t in cols.items()}
            impl = jm._main_step_fused_impl if gan_step == "fused" else jm._main_step_impl
            with S.interpreted_kernels(), S.jax_kernel_calls() as k910, \
                    jax_int8_calls() as traced:
                jax.make_jaxpr(lambda st: impl(st, _jbatch(batch), jax.random.PRNGKey(0), {},
                                               quant=jtree))(state)
            assert traced == calls, (gan_step, scope, traced)
        f0, b0 = krb.resblock_fwd_plain.calls, krb.resblock_bwd_plain.calls
        draws = dict(z_sr=torch.from_numpy(z_sr), z_sr2=torch.from_numpy(z_sr2))
        with port_int8_calls() as port_calls, port_int8_calls(NORM_OPS) as norm_calls:
            model.optimize_parameters(batch, 0, StepDraws(**draws))
        assert port_calls == calls, (gan_step, scope, port_calls, calls)
        if scope == "all":
            plain = S.port_model("float32", "off", seed=2, shape=shape, gan_step=gan_step)
            with port_int8_calls(NORM_OPS) as plain_calls:
                plain.optimize_parameters(batch, 0, StepDraws(**draws))
            assert norm_calls == plain_calls == QAT_NORM_CALLS[gan_step], (gan_step, norm_calls)
        assert k910 == {"fwd": 0, "bwd": 0}
        assert (krb.resblock_fwd_plain.calls - f0, krb.resblock_bwd_plain.calls - b0) == (0, 0)


def _nested(flat: dict) -> dict:
    """The port's flat amax tree of one net as the JAX quant collection."""
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v.item(), jnp.float32)
    return out


def test_int8_train_refusals():
    with pytest.raises(ValueError, match="--remat"):
        AdaINModel(default_train_args(**QAT_SHAPE, int8_train=True, remat=True), device="cpu")
    with pytest.raises(ValueError, match="unknown --int8_train_scope"):
        AdaINModel(default_train_args(**QAT_SHAPE, int8_train=True, int8_train_scope="x"),
                   device="cpu")


def test_calibrate_quant_train_matches_jax(calibrated):
    tree, batch, _, _, c, z = calibrated
    model = S.port_model("float32", "off", shape=QAT_SHAPE, int8_train=True)
    cols = model.calibrate_quant_train(batch, c, z)
    want = quant_from_jax(tree, model)
    assert set(cols) == set(want) == {"content_encoder", "decoder"}
    assert len(cols["content_encoder"]) == 11 and len(cols["decoder"]) == 10
    for net, leaves in want.items():
        assert set(cols[net]) == set(leaves), net
        for key, w in leaves.items():
            assert float(w) > 0
            assert abs(float(cols[net][key]) - float(w)) <= 1e-6 * float(w), (net, key)
    # refreshing keeps the tree's structure
    assert set(model.calibrate_quant_train(batch, c, z)["decoder"]) == set(cols["decoder"])


def test_forward_random_stays_float_after_calibration(calibrated):
    _, batch, _, _, c, z = calibrated
    model = S.port_model("float32", "off", shape=QAT_SHAPE, int8_train=True)
    before = model.forward_random(batch["x1"], z, c)[0]
    with port_int8_calls() as calls:
        model.calibrate_quant_train(batch, c, z)
        after = model.forward_random(batch["x1"], z, c)[0]
    assert torch.equal(before, after) and calls == dict.fromkeys(INT8_OPS, 0)
    model.disable_int8_train()
    assert all(m.train_amax is None for net in ("content_encoder", "decoder")
               for m in model.nets[net].modules() if hasattr(m, "train_amax"))


def test_train_quant_requantizes_after_an_update():
    """The QAT QuantConv is made once per update: forwards reuse it, the
    model's update and a load drop it, and the next QAT forward quantizes
    the new weights."""
    model = S.port_model("float32", "off", shape=QAT_SHAPE, int8_train=True)
    batch, z_sr, z_sr2 = S.batch_and_draws(0)
    model.calibrate_quant_train(batch, np.eye(3, dtype=np.float32)[[0, 1]], z_sr)
    conv = model.nets.content_encoder.res0.conv1.conv
    q1 = conv.train_quant()
    assert conv.train_quant() is q1
    model.main_step(batch, StepDraws(z_sr=torch.from_numpy(z_sr), z_sr2=torch.from_numpy(z_sr2)))
    q2 = conv.train_quant()
    assert q2 is not q1 and not torch.equal(q2.w, q1.w)
    want = kq.quant_conv(conv.weight, conv.bias, conv.train_amax, 1, "reflect")
    for a, b in ((q2.w, want.w), (q2.scale, want.scale), (q2.inv_sx, want.inv_sx)):
        assert torch.equal(a, b)
    model.load_params({name: net.state_dict() for name, net in model.nets.items()})
    q3 = conv.train_quant()
    assert q3 is not q2 and torch.equal(q3.w, q2.w)


def test_trainer_calibrates_at_the_frequency_and_on_resume(tmp_path, monkeypatch):
    """``--int8_calib_freq 2``: an unbroken run calibrates at iterations 0,
    2 and 4; a run resumed at 3 at 3 (it has no calibration) and 4, as
    ``masterthesis_tpu/train.py:82-89``; every main step runs under QAT."""
    make_image_tree(tmp_path / "data", num_domains=3, per_domain=3)
    seen = []
    real = Trainer.calibrate

    def calibrate(self, args, model, batch, it):
        seen.append(it)
        return real(self, args, model, batch, it)

    monkeypatch.setattr(Trainer, "calibrate", calibrate)
    base = dict(QAT_SHAPE, load_size=36, dataroot=str(tmp_path / "data"),
                dataset=data.PairedDataset, model=models.AdaINModel, int8_train=True,
                int8_calib_freq=2, num_workers=0, print_freq=100, save_freq=3,
                display_freq=100, logdir=None)

    def dirs(name):
        out = dict(checkpoint_dir=str(tmp_path / name / "ckpt"),
                   display_dir=str(tmp_path / name / "images"))
        for d in out.values():
            os.makedirs(d)
        return out

    with port_int8_calls() as calls:
        model = Trainer(device="cpu").run(default_train_args(**base, n_iters=4, max_iter=4,
                                                             **dirs("a")))
    assert seen == [0, 2, 4] and model.int8_train_installed
    assert calls == {k: 5 * n for k, n in QAT_CALLS["reference"].items()}
    saved = os.path.join(str(tmp_path / "a" / "ckpt"))
    seen.clear()
    Trainer(device="cpu").run(default_train_args(
        **base, n_iters=4, max_iter=4, last_iter=2, resume=os.path.join(saved, "model_3.ckpt"),
        resume_opt=os.path.join(saved, "opt_3.ckpt"), **dirs("b")))
    assert seen == [3, 4]
