"""The VGG perceptual loss (``--vgg_loss``) and ``--remat`` of the port, on
the CPU.

- ``VGGPerceptualLoss`` against Flax's on random weights (the JAX model's
  ``init_perceptual``, carried by ``perceptual_from_jax``): vgg16 and vgg19,
  l1 and l2, with and without ``--norm_feat``, shallow layers at 32 px; the
  loss within 1e-5 relative and its gradient in the fakes within 1e-4 of
  the largest, f32 whatever the training dtype.
- ``load_vgg_params`` on a synthetic npz of HWIO kernels, against the JAX
  package's loader (1e-5).
- A whole main step with the perceptual terms (``g_p`` on [img_ab, img_ba],
  ``g_p2`` on [img_ar, img_br]) held by
  ``torch_train_steps.assert_step_matches`` at the reference step's
  tolerances; the VGG gets no gradient and no optimizer state.
- ``--remat`` gives the step without it, bit for bit (the recompute runs the
  same ops on the same draws), for both GAN steps. Kernel 9 launches once
  per block forward and again per block recomputed in backward (AdaINModel:
  32 + 24 reference, 28 + 24 fused; kernel 10 24 either way), as many as a
  trace of the JAX package's body calls it (``jax.checkpoint`` traces the
  recomputed forward again).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.models import losses as JL  # noqa: E402
from masterthesis_tpu_torch.arguments import default_train_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel, BaseModel  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import perceptual_from_jax  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(S.SHAPE, dim=8)


def _nchw(a):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2).contiguous()


def _close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _vgg_pair(vgg, model_cls=AdaINModel, dtype="float32", seed=0, shape=SMALL, **flags):
    """The port model with ``vgg`` flags, and the JAX model's perceptual
    params (its random init) carried into it."""
    port = S.port_model(dtype, "off", seed=seed, model_cls=model_cls, shape=shape, **vgg, **flags)
    jm = S.jax_model(dict(shape, compute_dtype=dtype, **vgg, **flags), model_cls)
    jm.init_perceptual(jax.random.PRNGKey(seed + 40))
    port.perceptual.load_state_dict(perceptual_from_jax(jm.perceptual_params, port))
    return port, jm


VGG_CASES = [
    dict(vgg_type="vgg19", vgg_layers=["conv2_1"], layer_weights=[1.0], vgg_loss="l2",
         norm_feat=True),
    dict(vgg_type="vgg19", vgg_layers=["relu1_2", "conv2_2"], layer_weights=[0.5, 2.0],
         vgg_loss="l1"),
    dict(vgg_type="vgg16", vgg_layers=["conv1_2", "relu2_1"], layer_weights=[1.0, 1.0],
         vgg_loss="l2"),
    dict(vgg_type="vgg16", vgg_layers=["conv2_2"], layer_weights=[1.0], vgg_loss="l1",
         norm_feat=True),
]


@pytest.mark.parametrize("vgg", VGG_CASES)
def test_perceptual_loss_matches_flax(vgg):
    port, jm = _vgg_pair(vgg, dtype="bfloat16")
    assert not any(p.requires_grad for p in port.perceptual.parameters())
    assert "perceptual" not in port.nets and "perceptual" not in port.state.opt_state
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = np.tanh(rng.standard_normal((2, 32, 32, 3))).astype(np.float32)
    want, j_dy = jax.value_and_grad(
        lambda y_: jm._perceptual_loss(jm.perceptual_params, jnp.asarray(x), y_))(jnp.asarray(y))
    yt = _nchw(y).requires_grad_(True)
    got = port.perceptual(_nchw(x), yt)
    assert got.dtype == torch.float32
    (dy,) = torch.autograd.grad(got, yt)
    _close(got.detach().numpy(), want, 1e-5, "loss")
    _close(dy.permute(0, 2, 3, 1).numpy(), j_dy, 1e-4, "d fake")


def test_load_vgg_params_reads_an_npz_as_the_jax_loader(tmp_path):
    """Every conv of vgg19 in an npz (HWIO kernels, biases); an extractor to
    ``conv2_2`` takes its four and leaves the rest, as JAX's loader does."""
    rng = np.random.default_rng(6)
    path = tmp_path / "vgg19.npz"
    arrays, d = {}, 3
    widths = iter(v for v in JL.VGG_CONFIGS["vgg19"] if v != "M")
    for name in JL.vgg_layer_names("vgg19"):
        if name.startswith("conv"):
            w = next(widths)
            arrays[f"{name}/kernel"] = (rng.standard_normal((3, 3, d, w)) / np.sqrt(9 * d)).astype(
                np.float32)
            arrays[f"{name}/bias"] = (rng.standard_normal(w) * 0.1).astype(np.float32)
            d = w
    np.savez(path, **arrays)
    vgg = dict(vgg_type="vgg19", vgg_layers=["conv2_2"], layer_weights=[1.0], vgg_loss="l2")
    port = AdaINModel(default_train_args(fused_resblock="off", vgg_weights=str(path), **vgg,
                                         **SMALL), device="cpu")
    assert sorted(k.split(".")[1] for k in port.perceptual.state_dict()) == [
        "conv1_1", "conv1_1", "conv1_2", "conv1_2", "conv2_1", "conv2_1", "conv2_2", "conv2_2"]
    jm = S.jax_model(dict(SMALL, **vgg))
    jm.init_perceptual(weights_path=str(path))
    x = np.random.default_rng(7).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = x[::-1].copy()
    want = jm._perceptual_loss(jm.perceptual_params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = port.perceptual(_nchw(x), _nchw(y))
    _close(got.numpy(), want, 1e-5, "loss from the npz")


@pytest.mark.parametrize("model_cls,flags,seed", [
    (AdaINModel, dict(vgg_loss="l2", vgg_layers=["conv2_1"], norm_feat=True), 3),
    (BaseModel, dict(vgg_loss="l1", vgg_layers=["relu1_2"], gan_step="fused"), 4),
])
def test_perceptual_main_step_matches_jax(model_cls, flags, seed):
    vgg = {k: v for k, v in flags.items() if k != "gan_step"}
    gan_step = flags.get("gan_step", "reference")
    port_model, jm = _vgg_pair(vgg, model_cls, seed=seed, gan_step=gan_step)
    assert {"g_p", "g_p2"} <= set(port_model.print_loss)
    batch, z_sr, z_sr2 = S.batch_and_draws(seed)
    port = S.run_port(port_model, batch, z_sr, z_sr2)
    assert {"g_p", "g_p2"} <= set(port[0]) and float(port[0]["g_p"]) > 0
    assert set(port_model.print_losses()) == {"g_adv", "g_cls", "l1_cc_rec", "g_p", "g_p2"}
    ref = S.run_jax(dict(SMALL, compute_dtype="float32", fused_resblock="off", gan_step=gan_step,
                         **vgg), port[2], batch, z_sr, z_sr2, fused=False, model_cls=model_cls,
                    gan_step=gan_step, aux=jm.perceptual_params)
    S.assert_step_matches(port_model, port, ref, loss_rtol=1e-4,
                          min_move=0.1 if model_cls is BaseModel else 0.0)


@pytest.mark.parametrize("gan_step,dropout_want,want", [
    ("reference", (16, 12), (56, 24)),
    ("fused", (12, 12), (52, 24)),
])
def test_remat_step_equals_the_step_without_it(gan_step, dropout_want, want):
    """Same weights, batch and random draws (noise, eps, dropout masks from
    one generator seed): ``--remat`` changes no loss and no parameter."""
    out = []
    for remat in (False, True):
        model = S.port_model("float32", "on", seed=8, use_dropout=True, gan_step=gan_step,
                             remat=remat)
        batch, _, _ = S.batch_and_draws(8)
        model.generator.manual_seed(9)
        f0, b0 = krb.resblock_fwd_plain.calls, krb.resblock_bwd_plain.calls
        logs = model.optimize_parameters(batch, 0)
        calls = (krb.resblock_fwd_plain.calls - f0, krb.resblock_bwd_plain.calls - b0)
        out.append((logs, {n: net.state_dict() for n, net in model.nets.items()}, calls))
    (la, pa, ca), (lb, pb, cb) = out
    # with --use_dropout only the encoder's 4 blocks take kernels 9/10; remat
    # recomputes the 12 of G1's and G2's encodes
    assert ca == dropout_want and cb == (dropout_want[0] + 12, 12)
    assert {k: float(v) for k, v in la.items()} == {k: float(v) for k, v in lb.items()}
    for net in pa:
        for k in pa[net]:
            assert torch.equal(pa[net][k], pb[net][k]), (net, k)
    # without dropout every block is on kernels 9/10: the recompute's
    # launches equal a trace of the JAX package's body, whose jax.checkpoint
    # traces each recomputed block's forward again in the backward
    model = S.port_model("float32", "on", seed=8, gan_step=gan_step, remat=True)
    batch, z_sr, z_sr2 = S.batch_and_draws(8)
    f0, b0 = krb.resblock_fwd_plain.calls, krb.resblock_bwd_plain.calls
    S.run_port(model, batch, z_sr, z_sr2)
    assert (krb.resblock_fwd_plain.calls - f0, krb.resblock_bwd_plain.calls - b0) == want
    model = S.port_model("float32", "on", seed=8, gan_step=gan_step)
    args = dict(S.SHAPE, compute_dtype="float32", fused_resblock="auto", remat=True)
    assert S.jax_body_calls(args, model, batch, gan_step) == want


def test_remat_with_int8_train_raises():
    with pytest.raises(ValueError, match="remat"):
        AdaINModel(default_train_args(remat=True, int8_train=True, **SMALL), device="cpu")
