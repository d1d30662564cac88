"""BaseModel's training step, config A (the CLI default: plain style
encoder, ``Decoder`` with ``DecResnetBlock``s), the port against the JAX
package, in f32.

The setup and tolerances of tests/test_torch_train_step.py
(``torch_train_steps``): crop 32, dim 32 (the content encoder's resblocks
(B, 128, 8, 8), eligible for the fused path; the decoder's blocks have no
whole-block kernel), latent 4, 3 domains, batch 2 per side; the same
weights, batch and styles in both packages; no content noise; each phase
from the same params. Losses within 1e-4 relative; the D phases' gradients
within 1e-3 of each tensor's largest |gradient|; the G phases' within 2e-2
per net in norm; updated params within 0.1 lr where the gradients agree,
and moved wherever JAX moved them by more than 0.1 lr (``min_move``: G2's
Adam moment can cancel to within the gradients' noise).
Without ``reparam`` the JAX step takes ``kl_zs = l2_regularize(z_s) * 0.01``
and regresses the style code ``z_rec`` in phase 2, which the loss test holds
term by term.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.models import losses as JL  # noqa: E402
from masterthesis_tpu_torch.models import BaseModel  # noqa: E402
from masterthesis_tpu_torch.models import losses as L  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

FLAGS = {}
# kernel 9 / 10 calls per main step: the content encoder's four blocks in
# the D fakes (forward only), G1 (two encodes) and G2 (one encode)
PER_STEP = (16, 12)


def _args(**kw):
    return dict(S.SHAPE, compute_dtype="float32", **FLAGS, **kw)


@pytest.fixture(scope="module")
def fused_step():
    model = S.port_model("float32", "on", model_cls=BaseModel, **FLAGS)
    batch, z_sr, z_sr2 = S.batch_and_draws(0)
    f0, b0 = krb.resblock_fwd_plain.calls, krb.resblock_bwd_plain.calls
    port = S.run_port(model, batch, z_sr, z_sr2)
    calls = (krb.resblock_fwd_plain.calls - f0, krb.resblock_bwd_plain.calls - b0)
    with S.jax_kernel_calls() as jax_calls:
        ref = S.run_jax(_args(fused_resblock="auto"), port[2], batch, z_sr, z_sr2, fused=True,
                        model_cls=BaseModel)
    return model, port, ref, calls, (jax_calls["fwd"], jax_calls["bwd"]), batch


def test_fused_main_step_matches_jax(fused_step):
    model, port, ref, calls, jax_calls, _ = fused_step
    assert calls == jax_calls == PER_STEP
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4, min_move=0.1)


def test_content_step_matches_jax(fused_step):
    model, _, _, _, _, batch = fused_step
    S.assert_content_step_matches(model, batch, _args(), model_cls=BaseModel)


@pytest.fixture(scope="module")
def composed_step():
    model = S.port_model("float32", "off", seed=1, model_cls=BaseModel, **FLAGS)
    batch, z_sr, z_sr2 = S.batch_and_draws(1)
    f0 = krb.resblock_fwd_plain.calls
    port = S.run_port(model, batch, z_sr, z_sr2)
    assert krb.resblock_fwd_plain.calls == f0
    ref = S.run_jax(_args(fused_resblock="off"), port[2], batch, z_sr, z_sr2, fused=False,
                    model_cls=BaseModel)
    return model, port, ref, batch


def test_composed_main_step_matches_jax(composed_step):
    model, port, ref, _ = composed_step
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4, min_move=0.1)


def test_plain_encoder_loss_terms_match_jax(composed_step):
    """``kl_zs`` is 0.01 x the mean square of the style code (no mu, no
    logvar), in both packages on the G1 phase's params, and the G1 and G2
    logs ``kl_zs`` and ``l1_recon_z`` (the re-encoded style code regressed
    onto ``z_sr2``) agree with JAX's ``_g1_loss`` and ``_g2_loss`` within
    1e-5 relative."""
    model, port, ref, batch = composed_step
    logs, _, trees = port
    jlogs = ref[0]
    g1 = S.port_model("float32", "off", model_cls=BaseModel, **FLAGS)
    g1.load_params(S.params_from_jax(trees[2], g1))
    img, c_org, _ = g1._batch(batch)
    with torch.no_grad():
        z_s = g1.nets.style_encoder(img, c_org)
    kl = float(logs["kl_zs"])
    assert abs(kl - float(L.l2_regularize(z_s)) * 0.01) <= 1e-6 * kl
    jm = S.jax_model(_args(), BaseModel)
    params = jax.tree_util.tree_map(jnp.asarray, trees[2])
    jimg = jnp.concatenate([batch["x1"], batch["x2"]])
    jc = jnp.concatenate([batch["y1"], batch["y2"]])
    jz, mu, logvar = jm.encode_style(params, jimg, jc)
    assert mu is None and logvar is None
    jkl = float(jlogs["kl_zs"])
    assert abs(jkl - float(JL.l2_regularize(jz)) * 0.01) <= 1e-6 * jkl
    for k in ("kl_zs", "l1_recon_z"):
        assert abs(float(logs[k]) - float(jlogs[k])) <= 1e-5 * abs(float(jlogs[k])), k
