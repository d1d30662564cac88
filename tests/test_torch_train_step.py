"""The port's training step against the JAX package's, in f32.

Crop 32, dim 32 (every resblock (B, 128, 8, 8), eligible for the fused
path), latent 4, 3 domains, batch 2 per side, the content discriminator
with its small test shape; the same weights, batch and styles in both; no
content noise and z = mu (see tests/torch_train_steps.py). The fused step
holds the port's plain kernel 9/10 path against the JAX step with the Pallas
kernels in interpret mode; the composed step (``--fused_resblock off``) the
composed paths. Each phase is held from the same params in both packages.
Tolerances (``torch_train_steps.assert_step_matches``, with the reasons):
losses within 1e-4 relative; the D phases' gradients within 1e-3 of each
tensor's largest |gradient|; the G phases' within 2e-2 per net in norm, the
measured f32 noise of the step's cycle term in either package (without
that term, tests/test_torch_train_grad.py holds G1 per tensor at 1e-3);
updated params within 0.1 lr where the gradients agree.
"""
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fused_step():
    model = S.port_model("float32", "on")
    batch, z_sr, z_sr2 = S.batch_and_draws(0)
    f0, b0 = krb.resblock_fwd_plain.calls, krb.resblock_bwd_plain.calls
    port = S.run_port(model, batch, z_sr, z_sr2)
    calls = (krb.resblock_fwd_plain.calls - f0, krb.resblock_bwd_plain.calls - b0)
    ref = S.run_jax(dict(S.SHAPE, compute_dtype="float32", fused_resblock="auto"), port[2],
                    batch, z_sr, z_sr2, fused=True)
    return model, port, ref, calls, batch


def test_jax_tree_round_trips_through_params_from_jax():
    model = S.port_model("float32", "on", seed=3)
    back = S.params_from_jax(S.jax_tree(model), model)
    assert set(back) == set(model.nets) and "discriminator1" in back
    for net, sd in back.items():
        for k, v in model.nets[net].state_dict().items():
            assert torch.equal(sd[k], v), (net, k)


def test_fused_main_step_matches_jax(fused_step):
    model, port, ref, calls, _ = fused_step
    assert calls == (32, 24)
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4)


def test_content_step_matches_jax(fused_step):
    """The iteration after the main step (global_iter 1, d_iter 3) updates
    the content discriminator alone, at lr / 2.5 with its gradients clipped
    to global norm 5, on composed resblocks; the JAX step from the same
    params (``torch_train_steps.assert_content_step_matches``)."""
    model, _, _, _, batch = fused_step
    S.assert_content_step_matches(model, batch, dict(S.SHAPE, compute_dtype="float32"))
    assert model.state.step == 2


def test_composed_main_step_matches_jax():
    model = S.port_model("float32", "off", seed=1)
    batch, z_sr, z_sr2 = S.batch_and_draws(1)
    f0 = krb.resblock_fwd_plain.calls
    port = S.run_port(model, batch, z_sr, z_sr2)
    assert krb.resblock_fwd_plain.calls == f0
    ref = S.run_jax(dict(S.SHAPE, compute_dtype="float32", fused_resblock="off"), port[2],
                    batch, z_sr, z_sr2, fused=False)
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4)
