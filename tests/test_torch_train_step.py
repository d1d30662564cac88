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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_train_args as jax_train_args  # noqa: E402
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel  # noqa: E402
from masterthesis_tpu.models import losses as JL  # noqa: E402
from masterthesis_tpu.models.functions import apply_updates as jax_apply_updates  # noqa: E402
from masterthesis_tpu_torch.models.translation import StepDraws  # noqa: E402
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
    params."""
    model, _, _, _, batch = fused_step
    d = "content_discriminator"
    f0 = krb.resblock_fwd_plain.calls
    with S.recording(model) as updates:
        logs = model.optimize_parameters(batch, 1, StepDraws())
    assert krb.resblock_fwd_plain.calls == f0 and set(logs) == {"d_content_cls"}
    assert model.state.step == 2
    [(net, grads, tree)] = updates

    jm = JaxAdaINModel(jax_train_args(logdir=None, mode="train", compute_dtype="float32",
                                      **S.SHAPE))
    jm._make_tx()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    img = jnp.concatenate([batch["x1"], batch["x2"]])
    c_org = jnp.concatenate([batch["y1"], batch["y2"]])
    z_c = jm.encode_content(params, {}, img, None, train=False)

    def loss_fn(p):
        return JL.bce_logits_loss(jm.nets[d].apply({"params": p}, z_c), c_org)

    loss, g = jax.value_and_grad(loss_fn)(params[d])
    opt = jm.tx[d].init(params[d])
    lr = jm.schedule(jnp.ones((), jnp.int32)) / 2.5
    new, _ = jax_apply_updates(jm.tx[d], g, opt, params[d], lr)
    assert net == d
    assert abs(float(logs["d_content_cls"]) - float(loss)) <= 1e-4 * abs(float(loss))
    want = S.to_port(model, d, jax.tree_util.tree_map(np.asarray, new), tree)
    jgrads = S.to_port(model, d, jax.tree_util.tree_map(np.asarray, g), tree)
    before = S.to_port(model, d, tree[d], tree)
    # Adam's direction is that of the clipped, decayed gradient
    clip = [min(1.0, 5.0 / S._norm(g.values())) for g in (grads, jgrads)]
    # a conv bias right before its instance norm has a roundoff-only gradient
    floor = 1e-4 * max(g.abs().max().item() for g in jgrads.values())
    for k, w in want.items():
        jg = jgrads[k]
        assert (grads[k] - jg).abs().max().item() <= 1e-3 * max(jg.abs().max().item(), floor), k
        got = model.nets[d].state_dict()[k]
        assert bool((got != before[k]).all()), k
        u, v = (c * g[k] + 1e-4 * before[k] for c, g in zip(clip[::-1], (jgrads, grads)))
        m = (u.abs() > 1e-4 * u.abs().max()) & ((v - u).abs() <= 0.1 * u.abs())
        assert ((got - w).abs() * m).max().item() <= 0.1 * float(lr), k


def test_composed_main_step_matches_jax():
    model = S.port_model("float32", "off", seed=1)
    batch, z_sr, z_sr2 = S.batch_and_draws(1)
    f0 = krb.resblock_fwd_plain.calls
    port = S.run_port(model, batch, z_sr, z_sr2)
    assert krb.resblock_fwd_plain.calls == f0
    ref = S.run_jax(dict(S.SHAPE, compute_dtype="float32", fused_resblock="off"), port[2],
                    batch, z_sr, z_sr2, fused=False)
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4)
