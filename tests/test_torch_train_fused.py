"""The fused GAN step (``--gan_step fused``) of the port against the JAX
package's, in f32 on the CPU.

Crop 32, dim 32 (every resblock (2, 128, 8, 8) or (4, 128, 8, 8): eligible
for kernels 9/10, whose plain versions the port runs with
``--fused_resblock on``), latent 4, 3 domains, batch 2 per side, the content
discriminator at its small test shape; no content noise and z = mu
(``torch_train_steps``). The JAX step is its fused body composed from its
own jitted pieces with ``ks=None`` on composed resblocks (``_g1_forward``'s
vjp, ``_d_loss`` for D1 and D2, the adversarial gradient at the fakes,
``_g2_loss``), each phase from the port's params at that phase, held by
``torch_train_steps.assert_step_matches`` at the reference step's
tolerances (losses within 1e-4 relative, D gradients within 1e-3 of each
tensor's largest, G gradients within 2e-2 per net in norm, updated params
within 0.1 lr where the gradients agree). Kernel 9/10 calls are held to a
trace of the JAX package's whole fused body. Without draws the fused step
computes the reference step's update (its D fakes are G1's, and every norm
is per sample): the two port steps are held to each other at the same
tolerances, with no JAX.
"""
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu_torch.models import AdaINModel, BaseModel  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

F32 = dict(S.SHAPE, compute_dtype="float32")


def _port_step(model_cls=AdaINModel, fused="on", seed=0, **flags):
    model = S.port_model("float32", fused, seed=seed, model_cls=model_cls, **flags)
    batch, z_sr, z_sr2 = S.batch_and_draws(seed)
    f0, b0 = krb.resblock_fwd_plain.calls, krb.resblock_bwd_plain.calls
    port = S.run_port(model, batch, z_sr, z_sr2)
    calls = (krb.resblock_fwd_plain.calls - f0, krb.resblock_bwd_plain.calls - b0)
    return model, port, calls, (batch, z_sr, z_sr2)


@pytest.fixture(scope="module")
def fused_adain():
    return _port_step(gan_step="fused")


def test_fused_main_step_matches_jax(fused_adain):
    model, port, calls, (batch, z_sr, z_sr2) = fused_adain
    assert calls == (28, 24)
    ref = S.run_jax(dict(F32, gan_step="fused", fused_resblock="off"), port[2], batch, z_sr,
                    z_sr2, fused=False, gan_step="fused")
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4)


def test_base_model_b_fused_main_step_matches_jax():
    """BaseModel B (``--concat --reparam``): kernels 9/10 carry the content
    encoder and ``dec_share`` through G1, the D2 decode and G2."""
    flags = dict(concat=True, reparam=True, gan_step="fused")
    model, port, calls, (batch, z_sr, z_sr2) = _port_step(BaseModel, seed=5, **flags)
    assert calls == (16, 15)
    ref = S.run_jax(dict(F32, fused_resblock="off", **flags), port[2], batch, z_sr, z_sr2,
                    fused=False, model_cls=BaseModel, gan_step="fused")
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4, min_move=0.1)


def _held_to(port, ref_port, model):
    """The fused step's run against the reference step's run of the port,
    in ``assert_step_matches``' terms: the reference run's logs, gradients
    and updated nets as the JAX package's trees."""
    logs, phases, trees = ref_port
    grads = [{net: S.jax_tree_of(model, net, g) for net, g in p.items()} for p in phases]
    updated = [{net: trees[i + 1][net] for net in p} for i, p in enumerate(phases)]
    ref = ({k: float(v) for k, v in logs.items()}, grads, updated)
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4)


@pytest.mark.parametrize("model_cls,flags", [(AdaINModel, {}),
                                             (BaseModel, dict(concat=True, reparam=True))])
def test_fused_step_equals_the_reference_step_without_draws(fused_adain, model_cls, flags):
    """No noise, z = mu, no dropout: the fused step's D fakes are G1's fakes
    (``translation.py`` of the JAX package, :461-479 against :497-503), so
    both steps compute one update, from the same weights and batch."""
    if model_cls is AdaINModel:
        model, fused, _, _ = fused_adain
    else:
        model, fused, _, _ = _port_step(model_cls, seed=0, gan_step="fused", **flags)
    _, ref, calls, _ = _port_step(model_cls, seed=0, **flags)
    assert calls == ((32, 24) if model_cls is AdaINModel else (20, 15))
    _held_to(fused, ref, model)


@pytest.mark.parametrize("model_cls,flags,want", [
    (AdaINModel, {}, (28, 24)),
    (BaseModel, {}, (12, 12)),
    (BaseModel, dict(concat=True, reparam=True), (16, 15)),
])
def test_fused_kernel_calls_equal_a_trace_of_the_jax_fused_body(model_cls, flags, want):
    """The port's kernel 9/10 calls per fused main step (G1: two encodes and
    two decodes, D2's decode forward only, G2) equal the JAX package's calls
    in one trace of ``_main_step_fused_body`` at the same weights; its
    reference body traces to the reference step's calls."""
    model, _, calls, (batch, _, _) = _port_step(model_cls, gan_step="fused", **flags)
    assert calls == want
    args = dict(F32, fused_resblock="auto", **flags)
    assert S.jax_body_calls(args, model, batch, "fused", model_cls) == want
    if model_cls is AdaINModel:
        assert S.jax_body_calls(args, model, batch, "reference", model_cls) == (32, 24)
