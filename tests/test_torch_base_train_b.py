"""BaseModel's training step, config B (``--concat --reparam``:
``DecoderConcat`` and the reparameterized style encoder), the port against
the JAX package, in f32.

The setup and tolerances of tests/test_torch_base_train_a.py. At dim 32
``dec_share`` is 128 wide and takes kernels 9/10 beside the content
encoder's blocks, at 2B and 4B images; the ``dec1_*`` blocks are 135 wide
(128 + 4 + 3), fail ``resblock_train_eligible`` (C % 128) and compose, the
split of the full width's 256 and 268.
"""
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu_torch.models import BaseModel  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

FLAGS = dict(concat=True, reparam=True)
# kernel 9 / 10 calls per main step: config A's 16 / 12 and dec_share once
# per decode (D fakes, G1 twice, G2), backward in G1 and G2
PER_STEP = (20, 15)


def _args(**kw):
    return dict(S.SHAPE, compute_dtype="float32", **FLAGS, **kw)


@pytest.fixture(scope="module")
def fused_step():
    model = S.port_model("float32", "on", seed=5, model_cls=BaseModel, **FLAGS)
    batch, z_sr, z_sr2 = S.batch_and_draws(5)
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
