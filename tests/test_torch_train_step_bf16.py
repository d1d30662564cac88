"""The port's fused training step against the JAX package's in bf16 (see
tests/test_torch_train_step.py for the f32 steps and the setup).

Losses within 3 %, the tolerance of the JAX package's own fused-against-
composed test (tests/test_resblock_bf16.py): bf16 rounds the conv outputs,
the dgrads and every activation, in another order in each package. The
gradients: per net, the port's bf16 gradient is no further from the JAX
package's f32 gradient (at the same params) than the JAX package's own bf16
gradient is, within 25 % and 2 % of the norm (see
``torch_train_steps.assert_step_matches``). The params are not compared: a
bf16-sized gradient difference flips the sign of many small Adam steps."""
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu_torch.ops.kernels import resblock_train as krb  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)


def test_fused_main_step_matches_jax_in_bf16():
    model = S.port_model("bfloat16", "on", seed=2)
    batch, z_sr, z_sr2 = S.batch_and_draws(2)
    f0, b0 = krb.resblock_fwd_plain.calls, krb.resblock_bwd_plain.calls
    port = S.run_port(model, batch, z_sr, z_sr2)
    assert (krb.resblock_fwd_plain.calls - f0, krb.resblock_bwd_plain.calls - b0) == (32, 24)
    ref = S.run_jax(dict(S.SHAPE, compute_dtype="bfloat16", fused_resblock="auto"), port[2],
                    batch, z_sr, z_sr2, fused=True)
    # the f32 gradient at the same params, composed (no interpret mode)
    ref32 = S.run_jax(dict(S.SHAPE, compute_dtype="float32"), port[2], batch, z_sr, z_sr2,
                      fused=False)
    S.assert_step_matches(model, port, ref, loss_rtol=0.03, check_params=False, ref32=ref32)
