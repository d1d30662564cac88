"""One main training step of AdaINModel with ``--up_type pixelshuffle`` and
batch norm in both the encoder and the decoder (``--enc_norm batch
--dec_norm batch``), the port against the JAX package on the same weights,
batch and draws (composed resblocks, f32, crop 32, dim 8), within the
bounds of the step tests (``torch_train_steps.assert_step_matches``: the
losses within 1e-4 relative, and its gradient and parameter bounds).
"""
import pytest
import torch

pytest.importorskip("flax")

from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)


def test_a_pixelshuffle_batch_norm_main_step_matches_jax():
    flags = dict(up_type="pixelshuffle", enc_norm="batch", dec_norm="batch")
    shape = {**S.SHAPE, "dim": 8}
    model = S.port_model("float32", "off", seed=6, shape=shape, **flags)
    batch, z_sr, z_sr2 = S.batch_and_draws(6)
    port = S.run_port(model, batch, z_sr, z_sr2)
    ref = S.run_jax({**shape, **flags}, port[2], batch, z_sr, z_sr2, fused=False)
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4, min_move=0.1)
