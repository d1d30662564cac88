"""A whole main step of each training loss variant of the port against the
JAX package's, on the CPU: ``--gan_mode hinge`` with ``--dis_sn`` on
BaseModel A, ``--use_ragan`` on AdaINModel, and WGAN-GP with the
multi-scale, spectrally normalized, instance-normed discriminator on
BaseModel B (the penalty's D forward iterates from the stored ``u``, the
multi-scale trunk's recording forward on from its last ``u`` at each
scale; the penalty's eps is JAX's ``uniform`` of a fixed key, handed to the
port). Shapes as tests/test_torch_train_variants.py.

Each step is held by ``torch_train_steps.assert_step_matches`` at the
reference step's tolerances (losses 1e-4 relative, D gradients 1e-3 of each
tensor's largest, G gradients 2e-2 per net in norm, updated params within
0.1 lr where the gradients agree), and under ``--dis_sn`` the stored ``u``
after the D updates, moved, within 1e-6 of JAX's.
"""
import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu_torch.models import AdaINModel, BaseModel  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402
from tests.test_torch_train_variants import F32, MS, SMALL, _close, _gp_eps  # noqa: E402

torch.set_num_threads(2)


STEPS = {
    # (model, flags, seed): every variant in at least one whole step
    "hinge_dis_sn_base_a": (BaseModel, dict(gan_mode="hinge", dis_sn=True), 0),
    "ragan_adain": (AdaINModel, dict(use_ragan=True), 1),
    # the penalty's D forward iterates from the stored u; the multi-scale
    # trunk's recording forward iterates on from its last u at each scale
    "wgangp_ms_dis_sn_instance_base_b": (
        BaseModel, dict(MS, concat=True, reparam=True, gan_mode="wgangp", lambda_gp=10.0,
                        dis_norm="instance", dis_sn=True), 2),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_variant_main_step_matches_jax(name):
    model_cls, flags, seed = STEPS[name]
    model = S.port_model("float32", "off", seed=seed, model_cls=model_cls, shape=SMALL, **flags)
    batch, z_sr, z_sr2 = S.batch_and_draws(seed)
    gp, keys = {}, None
    if "lambda_gp" in flags:
        keys = {p: jax.random.fold_in(jax.random.PRNGKey(seed), i) for i, p in ((1, "d1"), (2, "d2"))}
        gp = {f"{p}.gp_eps": _gp_eps(k, 2 * S.B) for p, k in keys.items()}
    extras = []
    port = S.run_port(model, batch, z_sr, z_sr2, extras, **gp)
    assert ("d_gp" in port[0]) == bool(gp)
    spectral_out = {}
    ref = S.run_jax(dict(F32, **flags), port[2], batch, z_sr, z_sr2, fused=False,
                    model_cls=model_cls, extras=extras, gp_keys=keys,
                    spectral_out=spectral_out)
    S.assert_step_matches(model, port, ref, loss_rtol=1e-4,
                          min_move=0.1 if model_cls is BaseModel else 0.0)
    if flags.get("dis_sn"):
        # the stored u after D1 and D2, moved: JAX's u of the same update
        assert set(spectral_out) == {"discriminator1", "discriminator2"}
        for d, tree in spectral_out.items():
            got = jax.tree_util.tree_leaves(extras[-1][d])
            want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))
            before = jax.tree_util.tree_leaves(extras[0][d])
            assert len(got) == len(want) == len(before) == (model.args.dis_n_layers or 6)
            for g, w, u0 in zip(got, want, before):
                _close(g, w, 1e-6, f"{d} u")
                assert not np.array_equal(g, u0), d
