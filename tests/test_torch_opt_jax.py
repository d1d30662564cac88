"""An optimizer checkpoint the JAX package wrote (``opt_{it}.ckpt``), resumed
in the port with ``--resume --resume_opt``.

The JAX optimizer of a net is an optax chain (``models/functions.py``
``make_optimizer``): ``clip_by_global_norm`` (the content discriminator
only), ``add_decayed_weights`` (unless ``--wd 0``), ``scale_by_adam`` and
``scale(-1)``, so the Adam state sits at index 0, 1 or 2 of the serialized
tuple. Two configurations place it each way: the defaults with the content
discriminator (weight decay everywhere, the clip on the content
discriminator), and ``--wd 0``.

The JAX package's ``Model.save`` writes the files from the port's seeded
weights (carried into the JAX layout by the inverse of ``params_from_jax``)
and optax states moved off zero by two updates of random gradients. The
port must load ``count`` and ``step`` as they are, and ``mu``/``nu`` equal
(bit for bit) to the params' own conversion of the JAX moments. Then one
main step of each package from the loaded state (composed resblocks, f32,
crop 32, dim 8) agrees within the bounds of the step tests
(``torch_train_steps.assert_step_matches``: the losses within 1e-4
relative, and its gradient and parameter bounds).
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.models.state import TrainState  # noqa: E402
from masterthesis_tpu_torch.arguments import default_train_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel  # noqa: E402
from masterthesis_tpu_torch.models.model import find_adam  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

SHAPE = {**S.SHAPE, "dim": 8}
# the chain index of scale_by_adam: (content discriminator, every other net)
CASES = {"decay_and_clip": ({}, ("2", "1")), "no_decay": ({"wd": 0.0}, ("1", "0"))}
STEP = 7


def _moved_opt(jm, params, rng):
    """Each net's optax state after two updates of small random gradients."""
    opt = {}
    for name, p in params.items():
        state = jm.tx[name].init(p)
        for _ in range(2):
            g = jax.tree_util.tree_map(
                lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 1e-3), p)
            _, state = jm.tx[name].update(g, state, p)
        opt[name] = state
    return opt


@pytest.fixture(scope="module", params=list(CASES))
def resumed(request, tmp_path_factory):
    flags, where = CASES[request.param]
    ckdir = str(tmp_path_factory.mktemp(f"jax_opt_{request.param}"))
    seeded = S.port_model("float32", "off", seed=3, shape=SHAPE, **flags)
    tree = S.jax_tree(seeded)
    jm = S.jax_model({**SHAPE, **flags, "checkpoint_dir": ckdir})
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = _moved_opt(jm, params, np.random.default_rng(4))
    state = TrainState.create(params, opt, S.jax_extra(seeded))
    jm.save(state.replace(step=jnp.asarray(STEP, jnp.int32)), STEP)
    model = AdaINModel(default_train_args(
        compute_dtype="float32", fused_resblock="off", logdir=None, last_iter=3,
        resume=os.path.join(ckdir, f"model_{STEP}.ckpt"),
        resume_opt=os.path.join(ckdir, f"opt_{STEP}.ckpt"), **SHAPE, **flags), device="cpu")
    return SimpleNamespace(name=request.param, flags=flags, where=where, tree=tree, opt=opt,
                           model=model)


def test_the_adam_state_is_found_where_the_chain_puts_it(resumed):
    r = resumed
    from flax import serialization

    for name, state in r.opt.items():
        serial = serialization.to_state_dict(state)
        key = r.where[0] if name == "content_discriminator" else r.where[1]
        assert find_adam(serial) is serial[key]
        assert set(serial) == {str(i) for i in range(int(key) + 2)}


def test_the_moments_count_and_step_load_as_jax_wrote_them(resumed):
    r = resumed
    tm = r.model
    assert tm.state.step == STEP  # the file's step, not last_iter + 1
    assert set(tm.state.opt_state) == set(r.opt)
    for name, state in r.opt.items():
        adam = state[int(r.where[0] if name == "content_discriminator" else r.where[1])]
        mine = tm.state.opt_state[name]
        assert mine.count == int(adam.count) == 2
        keys = [k for k, _ in tm.nets[name].named_parameters()]
        for kind in ("mu", "nu"):
            want = S.to_port(tm, name, jax.tree_util.tree_map(np.asarray, getattr(adam, kind)),
                             r.tree)
            got = getattr(mine, kind)
            assert len(got) == len(keys)
            for key, t in zip(keys, got):
                assert t.dtype == torch.float32
                assert torch.equal(t, want[key]), (name, kind, key)
                assert t.abs().max() > 0, (name, kind, key)


def test_the_next_main_step_matches_jax(resumed):
    """The port's main step from the resumed state against the JAX
    package's from the same params and the optax states it wrote."""
    r = resumed
    batch, z_sr, z_sr2 = S.batch_and_draws(2)
    port = S.run_port(r.model, batch, z_sr, z_sr2)
    assert r.model.state.step == STEP + 1
    # G1 and G2 both update the content encoder and the decoder
    counts = {n: s.count for n, s in r.model.state.opt_state.items()}
    assert counts == {"discriminator1": 3, "discriminator2": 3, "style_encoder": 3,
                      "content_encoder": 4, "decoder": 4, "content_discriminator": 2}
    ref = S.run_jax({**SHAPE, **r.flags}, port[2], batch, z_sr, z_sr2, fused=False,
                    opt=r.opt)
    S.assert_step_matches(r.model, port, ref, loss_rtol=1e-4, min_move=0.1)
