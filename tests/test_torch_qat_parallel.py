"""``--int8_train`` under data parallelism: two gloo ranks on the CPU
(``parallel.mesh.run_ranks``, tests/torch_qat_parallel_worker.py) against
one process on the global batch, at tests/test_torch_qat.py's QAT_SHAPE
with a global batch of 4 a side (2 rows a rank), f32, the kernels' plain
versions.

- ``calibrate_quant_train``: the ranks, each on its rows of the batch and
  of the draws, install one amax tree, equal bit for bit to one process's
  MAX over its calibrations of the two row halves, and within 1e-6
  relative of its calibration of the whole batch (the convs sum in another
  order at another batch size); the trees of the ranks are equal. A rank
  whose rows are all zeros measures an amax of exactly 0 at the first
  conv, and MAX keeps the other rank's there.
- One process's tree is held against JAX's ``calibrate_quant_train`` on the
  same global batch and draws within 1e-6 relative, as
  tests/test_torch_qat.py holds the one-device tree.
- ``Trainer.calibrate`` under the mesh: the ranks' draws, in rank order,
  are one process's draws for the global batch.
- One reference and one fused QAT main step of the ranks against one
  process on the global batch with the same tree and draws, at
  tests/test_torch_parallel.py's bars (the gradients each rank applies, the
  ranks' mean, within 1e-5 of the net's largest |gradient| in the
  one-process step, a conv bias before a norm, whose gradient is roundoff,
  under 1e-4 of it on both sides; the logs within rtol 2e-3 / atol 2e-4),
  with the params and the int8
  weights (quantized anew from the updated weights) bit-equal across the
  ranks.
- The train CLI's ``Trainer`` with ``--int8_train --num_devices 2`` for two
  iterations, calibrating at both: every rank calibrates in the same
  iterations and the ranks end on the same params and int8 weights.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu_torch.models.blocks import BatchNorm2d  # noqa: E402
from masterthesis_tpu_torch.models.translation import INT8_NETS  # noqa: E402
from masterthesis_tpu_torch.ops.norms import InstanceNorm  # noqa: E402
from masterthesis_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import quant_from_jax  # noqa: E402
from tests import torch_qat_parallel_worker as W  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

from conftest import make_image_tree  # noqa: E402

torch.set_num_threads(2)

GRAD_TOL = 1e-5  # of the net's largest |gradient|, tests/test_torch_parallel.py's
LOG_RTOL, LOG_ATOL = 2e-3, 2e-4
AMAX_RTOL = 1e-6


def _jax_calibration(batch):
    """JAX's ``calibrate_quant_train`` on the seeded model's weights and the
    global batch, and the draws (c, z) it made from its key."""
    model = W.make_model()
    jm = S.jax_model(dict(W.SHAPE, **W.QAT))
    params = jax.tree_util.tree_map(jnp.asarray, S.jax_tree(model))
    from masterthesis_tpu.models.state import TrainState

    state = TrainState.create(params, {n: jm.tx[n].init(params[n]) for n in params}, {})
    key = jax.random.PRNGKey(7)
    tree = jm.calibrate_quant_train(state, {k: jnp.asarray(batch[k]) for k in ("x1", "x2")}, key)
    kz, kc = jax.random.split(key)
    k = W.SHAPE["num_domains"]
    c = np.asarray(jax.nn.one_hot(jax.random.randint(kc, (W.B,), 0, k), k), np.float32)
    z = np.asarray(jm.get_z_random(kz, W.B), np.float32)
    return quant_from_jax(jax.tree_util.tree_map(np.asarray, tree), model), c, z


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and this process's counterparts, computed while
    the ranks run."""
    root = tmp_path_factory.mktemp("qat_dp")
    make_image_tree(root / "data", num_domains=3, per_domain=4)
    batch = W.inputs()
    jax_tree, c, z = _jax_calibration(batch)
    draws_path = str(root / "draws.npz")
    np.savez(draws_path, c=c, z=z)
    failed = []

    def ranks():
        try:
            pmesh.run_ranks(W.rank_main, W.RANKS, args=(str(root), draws_path,
                                                         str(root / "data")), timeout=300)
        except BaseException as e:  # re-raised below, in the test's thread
            failed.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        ct, zt = torch.from_numpy(c.copy()), torch.from_numpy(z.copy())
        one = {key: W.halves_max(batch[key], ct, zt) for key in ("x1", "x1_zero")}
        one["whole"] = W.calibrate(W.make_model(), batch["x1"], ct, zt)
        one["zero_halves"] = [W.calibrate(W.make_model(), W.rows(batch["x1_zero"], r),
                                          W.rows(ct, r), W.rows(zt, r)) for r in range(W.RANKS)]
        one["draws"] = W.trainer_draws(W.trainer_args(str(root / "data"), str(root / "one"), 1))
    finally:
        thread.join()
    if failed:
        raise failed[0]
    got = [torch.load(os.path.join(str(root), f"rank{r}.pt")) for r in range(W.RANKS)]
    one["steps"] = {g: W.step(g, batch, one["x1"], ranks_int8=[r["steps"][g]["int8"] for r in got])
                    for g in W.GAN_STEPS}
    return one, got, jax_tree


def _trees_equal(a, b) -> bool:
    return set(a) == set(b) and all(
        set(a[n]) == set(b[n]) and all(torch.equal(a[n][k], b[n][k]) for k in a[n]) for n in a)


def test_ranks_install_one_tree_the_max_over_their_rows(runs):
    one, got, _ = runs
    for key in ("x1", "x1_zero"):
        assert _trees_equal(got[0][key], got[1][key]), key
        assert _trees_equal(got[0][key], one[key]), key
    for net in INT8_NETS:
        assert len(one["whole"][net]) == len(got[0]["x1"][net]) > 0
        for k, w in one["whole"][net].items():
            assert float(w) > 0
            assert abs(float(got[0]["x1"][net][k]) - float(w)) <= AMAX_RTOL * float(w), (net, k)


def test_a_rank_of_zero_rows_does_not_win(runs):
    """Rank 1's rows are all zeros: its amax at the content encoder's first
    calibrated conv is exactly 0 (its input is the zero image's), and the
    ranks' tree keeps rank 0's there, and the larger of the two elsewhere."""
    one, got, _ = runs
    mine, zeros = one["zero_halves"]
    exact_zero = [(n, k) for n in INT8_NETS for k, v in zeros[n].items() if float(v) == 0.0]
    assert exact_zero, "the zero rows give no amax of exactly 0: the case tests nothing"
    for net in INT8_NETS:
        for k in mine[net]:
            want = max(float(mine[net][k]), float(zeros[net][k]))
            assert float(got[1]["x1_zero"][net][k]) == want, (net, k)
    for net, k in exact_zero:
        assert float(got[0]["x1_zero"][net][k]) == float(mine[net][k]) > 0, (net, k)


def test_one_process_calibration_matches_jax(runs):
    one, _, jax_tree = runs
    assert set(jax_tree) == set(one["whole"]) == set(INT8_NETS)
    for net, leaves in jax_tree.items():
        assert set(leaves) == set(one["whole"][net]), net
        for k, w in leaves.items():
            assert abs(float(one["whole"][net][k]) - float(w)) <= AMAX_RTOL * float(w), (net, k)


def test_trainer_draws_are_the_global_draws(runs):
    one, got, _ = runs
    c, z = one["draws"]
    assert c.shape == (W.B, W.SHAPE["num_domains"]) and z.shape == (W.B, W.SHAPE["latent_dim"])
    assert torch.equal(torch.cat([g["draws"][0] for g in got]), c)
    assert torch.equal(torch.cat([g["draws"][1] for g in got]), z)


def _biases_before_norms(model) -> set:
    """(net, key) of every conv bias that feeds an instance or batch norm:
    its gradient is roundoff (tests/test_torch_parallel.py)."""
    out = set()
    for net_name, net in model.nets.items():
        for name, m in net.named_modules():
            conv = getattr(m, "conv", None)
            if (isinstance(getattr(m, "norm", None), (InstanceNorm, BatchNorm2d))
                    and isinstance(getattr(conv, "bias", None), torch.Tensor)):
                out.add((net_name, f"{name}.conv.bias"))
    return out


@pytest.mark.parametrize("gan_step", W.GAN_STEPS)
def test_qat_step_matches_one_process(runs, gan_step):
    """As tests/test_torch_parallel.py holds the plain step: the gradients
    each rank applies (the ranks' mean) within 1e-5 of the net's largest
    |gradient| in the one-process step, a conv bias before a norm under
    1e-4 of it on both sides, the logs at rtol 2e-3 / atol 2e-4; then the
    params and the int8 weights bit-equal across the ranks.

    The one process rounds every QAT conv's input itself and must land
    within one int8 step of the ranks' rounding, at no more than 1e-3 of
    the inputs (``test_torch_qat.py::test_int8_flips``'s bound), then goes
    on with the ranks' int8 input (``torch_qat_parallel_worker.step``):
    CPU GEMMs round differently at another batch size (the decoder's style
    MLP: 3.8e-5 at K=256 between 16 and 2 x 8 rows), and one input that
    such roundoff tips over a rounding boundary moves by a whole int8 step
    (0.1 at these ranges), which the untrained nets amplify through the
    cycle's 20 convs to 16-44 % of the G gradients in norm, measured here
    without the replay; the float step takes the same roundoff within 1e-6
    (tests/test_torch_parallel.py)."""
    one, got, _ = runs
    want = one["steps"][gan_step]
    ranks = [g["steps"][gan_step] for g in got]
    flips = want["flips"]
    assert len(flips) == len(ranks[0]["int8"]) == len(ranks[1]["int8"]) > 0
    assert max(m for m, _, _ in flips) <= 1, flips
    total, size = sum(n for _, n, _ in flips), sum(s for _, _, s in flips)
    print(f"{gan_step}: {total} one-step flips in {size} int8 inputs over {len(flips)} convs")
    assert total <= 1e-3 * size, flips
    roundoff = _biases_before_norms(W.make_model(gan_step))
    assert [n for n, _ in ranks[0]["updates"]] == [n for n, _ in want["updates"]]
    scale: dict = {}
    for net, grads in want["updates"]:
        scale[net] = max(scale.get(net, 0.0), *(g.abs().max().item() for g in grads.values()))
    for (net, mine), (_, grads) in zip(ranks[0]["updates"], want["updates"]):
        largest = scale[net]
        assert largest > 0, net
        for k, g in grads.items():
            if (net, k) in roundoff:
                for t in (mine[k], g):
                    assert t.abs().max().item() <= 1e-4 * largest, (net, k, "not roundoff")
                continue
            err = (mine[k] - g).abs().max().item()
            assert err <= GRAD_TOL * largest, (gan_step, net, k, err, largest)
    for r in ranks:
        assert set(r["logs"]) == set(want["logs"])
        for k, v in want["logs"].items():
            np.testing.assert_allclose(r["logs"][k], v, rtol=LOG_RTOL, atol=LOG_ATOL,
                                       err_msg=(gan_step, k))
    assert ranks[0]["digest"] == ranks[1]["digest"] != W.param_digest(W.make_model(gan_step))
    assert ranks[0]["int8_weights"] == ranks[1]["int8_weights"]


def test_trainer_calibrates_on_every_rank_alike(runs):
    _, got, _ = runs
    runs_ = [g["trainer"] for g in got]
    assert [r["calls"] for r in runs_] == [[0, 1], [0, 1]]
    assert all(r["installed"] and r["step"] == 2 for r in runs_)
    assert runs_[0]["digest"] == runs_[1]["digest"]
    assert runs_[0]["int8_weights"] == runs_[1]["int8_weights"]
