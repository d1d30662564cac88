"""Data-parallel training of the port: two gloo ranks on the CPU against
the one-process step on the whole batch.

Two worker processes (tests/torch_parallel_worker.py, started once for the
module, each with its own timeout) run every case of ``CASES`` over a
2-rank data mesh, each rank on 4 of the 8 rows a side; this process runs
the same cases on all 8 meanwhile. For each case (the reference main step,
the fused main step, the content step, ``--use_ragan``, batch norm in the
generators, BaseModel's ``--reparam`` (the KL term, a sum over the batch)
and ``--use_dropout``, all with their draws from one seeded generator):

- every net's gradients just before each of its optimizer steps, averaged
  over the ranks, within 1e-5 of the largest |gradient| that net gets in
  the one-process step (the sums run in another order). Per net and not
  per update: BaseModel B's G phase 2 gives the content encoder gradients
  of at most 3.4e-6 (its L1 terms cancel), and their f32 noise of about
  8e-9 is that of the terms that cancel. A conv bias that feeds an instance
  or batch norm has no gradient in exact arithmetic, only roundoff: there
  both steps' gradients must be under 1e-4 of the net's largest, the floor
  ``torch_train_steps.assert_step_matches`` sets for such biases;
- the logged losses within ``tests/test_sharding.py``'s rtol 2e-3 / atol
  2e-4 of the one-process step's;
- the params bit-equal across the ranks after the step.

Against the JAX package: the deterministic step (no noise, z = mu) of the
two ranks, phase by phase (``torch_train_steps.run_jax``, each piece jitted
once), at ``tiny_train_args(batch_size=8)``: the logs at rtol 2e-3 / atol
2e-4, the gradients and updates by ``torch_train_steps.assert_step_matches``.
Also the train CLI's ``Trainer`` as ``torchrun`` starts two ranks (the
launcher's environment, ``--num_devices 2``): each rank loads half the
global batch, both end on the same params, and rank 0 alone writes the
checkpoints and the image grid; the loader's rank shards, and
``--num_devices`` against the world size.
"""
import json
import os

import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.data.loader import DataLoader
from masterthesis_tpu_torch.models.blocks import BatchNorm2d
from masterthesis_tpu_torch.ops.norms import InstanceNorm
from masterthesis_tpu_torch.parallel import mesh as pmesh
from masterthesis_tpu_torch.train import Trainer
from tests import torch_parallel_worker as W

from conftest import make_image_tree

torch.set_num_threads(2)

RANKS = 2
GRAD_TOL = 1e-5  # of the net's largest |gradient|
LOG_RTOL, LOG_ATOL = 2e-3, 2e-4  # tests/test_sharding.py's
STEP_CASES = [n for n in W.CASES if n != "jax"]


def _model(case):
    """Case ``case``'s model at its seeded init."""
    return W.CASES[case][0](default_train_args(**W.SHAPE, **W.CASES[case][1], seed=3),
                            device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ranks = W.Ranks(RANKS, "steps", tmp_path_factory.mktemp("steps"), timeout=300)
    try:
        one = {name: W.run_case(name) for name in W.CASES}
    finally:
        outs = ranks.wait()
    summaries = [json.load(open(o + ".json")) for o in outs]
    tensors = [torch.load(o + ".pt") for o in outs]
    return one, summaries, tensors


def _biases_before_norms(model) -> set:
    """(net, key) of every conv bias that feeds an instance or batch norm."""
    out = set()
    for net_name, net in model.nets.items():
        for name, m in net.named_modules():
            conv = getattr(m, "conv", None)
            if (isinstance(getattr(m, "norm", None), (InstanceNorm, BatchNorm2d))
                    and isinstance(getattr(conv, "bias", None), torch.Tensor)):
                out.add((net_name, f"{name}.conv.bias"))
    return out


@pytest.mark.parametrize("case", STEP_CASES)
def test_two_ranks_give_the_one_process_step(runs, case):
    one, summaries, tensors = runs
    ref = one[case]
    roundoff = _biases_before_norms(_model(case))
    assert [net for net, _ in tensors[0][case]["updates"]] == [net for net, _ in ref["updates"]]
    scale = {}
    for net, want in ref["updates"]:
        scale[net] = max(scale.get(net, 0.0), *(w.abs().max().item() for w in want.values()))
    for (net, got), (_, want) in zip(tensors[0][case]["updates"], ref["updates"]):
        largest = scale[net]
        assert largest > 0, net
        for key, w in want.items():
            if (net, key) in roundoff:
                for g in (got[key], w):
                    assert g.abs().max().item() <= 1e-4 * largest, (net, key, "not roundoff")
                continue
            err = (got[key] - w).abs().max().item()
            assert err <= GRAD_TOL * largest, (net, key, err, largest)
    for r in range(RANKS):
        logs = summaries[r][case]["logs"]
        assert set(logs) == set(ref["logs"])
        for k, v in ref["logs"].items():
            np.testing.assert_allclose(logs[k], v, rtol=LOG_RTOL, atol=LOG_ATOL, err_msg=(case, k))
    assert summaries[0][case]["digest"] == summaries[1][case]["digest"], case
    # the step moved the params
    assert summaries[0][case]["digest"] != W.digest(_model(case))


def test_two_ranks_match_the_jax_one_device_step(runs):
    """The deterministic main step of two ranks against the JAX package's
    one-device step from the same params, phase by phase."""
    from tests import torch_train_steps as S

    _, summaries, tensors = runs
    model = _model("jax")
    params = tensors[0]["jax"]["params"]
    updates = tensors[0]["jax"]["updates"]
    trees, phases, i = [], [], 0
    for n in (1, 1, 3, 2):
        phases.append({net: g for net, g in updates[i:i + n]})
        trees.append({net: S.jax_tree_of(model, net, params[i][net]) for net in model.nets})
        i += n
    assert i == len(updates)
    trees.append({net: S.jax_tree_of(model, net, params[-1][net]) for net in model.nets})
    batch, (z_sr, z_sr2) = W.batch_and_styles()
    kw = {k: v for k, v in W.SHAPE.items() if k != "logdir"}
    ref = S.run_jax(dict(kw, **W.CASES["jax"][1]), trees, batch, z_sr, z_sr2, fused=False)
    logs = summaries[0]["jax"]["logs"]
    for k, v in ref[0].items():
        np.testing.assert_allclose(logs[k], float(v), rtol=LOG_RTOL, atol=LOG_ATOL, err_msg=k)
    S.assert_step_matches(model, (logs, phases, trees), ref, loss_rtol=LOG_RTOL)


class _Items:
    """A dataset of its indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.float32(i)

    def skip(self, i):
        pass


def test_the_train_cli_runs_data_parallel(tmp_path):
    make_image_tree(tmp_path / "data", num_domains=4, per_domain=4)
    exp = tmp_path / "exp"
    outs = W.Ranks(RANKS, "trainer", tmp_path, tmp_path / "data", exp, timeout=180).wait()
    got = [json.load(open(o + ".json")) for o in outs]
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["losses"] == got[1]["losses"]
    assert [g["local_batch"] for g in got] == [2, 2]
    assert got[0]["step"] == 4
    assert sorted(os.listdir(exp / "rank0" / "ckpt")) == [
        f"{k}_{it}.ckpt" for k in ("model", "opt") for it in (0, 2, 4)]
    assert sorted(os.listdir(exp / "rank0" / "images")) == ["gen_0.jpg", "gen_3.jpg"]
    assert os.listdir(exp / "rank1" / "ckpt") == os.listdir(exp / "rank1" / "images") == []


def test_loader_shards_are_disjoint_and_complete():
    seen = []
    for rank in range(RANKS):
        loader = DataLoader(_Items(16), batch_size=4, shuffle=True, seed=3, drop_last=True,
                            shard_index=rank, num_shards=RANKS)
        seen.append([float(x) for batch in loader for x in batch])
    assert not set(seen[0]) & set(seen[1])
    assert set(seen[0]) | set(seen[1]) == {float(i) for i in range(16)}


def test_num_devices_must_equal_the_world_size():
    with pytest.raises(ValueError, match="--num_devices 2 must equal the world size 1"):
        pmesh.make_mesh(2)
    assert pmesh.make_mesh(1).axis_size("data") == 1
    args = default_train_args(**W.SHAPE, num_devices=2)
    with pytest.raises(ValueError, match="world size 1"):
        Trainer(device="cpu", backend="gloo").local_batch(args)


def test_init_distributed_needs_a_whole_launcher_environment(monkeypatch):
    for key in pmesh.LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)
    assert pmesh.init_distributed("gloo") is False  # no launcher: one process
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        pmesh.init_distributed("gloo")
    assert not torch.distributed.is_initialized()
