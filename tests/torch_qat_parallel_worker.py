"""The ranks of tests/test_torch_qat_parallel.py: ``--int8_train`` over a data
mesh of gloo ranks on the CPU, started by ``parallel.mesh.run_ranks``
(:func:`rank_main`), and the same work in one process on the global batch.

The model is tests/test_torch_qat.py's QAT_SHAPE (crop 32, dim 8, latent 4,
3 domains, f32) at a global batch of 4 a side, 2 rows a rank. The draws of
the calibration (one-hot targets ``c``, styles ``z``) are given for the
global batch and each rank takes its rows, as ``StepDraws.shard`` gives a
rank its rows of the step's draws. This module imports no JAX: the ranks
are spawned processes, and each imports it again.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import AdaINModel, translation
from masterthesis_tpu_torch.models.quantize import int8_convs, merge_amax
from masterthesis_tpu_torch.models.translation import INT8_NETS, StepDraws
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.parallel import mesh as pmesh

RANKS = 2
# tests/test_torch_qat.py's QAT_SHAPE at a global batch of 4
SHAPE = dict(crop_size=32, dim=8, latent_dim=4, num_domains=3, batch_size=4,
             use_dis_content=False)
QAT = dict(compute_dtype="float32", int8_train=True, fused_resblock="off", seed=3)
B = SHAPE["batch_size"]
ROWS = B // RANKS
GAN_STEPS = ("reference", "fused")


def inputs(seed: int = 0) -> dict:
    """The global batch (NHWC, one-hot) and, for the steps, ``x1`` with the
    rows of rank 1 all zeros (``x1_zero``)."""
    rng = np.random.default_rng(seed)
    k = SHAPE["num_domains"]
    batch = {
        "x1": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
        "x2": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
        "y1": np.eye(k, dtype=np.float32)[rng.integers(0, k, B)],
        "y2": np.eye(k, dtype=np.float32)[rng.integers(0, k, B)],
    }
    zero = batch["x1"].copy()
    zero[ROWS:] = 0
    return dict(batch, x1_zero=zero)


def rows(a, rank: int):
    return a[rank * ROWS:(rank + 1) * ROWS]


def make_model(gan_step: str = "reference", mesh=None):
    model = AdaINModel(default_train_args(**SHAPE, **QAT, gan_step=gan_step), device="cpu")
    if mesh is not None:
        pmesh.replicate(model, mesh)
    return model


def calibrate(model, x, c, z) -> dict:
    return model.calibrate_quant_train(x, c, z)


def halves_max(x, c, z) -> dict:
    """One process's MAX over its calibrations of each rank's rows."""
    model = make_model()
    trees = [calibrate(model, rows(x, r), rows(c, r), rows(z, r)) for r in range(RANKS)]
    return {net: merge_amax(*[t[net] for t in trees]) for net in INT8_NETS}


def int8_digest(model) -> str:
    """A digest of the int8 weights, scales and activation scales that the
    next QAT forward uses, over every conv with an int8 route (the 3x3 ones:
    the 7x7 stem calibrates but stays float)."""
    h = hashlib.sha256()
    for net in INT8_NETS:
        for name, m in sorted(int8_convs(model.nets[net]).items()):
            if (m.kernel_size, m.padding) != (3, 1):
                continue
            q = m.train_quant()
            for t in (q.w, q.scale, q.inv_sx):
                h.update(name.encode())
                h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def param_digest(model) -> str:
    h = hashlib.sha256()
    for name in sorted(model.nets):
        for k, v in sorted(model.nets[name].state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _stitched(parts: list, like: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors of one call as the one process's: its rows are k
    chunks of the global batch, each the ranks' rows in rank order (the
    layout of ``StepDraws.shard``)."""
    k = like.shape[0] // (RANKS * ROWS)
    return torch.stack([p.reshape(k, ROWS, *p.shape[1:]) for p in parts], 1).reshape(like.shape)


def step(gan_step: str, batch: dict, tree: dict, mesh=None, ranks_int8=None) -> dict:
    """One QAT main step of ``gan_step`` from the seeded init, with the amax
    tree installed (data parallel: calibrated by the ranks, which must give
    ``tree``), its draws from one seeded generator; the logs, each update's
    (net, gradients), the params' and the int8 weights' digests after it.

    Data parallel it also returns the int8 input of every QAT conv call, in
    call order (``int8``). One process given the ranks' (``ranks_int8``):
    every QAT conv rounds its own input, records the largest gap to the
    ranks' rounding and the number of one-step gaps (``flips``: per call
    (largest, count, size)), and goes on with the ranks' int8 input, so that
    a rounding that another summation order tips over a boundary does not
    carry into the rest of the step."""
    model = make_model(gan_step, mesh)
    model.load_int8_train(tree)
    updates, int8, flips = [], [], []
    real, real_quantize = translation.apply_updates, kq._quantize

    def record(params, grads, state, *a, **kw):
        net = next(n for n, s in model.state.opt_state.items() if s is state)
        keys = [k for k, _ in model.nets[net].named_parameters()]
        updates.append((net, {k: (torch.zeros_like(p) if g is None else g.detach().clone())
                              for k, p, g in zip(keys, params, grads)}))
        return real(params, grads, state, *a, **kw)

    def quantize(x, inv):
        q = real_quantize(x, inv)
        if ranks_int8 is None:
            int8.append(q.clone())
            return q
        theirs = _stitched([r[len(flips)] for r in ranks_int8], q)
        gap = (q.int() - theirs.int()).abs()
        flips.append((int(gap.max()), int((gap > 0).sum()), gap.numel()))
        return theirs

    translation.apply_updates, kq._quantize = record, quantize
    try:
        local = {k: batch[k] for k in ("x1", "x2", "y1", "y2")}
        if mesh is not None:
            local = {k: rows(v, mesh.index("data")) for k, v in local.items()}
        logs = model.optimize_parameters(local, 0, StepDraws(torch.Generator().manual_seed(7)))
    finally:
        translation.apply_updates, kq._quantize = real, real_quantize
    return dict(logs={k: float(v) for k, v in logs.items()}, updates=updates,
                digest=param_digest(model), int8_weights=int8_digest(model),
                int8=int8 if mesh is not None else None, flips=flips)


def trainer_args(dataroot: str, exp_dir: str, world_size: int):
    """The train CLI's ``--int8_train`` run: two iterations (0 and 1), each
    calibrating (``--int8_calib_freq 1``)."""
    from masterthesis_tpu_torch import data, models

    dirs = dict(checkpoint_dir=os.path.join(exp_dir, "ckpt"),
                display_dir=os.path.join(exp_dir, "images"))
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return default_train_args(**SHAPE, **QAT, load_size=36, dataroot=dataroot,
                              dataset=data.PairedDataset, model=models.AdaINModel,
                              int8_calib_freq=1, num_workers=0, n_iters=1, max_iter=1,
                              print_freq=100, save_freq=100, display_freq=100, logdir=None,
                              num_devices=world_size, **dirs)


def trainer_draws(args, mesh=None) -> list:
    """The (c, z) that ``Trainer.calibrate`` hands the model at iteration 0
    for a batch of its local rows."""
    from masterthesis_tpu_torch.train import Trainer

    model = make_model(mesh=mesh)
    seen = []
    model.calibrate_quant_train = lambda batch, c, z: seen.append((c.clone(), z.clone()))
    local = B if mesh is None else ROWS
    Trainer(device="cpu").calibrate(args, model, {"x1": torch.zeros(local, 32, 32, 3)}, 0)
    return seen[0]


def rank_main(rank: int, out_dir: str, draws_path: str, dataroot: str) -> None:
    """Rank ``rank`` of two: the calibration on its rows (and with rank 1's
    rows zero), both QAT main steps, the Trainer's calibration draws and a
    two-iteration Trainer run; writes ``out_dir/rank{rank}.pt``."""
    from masterthesis_tpu_torch.train import Trainer

    mesh = pmesh.make_mesh(RANKS)
    saved = np.load(draws_path)
    c, z = torch.from_numpy(saved["c"]), torch.from_numpy(saved["z"])
    batch = inputs()
    out = {}
    for key in ("x1", "x1_zero"):
        model = make_model(mesh=mesh)
        out[key] = calibrate(model, rows(batch[key], rank), rows(c, rank), rows(z, rank))
    out["steps"] = {g: step(g, batch, out["x1"], mesh) for g in GAN_STEPS}
    out["draws"] = trainer_draws(trainer_args(dataroot, os.path.join(out_dir, "draws"), RANKS),
                                 mesh)
    calls = []
    real = Trainer.calibrate

    def calibrate_counted(self, args, model, b, it):
        calls.append(it)
        return real(self, args, model, b, it)

    Trainer.calibrate = calibrate_counted
    try:
        trainer = Trainer(device="cpu", backend="gloo")
        model = trainer.run(trainer_args(dataroot, os.path.join(out_dir, f"run{rank}"), RANKS))
    finally:
        Trainer.calibrate = real
    out["trainer"] = dict(calls=calls, step=model.state.step, digest=param_digest(model),
                          int8_weights=int8_digest(model), installed=model.int8_train_installed)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))

