"""One rank of the port's multi-process CPU tests (gloo), run as a
subprocess by tests/test_torch_parallel.py and tests/test_torch_spatial.py:

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT SUITE [ARG]

- ``steps``: every case of :data:`CASES` over a data mesh of WORLD ranks
  (:func:`run_case`), each rank on its rows of the case's global batch;
  writes OUT.json (per case the logs and a digest of the params after the
  step) and OUT.pt (per case the gradients of each update, and for
  ``jax`` the nets' params before each update and after the step).
- ``spatial``: the (2, WORLD / 2) forward of the weights in ARG (a
  ``torch.save`` file; :func:`spatial_inputs` makes the inputs), the int8
  forward over a WORLD-rank data mesh with the calibration in ARG, and the
  halo rows (:data:`HALO_CASES`) of this rank's quarter of
  :func:`halo_image`; writes OUT.pt.
- ``trainer``: the train CLI's ``Trainer`` as ``torchrun`` would start a
  rank (the launcher's environment), :func:`trainer_args` over the image
  tree ARG into ARG2/rank{RANK}; writes OUT.json.

The tests compute the one-process counterparts with the same functions.
Every rank runs with one thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from masterthesis_tpu_torch.arguments import default_test_args, default_train_args  # noqa: E402
from masterthesis_tpu_torch.data.loader import shard_batch  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel, BaseModel, translation  # noqa: E402
from masterthesis_tpu_torch.models.translation import StepDraws  # noqa: E402
from masterthesis_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from masterthesis_tpu_torch.parallel import spatial  # noqa: E402

# tests/conftest.py's tiny_train_args(batch_size=8): 8 images a side
SHAPE = dict(crop_size=32, load_size=36, dim=8, latent_dim=4, num_domains=4, batch_size=8,
             logdir=None, dis_content_layers=1, dis_content_final_kernel=2)
B = SHAPE["batch_size"]
# name: (model class, flags, global_iter); "jax" is the deterministic step
# (no generator: no noise, z = mu) that tests/test_torch_parallel.py holds
# against the JAX package's one-device step
CASES = {
    "reference": (AdaINModel, dict(use_dis_content=True), 0),
    "fused": (AdaINModel, dict(use_dis_content=True, gan_step="fused"), 0),
    "content": (AdaINModel, dict(use_dis_content=True), 1),
    "ragan": (AdaINModel, dict(use_ragan=True), 0),
    "batch_norm": (AdaINModel, dict(enc_norm="batch", dec_norm="batch"), 0),
    "reparam": (BaseModel, dict(concat=True, reparam=True), 0),
    "dropout": (AdaINModel, dict(use_dropout=True), 0),
    "jax": (AdaINModel, dict(use_dis_content=True), 0),
}


def batch_and_styles(seed: int = 0):
    """The global batch (NHWC, one-hot) and the styles z_sr, z_sr2 (B, latent)."""
    rng = np.random.default_rng(seed)
    k = SHAPE["num_domains"]
    batch = {
        "x1": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
        "x2": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32),
        "y1": np.eye(k, dtype=np.float32)[rng.integers(0, k, B)],
        "y2": np.eye(k, dtype=np.float32)[rng.integers(0, k, B)],
    }
    styles = [rng.standard_normal((B, SHAPE["latent_dim"])).astype(np.float32) for _ in range(2)]
    return batch, styles


def digest(model) -> str:
    h = hashlib.sha256()
    for name in sorted(model.nets):
        for k, v in sorted(model.nets[name].state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _params(model) -> dict:
    return {n: {k: v.detach().clone() for k, v in net.named_parameters()}
            for n, net in model.nets.items()}


def run_case(name: str, mesh=None) -> dict:
    """One step of case ``name`` from the seeded init, on the whole batch
    (``mesh`` None) or data parallel over ``mesh`` on this rank's rows.
    Returns the logs (floats), each update's (net, gradients by parameter
    name), the params' digest after the step and, for "jax", the params
    before each update and after the step."""
    model_cls, flags, it = CASES[name]
    model = model_cls(default_train_args(**SHAPE, **flags, seed=3), device="cpu")
    if mesh is not None:
        pmesh.replicate(model, mesh)
    batch, (z_sr, z_sr2) = batch_and_styles()
    if name == "jax":
        draws = StepDraws(z_sr=torch.from_numpy(z_sr), z_sr2=torch.from_numpy(z_sr2))
    else:
        draws = StepDraws(torch.Generator().manual_seed(7))
    updates, before = [], []
    real = translation.apply_updates

    def record(params, grads, state, *a, **kw):
        net = next(n for n, s in model.state.opt_state.items() if s is state)
        keys = [k for k, _ in model.nets[net].named_parameters()]
        updates.append((net, {k: (torch.zeros_like(p) if g is None else g.detach().clone())
                              for k, p, g in zip(keys, params, grads)}))
        if name == "jax":
            before.append(_params(model))
        return real(params, grads, state, *a, **kw)

    translation.apply_updates = record
    try:
        local = batch if mesh is None else shard_batch(batch, mesh)
        logs = model.optimize_parameters(local, it, draws)
    finally:
        translation.apply_updates = real
    out = dict(logs={k: float(v) for k, v in logs.items()}, updates=updates, digest=digest(model))
    if name == "jax":
        out["params"] = before + [_params(model)]
    return out


def spatial_inputs(seed: int = 5):
    """The spatial forward's inputs: B=4 NHWC images, styles and one-hot
    targets."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((4, SHAPE["latent_dim"])).astype(np.float32)
    c = np.eye(SHAPE["num_domains"], dtype=np.float32)[[0, 1, 2, 3]]
    return img, z, c


# (top, bottom, edge) of halo_rows: the stem's, a resblock conv's, a down
# conv's and a transposed conv's
HALO_CASES = [(3, 3, "reflect"), (1, 1, "reflect"), (1, 0, "reflect"), (0, 1, "zeros")]


def halo_image() -> torch.Tensor:
    """A seeded NCHW image of 16 rows, 4 to a rank of four."""
    return torch.from_numpy(np.random.default_rng(9).standard_normal((2, 3, 16, 5)).astype(
        np.float32))


def spatial_model(weights=None):
    """tiny_train_args' AdaINModel for serving, with ``weights`` (a
    state_dict per net) where given."""
    args = default_test_args(**{k: v for k, v in SHAPE.items() if k != "batch_size"},
                             batch_size=4)
    model = AdaINModel(args, device="cpu")
    if weights is not None:
        model.load_params(weights)
    return model


class Ranks:
    """WORLD worker processes of ``suite``, started at once on a free port
    (each writes ``out_dir/rank{r}.*``); :meth:`wait` joins them, killing
    all after ``timeout`` seconds, so a hung rank fails its test and does
    not stall the suite."""

    def __init__(self, world_size: int, suite: str, out_dir, *extra, timeout: float = 240.0):
        port = pmesh.free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.outs = [os.path.join(str(out_dir), f"rank{r}") for r in range(world_size)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world_size), str(port),
             self.outs[r], suite, *map(str, extra)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world_size)]
        self.timeout = timeout

    def wait(self) -> list:
        """The ranks' output paths (without suffix), once every rank exited 0."""
        try:
            texts = [p.communicate(timeout=self.timeout)[0] for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(self.procs, texts)):
            assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
        return self.outs


def trainer_args(dataroot: str, exp_dir: str, world_size: int):
    """The train CLI's tiny data-parallel run: the fused step, a content
    step, 3 iterations, checkpoints at 2 and the end."""
    from masterthesis_tpu_torch import data, models

    dirs = dict(checkpoint_dir=os.path.join(exp_dir, "ckpt"),
                display_dir=os.path.join(exp_dir, "images"))
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return default_train_args(**{**SHAPE, "batch_size": 2 * world_size}, dataroot=dataroot,
                              dataset=data.PairedDataset, model=models.AdaINModel,
                              use_dis_content=True, gan_step="fused", num_workers=0,
                              n_iters=3, max_iter=3, print_freq=1, save_freq=2, display_freq=3,
                              num_devices=world_size, **dirs)


def main(argv) -> int:
    rank, world_size, port, out, suite = int(argv[0]), int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    if suite == "trainer":
        # as torchrun starts a rank: the trainer joins the group itself
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        from masterthesis_tpu_torch.train import Trainer

        trainer = Trainer(device="cpu", backend="gloo")
        # each rank its own directories: rank 1's must stay empty
        args = trainer_args(argv[5], os.path.join(argv[6], f"rank{rank}"), world_size)
        model = trainer.run(args)
        with open(out + ".json", "w") as f:
            json.dump(dict(digest=digest(model), step=model.state.step,
                           losses=model.print_losses(), local_batch=trainer.local_batch(args)), f)
        torch.distributed.destroy_process_group()
        return 0
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world_size, rank=rank)
    try:
        if suite == "steps":
            mesh = pmesh.make_mesh(world_size)
            results = {name: run_case(name, mesh) for name in CASES}
            with open(out + ".json", "w") as f:
                json.dump({n: dict(logs=r["logs"], digest=r["digest"]) for n, r in results.items()},
                          f)
            torch.save({n: {k: v for k, v in r.items() if k in ("updates", "params")}
                        for n, r in results.items()}, out + ".pt")
        elif suite == "spatial":
            saved = torch.load(argv[5])
            model = spatial_model(saved["weights"])
            img, z, c = spatial_inputs()
            mesh2 = pmesh.make_mesh_2d(2, world_size // 2)
            rows = shard_batch({"z": z, "c": c}, mesh2)
            block = spatial.shard(torch.from_numpy(img), mesh2)
            out2d = spatial.forward_random(model, mesh2, block, torch.from_numpy(rows["z"]),
                                           torch.from_numpy(rows["c"]))
            gathered = spatial.gather(out2d, mesh2)
            model.load_int8(saved["quant"])
            out8 = pmesh.forward_rows(model, pmesh.make_mesh(world_size), img, z, c)
            # the halo rows of this rank's shard of one image split WORLD ways
            group = pmesh.make_mesh_2d(1, world_size).group("spatial")
            x = halo_image()
            h = x.shape[2] // world_size
            shard = x[:, :, rank * h:(rank + 1) * h].contiguous()
            halos = {(top, bottom, edge): spatial.halo_rows(shard, top, bottom, group, edge)
                     for top, bottom, edge in HALO_CASES}
            torch.save(dict(block=out2d, spatial=gathered, int8=out8, halos=halos), out + ".pt")
        else:
            raise ValueError(f"unknown suite {suite}")
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
