"""Driver entry points: the twins of the JAX package's ``__graft_entry__.py``.

- :func:`entry`: the flagship forward (AdaINModel random-style translation
  at 256x256, dim 64, batch 2) and example inputs, on the card unless the
  caller asks for the CPU.
- :func:`dryrun_multichip`: ``n`` ranks (gloo: CPU processes, or processes
  sharing the one card) run AdaINModel's full training step at a tiny size
  over an n-rank data mesh (the main step and the content step), the
  (data, spatial) forward on a 2 x n/2 mesh when n is even and at least 4,
  and the calibrated int8 forward over the data axis; every result must be
  finite.

    python -m masterthesis_tpu_torch.entry 8 --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.data.loader import shard_batch
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.models.model import resolve_device
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.parallel import mesh as pmesh
from masterthesis_tpu_torch.parallel import spatial


def _flagship_model(train: bool, crop_size: int = 256, dim: int = 64, device=None):
    args = default_train_args(crop_size=crop_size, dim=dim, latent_dim=8, num_domains=4,
                              batch_size=2, use_dis_content=train,
                              mode="train" if train else "test", logdir=None)
    return AdaINModel(args, device=device), args


def entry(device=None):
    """(fn, example_args): ``fn(img, z, c_trg)`` is the flagship model's
    ``_forward_random_impl`` without gradients (NHWC in and out), and the
    example arguments are zeros of its inputs' shapes on the model's device."""
    model, args = _flagship_model(train=False, device=device)

    def forward(img, z, c_trg):
        with torch.inference_mode():
            return model._forward_random_impl(img, z, c_trg)

    dev = model.device
    img = torch.zeros((2, 256, 256, 3), device=dev)
    z = torch.zeros((2, args.latent_dim), device=dev)
    c = torch.nn.functional.one_hot(torch.tensor([3, 3], device=dev), args.num_domains).float()
    return forward, (img, z, c)


def _finite(what: str, t) -> None:
    if not torch.isfinite(torch.as_tensor(t)).all():
        raise RuntimeError(f"dryrun_multichip: {what} is not finite")


def _dryrun_rank(rank: int, n: int, device: str) -> None:
    """One rank of :func:`dryrun_multichip`."""
    dev = torch.device(device)
    b = max(n, 2)
    args = default_train_args(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=b,
                              use_dis_content=True, dis_content_layers=1,
                              dis_content_final_kernel=2, logdir=None)
    model = AdaINModel(args, device=dev)
    mesh = pmesh.make_mesh(n)
    pmesh.replicate(model, mesh)
    rng = np.random.default_rng(0)
    k = args.num_domains
    batch = {
        "x1": rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
        "x2": rng.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32),
        "y1": np.eye(k, dtype=np.float32)[rng.integers(0, k, b)],
        "y2": np.eye(k, dtype=np.float32)[rng.integers(0, k, b)],
    }
    local = shard_batch(batch, mesh)
    # the main step (D1, D2, G phases) and the content-D off-iteration step
    for it in (0, 1):
        draws = StepDraws(torch.Generator(device=dev).manual_seed(it))
        for key, v in model.optimize_parameters(local, it, draws).items():
            _finite(f"step {it} {key}", v)

    z = np.zeros((b, args.latent_dim), np.float32)
    if n >= 4 and n % 2 == 0:
        # dp x spatial: the batch over 2 data rows, the height over n / 2
        mesh2 = pmesh.make_mesh_2d(2, n // 2)
        img = torch.from_numpy(batch["x1"])
        rows = shard_batch({"z": z, "c": batch["y1"]}, mesh2)
        out = spatial.forward_random(model, mesh2, spatial.shard(img, mesh2),
                                     torch.from_numpy(rows["z"]), torch.from_numpy(rows["c"]))
        _finite("the spatial forward", spatial.gather(out, mesh2).cpu())

    # int8 serving over the data mesh: every rank calibrates on the same
    # batches, then translates its rows through kernels 5-8
    model.calibrate_int8([batch["x1"], batch["x2"]], [batch["y1"], batch["y2"]], [z, z])
    out8 = pmesh.forward_rows(model, mesh, batch["x1"], z, batch["y1"])
    if tuple(out8.shape) != (b, 32, 32, 3):
        raise RuntimeError(f"dryrun_multichip: the int8 forward gave {tuple(out8.shape)}")
    _finite("the int8 forward", out8.cpu())
    model.disable_int8()


def dryrun_multichip(n_devices: int, device=None, timeout: float = 900.0) -> None:
    """The full training step, the spatial forward and int8 serving over
    ``n_devices`` gloo ranks on tiny shapes (see the module docstring):
    processes on the CPU with ``device="cpu"``, else processes sharing the
    card (none: an error, as every entry point's)."""
    dev = resolve_device(device)
    name = "cuda:0" if dev.type == "cuda" else "cpu"
    pmesh.run_ranks(_dryrun_rank, n_devices, (n_devices, name), backend="gloo", timeout=timeout)
    print(f"dryrun_multichip({n_devices}) OK on {name} "
          "(train + content step, spatial, int8 serving)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    a = p.parse_args(argv)
    dryrun_multichip(a.n_devices, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
