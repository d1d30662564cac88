"""Process groups, the mesh of ranks, and the collectives of training.

The port of ``masterthesis_tpu/parallel/mesh.py``. The JAX package runs one
program over a device mesh and lets XLA insert the collectives; here each
device is a process (a rank, as ``torchrun`` starts them), and the port
calls the collectives itself:

- :func:`init_distributed` joins the ranks that a launcher started; the
  backend is the caller's choice (NCCL for one rank per card, gloo on the
  CPU or for several ranks sharing one card).
- :func:`make_mesh` and :func:`make_mesh_2d` lay the ranks out as a
  ``("data",)`` or ``("data", "spatial")`` grid, with a process group per
  axis (:class:`Mesh`).
- :func:`replicate` gives every rank rank 0's weights and optimizer state
  and hands the model the mesh: its training step then all-reduces each
  net's gradients (:func:`mean_gradients`) and keeps every batch-coupled
  term global (:func:`all_reduce_sum`, an all-reduce that autograd goes
  through, for RaGAN's means and batch norm's statistics);
  :func:`all_reduce_max` gives every rank one int8 training calibration.

Without a process group everything here is the single-process identity:
``make_mesh(1)`` is then a one-rank mesh whose collectives do nothing.
:func:`run_ranks` starts ranks as processes (gloo ranks on the CPU, or
sharing one card, where NCCL takes one rank per card).
"""
from __future__ import annotations

import os
import socket
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# gradients travel in buckets of at most this many bytes, one all-reduce each
BUCKET_BYTES = 64 << 20


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """``LOCAL_RANK`` of a launcher (the card of this rank), else 0."""
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(backend: str) -> bool:
    """Join the process group a launcher describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them); ``backend`` is "nccl" (one rank per card) or
    "gloo". Returns False, doing nothing, without a launcher's environment
    or when the group exists already. Unlike the JAX package's, a failure
    is not swallowed: a set environment that does not initialize raises."""
    if dist.is_initialized():
        return False
    missing = [k for k in LAUNCHER_ENV if k not in os.environ]
    if len(missing) == len(LAUNCHER_ENV):
        return False
    if missing:
        raise RuntimeError(f"init_distributed: the launcher's environment lacks {missing}")
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", local_rank())
    dist.init_process_group(backend, init_method="env://", **kwargs)
    return True


class Mesh:
    """A grid of ranks with named axes: ``shape`` {"data": D} or {"data": D,
    "spatial": S}, rank ``r`` at data index ``r // S`` and spatial index
    ``r % S``. ``group(axis)`` is the process group of the ranks that share
    this rank's other coordinates, or None where no group spans the axis
    (one process, or an axis of one rank in a 2-D mesh)."""

    def __init__(self, shape: dict, rank: int, groups: dict):
        self.shape = dict(shape)
        self.rank = rank
        self.groups = dict(groups)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        spatial = self.axis_size("spatial")
        return self.rank // spatial if axis == "data" else self.rank % spatial

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _groups_of(grid: list[list[int]]) -> list:
    """One process group per row of ``grid`` (every rank creates every
    group, in the same order, as ``new_group`` requires); a row of one rank
    gets None."""
    return [dist.new_group(row) if len(row) > 1 else None for row in grid]


def make_mesh_2d(data: int, spatial: int) -> Mesh:
    """The (data, spatial) mesh over ranks 0 .. data * spatial - 1: the batch
    split over "data", the image height over "spatial". Every rank of the
    process group calls it; ``data * spatial`` must be the world size."""
    rank, size = world()
    if data * spatial != size:
        raise ValueError(f"a {data} x {spatial} mesh needs {data * spatial} ranks; "
                         f"the world has {size}")
    rows = [[d * spatial + s for s in range(spatial)] for d in range(data)]
    cols = [[d * spatial + s for d in range(data)] for s in range(spatial)]
    spatial_groups, data_groups = _groups_of(rows), _groups_of(cols)
    groups = {"data": data_groups[rank % spatial], "spatial": spatial_groups[rank // spatial]}
    return Mesh({"data": data, "spatial": spatial}, rank, groups)


def make_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The 1-D data mesh over every rank; ``num_devices``, where given, must
    be the world size (a rank cannot sit out of its own mesh). Within a
    process group its axis is the whole group, one rank too (whose
    collectives then run, on itself); without one it is the one-device
    mesh, whose collectives do nothing."""
    rank, size = world()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"--num_devices {num_devices} must equal the world size {size} "
                         "(one rank per device: torchrun --nproc_per_node "
                         f"{num_devices} ...)")
    if not dist.is_initialized():
        return Mesh({"data": 1}, 0, {})
    return Mesh({"data": size}, rank, {"data": dist.group.WORLD})


# ---------------------------------------------------------------- collectives


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; its gradient is the sum of the ranks' gradients
    (each rank's output depends on every rank's input), itself through
    this Function, so a double backward works too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g.contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable; ``x`` itself without
    a group."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group``, without gradient (the
    int8 training calibration's amax); ``x`` itself without a group."""
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def mean_gradients(grads: Sequence[Optional[torch.Tensor]], group) -> list:
    """The mean of each gradient over ``group``: flattened in buckets of at
    most :data:`BUCKET_BYTES` per dtype, one all-reduce each. None stays
    None (every rank runs the same step, so the same gradients are None)."""
    grads = list(grads)
    if group is None:
        return grads
    n = group_size(group)
    out = list(grads)
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        bucket, nbytes = [], 0
        for j, i in enumerate(idx):
            bucket.append(i)
            nbytes += grads[i].numel() * grads[i].element_size()
            if nbytes >= BUCKET_BYTES or j == len(idx) - 1:
                flat = torch.cat([grads[k].reshape(-1) for k in bucket])
                dist.all_reduce(flat, group=group)
                flat /= n
                offset = 0
                for k in bucket:
                    m = grads[k].numel()
                    out[k] = flat[offset:offset + m].view_as(grads[k])
                    offset += m
                bucket, nbytes = [], 0
    return out


def mean_logs(logs: dict, group) -> dict:
    """The logged losses averaged over ``group`` in one all-reduce: each
    rank's loss is its share of the global one (see ``translation.py``), so
    every rank logs the one-device values. Non-tensor entries pass."""
    if group is None:
        return logs
    keys = [k for k, v in logs.items() if isinstance(v, torch.Tensor)]
    if not keys:
        return logs
    flat = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= group_size(group)
    return {**logs, **{k: flat[i] for i, k in enumerate(keys)}}


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated on dim 0, in rank order
    (no gradient)."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


# ---------------------------------------------------------------- replication


def replicate(model, mesh: Mesh):
    """Give every rank of ``mesh`` rank 0's weights, buffers (spectral
    ``u``) and optimizer state, and hand the model the mesh: its steps
    then average each net's gradients over the data axis, and its batch
    norms take their statistics over the global batch. Every rank calls
    it. Returns the model."""
    group = mesh.group("data")
    if group is not None:
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for net in model.nets.values():
                for t in [*net.parameters(), *net.buffers()]:
                    dist.broadcast(t.data, src, group=group)
            if model.state is not None:
                for s in model.state.opt_state.values():
                    for t in s.mu + s.nu:
                        dist.broadcast(t, src, group=group)
    model.set_mesh(mesh)
    return model


def forward_rows(model, mesh: Mesh, img, z, c) -> torch.Tensor:
    """``model.forward_random`` over the data axis, as the JAX package
    serves a batch sharded over its data mesh: this rank translates its rows
    of the global batch (``shard_batch``), and the ranks' translations are
    gathered in rank order, on every rank. An int8 model must hold the same
    calibration on every rank."""
    from masterthesis_tpu_torch.data.loader import shard_batch

    local = shard_batch({"img": img, "z": z, "c": c}, mesh)
    out, _, _ = model.forward_random(local["img"], local["z"], local["c"])
    return all_gather_rows(out, mesh.group("data"))


# ---------------------------------------------------------------- launching


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world_size: int, port: int, backend: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world_size, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, args=(), backend: str = "gloo",
              timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes (spawned),
    each a rank of one ``backend`` process group on a free localhost port,
    with one thread each. Raises what a rank raised, and kills every rank
    after ``timeout`` seconds. ``fn`` must be importable (a module's
    top-level function)."""
    ctx = mp.start_processes(_rank_main, args=(fn, world_size, free_port(), backend, tuple(args)),
                             nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_ranks: {world_size} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
