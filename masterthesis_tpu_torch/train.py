"""The train CLI: the training loop around the model's steps.

The port of ``masterthesis_tpu/train.py``: ``Trainer.load_dataset``,
``create_model``, ``train`` and ``run``, with the JAX package's print, save
and display cadence and its final save.

    python -m masterthesis_tpu_torch.train --dataroot DIR --model AdaINModel ...

``Trainer(device=None)`` is the card, and without one that is an error
(``device="cpu"`` runs the kernels' plain versions, as the tests do).

Data parallel: one rank per card, started by a launcher,

    torchrun --nproc_per_node N -m masterthesis_tpu_torch.train ... --num_devices N

Each rank joins the process group the launcher describes (``backend``:
NCCL on the cards, gloo on the CPU), uses ``cuda:LOCAL_RANK``, and trains
the model replicated over the 1-D data mesh (``parallel.replicate``): its
gradients are averaged and its losses are the global batch's.
``--num_devices`` must equal the world size, and ``--batch_size`` stays the
global batch: each rank loads ``batch_size / N`` rows, striding the dataset
(``shard_index`` its rank, ``num_shards`` N), as the JAX package's
processes do. Rank 0 alone writes checkpoints, the loss log and image
grids; every rank reads ``--resume``.

Each iteration copies the host batch onto the device, and its random draws
come from generators seeded from (``--seed``, the iteration, a stream), in
place of the JAX package's ``fold_in(base_rng, global_iter)``: the step's
:class:`StepDraws` (the same on every rank: the model keeps each rank's
rows of the global draws), the device preprocess of ``--device_preproc``
(a stream per rank: each rank's images are its own) and the image grid
each have their own, and so do ``--int8_train``'s calibration draws: the
trainer calibrates at every ``--int8_calib_freq``-th iteration, and at the
first one of a run that has no calibration yet (a resume), as
``masterthesis_tpu/train.py:82-89`` does, on every rank alike (the
calibration is a collective). A run resumed with ``--resume``,
``--resume_opt`` and ``--last_iter`` continues the data stream where the
saved run was (``DataLoader.fast_forward``), so it repeats the iterations
of the unbroken run.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from masterthesis_tpu_torch.arguments import TrainArguments
from masterthesis_tpu_torch.data.device_preproc import preprocess_pair_batch
from masterthesis_tpu_torch.data.loader import DataLoader, infinite, to_device
from masterthesis_tpu_torch.models.model import resolve_device
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.parallel import mesh as pmesh
from masterthesis_tpu_torch.utils.profiling import StepTimer, TimerBlock

# the streams of an iteration's generators
STEP, PREPROC, VISUALS, CALIB = 0, 1, 2, 3


def iteration_generator(seed: int, it: int, stream: int, device, rank: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, ``it``, ``stream``),
    and ``rank`` where it is not 0 (a stream of a data-parallel rank's own)."""
    entropy = [int(seed), int(it), int(stream)] + ([int(rank)] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class Trainer:
    """The host-side training loop around the model's steps. ``backend``:
    the process group's, where a launcher started several ranks (see the
    module docstring)."""

    def __init__(self, device=None, backend: str = "nccl"):
        self.backend = backend
        if device is None and pmesh.init_distributed(backend):
            device = torch.device("cuda", pmesh.local_rank())
            torch.cuda.set_device(device)
        self.device = resolve_device(device)
        self.mesh = None  # the data mesh, made by create_model
        self.throughput: list[float] = []  # it/s at each of StepTimer's sync points

    def _mesh(self, args) -> pmesh.Mesh:
        if self.mesh is None:
            pmesh.init_distributed(self.backend)  # a no-op once joined, or without a launcher
            self.mesh = pmesh.make_mesh(getattr(args, "num_devices", None))
        return self.mesh

    def local_batch(self, args) -> int:
        """The rows each rank loads: ``--batch_size`` (the global batch)
        over the ranks of the data mesh."""
        n = self._mesh(args).axis_size("data")
        if args.batch_size % n:
            raise ValueError(f"--batch_size {args.batch_size} does not split over {n} ranks")
        return args.batch_size // n

    def load_dataset(self, args) -> DataLoader:
        mesh = self._mesh(args)
        with TimerBlock("Building data pipeline") as block:
            block.log(f"Dataset: {args.dataset.__name__} at {args.dataroot}")
            dataset = args.dataset(args)
            block.log(f"Prefetching loader: batch={args.batch_size}, "
                      f"rank shard {mesh.index('data') + 1}/{mesh.axis_size('data')}")
            return DataLoader(
                dataset,
                batch_size=self.local_batch(args),
                shuffle=getattr(args, "shuffle", False),
                num_workers=args.num_workers,
                drop_last=True,
                shard_index=mesh.index("data"),
                num_shards=mesh.axis_size("data"),
            )

    def create_model(self, args):
        mesh = self._mesh(args)
        with TimerBlock("Creating model") as block:
            model = args.model(args, device=self.device)
            block.log(f"Initialized on {self.device}")
            if mesh.group("data") is not None:
                pmesh.replicate(model, mesh)
                block.log(f"Replicated over {mesh}")
        return model

    def train(self, args, model, dataloader):
        with TimerBlock("Training model") as block:
            global_iter = args.last_iter + 1 if args.resume_opt is not None else 0
            iterations = min(args.n_iters, args.max_iter)
            block.log(f"Running for {iterations} iterations")
            if global_iter:
                dataloader.fast_forward(global_iter)
            seed = getattr(args, "seed", 0) or 0
            rank = self._mesh(args).index("data")
            log = block.log if model.writes else (lambda *a, **k: None)
            timer = StepTimer(sync_every=max(1, args.print_freq), device=self.device)
            device_preproc = getattr(args, "device_preproc", False)
            imgs_per_item = None
            for batch in infinite(dataloader):
                if imgs_per_item is None:
                    # paired datasets carry x1/x2 per item, single datasets x
                    imgs_per_item = (
                        sum(1 for k in batch if k in ("x", "x1", "x2"))
                        if isinstance(batch, dict) else 1
                    )
                batch = to_device(batch, self.device)
                if device_preproc:
                    batch = preprocess_pair_batch(
                        batch, iteration_generator(seed, global_iter, PREPROC, self.device, rank),
                        args.load_size, args.crop_size, train=True,
                        no_flip=getattr(args, "no_flip", False),
                    )
                if args.int8_train and (global_iter % max(1, args.int8_calib_freq) == 0
                                        or not model.int8_train_installed):
                    self.calibrate(args, model, batch, global_iter)
                draws = StepDraws(iteration_generator(seed, global_iter, STEP, self.device))
                model.optimize_parameters(batch, global_iter, draws)
                rate = timer.lap()
                if rate is not None:
                    self.throughput.append(rate)
                    log(f"throughput: {rate:.2f} it/s "
                        f"({rate * imgs_per_item * args.batch_size:.1f} img/s)")
                # every rank calls the writers (a batch norm's statistics in
                # the image grid's forward are a collective); rank 0 writes
                if global_iter % args.print_freq == 0:
                    log("\n")
                    log(f"iter {global_iter} | lr {model.get_current_lr()}")
                    model.write_loss(global_iter)
                    log(model.print_losses())
                if global_iter % args.save_freq == 0:
                    log(f"checkpoint -> {args.checkpoint_dir}")
                    model.save(global_iter)
                if global_iter % args.display_freq == 0 and global_iter % args.d_iter == 0:
                    log("image grid -> display dir")
                    model.save_images(
                        batch, global_iter, iteration_generator(seed, global_iter, VISUALS,
                                                                self.device))
                global_iter += 1
                if global_iter > iterations:
                    log(f"final checkpoint -> {args.checkpoint_dir}")
                    model.save(global_iter)
                    log("training complete")
                    return model

    def calibrate(self, args, model, batch, it: int) -> dict:
        """``--int8_train``'s delayed scaling: the activation ranges of this
        batch's ``x1``, with one-hot targets and styles drawn from the
        iteration's ``CALIB`` generator, as the JAX trainer draws them from
        its step key. Data parallel, every rank draws them for the global
        batch and keeps its own rows (as ``StepDraws.shard`` does the
        step's), so that the ranks together use one device's draws."""
        g = iteration_generator(getattr(args, "seed", 0) or 0, it, CALIB, self.device)
        b = len(batch["x1"])
        mesh = model.mesh
        ranks = 1 if mesh is None else mesh.axis_size("data")
        rows = slice(0, b) if mesh is None else slice(mesh.index("data") * b,
                                                      (mesh.index("data") + 1) * b)
        idx = torch.randint(args.num_domains, (b * ranks,), generator=g, device=self.device)
        c = torch.nn.functional.one_hot(idx, args.num_domains).float()
        z = model.get_z_random(b * ranks, g)
        return model.calibrate_quant_train(batch, c[rows], z[rows])

    def run(self, args):
        dataloader = self.load_dataset(args)
        model = self.create_model(args)
        return self.train(args, model, dataloader)


def main(argv=None) -> int:
    Trainer().run(TrainArguments().parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
