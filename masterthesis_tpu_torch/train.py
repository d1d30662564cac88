"""The train CLI: the training loop around the model's steps.

The port of ``masterthesis_tpu/train.py``: ``Trainer.load_dataset``,
``create_model``, ``train`` and ``run``, with the JAX package's print, save
and display cadence and its final save.

    python -m masterthesis_tpu_torch.train --dataroot DIR --model AdaINModel ...

The trainer runs on one device: ``Trainer(device=None)`` is the card, and
without one that is an error (``device="cpu"`` runs the kernels' plain
versions, as the tests do); ``--num_devices`` above 1 raises (ROADMAP A.7).
Each iteration copies the host batch onto the device, and its random draws
come from generators seeded from (``--seed``, the iteration, a stream), in
place of the JAX package's ``fold_in(base_rng, global_iter)``: the step's
:class:`StepDraws`, the device preprocess of ``--device_preproc`` and the
image grid each have their own. A run resumed with ``--resume``,
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
from masterthesis_tpu_torch.utils.profiling import StepTimer, TimerBlock

# the streams of an iteration's generators
STEP, PREPROC, VISUALS = 0, 1, 2


def iteration_generator(seed: int, it: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, ``it``, ``stream``)."""
    state = np.random.SeedSequence([int(seed), int(it), int(stream)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class Trainer:
    """The host-side training loop around the model's steps."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.throughput: list[float] = []  # it/s at each of StepTimer's sync points

    def load_dataset(self, args) -> DataLoader:
        with TimerBlock("Building data pipeline") as block:
            block.log(f"Dataset: {args.dataset.__name__} at {args.dataroot}")
            dataset = args.dataset(args)
            block.log(f"Prefetching loader: batch={args.batch_size}")
            return DataLoader(
                dataset,
                batch_size=args.batch_size,
                shuffle=getattr(args, "shuffle", False),
                num_workers=args.num_workers,
                drop_last=True,
            )

    def create_model(self, args):
        if (getattr(args, "num_devices", None) or 1) > 1:
            raise NotImplementedError(
                f"--num_devices {args.num_devices}: masterthesis_tpu_torch trains on one device; "
                "data parallelism across devices is ROADMAP A.7")
        with TimerBlock("Creating model") as block:
            model = args.model(args, device=self.device)
            block.log(f"Initialized on {self.device}")
        return model

    def train(self, args, model, dataloader):
        with TimerBlock("Training model") as block:
            global_iter = args.last_iter + 1 if args.resume_opt is not None else 0
            iterations = min(args.n_iters, args.max_iter)
            block.log(f"Running for {iterations} iterations")
            if global_iter:
                dataloader.fast_forward(global_iter)
            seed = getattr(args, "seed", 0) or 0
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
                        batch, iteration_generator(seed, global_iter, PREPROC, self.device),
                        args.load_size, args.crop_size, train=True,
                        no_flip=getattr(args, "no_flip", False),
                    )
                draws = StepDraws(iteration_generator(seed, global_iter, STEP, self.device))
                model.optimize_parameters(batch, global_iter, draws)
                rate = timer.lap()
                if rate is not None:
                    self.throughput.append(rate)
                    block.log(f"throughput: {rate:.2f} it/s "
                              f"({rate * imgs_per_item * args.batch_size:.1f} img/s)")
                if global_iter % args.print_freq == 0:
                    block.log("\n")
                    block.log(f"iter {global_iter} | lr {model.get_current_lr()}")
                    model.write_loss(global_iter)
                    block.log(model.print_losses())
                if global_iter % args.save_freq == 0:
                    block.log(f"checkpoint -> {args.checkpoint_dir}")
                    model.save(global_iter)
                if global_iter % args.display_freq == 0 and global_iter % args.d_iter == 0:
                    block.log("image grid -> display dir")
                    model.save_images(
                        batch, global_iter, iteration_generator(seed, global_iter, VISUALS,
                                                                self.device))
                global_iter += 1
                if global_iter > iterations:
                    block.log(f"final checkpoint -> {args.checkpoint_dir}")
                    model.save(global_iter)
                    block.log("training complete")
                    return model

    def run(self, args):
        dataloader = self.load_dataset(args)
        model = self.create_model(args)
        return self.train(args, model, dataloader)


def main(argv=None) -> int:
    Trainer().run(TrainArguments().parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
