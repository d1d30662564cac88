"""The sample CLI: translate an image folder or a video into target domains.

The port of ``masterthesis_tpu/sample.py``: ``Sampler`` with its modes,
per-target translation (``sample``, and ``sample_diverse``'s layout), the
input-by-target grid (``--gen_grid``), the multi-style grid
(``--gen_style``) and video in, video out (``--out_fmt video``), with
reference styles (``--reference``), ``--multi_iter``, ``--int8`` and
``--sample_size``. The files it writes have the JAX package's names and
sizes.

    python -m masterthesis_tpu_torch.sample --dataroot DIR_OR_VIDEO \\
        --model AdaINModel --resume model_N.ckpt --targets fog sun ...

``--resume`` takes the port's own checkpoints and those the JAX package
writes, ``model_N.ckpt`` files and ``model_N.orbax`` directories
(``Model.load``); ``--ckpt_format`` is read, as by the JAX sampler, only to
pick the form of what is written, and the sampler writes no checkpoint.
The sampler runs on one
device: ``Sampler(device=None)`` is the card, and without one that is an
error (``device="cpu"`` runs the kernels' plain versions, as the tests do);
it does not read ``--num_devices``, as the JAX sampler does not. The style codes, the VAE
draws of reference styles and the calibration's targets and styles come
from ``torch.Generator``s seeded from ``--seed``; they are not the JAX
package's ``jax.random`` draws.

The per-target loops keep the JAX package's one-deep pipeline: batch k + 1
is put on the device's stream (the un-timed forwards, no synchronize)
before batch k's images are copied back, through pinned memory, and
encoded, so that the device computes while the host encodes JPEGs.
``forward_random`` synchronizes, so only the grid, which reports the mean
forward time, uses it.
"""
from __future__ import annotations

import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from masterthesis_tpu_torch.arguments import TestArguments
from masterthesis_tpu_torch.data.datasets import ImageList, VideoDataset
from masterthesis_tpu_torch.data.loader import DataLoader
from masterthesis_tpu_torch.data.transforms import EvalTransform, load_rgb
from masterthesis_tpu_torch.models.model import resolve_device
from masterthesis_tpu_torch.utils.images import save_image, save_images, tensor_to_image
from masterthesis_tpu_torch.utils.profiling import TimerBlock

#: domain index order used by --targets names
DOMAIN_MAP = ["cloud", "fog", "rain", "sun"]


def _one_hot(index: int, num_domains: int, batch: int) -> np.ndarray:
    onehot = np.zeros((batch, num_domains), np.float32)
    onehot[:, int(index)] = 1.0
    return onehot


class Pending:
    """A tensor (a translated batch; ``evaluate``'s features and distances)
    on its way to the host as f32: on the card, copied into pinned memory
    behind an event; elsewhere the tensor itself."""

    def __init__(self, images: torch.Tensor):
        images = images.float()
        self.event = None
        if images.device.type == "cuda":
            host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
            host.copy_(images, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            images = host
        self.images = images

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.images.numpy()


def f32_to_device(a, device: torch.device) -> Optional[torch.Tensor]:
    """``a`` on ``device`` as f32; a host array through pinned memory, so
    that the copy does not wait for the work already on the stream (a copy
    from pageable memory synchronizes)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return a.to(device).float()
    host = a.float() if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a, np.float32))
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


class Sampler:
    """Drives a trained model over an image directory or a video."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.transforms = EvalTransform()
        # the last per-target loop: images translated and its seconds on the
        # host clock (the last copy and encode included)
        self.translated = 0
        self.loop_seconds = 0.0
        self.calibration_seconds = 0.0

    def generator(self, args) -> torch.Generator:
        """A generator on the sampler's device seeded from ``args.seed``."""
        return torch.Generator(device=self.device).manual_seed(int(getattr(args, "seed", 0) or 0))

    # setup
    def load_model(self, args):
        with TimerBlock("Building model") as block:
            model = args.model(args, device=self.device)
            block.log("Restoring parameters")
            model.initialize()
            return model

    def load_dataset(self, args) -> DataLoader:
        with TimerBlock("Opening input source") as block:
            if os.path.isdir(args.dataroot):
                block.log(f"Image directory: {args.dataroot}")
                dataset = ImageList(args.dataroot, transform=self.transforms)
            else:
                block.log(f"Video file: {args.dataroot}")
                dataset = VideoDataset(args.dataroot, transform=self.transforms)
            return DataLoader(dataset, batch_size=args.batch_size, num_workers=args.num_workers,
                              drop_last=True)

    def _style_image(self, args, path: str) -> np.ndarray:
        arr = self.transforms(load_rgb(path))
        return np.repeat(arr[None], args.batch_size, axis=0)

    def calibrate(self, args, model, dataloader) -> dict:
        """``--int8``: calibrate on the first ``--int8_calib_batches`` input
        batches, each with random targets and styles from a generator seeded
        from ``--seed``, as the JAX package draws them."""
        g = self.generator(args)
        batches, c_trgs, zs = [], [], []
        for batch in dataloader:
            b = len(batch)
            batches.append(np.asarray(batch))
            idx = torch.randint(args.num_domains, (b,), generator=g, device=self.device)
            c_trgs.append(torch.nn.functional.one_hot(idx, args.num_domains).float())
            zs.append(model.get_z_random(b, g))
            if len(batches) >= (getattr(args, "int8_calib_batches", None) or 2):
                break
        start = time.perf_counter()
        quant = model.calibrate_int8(batches, c_trgs, zs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.calibration_seconds = time.perf_counter() - start
        return quant

    def translate(self, args, model, batch, target: int, style_path: Optional[str] = None,
                  style_code=None, eps=None, generator=None, sync: bool = True):
        """One translation of ``batch`` into ``target``, with the style of a
        reference image (``style_path``; the VAE draw ``eps``, else from
        ``generator``) or a latent code (``style_code``). Returns (images,
        seconds, device GB) as the model's timed forwards do; ``sync=False``
        only puts the work on the device's stream and returns the device
        tensor (seconds and GB read 0)."""
        c_trg = _one_hot(target, args.num_domains, args.batch_size)
        if style_path is not None:
            ref = self._style_image(args, style_path)
            if sync:
                return model.forward_reference(batch, ref, c_trg, eps=eps, generator=generator)
            if model.reparam and eps is None:
                eps = model.get_z_random(len(batch), generator)
            return self._enqueue(model._forward_reference_impl, batch, ref, c_trg, eps)
        if style_code is not None:
            if sync:
                return model.forward_random(batch, style_code, c_trg)
            return self._enqueue(model._forward_random_impl, batch, style_code, c_trg)
        raise ValueError("provide a style reference image or a latent style code")

    def _to_device(self, a) -> Optional[torch.Tensor]:
        return f32_to_device(a, self.device)

    def _enqueue(self, fn, *args):
        """``fn`` on the device without waiting for it."""
        with torch.inference_mode():
            out = fn(*(self._to_device(a) for a in args))
        return out, 0.0, 0.0

    # modes
    def _translate_all(self, args, model, dataloader, trgs, refs, name_fn):
        """Every batch into every target, one fresh style per target, files
        named by ``name_fn``; ``--multi_iter N`` renders N random styles per
        target, with ``_s<k>`` before the file's extension."""
        g = self.generator(args)
        if trgs is None:
            trgs = range(args.num_domains)
        if refs is not None and len(refs) != len(trgs):
            raise ValueError(f"got {len(refs)} style references for {len(trgs)} targets")
        multi = int(getattr(args, "multi_iter", 0) or 0)
        if refs is not None:
            multi = 0  # reference styles are deterministic: one pass per target
        pending = None
        self.translated, start = 0, time.perf_counter()
        for t, trg in enumerate(trgs):
            for s in range(max(1, multi)):
                style_code = eps = None
                if refs is None:
                    style_code = model.get_z_random(args.batch_size, g)
                elif model.reparam:
                    eps = model.get_z_random(args.batch_size, g)
                suffix = f"_s{s}" if multi > 0 else ""
                for i, batch in enumerate(dataloader):
                    if refs is not None:
                        imgs, _, _ = self.translate(args, model, batch, trg, style_path=refs[t],
                                                    eps=eps, sync=False)
                    else:
                        imgs, _, _ = self.translate(args, model, batch, trg,
                                                    style_code=style_code, sync=False)
                    names = [name_fn(t, trg, i, j) for j in range(len(imgs))]
                    if suffix:
                        names = [f"{os.path.splitext(n)[0]}{suffix}{os.path.splitext(n)[1]}"
                                 for n in names]
                    done = pending
                    pending = (Pending(imgs), names)
                    if done is not None:
                        save_images(done[0].numpy(), done[1])
                    self.translated += len(names)
                if refs is not None:
                    break
        if pending is not None:
            save_images(pending[0].numpy(), pending[1])
        self.loop_seconds = time.perf_counter() - start

    def sample(self, args, model, dataloader, trgs=None, refs=None):
        """Per-target translation: ``display_dir/<domain index>/image<t>_<i>_<j>.jpg``."""
        with TimerBlock("Translating"):
            self._translate_all(
                args, model, dataloader, trgs, refs,
                lambda t, trg, i, j: os.path.join(args.display_dir, str(trg),
                                                  f"image{t}_{i}_{j}.jpg"))

    def sample_diverse(self, args, model, dataloader, trgs=None, refs=None):
        """The diverse layout: ``display_dir/<target position>/<i>_<j>.jpg``."""
        with TimerBlock("Translating (diverse)"):
            self._translate_all(
                args, model, dataloader, trgs, refs,
                lambda t, trg, i, j: os.path.join(args.display_dir, str(t), f"{i}_{j}.jpg"))

    def generate_image_grid(self, args, model, dataloader, refs=None, trgs=None):
        """``grid.png``: a row per input image, a column per target (with
        reference styles a header row of them), and the mean forward time and
        device memory printed."""
        timings: List[float] = []
        mem_gb: List[float] = []
        g = self.generator(args)
        style_code = model.get_z_random(args.batch_size, g) if refs is None else None
        if trgs is None:
            trgs = range(args.num_domains)
        if refs is not None and len(refs) != len(trgs):
            raise ValueError("each target needs a style reference image")
        columns = []
        if refs is not None:
            header = [np.ones_like(self._style_image(args, refs[0])[:1])]
            header += [self._style_image(args, r)[:1] for r in refs]
            columns.append(np.concatenate(header, axis=2))
        for batch in dataloader:
            row = [np.asarray(batch)]
            for t, trg in enumerate(trgs):
                if refs is not None:
                    imgs, dt, mem = self.translate(args, model, batch, trg, style_path=refs[t],
                                                   generator=g)
                else:
                    imgs, dt, mem = self.translate(args, model, batch, trg, style_code=style_code)
                row.append(imgs.float().cpu().numpy())
                timings.append(dt)
                mem_gb.append(mem)
            columns.append(np.concatenate(row, axis=2))
        grid = np.concatenate(columns, axis=1)
        print(f"mean forward time: {np.mean(timings):.4f}s over {len(timings)} calls, "
              f"device memory: {np.mean(mem_gb):.3f} GB")
        out = os.path.join(args.display_dir, "grid.png")
        save_image(grid[0], out)
        print(f"grid written to {out}")
        return timings

    def sample_video(self, args, model, dataloader, trgs=None, refs=None):
        """One video per target, ``<vid_fname root>_<domain><ext>`` in
        ``display_dir``, at the source's frame rate, one style per target."""
        from masterthesis_tpu_torch.tools.videoreaders import FrameWriter

        g = self.generator(args)
        if trgs is None:
            trgs = range(args.num_domains)
        if refs is not None and len(refs) != len(trgs):
            raise ValueError(f"got {len(refs)} style references for {len(trgs)} targets")
        fps = float(getattr(dataloader.dataset, "fps", 25.0))
        root, ext = os.path.splitext(args.vid_fname)
        self.translated, start = 0, time.perf_counter()
        with TimerBlock("Translating (video)") as block:
            for t, trg in enumerate(trgs):
                style_code = eps = None
                if refs is None:
                    style_code = model.get_z_random(args.batch_size, g)
                elif model.reparam:
                    eps = model.get_z_random(args.batch_size, g)
                fname = f"{root}_{DOMAIN_MAP[trg]}{ext or '.avi'}"
                writer = FrameWriter(args.display_dir, outfmt="video", fname=fname, fps=fps)
                n = 0
                pending = None
                for batch in dataloader:
                    if refs is not None:
                        imgs, _, _ = self.translate(args, model, batch, trg, style_path=refs[t],
                                                    eps=eps, sync=False)
                    else:
                        imgs, _, _ = self.translate(args, model, batch, trg,
                                                    style_code=style_code, sync=False)
                    done, pending = pending, Pending(imgs)
                    if done is not None:
                        for frame in done.numpy():
                            writer.write(tensor_to_image(frame[None]), n)
                            n += 1
                if pending is not None:
                    for frame in pending.numpy():
                        writer.write(tensor_to_image(frame[None]), n)
                        n += 1
                writer.close()
                self.translated += n
                block.log(f"{n} frames -> {os.path.join(args.display_dir, fname)} @ {fps:g} fps")
        self.loop_seconds = time.perf_counter() - start

    def generate_multiple_styles(self, args, model, image, trg,
                                 refs: Optional[Sequence[str]] = None, n_samples: int = 4):
        """``grid.png``: one content image rendered with ``n_samples`` random
        styles, or with each reference's style (after the references)."""
        g = self.generator(args)
        if isinstance(image, str):
            image = self._style_image(args, image)
        image = np.asarray(image)
        panels = []
        if refs is not None:
            n_samples = len(refs)
            panels += [self._style_image(args, r)[:1] for r in refs]
        panels.append(image[:1])
        for s in range(n_samples):
            if refs is not None:
                imgs, _, _ = self.translate(args, model, image, trg, style_path=refs[s],
                                            generator=g)
            else:
                style_code = model.get_z_random(image.shape[0], g)
                imgs, _, _ = self.translate(args, model, image, trg, style_code=style_code)
            panels.append(imgs.float().cpu().numpy()[:1])
        out = os.path.join(args.display_dir, "grid.png")
        save_image(np.concatenate(panels, axis=0), out, nrow=len(panels))
        print(f"style grid written to {out}")

    # entry
    def run(self, args):
        """The CLI on parsed ``args`` (``TestArguments().parse``); returns the model."""
        with TimerBlock("Sampling") as block:
            self.transforms = EvalTransform(tuple(getattr(args, "sample_size", None)
                                                  or (540, 960)))
            model = self.load_model(args)
            dataloader = self.load_dataset(args)
            if getattr(args, "int8", False):
                block.log("Calibrating int8 serving path")
                self.calibrate(args, model, dataloader)
            targets = args.targets
            if targets is not None:
                targets = [DOMAIN_MAP.index(t) for t in targets]
            if args.gen_grid:
                block.log("Mode: image grid")
                self.generate_image_grid(args, model, dataloader, args.reference, targets)
            elif args.gen_style:
                if not targets:
                    raise SystemExit("--gen_style needs a target domain: pass --targets <domain> "
                                     f"(one of {DOMAIN_MAP}).")
                block.log("Mode: multi-style grid")
                batch = next(iter(dataloader))
                self.generate_multiple_styles(args, model, batch, targets[0], args.reference)
            elif "video" in (getattr(args, "out_fmt", None) or "image"):
                block.log("Mode: video translation")
                self.sample_video(args, model, dataloader, targets, args.reference)
            else:
                block.log("Mode: per-target translation")
                self.sample(args, model, dataloader, targets, args.reference)
            return model


def main(argv=None) -> int:
    Sampler().run(TestArguments().parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
