"""The evaluate CLI: translate a validation set and score it.

The port of ``masterthesis_tpu/evaluate.py``, the reference's manual eval
workflow in one command: for each target domain, translate every
validation image of the other domains with N random styles and report

- FID(translated -> target-domain real images) per domain (metrics.fid),
  both sides mapped to [0, 1], and
- the mean LPIPS between the first two styles per content image
  (diversity, the reference's multimodality measure).

    python -m masterthesis_tpu_torch.evaluate --dataroot DATA --model AdaINModel \\
        --resume model_N.ckpt --num_domains 4 [--fid_extractor pixel] ...

expects DATA/val/<domain>/ (else DATA/train/<domain>/). Supply
``--fid_weights`` / ``--lpips_weights`` npzs (``tools/convert_weights.py``,
the JAX package's files load as they are) for numbers comparable to
pytorch-fid and the lpips package; the repository holds none, and without
them both nets run with seeded random weights. ``--fid_extractor pixel``
is FID over 4x4x3 thumbnails (48-d, weights-free), ``--fid_features N``
slices the Inception features to N.

The evaluator runs on one device: ``Evaluator(device=None)`` is the card,
and without one that is an error (``device="cpu"`` runs the kernels' plain
versions, as the tests do). ``--resume`` takes the port's checkpoints and a
``model_N.ckpt`` the JAX package wrote. The style codes come from a
``torch.Generator`` seeded from ``--seed``, not the JAX package's
``jax.random`` stream; so do ``--int8``'s calibration targets and styles,
as ``sample.py``'s ``Sampler.calibrate`` draws them.

The loop keeps the JAX package's one-deep pipeline, and extends it to the
metric nets: chunk k + 1's forwards, its LPIPS distances and both sides'
FID features are put on the device's stream before chunk k's features come
to the host (pinned memory behind an event, ``sample.Pending``) to be
accumulated in f64, so the device computes while the host decodes.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from masterthesis_tpu_torch.arguments import TestArguments
from masterthesis_tpu_torch.data.datasets import ImageList
from masterthesis_tpu_torch.data.transforms import TrainTransform
from masterthesis_tpu_torch.metrics.fid import FID
from masterthesis_tpu_torch.metrics.inception import make_inception_extractor, resize_bilinear
from masterthesis_tpu_torch.metrics.lpips import make_lpips_fn
from masterthesis_tpu_torch.models.model import resolve_device
from masterthesis_tpu_torch.sample import Pending, f32_to_device
from masterthesis_tpu_torch.utils.images import save_images
from masterthesis_tpu_torch.utils.profiling import TimerBlock


def pixel_features(x: torch.Tensor) -> torch.Tensor:
    """FID's weights-free features: NHWC images -> 4x4x3 bilinear
    thumbnails (antialiased, as ``jax.image.resize``), flattened HWC (N, 48)."""
    t4 = resize_bilinear(x.float().permute(0, 3, 1, 2), (4, 4))
    return t4.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def mode_dir(args) -> str:
    """DATA/val (the test mode's split), else DATA/<mode>, else DATA/train."""
    path = os.path.join(args.dataroot, args.mode if args.mode != "test" else "val")
    if not os.path.isdir(path):
        path = os.path.join(args.dataroot, "train")
    return path


class Evaluator:
    """Scores a model's translations of a validation tree (see the module
    docstring). After :meth:`evaluate`: ``fids`` (domain -> its FID, the
    accumulators), ``diversity`` (domain -> LPIPS distances), ``scored``
    (translations scored), ``loop_seconds`` and ``fid_seconds`` (domain ->
    host seconds of its ``FID.compute``)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.fids: dict = {}
        self.diversity: dict = {}
        self.fid_seconds: dict = {}
        self.scored = 0
        self.loop_seconds = 0.0
        self.calibration_seconds = 0.0

    def generator(self, args) -> torch.Generator:
        """A generator on the evaluator's device seeded from ``args.seed``."""
        return torch.Generator(device=self.device).manual_seed(int(getattr(args, "seed", 0) or 0))

    def load_model(self, args):
        with TimerBlock("Building model") as block:
            model = args.model(args, device=self.device)
            block.log("Restoring parameters")
            model.initialize()
            return model

    def calibrate(self, args, model) -> dict:
        """``--int8``: calibrate on ``--int8_calib_batches`` batches (the
        first 8 per batch of the split's images, sorted), each with random
        targets and styles from a generator seeded from ``--seed``."""
        transform = TrainTransform(args.load_size, args.crop_size, train=False)
        calib = ImageList(mode_dir(args), transform=transform)
        n_batches = max(1, int(getattr(args, "int8_calib_batches", 2) or 2))
        imgs = np.stack([calib[i] for i in range(min(len(calib), 8 * n_batches))])
        g = self.generator(args)
        batches, c_trgs, zs = [], [], []
        for batch in np.array_split(imgs, n_batches):
            if not len(batch):
                continue
            b = len(batch)
            batches.append(batch)
            idx = torch.randint(args.num_domains, (b,), generator=g, device=self.device)
            c_trgs.append(torch.nn.functional.one_hot(idx, args.num_domains).float())
            zs.append(model.get_z_random(b, g))
        start = time.perf_counter()
        quant = model.calibrate_int8(batches, c_trgs, zs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.calibration_seconds = time.perf_counter() - start
        return quant

    def make_fid(self, args, extractor):
        """A fresh FID for one domain: pixel thumbnails, the first
        ``--fid_features`` Inception features, or all 2048."""
        if getattr(args, "fid_extractor", None) == "pixel":
            return FID(num_features=48, feature_extractor=pixel_features, device=self.device)
        n = int(getattr(args, "fid_features", 0) or 0)
        if n:
            return FID(num_features=n, feature_extractor=lambda x: extractor(x)[:, :n],
                       device=self.device)
        return FID(num_features=2048, feature_extractor=extractor, device=self.device)

    def score(self, fid: FID, diversity: list) -> dict:
        return {"fid": fid.compute(),
                "lpips_diversity": float(np.mean(diversity)) if diversity else float("nan")}

    def evaluate_domain(self, args, model, domains, t: int, transform, lpips_fn, extractor,
                        generator, num_styles: int = 2):
        """Translate the other domains' images into ``domains[t]`` and
        accumulate its FID and LPIPS; returns (FID, distances)."""
        domain, root = domains[t], mode_dir(args)
        fid = self.make_fid(args, extractor)
        real_ds = ImageList(os.path.join(root, domain), transform=transform)
        content_paths = []  # content images: every OTHER domain
        for d2 in domains:
            if d2 != domain:
                content_paths += ImageList(os.path.join(root, d2)).dataset
        content_paths = content_paths[: len(real_ds)]
        trg1 = np.eye(args.num_domains, dtype=np.float32)[t]
        diversity = []
        eval_batch = int(getattr(args, "eval_batch", 8) or 8)
        fwd = getattr(model, "_forward_random_impl", None)
        if fwd is None:
            fwd = lambda img, z, c: model.forward_random(img, z, c)[0]  # noqa: E731
        save = bool(getattr(args, "save_visuals", False))

        def consume(p):
            """Accumulate a chunk's host features one chunk late (see the
            module docstring) and write its visuals."""
            if save:
                for s, out in enumerate(p["outs"]):
                    names = [os.path.join(args.display_dir, domain, f"{p['start'] + j}_{s}.jpg")
                             for j in range(p["bsz"])]
                    save_images(out.numpy(), names)
            fid.accumulate(p["fake"].numpy(), p["real"].numpy())
            if p["dist"] is not None:
                diversity.extend(float(v) for v in p["dist"].numpy())

        pending = None
        for start in range(0, len(content_paths), eval_batch):
            chunk = content_paths[start : start + eval_batch]
            imgs = np.stack([transform.load_file(p) for p in chunk])
            bsz = imgs.shape[0]
            reals = np.stack([np.asarray(real_ds[(start + j) % len(real_ds)], np.float32)
                              for j in range(bsz)])
            with torch.inference_mode():
                img = f32_to_device(imgs, self.device)
                trg = f32_to_device(np.tile(trg1, (bsz, 1)), self.device)
                outs = [fwd(img, model.get_z_random(bsz, generator), trg).float()
                        for _ in range(num_styles)]
                dist = lpips_fn(outs[0], outs[1]) if num_styles > 1 else None
                # both sides [-1, 1] -> [0, 1], as InceptionV3 expects
                fake = fid.features((outs[0] + 1.0) / 2.0)
                real = fid.features((f32_to_device(reals, self.device) + 1.0) / 2.0)
            done, pending = pending, dict(
                fake=Pending(fake), real=Pending(real), start=start, bsz=bsz,
                dist=None if dist is None else Pending(dist),
                outs=[Pending(o) for o in outs] if save else [])
            self.scored += bsz * num_styles
            if done is not None:
                consume(done)
        if pending is not None:
            consume(pending)
        return fid, diversity

    def metric_nets(self, args):
        """(LPIPS fn, InceptionV3 extractor or None under ``--fid_extractor
        pixel``) on the evaluator's device, from ``args``' weights."""
        lpips_fn = make_lpips_fn(getattr(args, "lpips_weights", None), self.device)
        extractor = None
        if getattr(args, "fid_extractor", None) != "pixel":
            extractor = make_inception_extractor(getattr(args, "fid_weights", None),
                                                 device=self.device)
        return lpips_fn, extractor

    def evaluate(self, args, model, num_styles: int = 2) -> dict:
        """Returns {domain_name: {'fid': float, 'lpips_diversity': float}}."""
        domains = sorted(os.listdir(mode_dir(args)))
        transform = TrainTransform(args.load_size, args.crop_size, train=False)
        lpips_fn, extractor = self.metric_nets(args)
        g = self.generator(args)
        self.fids, self.diversity, self.fid_seconds, self.scored = {}, {}, {}, 0
        results = {}
        start = time.perf_counter()
        for t, domain in enumerate(domains):
            fid, diversity = self.evaluate_domain(args, model, domains, t, transform, lpips_fn,
                                                  extractor, g, num_styles)
            t0 = time.perf_counter()
            results[domain] = self.score(fid, diversity)
            self.fid_seconds[domain] = time.perf_counter() - t0
            self.fids[domain], self.diversity[domain] = fid, diversity
        self.loop_seconds = time.perf_counter() - start
        return results

    def run(self, args) -> dict:
        """The CLI on parsed ``args`` (:func:`parse_args`); returns the results."""
        with TimerBlock("Evaluating") as block:
            model = self.load_model(args)
            if getattr(args, "int8", False):
                block.log("Calibrating int8 serving path")
                self.calibrate(args, model)
            results = self.evaluate(args, model, num_styles=args.num_styles)
            for domain, metrics in results.items():
                block.log(f"{domain}: FID={metrics['fid']:.3f} "
                          f"LPIPS-diversity={metrics['lpips_diversity']:.4f}")
            return results


def evaluate(args, model, num_styles: int = 2) -> dict:
    """Scores ``model`` on its own device (:meth:`Evaluator.evaluate`)."""
    return Evaluator(model.device).evaluate(args, model, num_styles)


def parse_args(argv=None):
    """The sample CLI's flags and the evaluator's own."""
    parser = TestArguments()
    parser.parser.add_argument("--fid_weights", type=str, default=None)
    parser.parser.add_argument("--lpips_weights", type=str, default=None)
    parser.parser.add_argument("--num_styles", type=int, default=2)
    parser.parser.add_argument(
        "--fid_extractor", type=str, default=None, choices=[None, "pixel"],
        help="'pixel': weights-free 4x4 thumbnail-statistics FID (the "
        "self-relative trend metric; Inception FID needs --fid_weights)",
    )
    parser.parser.add_argument(
        "--fid_features", type=int, default=0,
        help="slice Inception features to N dims (small validation sets)",
    )
    parser.parser.add_argument("--eval_batch", type=int, default=8,
                               help="content images translated per device call")
    return parser.parse(argv)


def main(argv=None) -> dict:
    return Evaluator().run(parse_args(argv))


if __name__ == "__main__":
    main()
