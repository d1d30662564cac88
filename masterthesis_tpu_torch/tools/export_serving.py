"""Serving-bundle export through ``torch.export``.

The port of ``masterthesis_tpu/tools/export_serving.py``: the inference
functions of a model, traced once into ``ExportedProgram``s that replay
without the model-building code. The kernels are ``torch.library`` ops
(``ops/kernels/library.py``), so a traced forward calls them as the eager
one does, on the card (CUDA) or through their plain versions (CPU). An int8
model exports with its calibration baked in: its quantized weights and
scales are built by one eager int8 forward before the trace, and the
program holds them as constants.

Bundle layout (one directory):
    manifest.json            shapes, platform, int8 flag, framework revision
    forward_random.pt2       (img, z, c) -> imgs
    forward_reference.pt2    (img_src, img_ref, c, eps) -> imgs, with eps the
                             style encoder's VAE draw (B, latent)

Each program holds the weights it reads. Replay needs torch and
``ops/kernels/library.py`` only, not the model classes:

    from masterthesis_tpu_torch.tools.export_serving import load_bundle
    bundle = load_bundle("exported/")
    out = bundle.forward_random(img, z, c)   # NHWC f32 in and out

Programs replay on the device they were traced on (the manifest's
``platforms``): export on the machine class you serve on.

CLI (the JAX tool's flags, and ``--device``; without it the card):
    python -m masterthesis_tpu_torch.tools.export_serving \\
        --model AdaINModel --resume ckpt --out exported/ \\
        [--int8 --calib_dir imgs/ --int8_calib_batches 2] \\
        [--batch_size 256 --crop_size 256]
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from masterthesis_tpu_torch.ops.kernels import library  # noqa: F401  (registers the kernels' ops)

MANIFEST = "manifest.json"
SUFFIX = ".pt2"
FUNCTIONS = ("forward_random", "forward_reference")


def _git_rev() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL,
        ).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


class _Traced(nn.Module):
    """One of the model's NHWC inference functions as a module whose
    submodules are the model's nets, so that the trace takes their
    parameters as the program's state."""

    def __init__(self, model, fn: str):
        super().__init__()
        self.nets = nn.ModuleDict(dict(model.nets))
        self.model, self.fn = model, fn

    def forward(self, *args):
        return getattr(self.model, f"_{self.fn}_impl")(*args)


def export_bundle(model, out_dir: str, batch_size: int, crop_size: int,
                  fns: Sequence[str] = FUNCTIONS) -> dict:
    """Export ``model``'s inference functions (``fns`` of ``FUNCTIONS``) as
    a serving bundle in ``out_dir``, traced on the model's device at
    ``batch_size`` images of ``crop_size``. A model with an int8
    calibration (``calibrate_int8``) exports its int8 forward with that
    calibration baked in. Returns the manifest."""
    os.makedirs(out_dir, exist_ok=True)
    a = model.args
    b, s = int(batch_size), int(crop_size)
    dim_in = int(getattr(a, "input_dim", None) or 3)
    nd, latent = int(a.num_domains), int(model.latent_dim)
    dev = model.device

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    # distinct tensors: an input passed twice would be traced as one
    img, z, c = zeros(b, s, s, dim_in), zeros(b, latent), zeros(b, nd)
    inputs = {"forward_random": (img, z, c),
              "forward_reference": (zeros(b, s, s, dim_in), zeros(b, s, s, dim_in),
                                    zeros(b, nd), zeros(b, latent))}
    from masterthesis_tpu_torch.models.quantize import int8_convs

    for net in model.nets.values():
        for m in int8_convs(net).values():
            m.drop_quant()
    with torch.no_grad():
        # one eager forward: the int8 convs quantize their weights now, so
        # that the trace reads real tensors and keeps them as constants
        model._forward_random_impl(img, z, c)
        for name in fns:
            program = torch.export.export(_Traced(model, name), inputs[name], strict=False)
            torch.export.save(program, os.path.join(out_dir, name + SUFFIX))
    manifest = {
        "model": type(model).__name__,
        "batch_size": b,
        "crop_size": s,
        "input_dim": dim_in,
        "num_domains": nd,
        "latent_dim": latent,
        "int8": bool(model.quant),
        "functions": sorted(fns),
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        "framework_rev": _git_rev(),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServingBundle:
    """A loaded bundle: each exported function callable on NHWC f32 tensors
    on the device it was traced on, without gradients."""

    def __init__(self, manifest: dict, programs: dict):
        self.manifest = manifest
        self.programs = programs
        self._fns = {name: p.module() for name, p in programs.items()}
        self.device = torch.device(manifest["platforms"][0])

    def forward_random(self, img, z, c):
        with torch.no_grad():
            return self._fns["forward_random"](img, z, c)

    def forward_reference(self, img_src, img_ref, c_trg, eps=None,
                          generator: Optional[torch.Generator] = None):
        """``eps``: the VAE draw (B, latent); else normal draws from
        ``generator`` (default: seed 0 on the bundle's device)."""
        if eps is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            eps = torch.randn((img_src.shape[0], self.manifest["latent_dim"]),
                              generator=generator, device=generator.device).to(self.device)
        with torch.no_grad():
            return self._fns["forward_reference"](img_src, img_ref, c_trg, eps)


def load_bundle(bundle_dir: str) -> ServingBundle:
    """Load a bundle that :func:`export_bundle` wrote. Needs torch and the
    kernels' ops only: no model classes, no arguments."""
    with open(os.path.join(bundle_dir, MANIFEST)) as f:
        manifest = json.load(f)
    programs = {name: torch.export.load(os.path.join(bundle_dir, name + SUFFIX))
                for name in manifest["functions"]}
    return ServingBundle(manifest, programs)


def _calibrate_from_dir(model, calib_dir: str, n_batches: int, crop_size: int,
                        load_size: int, seed: int = 0) -> dict:
    """int8 calibration on up to 8 x ``n_batches`` images of ``calib_dir``
    (the eval transform), with one-hot targets and styles drawn from a
    generator seeded with ``seed`` on the model's device."""
    from masterthesis_tpu_torch.data.datasets import ImageList
    from masterthesis_tpu_torch.data.transforms import TrainTransform

    ds = ImageList(calib_dir, transform=TrainTransform(load_size, crop_size, train=False))
    k = min(len(ds), 8 * n_batches)
    if k == 0:
        raise ValueError(f"--calib_dir {calib_dir}: no images found")
    imgs = np.stack([ds[i] for i in range(k)])
    batches = [bb for bb in np.array_split(imgs, n_batches) if len(bb)]
    g = torch.Generator(device=model.device).manual_seed(int(seed))
    nd = int(model.args.num_domains)
    c_trgs, zs = [], []
    for bb in batches:
        idx = torch.randint(nd, (len(bb),), generator=g, device=model.device)
        c_trgs.append(torch.nn.functional.one_hot(idx, nd).float())
        zs.append(model.get_z_random(len(bb), g))
    return model.calibrate_int8(batches, c_trgs, zs)


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    from masterthesis_tpu_torch import models as model_zoo
    from masterthesis_tpu_torch.arguments import default_test_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="AdaINModel", choices=["AdaINModel", "BaseModel"])
    ap.add_argument("--resume", type=str, default=None,
                    help="model checkpoint (model_{it}.ckpt, the port's or the JAX package's)")
    ap.add_argument("--out", type=str, required=True, help="bundle directory")
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--load_size", type=int, default=286)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--latent_dim", type=int, default=8)
    ap.add_argument("--num_domains", type=int, default=4)
    ap.add_argument("--compute_dtype", type=str, default="bfloat16")
    ap.add_argument("--concat", action="store_true")
    ap.add_argument("--int8", action="store_true", help="calibrate + export the int8 serving path")
    ap.add_argument("--calib_dir", type=str, default=None,
                    help="image dir for int8 calibration (required w/ --int8)")
    ap.add_argument("--int8_calib_batches", type=int, default=2)
    ap.add_argument("--skip_reference", action="store_true", help="export forward_random only")
    ap.add_argument("--device", type=str, default=None,
                    help="where to trace and serve: the card unless 'cpu'")
    cli = ap.parse_args(argv)

    args = default_test_args(
        crop_size=cli.crop_size, load_size=cli.load_size, dim=cli.dim,
        latent_dim=cli.latent_dim, num_domains=cli.num_domains, batch_size=cli.batch_size,
        compute_dtype=cli.compute_dtype, concat=cli.concat, resume=cli.resume, logdir=None,
    )
    model = getattr(model_zoo, cli.model)(args, device=cli.device)
    model.initialize()
    if cli.int8:
        if not cli.calib_dir:
            raise SystemExit("--int8 requires --calib_dir")
        _calibrate_from_dir(model, cli.calib_dir, max(1, cli.int8_calib_batches),
                            cli.crop_size, cli.load_size)
    fns = ("forward_random",) if cli.skip_reference else FUNCTIONS
    manifest = export_bundle(model, cli.out, cli.batch_size, cli.crop_size, fns=fns)
    print(json.dumps(manifest, indent=1))


if __name__ == "__main__":
    main()
