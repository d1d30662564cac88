"""What every run of the benchmark shares: the files it reads by name, the
import guard, the seeded weights and inputs, and the result line.

Everything a cell is made of is found by name under ``portbench/``:
``configs/<config>.json`` (the model and its flags, and the name of its
plain reference), ``reference/<reference>.<role>.py`` (that reference for
one role, ``serve`` or ``train``, or the role a mix names),
``traffic/<mix>.json`` (the traffic kind and its parameters),
``cells/<workload>.json`` (the limits that decide ``correct`` and the kernels
the cell drives), ``metrics/<metric>.py`` (one reader per per-layer metric)
and ``kernels/<kernel>.json`` (one hand-written kernel function, the names
of its device launches, and the work function that counts its operations
and bytes). A later change adds a cell, a configuration, a mix, a
reference, a metric or a kernel by adding files; no file here needs an edit
for it.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# whole top-level module names that no run may load (the JAX package's name
# is a prefix of the port's, so names are compared whole, never by prefix)
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "masterthesis_tpu")
PORT = "masterthesis_tpu_torch"


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files resolved by name."""

    name: str
    config_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict  # number compared -> its limit
    kernels: list = field(default_factory=list)  # the kernel files the cell drives
    end_to_end: list = field(default_factory=list)  # e2e metric entries the cell reports
    per_layer: list = field(default_factory=list)  # per-layer metric entries it reports


def reports(metric: dict, cell: str, e2e_cells: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or, without a
    list, every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or cell in e2e_cells.get(moves, ())


def resolve(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json by default), its
    configuration, traffic and limits read from their files under ``root``."""
    bench = benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    base = root / "portbench"
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    own = load_json(base / "cells" / f"{name}.json")
    all_cells = [c["name"] for c in bench["workloads"]]
    e2e_cells = {m["name"]: m.get("workloads", all_cells) for m in bench["end_to_end"]}
    e2e = [m for m in bench["end_to_end"] if name in e2e_cells[m["name"]]]
    per_layer = [m for m in bench["per_layer"] if reports(m, name, e2e_cells)]
    return Cell(name, w["config"], int(w["chips"]), config, traffic, own["limits"],
                own.get("kernels", []), e2e, per_layer)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def traffic_kind(kind: str, base: Path = HERE):
    """The module that runs traffic of ``kind``: ``kinds/<kind>.py``."""
    return load_module(base / "kinds" / f"{kind}.py", f"portbench_kind_{kind}")


def reference(cell: Cell, role: str, base: Path = HERE):
    """The plain reference of ``cell`` for ``role`` ("serve": a module with
    ``forward_random``; "train": one with ``Step`` and ``draw_shapes``):
    ``reference/<config's reference>.<role>.py``, where the cell's mix may
    name a role of its own (``reference_role``)."""
    name, role = cell.config["reference"], cell.traffic.get("reference_role", role)
    return load_module(base / "reference" / f"{name}.{role}.py",
                       f"portbench_reference_{name}_{role}".replace("-", "_").replace(".", "_"))


def metric_reader(name: str, base: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    safe = name.replace(".", "_").replace("-", "_")
    return load_module(base / "metrics" / f"{name}.py", f"portbench_metric_{safe}").read


def kernel_files(base: Path = HERE) -> dict[str, dict]:
    """Every ``kernels/<kernel>.json``, by kernel name."""
    return {p.stem: load_json(p) for p in sorted((base / "kernels").glob("*.json"))}


def plant(ctx, model) -> None:
    """Plant ``ctx.fault`` (tests and readings only) in ``model``. A fault
    that patches a module of the program returns the function that takes it
    out again, kept in ``ctx.undo`` for :func:`unplant`."""
    if ctx.fault is not None:
        undo = ctx.fault(model)
        if callable(undo):
            ctx.undo.append(undo)


def unplant(ctx) -> None:
    while ctx.undo:
        ctx.undo.pop()()


def sub_seed(seed: int, purpose: int) -> int:
    """An independent 63-bit seed for one purpose of a run's ``--seed``."""
    return (int(seed) * 1_000_003 + purpose * 7_919) % (2**63 - 1)


# purposes of sub_seed: each stream of a run draws from a generator of its own
WEIGHTS, POOL, CALIBRATION, SAMPLE, DRAWS = 1, 2, 3, 4, 5


def make_args(config: dict, traffic: dict, mode: str):
    """The port's argument namespace for ``config``'s flags and the mix's
    (compute dtype, training flags)."""
    from masterthesis_tpu_torch.arguments import default_test_args, default_train_args

    flags = dict(config["flags"])
    flags.update(traffic.get("flags", {}))
    flags["seed"] = 0
    make = default_train_args if mode == "train" else default_test_args
    return make(**flags)


def build_model(config: dict, args, device):
    from masterthesis_tpu_torch import models

    return getattr(models, config["model"])(args, device=device)


def weight_kinds(net) -> dict[str, tuple[str, int]]:
    """Each parameter of ``net`` by state_dict key: (kind, fan_in), kind one
    of "weight" (a conv or linear kernel), "transposed" (a transposed conv's
    IOHW kernel), "bias", "scale" (a norm's multiplier)."""
    out = {}
    for mod_name, mod in net.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{p_name}" if mod_name else p_name
            if p.dim() >= 2:
                transposed = type(mod).__name__ == "ConvTranspose2d"
                # a k x k / s transposed conv's output sums over C_in * k^2 / s^2 taps
                fan = (p.shape[0] * p[0, 0].numel() // max(1, mod.stride ** 2) if transposed
                       else p[0].numel())
                out[key] = ("transposed" if transposed else "weight", max(1, fan))
            elif p_name == "scale":
                out[key] = ("scale", 1)
            else:
                out[key] = ("bias", 1)
    return out


def make_weights(nets: dict, seed: int, device) -> dict[str, dict]:
    """Seeded weights for every net, made on ``device`` in one normal draw and
    cut into parameters: kernels N(0, 1 / fan_in), biases N(0, 0.1^2), norm
    scales 1 + N(0, 0.1^2). Returns {net: state_dict}, f32; buffers are the
    nets' own."""
    import torch

    kinds, total = {}, 0
    for name in sorted(nets):
        kinds[name] = weight_kinds(nets[name])
        total += sum(p.numel() for p in nets[name].parameters())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name in sorted(nets):
        params = dict(nets[name].named_parameters())
        sd = {}
        for key, value in nets[name].state_dict().items():
            if key not in params:
                sd[key] = value.detach().clone()
                continue
            n = value.numel()
            draw = flat[at:at + n].view(value.shape)
            at += n
            kind, fan = kinds[name][key]
            if kind in ("weight", "transposed"):
                sd[key] = draw * fan ** -0.5
            elif kind == "scale":
                sd[key] = 1.0 + 0.1 * draw
            else:
                sd[key] = 0.1 * draw
        out[name] = sd
    return out


def smooth_images(gen, n: int, size: int, device):
    """``n`` NHWC f32 images in (-1, 1): smooth seeded random fields (coarse
    and middle scales upsampled, a little pixel noise, through tanh)."""
    import torch
    import torch.nn.functional as F

    coarse = torch.randn((n, 3, 8, 8), generator=gen, device=device)
    middle = torch.randn((n, 3, 32, 32), generator=gen, device=device)
    fine = torch.randn((n, 3, size, size), generator=gen, device=device)
    img = (F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)
           + 0.5 * F.interpolate(middle, size=(size, size), mode="bilinear", align_corners=False)
           + 0.1 * fine)
    return torch.tanh(img).permute(0, 2, 3, 1).contiguous()


def request_batch(gen, n: int, size: int, latent: int, domains: int, device) -> dict:
    """One serving request: NHWC images, styles N(0, 1) (n, latent) and
    one-hot targets uniform over the domains."""
    import torch
    import torch.nn.functional as F

    img = smooth_images(gen, n, size, device)
    z = torch.randn((n, latent), generator=gen, device=device)
    c = F.one_hot(torch.randint(0, domains, (n,), generator=gen, device=device), domains).float()
    return {"img": img, "z": z, "c": c}


def device_info(torch, count: int) -> dict:
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
                "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                             for i in range(count)))}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                compared: dict, breakdown: Optional[dict] = None,
                setup_parts: Optional[dict] = None) -> str:
    """The contract's last line: ``compared`` (each number compared with its
    limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if setup_parts is not None:
        out["setup_parts"] = setup_parts
    out["compared"] = compared
    return json.dumps(out)


def env_caches(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for anything that builds:
    the port's nvcc libraries go to ``build/kernels/`` by the program's own
    rule; torch's extension and Triton caches, if any library reaches for
    them, to ``build/`` too."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
