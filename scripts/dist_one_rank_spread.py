#!/usr/bin/env python3
"""The spread of the first fused GAN step's losses on one NVIDIA card: bare
runs against runs through the distributed path on one NCCL rank.

    python3 scripts/dist_one_rank_spread.py [--runs 4] [--deterministic]

``chip_smoke.py``'s ``distributed`` phase holds one rank's first step
against a bare one within three times the bare runs' own spread. This
script shows whether the two kinds of run come from one spread: it makes
``--runs`` bare runs and as many one-rank runs (``make_mesh(1)`` in a
process group of one), in turns, each from a fresh model with the same
seeded weights, batch and draws (the phase's flagship config: 256 px, dim
64, B=8 a side, bf16), and prints the relative gap of every pair
(``chip_smoke._rel_gap``: the worst loss, |a - b| / max(|b|, 1)) within
the bare runs, within the one-rank runs and across, then one summary line
with each group's largest and median gap. With ``--deterministic`` both
kinds run with cuDNN's deterministic algorithms and
``torch.use_deterministic_algorithms(True, warn_only=True)`` (the reflect
pad's backward has no deterministic CUDA kernel and keeps its atomics).
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from masterthesis_tpu_torch.parallel import mesh as pmesh  # noqa: E402


def first_step(batch, mesh=None) -> dict:
    model = cs.AdaINModel(cs.default_train_args(**cs.FUSED_GAN_ARGS))
    if mesh is not None:
        model = pmesh.replicate(model, mesh)
    logs = cs._floats(model.main_step(batch, cs.StepDraws(cs._dist_generator())))
    torch.cuda.synchronize()
    del model
    torch.cuda.empty_cache()
    return logs


def gaps(runs_a, runs_b=None) -> list:
    pairs = (itertools.combinations(runs_a, 2) if runs_b is None
             else itertools.product(runs_a, runs_b))
    return [cs._rel_gap(a, b) for a, b in pairs]


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=4)
    p.add_argument("--deterministic", action="store_true")
    a = p.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    if a.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    card = cs.card_line()
    _, batch = cs.train_batch(cs.FUSED_GAN_ARGS, seed=41)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{pmesh.free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    runs = {"bare": [], "one_rank": []}
    try:
        mesh = pmesh.make_mesh(1)
        kinds = ("bare", "one_rank", "one_rank", "bare")
        for i in range(a.runs * 2):
            kind = kinds[i % 4]
            runs[kind].append(first_step(batch, mesh if kind == "one_rank" else None))
    finally:
        dist.destroy_process_group()
    for kind, logs in runs.items():
        for i, one in enumerate(logs):
            print(json.dumps(dict(run=kind, index=i, losses=one)), flush=True)
    groups = {"bare": gaps(runs["bare"]), "one_rank": gaps(runs["one_rank"]),
              "across": gaps(runs["one_rank"], runs["bare"])}
    for name, gs in groups.items():
        print(json.dumps(dict(pairs=name, gaps=gs)), flush=True)
    print(json.dumps(dict(
        summary="first fused step, relative gaps", card=card, deterministic=a.deterministic,
        runs=a.runs, **{f"{name}_max": max(g for _, g in gs) for name, gs in groups.items()},
        **{f"{name}_median": statistics.median(g for _, g in gs) for name, gs in groups.items()},
        worst_keys={name: sorted({k for k, _ in gs}) for name, gs in groups.items()})),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
