#!/usr/bin/env python3
"""Serving A/B of two checkouts of the PyTorch port on one NVIDIA card.

    python3 scripts/port_serve_ab.py PARENT_DIR CHANGE_DIR [--rounds 3]
        [--paths bf16 f32 int8 base_A_f32 base_B_f32 base_A_int8 base_B_int8]

Runs ``chip_smoke.py``'s ``serve`` phase (bf16, f32) and its ``int8_serve``
phase alone (the flagship AdaINModel at B=8, 256px, dim 64), and with
``base_A_f32`` / ``base_B_f32`` its ``serve`` phase, with ``base_A_int8`` /
``base_B_int8`` its ``int8_serve`` phase, on BaseModel's configs A and B,
each time in a fresh process
from the root of one checkout, in the order parent, change, change, parent
per round. Prints one JSON line per process and path: the side, img/s, and
the median and least request ms. Each checkout builds its own kernels at
first use. Needs a CUDA card; without one the first process fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

CHILD = """
import sys
import torch
import chip_smoke as cs
from masterthesis_tpu_torch.ops.kernels import build
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
build.build()
card = cs.card_line()
for path in sys.argv[1:]:
    if path == "int8":
        cs.int8_serve(card)
    elif path.endswith("_int8"):
        cfg = path.split("_")[1]
        cs.int8_serve(card, cs.BaseModel, cs.BASE_CONFIGS[cfg], cs.BASE_INT8_PER_FORWARD[cfg],
                      f"base_int8_serve/{cfg}", reps=2)
    elif path.startswith("base_"):
        cfg = path.split("_")[1]
        cs.serve("f32", card, cs.BaseModel, cs.BASE_CONFIGS[cfg], cs.BASE_FLOAT_PER_FORWARD,
                 f"base_serve/{cfg}", reps=2)
    else:
        cs.serve(path, card)
"""


def run(side: str, root: str, dtypes) -> None:
    # ``python -c`` puts the working directory first on sys.path, so the
    # child imports that checkout's chip_smoke.py and package
    out = subprocess.run([sys.executable, "-c", CHILD, *dtypes], cwd=root,
                         capture_output=True, text=True, check=True, timeout=900)
    for line in out.stdout.splitlines():
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if d.get("phase") not in ("serve", "int8_serve", "base_serve/A", "base_serve/B",
                                  "base_int8_serve/A", "base_int8_serve/B"):
            continue
        ms = sorted(1e3 * s for s in d["request_s"])
        path = d.get("dtype", "int8")
        if d["phase"].startswith("base_"):
            path = f"base_{d['phase'][-1]}_{path}"
        print(json.dumps(dict(side=side, path=path, img_per_s=d["img_per_s"],
                              median_ms=statistics.median(ms), min_ms=ms[0], card=d["card"])),
              flush=True)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--paths", nargs="+", default=["bf16", "f32", "int8"],
                   choices=["bf16", "f32", "int8", "base_A_f32", "base_B_f32", "base_A_int8",
                            "base_B_int8"])
    a = p.parse_args(argv)
    for _ in range(a.rounds):
        for side in ("parent", "change", "change", "parent"):
            run(side, getattr(a, side), a.paths)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
