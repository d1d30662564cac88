#!/usr/bin/env python3
"""Serving (and training) A/B of two checkouts of the PyTorch port on one
NVIDIA card.

    python3 scripts/port_serve_ab.py PARENT_DIR CHANGE_DIR [--rounds 3]
        [--paths bf16 f32 int8 base_A_f32 base_B_f32 base_A_int8 base_B_int8 train int8_bf16]

Runs ``chip_smoke.py``'s ``serve`` phase (bf16, f32) and its ``int8_serve``
phase alone (the flagship AdaINModel at B=8, 256px, dim 64), and with
``base_A_f32`` / ``base_B_f32`` its ``serve`` phase, with ``base_A_int8`` /
``base_B_int8`` its ``int8_serve`` phase, on BaseModel's configs A and B,
with ``train`` its ``train`` phase (AdaINModel's main steps; their ms
stand in for the request ms below), and with ``int8_bf16`` its
``int8_serve_bf16`` phase on AdaINModel alone (int8 at bf16 compute, B=8
and 64: paths ``int8_bf16_B8`` and ``int8_bf16_B64``), each time in a fresh process
from the root of one checkout, in the order parent, change, change, parent
per round. Prints one JSON line per process and path: the side, img/s, and
the median and least request ms; then one summary line per path: each
side's median over its processes of their median request ms, and the
interquartile range of those medians, the noise a change is read against:
``slower`` when the change's median lies above the parent's third quartile,
``faster`` when below its first, else ``within noise``. Each checkout builds
its own kernels at first use. Needs a CUDA card; without one the first
process fails.
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
    elif path == "int8_bf16":
        cs._int8_serve_bf16(card, "AdaINModel", *cs.BF16_INT8_MODELS["AdaINModel"])
    elif path.endswith("_int8"):
        cfg = path.split("_")[1]
        cs.int8_serve(card, cs.BaseModel, cs.BASE_CONFIGS[cfg], cs.BASE_INT8_PER_FORWARD[cfg],
                      f"base_int8_serve/{cfg}", reps=2)
    elif path == "train":
        cs.train(card)
    elif path.startswith("base_"):
        cfg = path.split("_")[1]
        cs.serve("f32", card, cs.BaseModel, cs.BASE_CONFIGS[cfg], cs.BASE_FLOAT_PER_FORWARD,
                 f"base_serve/{cfg}", reps=2)
    else:
        cs.serve(path, card)
"""


def run(side: str, root: str, dtypes) -> list:
    # ``python -c`` puts the working directory first on sys.path, so the
    # child imports that checkout's chip_smoke.py and package
    out = subprocess.run([sys.executable, "-c", CHILD, *dtypes], cwd=root,
                         capture_output=True, text=True, check=True, timeout=900)
    rows = []
    for line in out.stdout.splitlines():
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if d.get("phase") not in ("serve", "int8_serve", "base_serve/A", "base_serve/B",
                                  "base_int8_serve/A", "base_int8_serve/B", "train",
                                  "int8_serve_bf16/AdaINModel"):
            continue
        if d["phase"] == "train":
            ms = sorted(1e3 * s for s in d["main_step_s"])
            path, rate = "train", dict(main_it_per_s=d["main_it_per_s"])
        else:
            ms = sorted(1e3 * s for s in d["request_s"])
            path, rate = d.get("dtype", "int8"), dict(img_per_s=d["img_per_s"])
        if d["phase"].startswith("base_"):
            path = f"base_{d['phase'][-1]}_{path}"
        elif d["phase"].startswith("int8_serve_bf16"):
            path = f"int8_bf16_B{d['batch']}"
        rows.append(dict(side=side, path=path, **rate,
                         median_ms=statistics.median(ms), min_ms=ms[0], card=d["card"]))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def quartiles(xs) -> tuple[float, float, float]:
    """(first quartile, median, third quartile) of ``xs`` (inclusive method:
    the quartiles lie within the values)."""
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return q1, q2, q3


def summary(rows, path: str) -> dict:
    out = dict(summary=path)
    for side in ("parent", "change"):
        q1, med, q3 = quartiles([r["median_ms"] for r in rows if r["path"] == path and
                                 r["side"] == side])
        out.update({f"{side}_median_ms": med, f"{side}_iqr_ms": [q1, q3]})
    lo, hi = out["parent_iqr_ms"]
    change = out["change_median_ms"]
    out["verdict"] = "slower" if change > hi else "faster" if change < lo else "within noise"
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--paths", nargs="+", default=["bf16", "f32", "int8"],
                   choices=["bf16", "f32", "int8", "base_A_f32", "base_B_f32", "base_A_int8",
                            "base_B_int8", "train", "int8_bf16"])
    a = p.parse_args(argv)
    rows = []
    for _ in range(a.rounds):
        for side in ("parent", "change", "change", "parent"):
            rows += run(side, getattr(a, side), a.paths)
    for path in dict.fromkeys(r["path"] for r in rows):
        print(json.dumps(summary(rows, path)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
