#!/usr/bin/env python3
"""Float serving A/B of two checkouts of the PyTorch port on one NVIDIA card.

    python3 scripts/port_serve_ab.py PARENT_DIR CHANGE_DIR [--rounds 3]

Runs ``chip_smoke.py``'s float ``serve`` phase alone (bf16, then f32: the
flagship AdaINModel at B=8, 256px, dim 64), each time in a fresh process
from the root of one checkout, in the order parent, change, change, parent
per round. Prints one JSON line per process and dtype: the side, img/s, and
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
for dtype in sys.argv[1:]:
    cs.serve(dtype, card)
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
        if d.get("phase") != "serve":
            continue
        ms = sorted(1e3 * s for s in d["request_s"])
        print(json.dumps(dict(side=side, dtype=d["dtype"], img_per_s=d["img_per_s"],
                              median_ms=statistics.median(ms), min_ms=ms[0], card=d["card"])),
              flush=True)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args(argv)
    for _ in range(a.rounds):
        for side in ("parent", "change", "change", "parent"):
            run(side, getattr(a, side), ("bf16", "f32"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
