#!/usr/bin/env python3
"""Kernels 9 and 10 (``resblock_fwd`` / ``resblock_bwd``) bit for bit across
two checkouts of the PyTorch port, on one NVIDIA card.

    python3 scripts/resblock_train_bits.py PARENT_DIR CHANGE_DIR

Runs both kernels at (16, 256, 64, 64) bf16 on inputs made from seed 5 in a
fresh process from the root of each checkout (which imports that checkout's
package and builds its kernels), saves every output under ``build/``, and
prints whether the two checkouts give the same bits. Exits 1 if they do not.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

CHILD = """
import sys
import torch
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb

g = torch.Generator(device="cuda").manual_seed(5)
def r(*s, sc=1.0):
    return torch.randn(s, generator=g, device="cuda") * sc
x, gg = r(16, 256, 64, 64).bfloat16(), r(16, 256, 64, 64).bfloat16()
w1, w2 = r(256, 256, 3, 3, sc=0.03), r(256, 256, 3, 3, sc=0.03)
gamma, beta = r(16, 256, sc=0.3), r(16, 256, sc=0.3)
out, h1, h2, stats = krb.resblock_fwd(x, w1, w2, gamma, beta)
bwd = krb.resblock_bwd(x, h1, h2, gg, stats, w1, w2, gamma, beta)
flat = []
def add(t):
    if isinstance(t, (tuple, list)):
        for u in t:
            add(u)
    elif isinstance(t, torch.Tensor):
        flat.append(t.cpu())
add((out, h1, h2, stats, bwd))
torch.save(flat, sys.argv[1])
"""


def outputs(root: str, out: Path) -> list:
    # ``python -c`` puts the working directory first on sys.path
    subprocess.run([sys.executable, "-c", CHILD, str(out)], cwd=root, check=True, timeout=900)
    return torch.load(out)


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    build = Path(__file__).resolve().parents[1] / "build"
    build.mkdir(exist_ok=True)
    a = outputs(argv[0], build / "resblock_bits_parent.pt")
    b = outputs(argv[1], build / "resblock_bits_change.pt")
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"kernels 9/10: {len(a)} output tensors, bit-equal across the checkouts: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
