"""Two-directory FID CLI (the port of ``masterthesis_tpu/tools/compute_fid.py``).

``--mode clean`` reproduces cleanfid's resize protocol (host-side
unquantized PIL-bicubic resize to 299); ``--mode plain`` resizes on the
device with bilinear. Runs on the card.

Usage: python -m masterthesis_tpu_torch.tools.compute_fid dir1 dir2 \\
           [--mode clean] [--weights fid_inception.npz]
"""
from __future__ import annotations

import argparse

from masterthesis_tpu_torch.metrics.fid import compute_fid_from_dirs


def main(argv=None) -> float:
    parser = argparse.ArgumentParser("FID")
    parser.add_argument("dir1")
    parser.add_argument("dir2")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--mode", choices=["plain", "clean"], default="plain")
    parser.add_argument("--weights", type=str, default=None,
                        help="npz with pretrained FID-InceptionV3 weights")
    args = parser.parse_args(argv)
    score = compute_fid_from_dirs(
        args.dir1, args.dir2, batch_size=args.batch_size,
        weights_path=args.weights, mode=args.mode,
    )
    print(f"FID: {score}")
    return score


if __name__ == "__main__":
    main()
