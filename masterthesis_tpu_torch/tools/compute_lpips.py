"""Directory-pair LPIPS CLI (the port of ``masterthesis_tpu/tools/compute_lpips.py``),
on the card.

Usage: python -m masterthesis_tpu_torch.tools.compute_lpips -d0 dir0 -d1 dir1 -o out.txt
"""
from __future__ import annotations

import argparse

from masterthesis_tpu_torch.metrics.lpips import compute_lpips_from_dirs


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-d0", "--dir0", type=str, default="./imgs/ex_dir0")
    parser.add_argument("-d1", "--dir1", type=str, default="./imgs/ex_dir1")
    parser.add_argument("-o", "--out", type=str, default="./example_dists.txt")
    parser.add_argument("--weights", type=str, default=None,
                        help="npz with pretrained LPIPS/AlexNet weights")
    args = parser.parse_args(argv)
    avg = compute_lpips_from_dirs(args.dir0, args.dir1, args.out, args.weights)
    print(f"mean LPIPS: {avg}")
    return avg


if __name__ == "__main__":
    main()
