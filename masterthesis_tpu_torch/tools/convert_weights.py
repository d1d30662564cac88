"""Convert PyTorch pretrained weights to the metric and loss nets' npz files.

The port of ``masterthesis_tpu/tools/convert_weights.py``: it writes the
npz that the JAX tool writes, array for array (flat ``"a/b/c"`` keys, conv
kernels OIHW -> HWIO), so a file converted once loads in both packages:
the port's ``models/losses.py`` ``load_vgg_params``,
``metrics/inception.py`` ``load_inception_params`` and
``metrics/lpips.py`` ``load_lpips_params`` read them. Pretrained VGG
(perceptual loss), FID InceptionV3 (e.g. pytorch-fid's
pt_inception-2015-12-05) and LPIPS AlexNet weights are not in the
repository; convert them from torch checkpoints:

    python -m masterthesis_tpu_torch.tools.convert_weights vgg19 vgg19.pth vgg19.npz
    python -m masterthesis_tpu_torch.tools.convert_weights inception pt_inception.pth fid_inception.npz
    python -m masterthesis_tpu_torch.tools.convert_weights alexnet alexnet.pth lpips_alex.npz \\
        --lpips alex.pth
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def _conv(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (2, 3, 1, 0))  # OIHW -> HWIO


def convert_vgg(state_dict: Dict, vgg_type: str = "vgg19") -> Dict[str, np.ndarray]:
    """torchvision vgg*.features state_dict -> {conv name}/kernel|bias
    matching models.losses.VGGFeatureExtractor naming."""
    from masterthesis_tpu_torch.models.losses import vgg_layer_names

    names = vgg_layer_names(vgg_type)
    out = {}
    conv_names = [n for n in names if n.startswith("conv")]
    # torchvision features indices of convs, in order
    feature_keys = sorted(
        {int(k.split(".")[1]) for k in state_dict if k.startswith("features.") and k.endswith(".weight")}
    )
    assert len(feature_keys) == len(conv_names), (len(feature_keys), len(conv_names))
    for name, idx in zip(conv_names, feature_keys):
        out[f"{name}/kernel"] = _conv(state_dict[f"features.{idx}.weight"])
        out[f"{name}/bias"] = np.asarray(state_dict[f"features.{idx}.bias"])
    return out


def _basic_conv(out: Dict, prefix_t: str, prefix_j: str, sd: Dict):
    out[f"{prefix_j}/conv/kernel"] = _conv(sd[f"{prefix_t}.conv.weight"])
    out[f"{prefix_j}/bn_scale"] = np.asarray(sd[f"{prefix_t}.bn.weight"])
    out[f"{prefix_j}/bn_bias"] = np.asarray(sd[f"{prefix_t}.bn.bias"])
    out[f"{prefix_j}/bn_mean"] = np.asarray(sd[f"{prefix_t}.bn.running_mean"])
    out[f"{prefix_j}/bn_var"] = np.asarray(sd[f"{prefix_t}.bn.running_var"])


_INCEPTION_BRANCHES = {
    "Mixed_5b": ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
                 "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"],
    "Mixed_6a": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
    "Mixed_6b": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                 "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                 "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "Mixed_7a": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
                 "branch7x7x3_3", "branch7x7x3_4"],
    "Mixed_7b": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
                 "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
                 "branch3x3dbl_3b", "branch_pool"],
}
_INCEPTION_BRANCHES["Mixed_5c"] = _INCEPTION_BRANCHES["Mixed_5b"]
_INCEPTION_BRANCHES["Mixed_5d"] = _INCEPTION_BRANCHES["Mixed_5b"]
_INCEPTION_BRANCHES["Mixed_6c"] = _INCEPTION_BRANCHES["Mixed_6b"]
_INCEPTION_BRANCHES["Mixed_6d"] = _INCEPTION_BRANCHES["Mixed_6b"]
_INCEPTION_BRANCHES["Mixed_6e"] = _INCEPTION_BRANCHES["Mixed_6b"]
_INCEPTION_BRANCHES["Mixed_7c"] = _INCEPTION_BRANCHES["Mixed_7b"]


def convert_inception(state_dict: Dict) -> Dict[str, np.ndarray]:
    """FID InceptionV3 (torchvision layout, e.g. pytorch-fid's
    pt_inception-2015-12-05 weights) -> metrics.inception.InceptionV3 tree."""
    out: Dict[str, np.ndarray] = {}
    for stem in ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
                 "Conv2d_3b_1x1", "Conv2d_4a_3x3"]:
        _basic_conv(out, stem, stem, state_dict)
    for mixed, branches in _INCEPTION_BRANCHES.items():
        for b in branches:
            _basic_conv(out, f"{mixed}.{b}", f"{mixed}/{b}", state_dict)
    return out


def convert_alexnet_lpips(alex_sd: Dict, lpips_sd: Dict | None = None) -> Dict[str, np.ndarray]:
    """torchvision alexnet.features + (optional) lpips linear heads ->
    metrics.lpips.LPIPS tree."""
    out: Dict[str, np.ndarray] = {}
    conv_ids = sorted(
        {int(k.split(".")[1]) for k in alex_sd if k.startswith("features.") and k.endswith(".weight")}
    )
    for i, idx in enumerate(conv_ids):
        out[f"alex/conv{i}/kernel"] = _conv(alex_sd[f"features.{idx}.weight"])
        out[f"alex/conv{i}/bias"] = np.asarray(alex_sd[f"features.{idx}.bias"])
    if lpips_sd is not None:
        for i in range(5):
            w = lpips_sd.get(f"lin{i}.model.1.weight")
            if w is None:
                w = lpips_sd.get(f"lins.{i}.model.1.weight")
            out[f"lin{i}"] = np.asarray(w).reshape(-1)
    return out


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser("weight converter")
    parser.add_argument("kind", choices=["vgg19", "vgg16", "vgg13", "vgg11",
                                         "inception", "alexnet"])
    parser.add_argument("src", help=".pth state_dict path")
    parser.add_argument("dst", help="output .npz path")
    parser.add_argument("--lpips", default=None, help="lpips linear-head .pth (alexnet only)")
    args = parser.parse_args(argv)
    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    if args.kind.startswith("vgg"):
        out = convert_vgg(sd, args.kind)
    elif args.kind == "inception":
        out = convert_inception(sd)
    else:
        lp = None
        if args.lpips:
            lp = torch.load(args.lpips, map_location="cpu", weights_only=True)
            lp = {k: v.numpy() for k, v in lp.items()}
        out = convert_alexnet_lpips(sd, lp)
    np.savez(args.dst, **out)
    print(f"wrote {len(out)} arrays to {args.dst}")


if __name__ == "__main__":
    main()
