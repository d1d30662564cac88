"""Argument defaults, as plain namespaces for programmatic use.

The port's own copy of the JAX package's ``default_train_args`` /
``default_test_args`` and the parsers they read, so that a configuration
means the same in both packages. The port serves inference only: of these
flags it reads the model's shape (``dim``, ``latent_dim``, ``num_domains``,
``input_dim``, ``crop_size``), ``enc_norm``/``dec_norm``/``up_type``,
``compute_dtype``, ``init_type``/``init_gain`` and ``seed``; the rest are
kept so that one namespace drives either package.
"""
from __future__ import annotations

import argparse


class AttributeDict(dict):
    """dict with attribute access; a missing attribute reads as None, so
    optional flags are probed with plain ``args.flag``."""

    def __getattr__(self, name):
        if name.startswith("__"):  # keep pickling/copy protocols sane
            raise AttributeError(name)
        return self.get(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


def _add_base_args(parser: argparse.ArgumentParser):
    parser.add_argument("--dataroot", help="root folder of the dataset")
    parser.add_argument("--name", type=str, default="experiment")
    parser.add_argument("--exp_dir", type=str, default="../exps")
    parser.add_argument("--model", type=str, default="BaseModel")
    parser.add_argument("--input_dim", type=int, default=3)
    parser.add_argument("--output_dim", type=int, default=3)
    parser.add_argument("--dim", type=int, default=64, help="# of gen filters in the last conv layer")
    parser.add_argument("--init_type", type=str, default="normal", help="network initialization")
    parser.add_argument("--init_gain", type=float, default=0.02)
    parser.add_argument("--use_dropout", action="store_true")
    parser.add_argument("--num_domains", type=int, default=2)
    parser.add_argument("--mode", type=str, default="train")
    parser.add_argument("--concat", action="store_true")
    parser.add_argument("--reparam", action="store_true")
    parser.add_argument("--use_dis_content", action="store_true")
    parser.add_argument("--latent_dim", type=int, default=8)
    parser.add_argument("--up_type", type=str, default="transpose",
                        choices=["transpose", "nearest", "pixelshuffle"])
    parser.add_argument("--dec_norm", type=str, default="layer", choices=["batch", "instance", "layer"])
    parser.add_argument("--enc_norm", type=str, default="instance", choices=["batch", "instance", "layer"])
    parser.add_argument("--dataset", type=str, default="PairedDataset")
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--num_workers", default=4, type=int)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--load_size", type=int, default=286)
    parser.add_argument("--crop_size", type=int, default=256)
    parser.add_argument("--no_flip", action="store_true")
    parser.add_argument("--select_domains", default=None, type=str, nargs="+")
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--save_logs", action="store_true")
    parser.add_argument("--seed", type=int, default=0, help="PRNG seed")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--num_devices", type=int, default=None)
    parser.add_argument("--device_preproc", action="store_true")
    parser.add_argument("--gan_step", type=str, default="reference", choices=["reference", "fused"])
    parser.add_argument("--fused_resblock", type=str, default="off", choices=["auto", "off"])
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--int8_train", action="store_true")
    parser.add_argument("--int8_train_scope", type=str, default="all")
    parser.add_argument("--int8_calib_freq", type=int, default=100)
    parser.add_argument("--ckpt_format", type=str, default="msgpack", choices=["msgpack", "orbax"])


def _add_train_args(parser: argparse.ArgumentParser):
    parser.add_argument("--dis_norm", type=str, default=None, choices=["batch", "instance", "layer"])
    parser.add_argument("--norm_feat", action="store_true")
    parser.add_argument("--lr", type=float, default=0.0001)
    parser.add_argument("--wd", type=float, default=0.0001)
    parser.add_argument("--beta1", type=float, default=0.5)
    parser.add_argument("--beta2", type=float, default=0.999)
    parser.add_argument("--lr_policy", type=str, default="step")
    parser.add_argument("--n_iters", type=int, default=1000000)
    parser.add_argument("--last_iter", type=int, default=-1)
    parser.add_argument("--max_iter", type=int, default=1000000)
    parser.add_argument("--n_iter_decay", type=int, default=600000)
    parser.add_argument("--d_iter", type=int, default=3)
    parser.add_argument("--lambda_rec", type=float, default=10)
    parser.add_argument("--lambda_cls", type=float, default=1.0)
    parser.add_argument("--lambda_cls_G", type=float, default=5.0)
    parser.add_argument("--lambda_style", type=float, default=5.0)
    parser.add_argument("--print_freq", type=int, default=1000)
    parser.add_argument("--save_freq", type=int, default=1000)
    parser.add_argument("--display_freq", type=int, default=1000)
    parser.add_argument("--train_n_batch", type=float, default=float("inf"))
    parser.add_argument("--gan_mode", type=str, default="vanilla")
    parser.add_argument("--resume_opt", type=str, default=None)
    parser.add_argument("--lambda_gp", type=float, default=0.0)
    parser.add_argument("--ms_dis", action="store_true")
    parser.add_argument("--dis_sn", action="store_true")
    parser.add_argument("--num_scales", type=int, default=3)
    parser.add_argument("--use_ragan", action="store_true")
    parser.add_argument("--lambda_perceptual", type=float, default=1.0)
    parser.add_argument("--vgg_type", type=str, default="vgg19")
    parser.add_argument("--vgg_loss", type=str, default=None)
    parser.add_argument("--vgg_layers", type=str, nargs="+", default=["conv5_4"])
    parser.add_argument("--layer_weights", type=float, nargs="+", default=[1.0])
    parser.add_argument("--vgg_weights", type=str, default=None)


def _add_test_args(parser: argparse.ArgumentParser):
    parser.add_argument("--num", type=int, default=5, help="number of outputs per image")
    parser.add_argument("--result_dir", type=str, default="./outputs")
    parser.add_argument("--out_fmt", type=str, default="image", help="one of [image, video]")
    parser.add_argument("--vid_fname", type=str, default="video.avi")
    parser.add_argument("--reference", type=str, nargs="+", default=None)
    parser.add_argument("--targets", type=str, nargs="+", default=None)
    parser.add_argument("--multi_iter", type=int, default=0)
    parser.add_argument("--save_visuals", action="store_true")
    parser.add_argument("--gen_grid", action="store_true")
    parser.add_argument("--gen_style", action="store_true")
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--int8_calib_batches", type=int, default=2)
    parser.add_argument("--sample_size", type=int, nargs=2, default=[540, 960], metavar=("H", "W"))


def _defaults_from(parsers) -> AttributeDict:
    d = AttributeDict()
    for add in parsers:
        p = argparse.ArgumentParser()
        add(p)
        for action in p._actions:
            if action.dest != "help":
                d[action.dest] = action.default
    return d


def default_train_args(**overrides) -> AttributeDict:
    """Training defaults (no CLI, no directories created)."""
    d = _defaults_from([_add_base_args, _add_train_args])
    d["mode"] = "train"
    d.update(overrides)
    return d


def default_test_args(**overrides) -> AttributeDict:
    """Test/sampling defaults (no CLI, no directories created)."""
    d = _defaults_from([_add_base_args, _add_test_args])
    d["mode"] = "test"
    d["dis_scale"] = 3
    d["dis_norm"] = None
    d["dis_sn"] = False
    d.update(overrides)
    return d
