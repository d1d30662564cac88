"""The argument system: the command-line parsers and their defaults.

The port's own copy of the JAX package's parsers: ``TrainArguments`` /
``TestArguments`` parse a command line (``parse(argv)``), resolve
``--model`` and ``--dataset`` to the port's classes, make the experiment's
directories (``checkpoints``, ``logs``, ``images`` under ``exp_dir/name``)
and write ``args.txt``; ``default_train_args`` / ``default_test_args`` give
the same defaults as plain namespaces, so that a configuration means the
same in both packages. The port reads the model's shape (``dim``,
``latent_dim``, ``num_domains``, ``input_dim``, ``crop_size``), BaseModel's
``concat`` and ``reparam``, ``use_dropout`` (inert at serving, dropout
masks from the step's draws in training; either way it keeps resblocks off
the whole-block kernels, as in the JAX package),
``enc_norm``/``dec_norm``/``up_type``, ``compute_dtype``,
``init_type``/``init_gain`` and ``seed``, and for training the optimizer,
schedule and loss flags, ``use_dis_content``/``d_iter``, the discriminators'
shapes and ``fused_resblock`` ("auto": the whole-block resblock kernels on
the card; "off"; tests also set "on", which routes CPU tensors through the
kernels' plain versions, as the JAX package's tests set "interpret"). Every
flag of the JAX package selects its branch in the port too; the flags that
only the JAX package reads are kept so that one namespace drives either
package. The sample CLI (``sample.py``) reads
the test flags as the JAX sampler does (and, as it, not
``--num_devices``); there, as in training, ``--ckpt_format`` picks the
form of what is written (``checkpoint.py``: ``.ckpt`` files, or ``.orbax``
directories). ``--num_devices`` is the data-parallel trainer's world size
(``train.py``), ``--int8_train`` among its flags.
"""
from __future__ import annotations

import argparse
import os
import subprocess
from datetime import datetime


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
    parser.add_argument("--name", type=str,
                        default=f'{datetime.now().strftime("%Y-%m-%d_%H-%M-%S")}',
                        help="name of the experiment: where its checkpoints and images go")
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


def _resolve_classes(args):
    from masterthesis_tpu_torch import data as data_mod
    from masterthesis_tpu_torch import models as models_mod
    from masterthesis_tpu_torch.utils import module_to_dict

    if isinstance(getattr(args, "dataset", None), str):
        args.dataset = module_to_dict(data_mod)[args.dataset]
    if isinstance(args.model, str):
        args.model = module_to_dict(models_mod)[args.model]
    return args


def _make_exp_dirs(args):
    args.exp_dir = os.path.join(args.exp_dir, args.name)
    args.checkpoint_dir = os.path.join(args.exp_dir, "checkpoints")
    args.logdir = os.path.join(args.exp_dir, "logs")
    args.display_dir = os.path.join(args.exp_dir, "images")
    for d in (args.exp_dir, args.checkpoint_dir, args.logdir, args.display_dir):
        os.makedirs(d, exist_ok=True)
    return args


def _git_revision() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _dump_args(args, path):
    """Print the arguments and append them to ``path``, with the revision."""
    arguments = dict(args)
    arguments["framework_revision"] = _git_revision()
    with open(path, "a") as f:
        print("\n--- Loaded arguments ---")
        for name, value in sorted(arguments.items(), key=lambda kv: kv[0]):
            print("%s: %s" % (str(name), str(value)))
            f.write("%s: %s\n" % (str(name), str(value)))


class Arguments:
    """The base parser."""

    def __init__(self):
        self.parser = argparse.ArgumentParser("Arguments for the program")
        _add_base_args(self.parser)

    def parse(self, argv=None) -> AttributeDict:
        """The parsed flags as an :class:`AttributeDict` (a flag the parser
        lacks reads as None, as the models probe optional ones)."""
        args = AttributeDict(vars(self.parser.parse_args(argv)))
        args = _resolve_classes(args)
        args = _make_exp_dirs(args)
        _dump_args(args, os.path.join(args.exp_dir, "args.txt"))
        return args


class TrainArguments(Arguments):
    """Training: the base flags and the training flags."""

    def __init__(self):
        super().__init__()
        _add_train_args(self.parser)


class TestArguments(Arguments):
    """Sampling: the base flags and the test flags; directories under
    ``--result_dir``."""

    def __init__(self):
        super().__init__()
        _add_test_args(self.parser)

    def parse(self, argv=None) -> AttributeDict:
        args = AttributeDict(vars(self.parser.parse_args(argv)))
        os.makedirs(args.result_dir, exist_ok=True)
        if "image" in args.out_fmt:
            args.display_dir = os.path.join(args.result_dir, "images")
        elif "video" in args.out_fmt:
            args.display_dir = os.path.join(args.result_dir, "videos")
        os.makedirs(args.display_dir, exist_ok=True)
        args.mode = "test"
        args.dis_scale = 3
        args.dis_norm = None
        args.dis_sn = False
        args = _resolve_classes(args)
        _dump_args(args, os.path.join(args.result_dir, "args.txt"))
        return args


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
