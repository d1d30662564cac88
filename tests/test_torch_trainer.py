"""The port's train CLI against the JAX package's ``Trainer``.

- The trainer cases of ``tests/test_cli_integration.py`` (the reference and
  the fused GAN step) and ``tests/test_device_preproc.py`` (uint8 batches
  preprocessed on the device), on the same tiny args and image tree: the
  port's final step, its last iteration's loss keys, the files it writes
  (``model_{it}.ckpt``, ``opt_{it}.ckpt``, ``gen_{it}.jpg``) and its log's
  cadence lines (iterations with their lrs, checkpoints, grids) equal what
  the JAX package's ``Trainer`` gives. Losses differ: the draws do.
- Resume: 4 unbroken iterations against 2 and a resume of 2 from their
  checkpoints (``--resume``, ``--resume_opt``, ``--last_iter``), with
  content steps, spectral norm and a shuffled loader: bit-equal params,
  spectral ``u``, Adam state and step on the CPU, on the host route and
  under ``--device_preproc``.
- ``compute_visuals`` against the JAX package's, from the same params and
  draws, in f32 within ``tests/test_torch_model.py``'s float tolerance (1e-4
  of the largest magnitude), for AdaINModel and BaseModel A.
- ``TrainArguments().parse`` resolves the port's classes and makes the
  experiment's directories; ``Trainer()`` without a card raises.

The JAX models initialize with each net's init compiled
(``torch_jax_init.compiled_jax_init``): no check here reads the JAX init's
values (the visuals take the one perturbed tree into both packages).
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu import data as jdata
from masterthesis_tpu import models as jmodels
from masterthesis_tpu.arguments import default_test_args as jax_test_args
from masterthesis_tpu.train import Trainer as JaxTrainer
from masterthesis_tpu_torch import checkpoint as ckpt
from masterthesis_tpu_torch import data, models
from masterthesis_tpu_torch.arguments import TrainArguments, default_test_args, default_train_args
from masterthesis_tpu_torch.tools.convert_jax import params_from_jax
from masterthesis_tpu_torch.train import Trainer
from tests.torch_jax_init import compiled_jax_init

from conftest import make_image_tree, tiny_train_args

torch.set_num_threads(2)

TOL = 1e-4  # tests/test_torch_model.py's f32 bound, of max(1, max |reference|)
TINY = dict(crop_size=32, load_size=36, dim=8, latent_dim=4, num_domains=4, batch_size=2,
            logdir=None, dis_content_layers=1, dis_content_final_kernel=2)
# the JAX package's trainer tests, by name: their arguments
CASES = {
    "reference": dict(use_dis_content=True, n_iters=2, max_iter=2, print_freq=1, save_freq=2,
                      display_freq=3),
    "fused": dict(use_dis_content=True, gan_step="fused", d_iter=1, n_iters=2, max_iter=2,
                  print_freq=1, save_freq=2, display_freq=3),
    "device_preproc": dict(device_preproc=True, use_dis_content=False, n_iters=1, max_iter=1,
                           print_freq=10, save_freq=10, display_freq=10),
}
CADENCE = re.compile(r"(iter \d+ \| lr .*|.*checkpoint ->|image grid ->|training complete|Running for .*)")


def _dirs(root, name) -> dict:
    out = dict(checkpoint_dir=str(root / name / "ckpt"), display_dir=str(root / name / "images"))
    for d in out.values():
        os.makedirs(d)
    return out


def _cadence(text: str, root) -> list:
    lines = [line.split("] ", 1)[-1].strip().replace(str(root), "") for line in text.splitlines()]
    return [line for line in lines if CADENCE.fullmatch(line)]


def _files(args) -> tuple:
    return sorted(os.listdir(args.checkpoint_dir)), sorted(os.listdir(args.display_dir))


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_the_jax_trainer(tmp_path, capsys, case):
    make_image_tree(tmp_path / "data", num_domains=4, per_domain=2)
    flags = dict(dataroot=str(tmp_path / "data"), num_workers=0, shuffle=False, resume=None,
                 resume_opt=None, **CASES[case])
    jargs = tiny_train_args(dataset=jdata.PairedDataset, model=jmodels.AdaINModel, **flags,
                            **_dirs(tmp_path, "jax"))
    trainer = JaxTrainer()
    loader = trainer.load_dataset(jargs)
    with compiled_jax_init():
        jmodel, state = trainer.create_model(jargs)
    state = trainer.train(jargs, jmodel, state, loader, mesh=None)
    want = capsys.readouterr().out

    args = default_train_args(**{**TINY, **flags}, dataset=data.PairedDataset,
                              model=models.AdaINModel, **_dirs(tmp_path, "port"))
    model = Trainer(device="cpu").run(args)
    got = capsys.readouterr().out
    assert model.state.step == int(state.step)
    assert set(model.loss) == set(jmodel.loss)
    assert _files(args) == _files(jargs)
    assert _cadence(got, tmp_path / "port") == _cadence(want, tmp_path / "jax")
    assert _cadence(got, tmp_path / "port"), got


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}{i}/")
    else:
        yield prefix, tree


def _same_files(a: str, b: str) -> None:
    ta, tb = dict(_tensors(ckpt.load_pytree(a))), dict(_tensors(ckpt.load_pytree(b)))
    assert set(ta) == set(tb)
    for k, v in ta.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, tb[k]), (a, k)
        else:
            assert v == tb[k], (a, k)


@pytest.mark.parametrize("device_preproc", [False, True])
def test_resume_repeats_the_unbroken_run(tmp_path, device_preproc):
    make_image_tree(tmp_path / "data", num_domains=4, per_domain=3)
    base = dict(TINY, dataroot=str(tmp_path / "data"), dataset=data.PairedDataset,
                model=models.AdaINModel, use_dis_content=True, d_iter=2, dis_sn=True,
                gan_step="fused", shuffle=True, num_workers=1, device_preproc=device_preproc,
                print_freq=100, save_freq=100, display_freq=100)
    unbroken = default_train_args(**base, n_iters=3, max_iter=3, **_dirs(tmp_path, "a"))
    Trainer(device="cpu").run(unbroken)
    first = default_train_args(**base, n_iters=1, max_iter=1, **_dirs(tmp_path, "b"))
    Trainer(device="cpu").run(first)
    saved = first.checkpoint_dir
    resumed = default_train_args(**base, n_iters=3, max_iter=3, last_iter=1,
                                 resume=os.path.join(saved, "model_2.ckpt"),
                                 resume_opt=os.path.join(saved, "opt_2.ckpt"),
                                 **_dirs(tmp_path, "c"))
    model = Trainer(device="cpu").run(resumed)
    assert model.state.step == 4
    for name in ("model_4.ckpt", "opt_4.ckpt"):
        _same_files(os.path.join(unbroken.checkpoint_dir, name),
                    os.path.join(resumed.checkpoint_dir, name))
    u = [k for k in model.nets.discriminator1.state_dict() if k.endswith("sn.u")]
    assert u, "spectral norm's u is in the checkpoint"


# ------------------------------------------------------------- visuals --


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "bias":
            out[k] = (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


VISUAL_MODELS = {
    "AdaINModel": (jmodels.AdaINModel, models.AdaINModel, {}),
    "BaseModel_A": (jmodels.BaseModel, models.BaseModel, {}),
}


@pytest.mark.parametrize("name", list(VISUAL_MODELS))
def test_compute_visuals_matches_jax(name):
    jcls, cls, flags = VISUAL_MODELS[name]
    shape = dict(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=2, **flags)
    jm = jcls(jax_test_args(**shape))
    with compiled_jax_init():
        state = jm.initialize()
    tree = _perturb(jax.tree_util.tree_map(np.asarray, state.params),
                    np.random.default_rng(0))
    tm = cls(default_test_args(**shape), device="cpu")
    tm.load_params(params_from_jax(tree, tm))
    rng = np.random.default_rng(1)
    y = np.eye(4, dtype=np.float32)
    batch = dict(x1=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                 x2=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32), y1=y[[0, 1]], y2=y[[2, 3]])
    key = jax.random.PRNGKey(7)
    want = np.asarray(jm.compute_visuals(tree, batch, key))
    # the JAX forward's draws: the style eps from k1 over both halves
    # (recovered as (z - mu) / exp(logvar / 2)), z_sr from k2
    k1, k2 = jax.random.split(key)
    img = np.concatenate([batch["x1"], batch["x2"]])
    c = np.concatenate([batch["y1"], batch["y2"]])
    eps = None
    if tm.reparam:
        z, mu, logvar = jm.encode_style(tree, img, c, k1, sample=True)
        eps = (np.asarray(z) - np.asarray(mu)) / np.exp(0.5 * np.asarray(logvar))
    z_sr = np.array(jm.get_z_random(k2, 2))
    got = tm.compute_visuals(batch, eps=eps, z_sr=z_sr)
    assert got.shape == want.shape == (64, 128, 3)
    assert np.abs(want).max() > 0.3, "outputs must span the tanh range to test anything"
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))
    # without draws: from the generator, reproducibly
    a = tm.compute_visuals(batch, torch.Generator().manual_seed(3))
    b = tm.compute_visuals(batch, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_train_arguments_parse_and_dirs(tmp_path):
    args = TrainArguments().parse([
        "--dataroot", str(tmp_path / "data"), "--exp_dir", str(tmp_path / "exps"),
        "--name", "exp1", "--model", "AdaINModel", "--dataset", "PairedDataset",
        "--batch_size", "2", "--num_domains", "4",
    ])
    assert args.model is models.AdaINModel and args.dataset is data.PairedDataset
    for d in (args.checkpoint_dir, args.logdir, args.display_dir):
        assert os.path.isdir(d)
    assert os.path.exists(os.path.join(args.exp_dir, "args.txt"))
    assert isinstance(args.beta2, float) and args.dis_n_layers is None


def test_trainer_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer()
    assert Trainer(device="cpu").device.type == "cpu"
    # one process is a world of one: --num_devices 2 names both numbers
    args = default_train_args(**TINY, model=models.AdaINModel, num_devices=2)
    with pytest.raises(ValueError, match="--num_devices 2 must equal the world size 1"):
        Trainer(device="cpu").create_model(args)
    # --int8_train trains (its data-parallel form raises, tests/test_torch_train.py)
    model = Trainer(device="cpu").create_model(default_train_args(**TINY, model=models.AdaINModel,
                                                                  int8_train=True))
    assert model._qat_scope == {"conv", "stride2", "deconv"}
