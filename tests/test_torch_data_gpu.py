"""Card-only tests of the data tier and the train CLI.

- The device preprocess on the card equals the CPU's bit for bit, given
  the same uint8 images and crop parameters (one gather, then the same f32
  multiply and subtract).
- A tiny trainer run on the card (``Trainer()``, the card by default) with
  content steps, spectral norm and ``--device_preproc``: its checkpoints
  load back bit for bit (params, spectral ``u``, Adam state, step), and a
  run resumed from them (``--resume``, ``--resume_opt``, ``--last_iter``)
  repeats the unbroken run's iterations: the same draws from (seed,
  iteration), the same batches; losses within 1e-5 relative.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_data_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from masterthesis_tpu_torch import checkpoint as ckpt
from masterthesis_tpu_torch import data, models
from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.data.device_preproc import preprocess, sample_crop_params
from masterthesis_tpu_torch.train import Trainer

pytestmark = pytest.mark.gpu

TINY = dict(crop_size=32, load_size=36, dim=8, latent_dim=4, num_domains=4, batch_size=2,
            dis_content_layers=1, dis_content_final_kernel=2, logdir=None, seed=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_device_preprocess_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (8, 286, 286, 3), dtype=np.uint8))
    params = sample_crop_params(torch.Generator(device=cuda).manual_seed(1), 8, 286, 256)
    assert params["tops"].is_cuda and params["flips"].any() and not params["flips"].all()
    got = preprocess(imgs.to(cuda), params, 256)
    want = preprocess(imgs, {k: v.cpu() for k, v in params.items()}, 256)
    assert got.is_cuda and got.shape == (8, 256, 256, 3)
    assert torch.equal(got.cpu(), want)


def _tree(root):
    rng = np.random.default_rng(1)
    for name in ("cloud", "fog", "rain", "sun"):
        d = os.path.join(root, "train", name)
        os.makedirs(d)
        for i in range(3):
            arr = rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img{i}.jpg"))


class _Recording(Trainer):
    """The trainer with each iteration's losses kept (device tensors)."""

    def create_model(self, args):
        model = super().create_model(args)
        self.losses, step = {}, model.optimize_parameters

        def recorded(batch, it, draws=None):
            logs = step(batch, it, draws)
            self.losses[it] = {k: v.detach().clone() for k, v in logs.items()
                               if isinstance(v, torch.Tensor)}
            return logs

        model.optimize_parameters = recorded
        return model


def _dirs(root, name):
    out = dict(checkpoint_dir=os.path.join(root, name, "ckpt"),
               display_dir=os.path.join(root, name, "images"))
    for d in out.values():
        os.makedirs(d)
    return out


def test_tiny_trainer_on_the_card_saves_and_resumes(cuda, tmp_path):
    _tree(tmp_path / "data")
    base = dict(TINY, dataroot=str(tmp_path / "data"), dataset=data.PairedDataset,
                model=models.AdaINModel, use_dis_content=True, d_iter=2, dis_sn=True,
                gan_step="fused", fused_resblock="auto", device_preproc=True, shuffle=True,
                num_workers=1, print_freq=100, save_freq=2, display_freq=2)
    unbroken = _Recording()
    args = default_train_args(**base, n_iters=5, max_iter=5, **_dirs(tmp_path, "a"))
    model = unbroken.run(args)
    assert model.device.type == "cuda" and model.state.step == 6
    files = set(os.listdir(args.checkpoint_dir))
    assert {f"{k}_{i}.ckpt" for k in ("model", "opt") for i in (0, 2, 4, 6)} == files
    assert set(os.listdir(args.display_dir)) == {"gen_0.jpg", "gen_2.jpg", "gen_4.jpg"}

    saved = os.path.join(args.checkpoint_dir, "model_2.ckpt"), os.path.join(
        args.checkpoint_dir, "opt_2.ckpt")
    resumed = _Recording()
    rargs = default_train_args(**base, n_iters=5, max_iter=5, last_iter=2, resume=saved[0],
                               resume_opt=saved[1], **_dirs(tmp_path, "b"))
    loader = resumed.load_dataset(rargs)
    restored = resumed.create_model(rargs)
    params, opt = ckpt.load_pytree(saved[0]), ckpt.load_pytree(saved[1])
    assert restored.state.step == opt["step"] == 3
    for n, net in restored.nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(v.cpu(), params["params"][n][k]), (n, k)
        s = restored.state.opt_state[n]
        assert s.count == opt["opt_state"][n]["count"]
        for mine, theirs in zip(s.mu + s.nu, opt["opt_state"][n]["mu"] + opt["opt_state"][n]["nu"]):
            assert torch.equal(mine.cpu(), theirs), n
    assert any(k.endswith("sn.u") for k in params["params"]["discriminator1"])
    resumed.train(rargs, restored, loader)
    assert sorted(resumed.losses) == [3, 4, 5]
    for it, logs in resumed.losses.items():
        want = unbroken.losses[it]
        assert set(logs) == set(want)
        for k, v in want.items():
            v, g = float(v), float(logs[k])
            assert abs(g - v) <= 1e-5 * max(abs(v), 1e-2), (it, k, g, v)
