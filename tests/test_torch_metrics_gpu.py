"""Card-only tests of the metrics and the evaluate CLI: InceptionV3 and LPIPS
on the card against the CPU on the same weights, a small ``evaluate`` on
the card against the CPU (the same model weights, metric weights and style
codes), the kernels' launches per evaluate run, and ``python -m
masterthesis_tpu_torch.evaluate`` on the card.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_metrics_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import). TF32 is off, so the card's
f32 convs are full f32.

Tolerances: the 2048-d features within 1e-4 of their mean magnitude, LPIPS
distances within 1e-4 relative (f32 convs summed in another order, ~95 deep
for the Inception); the small evaluate's pixel FID and LPIPS diversity
within 1e-3 relative (the model's f32 outputs within 1e-4 of the CPU's,
``chip_smoke.py``'s bound).
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.evaluate import Evaluator
from masterthesis_tpu_torch.metrics.inception import InceptionV3
from masterthesis_tpu_torch.metrics.lpips import LPIPS
from masterthesis_tpu_torch.metrics.metrics import load_flat_params
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import moments as kmoments

torch.set_num_threads(2)

pytestmark = [pytest.mark.gpu, pytest.mark.filterwarnings("ignore:.*RANDOM weights")]

SMALL = dict(num_domains=2, latent_dim=4, dim=8, crop_size=32, load_size=36, seed=0)
PER_DOMAIN = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flat_weights(module, seed):
    """Random weights for ``module`` as the metric npz holds them (HWIO
    kernels): He-scaled kernels, batch-norm statistics off identity."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, p in module.state_dict().items():
        path, leaf = name.replace(".", "/"), name.split(".")[-1]
        if leaf == "weight" and p.dim() == 4:
            o, i, kh, kw = p.shape
            flat[path[:-len("weight")] + "kernel"] = rng.standard_normal((kh, kw, i, o)) * np.sqrt(
                2.0 / (kh * kw * i))
        elif leaf in ("bn_scale", "bn_var"):
            flat[path] = rng.uniform(0.8, 1.2, p.shape)
        elif leaf.startswith("lin"):
            flat[path] = rng.uniform(0.0, 1.0, p.shape)
        else:
            flat[path] = rng.normal(0.0, 0.05, p.shape)
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


def _pair(cls, seed, device):
    flat = _flat_weights(cls(), seed)
    nets = []
    for dev in ("cpu", device):
        m = cls()
        load_flat_params(m, flat)
        nets.append(m.to(dev).eval())
    return nets


@pytest.mark.parametrize("size,resize", [(256, True), (299, False)])
def test_inception_on_the_card_matches_the_cpu(cuda, size, resize):
    on_cpu, on_card = _pair(lambda: InceptionV3(resize_input=resize), 1, cuda)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (4, size, size, 3)).astype(
        np.float32))
    with torch.no_grad():
        want = on_cpu(x)
        got = on_card(x.to(cuda)).cpu()
    assert got.shape == (4, 2048)
    assert (got - want).abs().max() <= 1e-4 * want.abs().mean()


def test_lpips_on_the_card_matches_the_cpu(cuda):
    on_cpu, on_card = _pair(LPIPS, 3, cuda)
    rng = np.random.default_rng(4)
    x, y = (torch.from_numpy(rng.uniform(-1, 1, (8, 256, 256, 3)).astype(np.float32))
            for _ in range(2))
    with torch.no_grad():
        want = on_cpu(x, y)
        got = on_card(x.to(cuda), y.to(cuda)).cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _tree(root, per_domain=PER_DOMAIN):
    rng = np.random.default_rng(5)
    for d, base in (("cloud", 90), ("fog", 150)):
        os.makedirs(root / "val" / d)
        for i in range(per_domain):
            arr = np.clip(rng.normal(base, 40, (40, 40, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(root / "val" / d / f"img{i:02d}.jpg")
    return str(root)


class _Codes:
    """The same seeded style codes on any device."""

    def __init__(self, n, device):
        rng = np.random.default_rng(6)
        self.codes = iter(torch.from_numpy(rng.standard_normal((8, SMALL["latent_dim"])).astype(
            np.float32)).to(device) for _ in range(n))

    def __call__(self, n, generator=None):
        return next(self.codes)[:n]


def _evaluate(device, dataroot, **flags):
    args = default_test_args(**SMALL, dataroot=dataroot, mode="val", **flags)
    model = AdaINModel(args, device=device)  # the seeded init, the same on both devices
    model.get_z_random = _Codes(2 * PER_DOMAIN // 8 * 2, device)
    ev = Evaluator(device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ev.evaluate(args, model), ev


def test_small_evaluate_on_the_card_matches_the_cpu(cuda, tmp_path):
    data = _tree(tmp_path)
    want, ev_cpu = _evaluate("cpu", data, fid_extractor="pixel")
    got, ev_card = _evaluate(cuda, data, fid_extractor="pixel")
    assert set(got) == set(want) == {"cloud", "fog"}
    for d in want:
        for key in ("fid", "lpips_diversity"):
            assert abs(got[d][key] - want[d][key]) <= 1e-3 * abs(want[d][key]), (d, key)
        a, b = ev_card.fids[d].accumulators(), ev_cpu.fids[d].accumulators()
        for k in ("train_total", "test_total"):
            assert np.abs(a[k] - b[k]).max() <= 1e-4 * np.abs(b[k]).max(), (d, k)


def test_evaluate_launches_per_forward(cuda, tmp_path):
    """Every forward of an evaluate run launches the float path's 13
    moments and 8 AdaIN kernels; the metric nets launch none."""
    data = _tree(tmp_path)
    kmoments.moments.launches = kadain.adain.launches = 0
    _evaluate(cuda, data, fid_features=8)
    forwards = 2 * (PER_DOMAIN // 8) * 2
    assert kmoments.moments.launches == 13 * forwards
    assert kadain.adain.launches == 8 * forwards


def test_evaluate_module_runs_on_the_card(cuda, tmp_path):
    """``python -m masterthesis_tpu_torch.evaluate`` prints a FID and an LPIPS
    diversity per domain (a seeded model checkpoint, pixel FID)."""
    data = _tree(tmp_path)
    ckdir = tmp_path / "ckpt"
    from masterthesis_tpu_torch.arguments import default_train_args

    AdaINModel(default_train_args(**SMALL, checkpoint_dir=str(ckdir), logdir=None)).save(0)
    small = [a for k, v in SMALL.items() for a in (f"--{k}", str(v))]
    out = subprocess.run(
        [sys.executable, "-m", "masterthesis_tpu_torch.evaluate", "--dataroot", data,
         "--model", "AdaINModel", "--resume", str(ckdir / "model_0.ckpt"),
         "--result_dir", str(tmp_path / "out"), "--fid_extractor", "pixel", *small],
        capture_output=True, text=True, timeout=300, check=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for d in ("cloud", "fog"):
        line = next(x for x in out.stdout.splitlines() if f"{d}: FID=" in x)
        fid, div = (float(v) for v in
                    line.split("FID=")[1].replace("LPIPS-diversity=", "").split())
        assert np.isfinite(fid) and fid > 0 and np.isfinite(div) and div > 0
