"""The port as a package: it imports nothing of JAX, Flax or the JAX
package; it runs on the card unless asked for the CPU; its argument
defaults are the JAX package's; its kernels build into an ignored directory."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from masterthesis_tpu.arguments import default_test_args as jax_test_args
from masterthesis_tpu.arguments import default_train_args as jax_train_args
from masterthesis_tpu_torch import arguments
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

_ISOLATED = r"""
import importlib, pkgutil, sys
# a None entry makes every import of that name (and its submodules) fail;
# 'masterthesis_tpu' is matched exactly: 'masterthesis_tpu_torch' shares its prefix
for name in ("jax", "flax", "msgpack", "masterthesis_tpu"):
    sys.modules[name] = None
import masterthesis_tpu_torch
names = [m.name for m in pkgutil.walk_packages(masterthesis_tpu_torch.__path__,
                                               "masterthesis_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "masterthesis_tpu"))]
assert not bad, bad
print(len(names), "modules")
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    expected = {p for p in (ROOT / "masterthesis_tpu_torch").rglob("*.py")}
    assert int(proc.stdout.split()[0]) == len(expected) - 1  # every module but the root __init__


def test_adain_model_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = arguments.default_test_args(crop_size=32, dim=8, latent_dim=4, num_domains=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdaINModel(args)
    assert AdaINModel(args, device="cpu").device.type == "cpu"


def test_seeded_init_is_deterministic_and_follows_the_scheme():
    args = arguments.default_test_args(crop_size=32, dim=8, latent_dim=4, num_domains=4)
    a = AdaINModel(args, device="cpu")
    b = AdaINModel(args, device="cpu")
    c = AdaINModel(arguments.default_test_args(**{**args, "seed": 1}), device="cpu")
    sa, sb, sc = (m.nets.decoder.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["dec1_0.conv1.conv.weight"], sc["dec1_0.conv1.conv.weight"])
    # init_type "normal": conv kernels N(0, 0.02), conv biases 0, LayerNorm 1/0,
    # linears U(+-1/sqrt(fan_in))
    w = sa["dec1_0.conv1.conv.weight"]
    assert abs(w.std().item() - 0.02) < 2e-3
    assert torch.equal(sa["dec2.up0.conv.bias"], torch.zeros_like(sa["dec2.up0.conv.bias"]))
    assert torch.equal(sa["dec2.up0.norm.scale"], torch.ones_like(sa["dec2.up0.norm.scale"]))
    fc = sa["linear.fc0.weight"]
    assert fc.abs().max().item() <= 1 / fc.shape[1] ** 0.5


@pytest.mark.parametrize("which", ["train", "test"])
def test_argument_defaults_match_the_jax_package(which):
    ours = getattr(arguments, f"default_{which}_args")()
    theirs = {"train": jax_train_args, "test": jax_test_args}[which]()
    assert set(ours) == set(theirs)
    # 'name' defaults to a timestamp in the JAX package
    assert {k: v for k, v in ours.items() if k != "name"} == {
        k: v for k, v in theirs.items() if k != "name"
    }
    assert ours.missing_flag is None


def test_kernel_libraries_build_into_an_ignored_directory():
    lib = build.library_path("moments")
    assert lib.parent == ROOT / "build" / "kernels"
    assert "/build/" in (ROOT / ".gitignore").read_text().split()
    assert lib != build.library_path("adain")
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}
