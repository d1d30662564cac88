"""Card-only tests of the rest of the model surface: kernel 4 (the int8
stride-1 3x3 conv) at the widths the nearest and pixelshuffle up blocks give
it, against its plain version; small models with those up types and batch
norm on the card against their plain runs and the CPU; ``devtime.measure``.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_surface_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

Kernel 4 writes the same int8 operands, int32 sums and dequantized y as its
plain version, at f32 and at bf16 compute, so its outputs are compared for
equality. A whole int8 forward through the kernels agrees with the same
forward through the plain versions within 1e-5 (f32) or 2^-7 (bf16): a
float op between them (the 7x7 head, a norm) may sum in another order.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import AdaINModel, BaseModel
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import moments as kmoments
from masterthesis_tpu_torch.utils import devtime

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

SMALL = dict(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=2, seed=0)
MODELS = {"AdaIN": (AdaINModel, {}), "A": (BaseModel, {}),
          "B": (BaseModel, dict(concat=True, reparam=True))}
# int8 launches per forward with a nearest or pixelshuffle tail, as the JAX
# package routes them (tests/test_torch_surface_models.py counts its calls)
ROUTES = {
    "AdaIN": dict(moments=3, downconv=2, resblock=8, conv3x3=2, deconv=0, head=0),
    "A": dict(moments=11, downconv=2, resblock=4, conv3x3=10, deconv=0, head=0),
    "B": dict(moments=3, downconv=2, resblock=8, conv3x3=2, deconv=0, head=0),
}
PLAIN = ((kmoments, "moments", kmoments.moments_plain), (kq, "downconv", kq.conv_plain),
         (kq, "conv3x3", kq.conv_plain), (kq, "deconv", kq.conv_plain),
         (kq, "resblock", kq.resblock_plain), (khead, "head", khead.head_plain))
# (C, Co) of the up convs at full width: AdaINModel nearest, pixelshuffle;
# BaseModel B (--concat --reparam) nearest, pixelshuffle
UP_WIDTHS = [(256, 128), (128, 64), (256, 512), (128, 256),
             (276, 138), (146, 73), (276, 552), (146, 292)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _on(qc, device):
    return replace(qc, w=qc.w.to(device), scale=qc.scale.to(device),
                   bias=None if qc.bias is None else qc.bias.to(device),
                   inv_sx=qc.inv_sx.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co", UP_WIDTHS)
def test_kernel_4_at_the_up_convs_widths_matches_plain(cuda, c, co, dtype):
    """Zero padding, bias, no prologue, no statistics, as the up blocks call
    it; a small batch and map (the widths are what is new)."""
    qc = kq.quant_conv(_randn((co, c, 3, 3), 1, 0.05), _randn((co,), 2, 0.2), 3.0, 1, None)
    x = _randn((2, c, 12, 20), 3, 1.5).to(dtype)
    before = kq.conv3x3.launches
    got = kq.conv3x3(x.to(cuda), _on(qc, cuda))
    torch.cuda.synchronize()
    assert kq.conv3x3.launches == before + 1
    want = kq.conv3x3(x, qc)
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), want)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
            rng.standard_normal((2, 4)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, 2)])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("up_type", ["nearest", "pixelshuffle"])
@pytest.mark.parametrize("model", list(MODELS))
def test_small_int8_forward_kernels_match_plain_on_the_card(cuda, monkeypatch, model, up_type,
                                                            compute):
    cls, flags = MODELS[model]
    net = cls(default_test_args(up_type=up_type, compute_dtype=compute, **flags, **SMALL))
    img, z, c = _inputs(1)
    net.calibrate_int8([img], [c], [z])
    before = {name: getattr(module, name).launches for module, name, _ in PLAIN}
    out, _, _ = net.forward_random(img, z, c)
    after = {name: getattr(module, name).launches for module, name, _ in PLAIN}
    assert {k: after[k] - before[k] for k in after} == ROUTES[model]
    for module, name, plain in PLAIN:
        monkeypatch.setattr(module, name, plain)
    ref, _, _ = net.forward_random(img, z, c)
    tol = 1e-5 if compute == "float32" else 2.0 ** -7
    torch.testing.assert_close(out.float().cpu(), ref.float().cpu(), rtol=0, atol=tol)


@pytest.mark.parametrize("model", list(MODELS))
def test_batch_norm_and_a_nearest_tail_on_the_card_match_the_cpu(cuda, model):
    """f32 float: cuDNN sums in other orders, so within 1e-4."""
    cls, flags = MODELS[model]
    args = default_test_args(enc_norm="batch", dec_norm="batch", up_type="nearest",
                             init_type="kaiming", **flags, **SMALL)
    img, z, c = _inputs(2)
    ref, _, _ = cls(args, device="cpu").forward_random(img, z, c)
    out, _, _ = cls(args).forward_random(img, z, c)
    assert ref.abs().max() > 0.05
    assert (out.cpu() - ref).abs().max() <= 1e-4


def test_devtime_measures_kernels_on_the_card(cuda):
    a = torch.randn(512, 512, device=cuda)
    medians, kernels = devtime.measure({"mm": lambda: a @ a}, iters=3)
    assert medians["mm"] > 0
    assert kernels["mm"] and all(v > 0 for v in kernels["mm"].values())
