"""Card-only tests of int8 serving at compute dtype bf16 and of the sample
CLI: kernels 4-8 with bf16 activations against their plain versions on the
same inputs, at small shapes and at the sample CLI's 540 x 960 shapes (the
bottleneck of 135 rows), and a tiny ``Sampler`` run on the card with
``--int8 --compute_dtype bfloat16``.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_sample_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

Tolerances: kernels 4-7 give the plain version's bf16 y and statistics
exactly (the same f32 ``acc * scale + bias``, rounded once), and kernel 6
its output (the same affine, rounded, then the sum, rounded); the head sums
its channels in another order, so an output may move by a bf16 step of its
pre-tanh value (``head.BF16_TOL``).
"""
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from masterthesis_tpu_torch import arguments
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.sample import Sampler

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu


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


def _bf16(shape, seed):
    return _randn(shape, seed).to(torch.bfloat16)


def _pending(b, c, seed, alpha=0.0):
    return kq.Pending(_randn((b, c), seed).abs() + 0.5, _randn((b, c), seed + 1, 0.3), True,
                      alpha)


def _to(p, device):
    return None if p is None else replace(p, scale=p.scale.to(device), shift=p.shift.to(device))


def _on(qc, device):
    return replace(qc, w=qc.w.to(device), scale=qc.scale.to(device),
                   bias=None if qc.bias is None else qc.bias.to(device),
                   inv_sx=qc.inv_sx.to(device))


def _make(kind, c, co, seed, amax):
    if kind == "deconv":
        return kq.quant_deconv(_randn((c, co, 3, 3), seed, 0.1), _randn((co,), seed + 1, 0.2), amax)
    return kq.quant_conv(_randn((co, c, 3, 3), seed, 0.1), _randn((co,), seed + 1, 0.2), amax,
                         2 if kind == "down" else 1, "reflect")


WRAPPERS = {"down": "downconv", "conv3x3": "conv3x3", "deconv": "deconv"}
# (kind, B, C, Co, H, W, prologue): small maps with odd sizes and unaligned
# channels, then the sample CLI's 540 x 960 shapes at one image
CONV_CASES = [
    ("down", 3, 40, 24, 21, 29, True), ("conv3x3", 2, 268, 268, 9, 20, True),
    ("conv3x3", 3, 72, 40, 7, 130, False), ("deconv", 2, 64, 48, 7, 80, True),
    ("deconv", 1, 276, 138, 5, 9, False),
    ("down", 1, 128, 256, 270, 480, True), ("conv3x3", 1, 256, 256, 135, 240, True),
    ("deconv", 1, 256, 128, 135, 240, False), ("deconv", 1, 128, 64, 270, 480, True),
]


@pytest.mark.parametrize("kind,b,c,co,h,w,prologue", CONV_CASES)
def test_int8_convs_take_and_give_bf16(cuda, kind, b, c, co, h, w, prologue):
    x = _bf16((b, c, h, w), 10)
    p = _pending(b, c, 20, 0.01 if kind == "down" else 0.0) if prologue else None
    qc = _make(kind, c, co, 30, kq.prologue_plain(x, p).abs().amax())
    want = kq.conv_plain(x, qc, p, True)
    xq = kq.quant_pad_cuda(x.to(cuda), _on(qc, cuda), _to(p, cuda))
    assert torch.equal(xq.cpu(), kq.quant_pad_plain(x, qc, p))
    got = getattr(kq, WRAPPERS[kind])(x.to(cuda), _on(qc, cuda), _to(p, cuda), with_stats=True)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16 and got[0].shape == want[0].shape
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)


@pytest.mark.parametrize("b,c,h,w", [(2, 268, 9, 20), (3, 40, 7, 130), (1, 256, 135, 240)])
def test_int8_resblock_takes_and_gives_bf16(cuda, b, c, h, w):
    x = _bf16((b, c, h, w), 40)
    q1 = kq.quant_conv(_randn((c, c, 3, 3), 41, 0.06), None, x.float().abs().amax(), 1, "reflect")
    q2 = kq.quant_conv(_randn((c, c, 3, 3), 42, 0.06), None, 4.0, 1, "reflect")
    gamma, beta = _randn((b, c), 43, 0.3), _randn((b, c), 44, 0.3)
    want = kq.resblock_plain(x, q1, q2, gamma, beta)
    got = kq.resblock(x.to(cuda), _on(q1, cuda), _on(q2, cuda), gamma.to(cuda), beta.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,c,h,w,bias", [(2, 24, 7, 9, True), (1, 64, 540, 960, False)])
def test_head_takes_and_gives_bf16(cuda, b, c, h, w, bias):
    x = _bf16((b, c, h, w), 50)
    p = _pending(b, c, 51)
    weight = _randn((3, c), 52, 0.1)
    bb = _randn((3,), 53, 0.2) if bias else None
    want = khead.head_plain(x, p, weight, bb)
    got = khead.head(x.to(cuda), _to(p, cuda), weight.to(cuda), None if bb is None else bb.to(cuda))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert (got.cpu().float() - want.float()).abs().max().item() <= khead.BF16_TOL


def test_a_tiny_sampler_serves_int8_in_bf16_on_the_card(cuda, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    data = tmp_path / "imgs"
    data.mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)).save(data / f"{i}.jpg")
    args = arguments.TestArguments().parse([
        "--dataroot", str(data), "--model", "AdaINModel", "--dim", "8", "--latent_dim", "4",
        "--num_domains", "4", "--batch_size", "2", "--num_workers", "0", "--sample_size", "36",
        "52", "--compute_dtype", "bfloat16", "--int8", "--targets", "fog", "sun",
        "--result_dir", str(tmp_path / "out")])
    sampler = Sampler()
    kq.downconv.launches = kq.resblock.launches = kq.deconv.launches = khead.head.launches = 0
    model = sampler.run(args)
    assert model.quant is not None and model.device.type == "cuda"
    assert sampler.translated == 8
    # per forward: 2 down convs, 8 resblocks, 2 transposed convs, 1 head
    assert (kq.downconv.launches, kq.resblock.launches, kq.deconv.launches,
            khead.head.launches) == (8, 32, 8, 4)
    names = sorted(os.path.relpath(os.path.join(d, f), args.display_dir)
                   for d, _, fs in os.walk(args.display_dir) for f in fs)
    assert names == sorted(os.path.join(str(t), f"image{k}_{i}_{j}.jpg")
                           for k, t in enumerate((1, 3)) for i in range(2) for j in range(2))
    with Image.open(os.path.join(args.display_dir, names[0])) as im:
        assert im.size == (52, 36)
