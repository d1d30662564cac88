"""Card-only tests of BaseModel serving: kernel 4 (the int8 stride-1 3x3
conv, ``int8_conv.conv3x3``) against its plain PyTorch version, and small
BaseModels (config A, the CLI default; B, ``--concat --reparam``) on the card
against their plain runs and the CPU.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_base_model_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

Given the same input and prologue affine, kernel 4 writes the same int8
operands, int32 sums, dequantized y and exact statistics as the plain
version, so its outputs are compared for equality.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import BaseModel
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import moments as kmoments

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

SMALL = dict(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=2, seed=0)
CONFIGS = {"A": {}, "B": dict(concat=True, reparam=True)}
# int8 launches per forward, as the JAX package routes them, but for B's head
# (kernel 8 with z's per-image term, where the JAX package runs a float conv)
INT8_ROUTES = {
    "A": dict(moments=9, downconv=2, resblock=4, conv3x3=8, deconv=2, head=1),
    "B": dict(moments=1, downconv=2, resblock=8, conv3x3=0, deconv=2, head=1),
}
PLAIN = ((kmoments, "moments", kmoments.moments_plain), (kq, "downconv", kq.conv_plain),
         (kq, "conv3x3", kq.conv_plain), (kq, "deconv", kq.conv_plain),
         (kq, "resblock", kq.resblock_plain), (khead, "head", khead.head_plain))


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


def _pending(b, c, seed, alpha, device):
    return kq.Pending((_randn((b, c), seed).abs() + 0.5).to(device),
                      _randn((b, c), seed + 1, 0.3).to(device), True, alpha)


# (B, C, Co, H, W, padding, prologue alpha or None, with_stats): the flagship
# width, DecoderConcat's 268, and small unaligned widths at odd sizes; then
# the wgmma template's edges: a tail k-slab (Cp 320, 96) with a second and a
# third N tile (R 280, 520), W + 2 above the 128-row M tile, odd B
CONV3X3 = [
    (2, 256, 256, 16, 16, "reflect", None, False),
    (2, 256, 256, 16, 16, "reflect", 0.0, True),
    (1, 268, 268, 9, 11, None, 0.0, True),
    (2, 20, 10, 7, 9, "reflect", 0.01, True),
    (1, 40, 72, 5, 6, None, None, False),
    (3, 300, 280, 6, 140, None, 0.0, True),
    (1, 96, 520, 3, 3, "reflect", None, False),
]


@pytest.mark.parametrize("b,c,co,h,w,padding,alpha,stats", CONV3X3)
def test_conv3x3_kernel_matches_plain(cuda, b, c, co, h, w, padding, alpha, stats):
    qc = kq.quant_conv(_randn((co, c, 3, 3), 1, 0.1), _randn((co,), 2, 0.2), 2.5, 1, padding)
    x = _randn((b, c, h, w), 3, 1.5)
    p = None if alpha is None else _pending(b, c, 4, alpha, "cpu")
    pc = None if p is None else replace(p, scale=p.scale.to(cuda), shift=p.shift.to(cuda))
    # the operands and the int32 sums (unit scales: y holds them exactly)
    xq = kq.quant_pad_cuda(x.to(cuda), _on(qc, cuda), pc)
    assert torch.equal(xq.cpu(), kq.quant_pad_plain(x, qc, p))
    unit = kq.with_unit_scale(qc)
    assert torch.equal(kq.conv_padded_cuda(xq, _on(unit, cuda)).cpu(),
                       kq.conv_padded_plain(xq.cpu(), unit))
    before = kq.conv3x3.launches
    got = kq.conv3x3(x.to(cuda), _on(qc, cuda), pc, with_stats=stats)
    torch.cuda.synchronize()
    assert kq.conv3x3.launches == before + 1
    want = kq.conv3x3(x, qc, p, with_stats=stats)
    for g, r in zip(got if stats else (got,), want if stats else (want,)):
        assert torch.equal(g.cpu(), r)


def test_conv3x3_repeats_bit_for_bit(cuda):
    qc = _on(kq.quant_conv(_randn((268, 268, 3, 3), 5, 0.1), _randn((268,), 6, 0.2), 2.5, 1,
                           None), cuda)
    x = _randn((3, 268, 9, 130), 7, 1.5).to(cuda)
    p = _pending(3, 268, 8, 0.0, cuda)
    first = kq.conv3x3(x, qc, p, with_stats=True)
    again = kq.conv3x3(x, qc, p, with_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_conv3x3_refuses_what_it_cannot_take(cuda):
    qc = _on(kq.quant_conv(_randn((8, 8, 3, 3), 0), None, 1.0, 1, "reflect"), cuda)
    x = _randn((1, 8, 6, 6), 1).to(cuda)
    with pytest.raises(ValueError):
        kq.conv3x3(x.double(), qc)
    with pytest.raises(ValueError):
        kq.conv3x3(x[:, :4].contiguous(), qc)
    with pytest.raises(ValueError):
        kq.conv3x3(x[:, :, :1].contiguous(), qc)  # reflect padding of one row
    with pytest.raises(ValueError, match="stride-1"):
        kq.conv3x3(x, _on(kq.quant_conv(_randn((8, 8, 3, 3), 0), None, 1.0, 2, None), cuda))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
            rng.standard_normal((2, 4)).astype(np.float32),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, 2)])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_small_int8_forward_kernels_match_plain_on_the_card(cuda, monkeypatch, config):
    """The int8 forward through the kernels, with its launches per forward,
    against the same forward through their plain versions on the card: every
    int8 operand and statistic is equal, so only the head sums its 1x1 conv
    in another order."""
    model = BaseModel(default_test_args(**CONFIGS[config], **SMALL))
    img, z, c = _inputs(1)
    model.calibrate_int8([img], [c], [z])
    before = {name: getattr(module, name).launches for module, name, _ in PLAIN}
    out, _, _ = model.forward_random(img, z, c)
    after = {name: getattr(module, name).launches for module, name, _ in PLAIN}
    assert {k: after[k] - before[k] for k in after} == INT8_ROUTES[config]
    for module, name, plain in PLAIN:
        monkeypatch.setattr(module, name, plain)
    ref, _, _ = model.forward_random(img, z, c)
    torch.testing.assert_close(out.cpu(), ref.cpu(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_small_forward_on_the_card_matches_the_cpu(cuda, config):
    """f32 float, and int8 with one amax tree calibrated on the CPU (the path
    the CPU tests hold against the JAX package). cuDNN sums in other orders,
    so float agrees within 1e-4, and a few int8 values can flip: bounded as
    in tests/test_torch_int8.py."""
    args = default_test_args(**CONFIGS[config], **SMALL)
    img, z, c = _inputs(2)
    on_cpu, on_card = BaseModel(args, device="cpu"), BaseModel(args)
    ref, _, _ = on_cpu.forward_random(img, z, c)
    out, _, _ = on_card.forward_random(img, z, c)
    assert (out.cpu() - ref).abs().max() <= 1e-4
    on_card.load_int8(on_cpu.calibrate_int8([img], [c], [z]))
    ref, _, _ = on_cpu.forward_random(img, z, c)
    out, _, _ = on_card.forward_random(img, z, c)
    diff = (out.cpu() - ref).abs()
    assert diff.max() <= 2e-2 and (diff > 1e-4).float().mean() <= 0.05
