"""Card-only tests of the int8 serving kernels: each against its plain
PyTorch version on the same inputs, and the calibrated int8 forward on the
card against the same model on the CPU.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_int8_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

Given the same input and prologue affine, the quantize-and-pad launch writes
the same int8 operands as the plain version, the conv the same int32 sums
(checked with unit scales, where y holds them exactly below 2^24), and so
the same dequantized y. The statistics come from exact integer sums, so
they are equal too, and so is a whole residual block.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import moments as kmoments

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


def _pending(b, c, seed, relu=True, alpha=0.0):
    return {"scale": _randn((b, c), seed).abs() + 0.5, "shift": _randn((b, c), seed + 1, 0.3),
            "relu": relu, "alpha": alpha}


def _to(p, device):
    return None if p is None else {**p, "scale": p["scale"].to(device),
                                   "shift": p["shift"].to(device)}


def _make(kind, c, co, seed, padding="reflect"):
    if kind == "deconv":
        return kq.quant_deconv(_randn((c, co, 3, 3), seed, 0.1), _randn((co,), seed + 1, 0.2), 2.5)
    stride = 2 if kind == "down" else 1
    return kq.quant_conv(_randn((co, c, 3, 3), seed, 0.1), _randn((co,), seed + 1, 0.2), 2.5,
                         stride, padding)


def _on(qc, device):
    return replace(qc, w=qc.w.to(device), scale=qc.scale.to(device),
                   bias=None if qc.bias is None else qc.bias.to(device),
                   inv_sx=qc.inv_sx.to(device))


# (kind, B, C, Co, H, W): the flagship's channel counts at small maps, odd
# sizes and channel counts that are not multiples of 32
CONVS = [
    ("down", 2, 64, 128, 16, 16),
    ("down", 1, 8, 16, 10, 14),
    ("res", 2, 256, 256, 8, 8),
    ("res", 1, 24, 24, 7, 9),
    ("deconv", 2, 256, 128, 8, 8),
    ("deconv", 1, 12, 20, 5, 7),
]


@pytest.mark.parametrize("kind,b,c,co,h,w", CONVS)
@pytest.mark.parametrize("prologue", [False, True])
def test_quant_pad_and_conv_are_exact(cuda, kind, b, c, co, h, w, prologue):
    qc = _make(kind, c, co, seed=1)
    x = _randn((b, c, h, w), 2, 1.5)
    p = _pending(b, c, 3, alpha=0.01) if prologue else None
    ref_q = kq.quant_pad_plain(x, qc, p)
    got_q = kq.quant_pad_cuda(x.to(cuda), _on(qc, cuda), _to(p, cuda))
    assert torch.equal(got_q.cpu(), ref_q)
    unit = kq.with_unit_scale(qc)
    acc = kq.conv_acc_plain(ref_q, unit)
    assert acc.abs().max() < 2**24
    got = kq.conv_padded_cuda(got_q, _on(unit, cuda))
    assert torch.equal(got.cpu(), kq.conv_padded_plain(ref_q, unit))


@pytest.mark.parametrize("kind,b,c,co,h,w", [k for k in CONVS if k[0] != "res"])
def test_conv_wrappers_match_plain(cuda, kind, b, c, co, h, w):
    qc = _make(kind, c, co, seed=4, padding=None)
    x = _randn((b, c, h, w), 5)
    p = _pending(b, c, 6)
    fn = kq.downconv if kind == "down" else kq.deconv
    before = fn.launches
    y, s, sq = fn(x.to(cuda), _on(qc, cuda), _to(p, cuda), with_stats=True)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ry, rs, rsq = fn(x, qc, p, with_stats=True)
    assert torch.equal(y.cpu(), ry)
    assert torch.equal(s.cpu(), rs) and torch.equal(sq.cpu(), rsq)


@pytest.mark.parametrize("style", ["instance", "adain"])
@pytest.mark.parametrize("shape", [(2, 256, 16, 16), (1, 40, 6, 10)])
def test_resblock_kernel_matches_plain(cuda, style, shape):
    b, c, h, w = shape
    q1, q2 = _make("res", c, c, 7), _make("res", c, c, 9)
    x = _randn(shape, 11)
    g = _randn((b, c), 12, 0.3) if style == "adain" else torch.zeros(b, c)
    be = _randn((b, c), 13, 0.3) if style == "adain" else torch.zeros(b, c)
    before = kq.resblock.launches
    y = kq.resblock(x.to(cuda), _on(q1, cuda), _on(q2, cuda), g.to(cuda), be.to(cuda))
    torch.cuda.synchronize()
    assert kq.resblock.launches == before + 1
    # exact statistics give conv2 the same prologue affine, so the same int8
    # operands, and the residual apply is the same three rounded operations
    assert torch.equal(y.cpu(), kq.resblock_plain(x, q1, q2, g, be))


@pytest.mark.parametrize("shape,co,bias", [((2, 64, 32, 32), 3, False), ((1, 10, 5, 7), 5, True)])
def test_head_kernel_matches_plain(cuda, shape, co, bias):
    b, c, h, w = shape
    x = _randn(shape, 14)
    p = _pending(b, c, 15)
    wt = _randn((co, c), 16, 0.2)
    bs = _randn((co,), 17, 0.1) if bias else None
    before = khead.head.launches
    y = khead.head(x.to(cuda), _to(p, cuda), wt.to(cuda), None if bs is None else bs.to(cuda))
    torch.cuda.synchronize()
    assert khead.head.launches == before + 1
    # the 1x1 sum over C in channel order against cuDNN's/the CPU's order
    torch.testing.assert_close(y.cpu(), khead.head_plain(x, p, wt, bs), rtol=0, atol=1e-5)


SMALL = dict(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=2, seed=0)


def test_int8_forward_on_the_card_matches_the_cpu(cuda):
    """One amax tree (calibrated on the CPU) on both devices; the CPU path is
    the one the other tests hold against the JAX package. The float stem
    conv and the style projection sum in other orders on the card, so a few
    int8 values can flip: bounded as in tests/test_torch_int8.py."""
    args = default_test_args(**SMALL)
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((2, 4)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[[0, 2]]
    on_cpu = AdaINModel(args, device="cpu")
    quant = on_cpu.calibrate_int8([img], [c], [z])
    on_card = AdaINModel(args)
    on_card.load_int8(quant)
    counts = [kq.downconv.launches, kq.resblock.launches, kq.deconv.launches, khead.head.launches]
    out, _, _ = on_card.forward_random(img, z, c)
    after = [kq.downconv.launches, kq.resblock.launches, kq.deconv.launches, khead.head.launches]
    assert [a - b for a, b in zip(after, counts)] == [2, 8, 2, 1]
    ref, _, _ = on_cpu.forward_random(img, z, c)
    diff = (out.cpu() - ref).abs()
    assert diff.max() <= 2e-2 and (diff > 1e-4).float().mean() <= 0.05


def test_int8_forward_kernels_match_plain_on_the_card(cuda, monkeypatch):
    """Every int8 operand and statistic is the same through the kernels and
    through their plain versions on the card, so the two forwards differ only
    by the head's 1x1 sum over C, taken in another order."""
    args = default_test_args(**SMALL)
    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((2, 4)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[[1, 3]]
    model = AdaINModel(args)
    model.calibrate_int8([img], [c], [z])
    out, _, _ = model.forward_random(img, z, c)
    for module, name, plain in ((kmoments, "moments", kmoments.moments_plain),
                                (kq, "downconv", kq.conv_plain), (kq, "deconv", kq.conv_plain),
                                (kq, "resblock", kq.resblock_plain),
                                (khead, "head", khead.head_plain)):
        monkeypatch.setattr(module, name, plain)
    ref, _, _ = model.forward_random(img, z, c)
    torch.testing.assert_close(out.cpu(), ref.cpu(), rtol=0, atol=1e-5)


def test_int8_kernels_refuse_what_they_cannot_take(cuda):
    qc = _make("down", 8, 16, 1)
    x = _randn((1, 8, 8, 8), 2).to(cuda)
    with pytest.raises(ValueError):
        kq.downconv(x.double(), _on(qc, cuda))
    with pytest.raises(ValueError):
        kq.downconv(x, qc)  # weights on the CPU
    with pytest.raises(ValueError):
        kq.downconv(x[:, :4].contiguous(), _on(qc, cuda))
    with pytest.raises(NotImplementedError):
        kq.quant_conv(_randn((4, 4, 3, 3), 0), None, 1.0, 2, "replicate")
    with pytest.raises(ValueError):
        khead.head(x, _to(_pending(1, 8, 3), cuda), torch.zeros(9, 8, device=cuda))
