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
import math
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
    return kq.Pending(_randn((b, c), seed).abs() + 0.5, _randn((b, c), seed + 1, 0.3), relu,
                      alpha)


def _to(p, device):
    return None if p is None else replace(p, scale=p.scale.to(device), shift=p.shift.to(device))


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
# sizes and channel counts that are not multiples of 32; for the stride-1
# conv also a 32-channel tail k-slab (Cp 288), a second N tile (R 268, 300),
# W + 2 above its 128-row M tile, Ho x Wp off that tile, odd B; for the
# stride-2 conv Wo above its 128-column box, Wo = 80 (a 128-column box with
# 80 columns inside, TMA stores), Wo = 5 (boxes of 4 x 32 pixels, and y's
# rows too narrow for TMA stores) with odd B, and odd H and W (the padded
# input rounded up to an even size); the transposed conv at DecoderConcat's
# widths, 276 -> 138 (Cp 288, R 552: a 40-row tail N tile) and 146 -> 73
# (Cp 160, R 292), and at W = 80 (a 128-column box, 160 output columns)
CONVS = [
    ("down", 2, 64, 128, 16, 16),
    ("down", 1, 8, 16, 10, 14),
    ("down", 1, 24, 40, 4, 260),
    ("down", 1, 24, 40, 6, 160),
    ("down", 3, 40, 24, 60, 10),
    ("down", 1, 24, 16, 9, 11),
    ("res", 2, 256, 256, 8, 8),
    ("res", 1, 24, 24, 7, 9),
    ("res", 3, 268, 268, 5, 130),
    ("res", 1, 300, 300, 4, 6),
    ("deconv", 2, 256, 128, 8, 8),
    ("deconv", 1, 12, 20, 5, 7),
    ("deconv", 1, 276, 138, 4, 5),
    ("deconv", 2, 146, 73, 6, 3),
    ("deconv", 1, 16, 12, 3, 80),
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


def test_stat_tiles_follow_each_route(cuda):
    """The library sizes the partials per route: the stride-1 convs over the
    padded width in tiles of 128 rows (``M_TILE`` of
    ``tests/test_torch_int8_tiling.py``), the stride-2 and transposed convs
    in boxes of by output rows x bx columns (its ``box_tile``: bx = 32, 64
    or 128, the least that holds Wo, or 128; by = min(128 // bx, Ho)); and
    it splits the N tiles into launches as ``conv_launches`` says (256 wide
    for the stride-1 convs, ``BOX_NW`` = 128 for the others, then a tail)."""
    conv = kq.quant_conv(torch.ones(8, 8, 3, 3), None, 1.0, 1, "reflect")
    down = kq.quant_conv(torch.ones(8, 8, 3, 3), None, 1.0, 2, "reflect")
    deconv = kq.quant_deconv(torch.ones(8, 8, 3, 3), None, 1.0)
    assert kq.conv_tiling(conv, 66, 66) == (math.ceil(64 * 66 / 128), 128) == (33, 128)
    assert kq.conv_tiling(conv, 3, 142) == (2, 128)
    assert kq.conv_tiling(down, 258, 258) == (128, 128)  # down0: one output row of 128
    assert kq.conv_tiling(down, 130, 130) == (32, 128)  # down1: two rows of 64
    assert kq.conv_tiling(down, 12, 262) == (5 * 2, 128)  # Wo 130: two spans a row
    assert kq.conv_tiling(down, 62, 12) == (math.ceil(30 / 4), 128)  # Wo 5: boxes of 4 x 32
    assert kq.conv_tiling(down, 8, 162) == (3, 128)  # Wo 80: one row of a 128-column box
    assert kq.conv_tiling(deconv, 4, 81) == (3, 128)  # W 80: the same
    assert kq.conv_tiling(deconv, 5, 41) == (2, 128)  # W 40: boxes of 2 x 64
    assert kq.conv_tiling(deconv, 65, 65) == (32, 128)  # up0: two rows of 64
    assert kq.conv_tiling(deconv, 129, 129) == (128, 128)  # up1: one row of 128
    wide = kq.quant_conv(torch.ones(268, 8, 3, 3), None, 1.0, 1, "reflect")
    down300 = kq.quant_conv(torch.ones(300, 8, 3, 3), None, 1.0, 2, "reflect")
    deconv138 = kq.quant_deconv(torch.ones(8, 138, 3, 3), None, 1.0)
    assert kq.conv_launches(conv) == (8,) and kq.conv_launches(wide) == (256, 12)
    assert kq.conv_launches(down300) == (256, 44) and kq.conv_launches(deconv138) == (512, 40)
    assert kq.conv_launches(kq.quant_conv(torch.ones(256, 8, 3, 3), None, 1.0, 2, None)) == (256,)


@pytest.mark.parametrize("style", ["instance", "adain"])
@pytest.mark.parametrize("shape", [(2, 256, 16, 16), (1, 40, 6, 10), (3, 268, 5, 130)])
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


def test_resblock_kernel_repeats_bit_for_bit(cuda):
    b, c, h, w = 3, 268, 9, 20
    q1, q2 = _on(_make("res", c, c, 21), cuda), _on(_make("res", c, c, 22), cuda)
    x = _randn((b, c, h, w), 23).to(cuda)
    g, be = _randn((b, c), 24, 0.3).to(cuda), _randn((b, c), 25, 0.3).to(cuda)
    first = kq.resblock(x, q1, q2, g, be)
    assert torch.equal(first, kq.resblock(x, q1, q2, g, be))


@pytest.mark.parametrize("kind,b,c,co,h,w", [("down", 3, 40, 24, 60, 10),
                                              ("deconv", 1, 276, 138, 4, 5)])
def test_strided_convs_repeat_bit_for_bit(cuda, kind, b, c, co, h, w):
    qc = _on(_make(kind, c, co, 31), cuda)
    x = _randn((b, c, h, w), 32).to(cuda)
    p = _to(_pending(b, c, 33), cuda)
    fn = kq.downconv if kind == "down" else kq.deconv
    first = fn(x, qc, p, with_stats=True)
    assert all(torch.equal(f, a) for f, a in zip(first, fn(x, qc, p, with_stats=True)))


@pytest.mark.parametrize("c,padding", [(256, "reflect"), (268, None), (20, "reflect")])
def test_nhwc_quant_pad_matches_plain(cuda, c, padding):
    """Kernel 6's second quantize reads h1 NHWC: the same operands as the
    plain version of the NCHW tensor, with the prologue affine and relu."""
    qc = _make("res", c, c, 26, padding)
    h = _randn((2, c, 5, 7), 27, 1.5)
    p = _pending(2, c, 28)
    got = kq.quant_pad_cuda(h.permute(0, 2, 3, 1).contiguous().to(cuda), _on(qc, cuda),
                            _to(p, cuda), nhwc=True)
    assert torch.equal(got.cpu(), kq.quant_pad_plain(h, qc, p))


# (shape, co, bias, alpha, act): the kernel's edges are odd B, hw off the
# 16-byte vector (scalar runs; 37 x 53) or on it with a cut warp group
# (37 x 56), C off the channel batch, Co 5 (8 sums per pixel), a bias, relu
# with alpha and no activation
HEAD_CASES = [((2, 64, 32, 32), 3, False, 0.0, "tanh"), ((1, 10, 5, 7), 5, True, 0.0, "tanh"),
              ((3, 21, 37, 53), 5, True, 0.2, None), ((3, 20, 37, 56), 5, True, 0.2, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,co,bias,alpha,act", HEAD_CASES)
def test_head_kernel_matches_plain(cuda, shape, co, bias, alpha, act, dtype):
    b, c, h, w = shape
    x = _randn(shape, 14).to(dtype)
    p = _pending(b, c, 15, alpha=alpha)
    wt = _randn((co, c), 16, 0.2)
    bs = _randn((co,), 17, 0.1) if bias else None
    before = khead.head.launches
    y = khead.head(x.to(cuda), _to(p, cuda), wt.to(cuda), None if bs is None else bs.to(cuda),
                   act)
    torch.cuda.synchronize()
    assert khead.head.launches == before + 1
    assert y.dtype == dtype
    # the 1x1 sum over C in channel order against cuDNN's/the CPU's order; in
    # bf16 that can move an output by two bf16 steps: 2^-7 in [-1, 1] (tanh),
    # 2^-6 |y| above it (no activation)
    tol = (1e-5, 0.0) if dtype == torch.float32 else \
        (khead.BF16_TOL, 0.0 if act == "tanh" else 2 * khead.BF16_TOL)
    torch.testing.assert_close(y.cpu().float(), khead.head_plain(x, p, wt, bs, act).float(),
                               atol=tol[0], rtol=tol[1])


# the per-image term (DecoderConcat's z share of its 1x1 sum): BaseModel B's
# head at its serving shape, (64, 73, 256, 256) -> 3, and two ragged shapes
# (scalar runs; a cut warp group, with a bias and no activation)
TERM_CASES = [((64, 73, 256, 256), 3, False, "tanh"), ((3, 21, 37, 53), 5, True, "tanh"),
              ((3, 20, 37, 56), 5, True, None)]


def _head_tol(dtype, act):
    return (1e-5, 0.0) if dtype == torch.float32 else \
        (khead.BF16_TOL, 0.0 if act == "tanh" else 2 * khead.BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,co,bias,act", TERM_CASES)
def test_head_kernel_with_a_term_matches_plain(cuda, shape, co, bias, act, dtype):
    """Kernel 8 with t against its plain version (on the card: cuDNN's f32
    1x1 conv, TF32 off), in one launch."""
    b, c, h, w = shape
    x = _randn(shape, 40).to(dtype).to(cuda)
    p = _to(_pending(b, c, 41), cuda)
    wt = _randn((co, c), 42, 0.2).to(cuda)
    bs = _randn((co,), 43, 0.1).to(cuda) if bias else None
    t = _randn((b, co), 44, 0.5).to(cuda)
    before = khead.head.launches
    y = khead.head(x, p, wt, bs, act, t)
    torch.cuda.synchronize()
    assert khead.head.launches == before + 1 and y.dtype == dtype
    atol, rtol = _head_tol(dtype, act)
    torch.testing.assert_close(y.float(), khead.head_plain(x, p, wt, bs, act, t).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_head_kernel_without_a_term_is_unchanged_at_the_serving_shape(cuda, dtype):
    """The launch without a term (AdaINModel's and BaseModel A's head at
    (64, 64, 256, 256) -> 3) within the plain version's tolerance, and a
    zero term equal to it bit for bit: the kernel adds 0 where none is given."""
    b, c, h, w = 64, 64, 256, 256
    x = _randn((b, c, h, w), 45).to(dtype).to(cuda)
    p = _to(_pending(b, c, 46), cuda)
    wt = _randn((3, c), 47, 0.2).to(cuda)
    y = khead.head(x, p, wt)
    atol, rtol = _head_tol(dtype, "tanh")
    torch.testing.assert_close(y.float(), khead.head_plain(x, p, wt).float(), atol=atol,
                               rtol=rtol)
    assert torch.equal(y, khead.head(x, p, wt, None, "tanh", torch.zeros(b, 3, device=cuda)))


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
    with pytest.raises(ValueError):  # a term on the CPU
        khead.head(x, _to(_pending(1, 8, 3), cuda), torch.zeros(3, 8, device=cuda), None,
                   "tanh", torch.zeros(1, 3))
