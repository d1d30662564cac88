"""Card-only tests of the decoder-mix kernel (``ops/kernels/dec_mix.py``,
``csrc/dec_mix.cu``): the kernel against its plain PyTorch version on the
card, and a BaseModel A int8 forward at bf16 compute through it against the
same forward composed.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_dec_mix_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

The kernel and the plain version take the same bf16 operands, sum in f32
and round at the same places; only the order of the sums differs. So a
hidden value or the second conv's output can land one bf16 step apart (at
most 2^-7 of its value), and with the residual the sum's rounding one more
step: :data:`STEP_TOL` allows two steps of the larger of the output and the
mix's value before the residual (whose add can cancel it), and at most
:data:`MOVED` of the outputs may differ at all.
"""
import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import BaseModel
from masterthesis_tpu_torch.ops import norms
from masterthesis_tpu_torch.ops.kernels import dec_mix as kmix

pytestmark = pytest.mark.gpu

STEP_TOL = 2.0**-6  # two bf16 steps, relative to max(|plain|, |mix|, 1)
MOVED = 0.02  # share of outputs that may differ


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))


def _case(b, h, w, hidden, seed, device):
    """x with channel means and spreads of its own, the statistics as the
    block takes them, and the operands of two seeded 1x1 convs and a style
    chunk of 256 channels."""
    c = kmix.C
    x = (_randn((b, c, h, w), seed, 1.0) * _randn((1, c, 1, 1), seed + 1, 0.5, 1.0)
         + _randn((1, c, 1, 1), seed + 2, 0.5)).to(torch.bfloat16).to(device)
    mean, var = norms.moments(x)
    rstd = torch.rsqrt(var + norms.EPS)
    wa = _randn((hidden, c + 256, 1, 1), seed + 3, (c + 256) ** -0.5)
    wb = _randn((c, hidden, 1, 1), seed + 4, hidden ** -0.5)
    ops = kmix.operands(wa.to(device), _randn((hidden,), seed + 5, 0.1).to(device),
                        wb.to(device), _randn((c,), seed + 6, 0.1).to(device),
                        _randn((b, 256), seed + 7).to(device), torch.bfloat16)
    r = _randn((b, c, h, w), seed + 8).to(torch.bfloat16).to(device)
    return x, mean.flatten(1), rstd.flatten(1), ops, r


def _assert_steps(got, want, r=None):
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs() if r is None else torch.maximum(want.abs(), (want - r.float().cpu()).abs())
    diff = (got - want).abs()
    assert (diff <= STEP_TOL * scale.clamp_min(1.0)).all(), diff.max()
    assert (diff > 0).float().mean() <= MOVED, (diff > 0).float().mean()


# (B, H, W, hidden): the serving shape; H x W off the 128-pixel tile and off
# the 8-pixel vector (padded by the wrapper); one 64-channel hidden chunk
SHAPES = [(64, 64, 64, 512), (3, 37, 53, 512), (2, 9, 24, 512), (1, 16, 16, 64)]


@pytest.mark.parametrize("residual", [False, True], ids=["mix1", "mix2"])
@pytest.mark.parametrize("b,h,w,hidden", SHAPES)
def test_kernel_matches_plain(cuda, b, h, w, hidden, residual):
    x, mean, rstd, ops, r = _case(b, h, w, hidden, 10 * b + h, cuda)
    r = r if residual else None
    before = kmix.dec_mix.launches
    got = kmix.dec_mix(x, mean, rstd, *ops, r)
    torch.cuda.synchronize()
    assert kmix.dec_mix.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    _assert_steps(got, kmix.dec_mix_plain(x, mean, rstd, *ops, r), r)


def test_kernel_repeats_bit_for_bit(cuda):
    x, mean, rstd, ops, r = _case(4, 32, 40, 512, 3, cuda)
    assert torch.equal(kmix.dec_mix(x, mean, rstd, *ops, r), kmix.dec_mix(x, mean, rstd, *ops, r))


def test_kernel_refuses_what_it_cannot_take(cuda):
    x, mean, rstd, ops, r = _case(2, 8, 8, 512, 4, cuda)
    wa, vec, wb, bb = ops
    with pytest.raises(ValueError):
        kmix.dec_mix(x.float(), mean, rstd, *ops)
    with pytest.raises(ValueError):
        kmix.dec_mix(x, mean, rstd, wa[:96].contiguous(), vec[:, :96].contiguous(),
                     wb[:, :96].contiguous(), bb)
    with pytest.raises(ValueError):
        kmix.dec_mix(x, mean, rstd, *ops, r[:1].contiguous())


def test_base_model_a_int8_bf16_forward_through_the_kernel(cuda, monkeypatch):
    """BaseModel A at its published widths (256 channels into the decoder),
    int8 at bf16 compute on a small image: 8 launches a forward, and the
    output of the composed route within the bf16 forward's bound (two bf16
    steps at |x| ~ 4, tests/test_torch_int8_bf16.py's: a hidden value a step
    apart can move an int8 operand of the next conv by one level)."""
    args = default_test_args(crop_size=32, dim=64, latent_dim=8, num_domains=4, batch_size=2,
                             seed=0, compute_dtype="bfloat16")
    model = BaseModel(args)
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 2)]
    model.calibrate_int8([img], [c], [z])
    before = kmix.dec_mix.launches
    out, _, _ = model.forward_random(img, z, c)
    assert kmix.dec_mix.launches - before == 8
    monkeypatch.setattr(kmix, "takes", lambda *a: False)
    ref, _, _ = model.forward_random(img, z, c)
    assert kmix.dec_mix.launches - before == 8
    diff = (out.float() - ref.float()).abs()
    assert diff.max() <= 5e-2, diff.max()
