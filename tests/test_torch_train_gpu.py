"""Card-only tests of the training resblock kernels (9 and 10): each against
its plain PyTorch version on the same inputs on the card, and the autograd
Function's gradients into the style projection and z.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_train_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

Tolerances, relative to each tensor's largest magnitude. f32: the kernel's
conv sums run in another order than cuDNN's f32 convs (TF32 off), so 1e-4.
bf16: the same order difference can round a conv output (h1, h2, the
dgrads) to the neighbouring bf16 value (2^-8 relative), and such a flip
carries into the next conv, so 2e-2, the CPU tests' bf16 bound.
"""
import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.models.blocks import AdaINResnetBlock
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def _inputs(shape, dtype, style, seed, device):
    b, c, h, w = shape
    x = _randn(shape, seed).to(dtype)
    w1, w2 = _randn((c, c, 3, 3), seed + 1, 0.05), _randn((c, c, 3, 3), seed + 2, 0.05)
    gamma = _randn((b, c), seed + 3, 0.3) if style else torch.zeros(b, c)
    beta = _randn((b, c), seed + 4, 0.3) if style else torch.zeros(b, c)
    g = _randn(shape, seed + 5).to(dtype)
    return [t.to(device) for t in (x, w1, w2, gamma, beta, g)]


def _close(got, want, tol, what):
    got, want = got.float(), want.float()
    scale = max(want.abs().max().item(), 1e-6)
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"{what}: max error {err} > {tol} x {scale}"


def _check(shape, dtype, padding, relu_mid, style, device):
    x, w1, w2, gamma, beta, g = _inputs(shape, dtype, style, 3, device)
    cfg = (padding, relu_mid, 1e-5)
    f0, b0 = krb.resblock_fwd.launches, krb.resblock_bwd.launches
    fwd = krb.resblock_fwd(x, w1, w2, gamma, beta, *cfg)
    bwd = krb.resblock_bwd(x, fwd[1], fwd[2], g, fwd[3], w1, w2, gamma, beta, *cfg)
    torch.cuda.synchronize()
    assert (krb.resblock_fwd.launches, krb.resblock_bwd.launches) == (f0 + 1, b0 + 1)
    ref_fwd = krb.resblock_fwd_plain(x, w1, w2, gamma, beta, *cfg)
    # the backward's plain version from the kernel's residuals, so that it
    # checks kernel 10 alone
    ref_bwd = krb.resblock_bwd_plain(x, fwd[1], fwd[2], g, fwd[3], w1, w2, gamma, beta, *cfg)
    tol = TOL[dtype]
    for what, got, want in zip(("out", "h1", "h2", "stats"), fwd, ref_fwd):
        assert got.shape == want.shape and got.dtype == want.dtype, what
        _close(got, want, tol, what)
    for what, got, want in zip(("dx", "dw1", "dw2", "dgamma", "dbeta"), bwd, ref_bwd):
        assert got.shape == want.shape and got.dtype == want.dtype, what
        assert torch.isfinite(got).all(), what
        _close(got, want, tol, what)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 256, 16, 16), (2, 128, 8, 8)])
@pytest.mark.parametrize("padding,relu_mid,style", [
    ("reflect", True, True), ("reflect", True, False), ("reflect", False, True),
    ("zero", True, True), ("zero", False, False),
])
def test_resblock_kernels_match_plain(cuda, dtype, shape, padding, relu_mid, style):
    _check(shape, dtype, padding, relu_mid, style, cuda)


def test_resblock_kernels_match_plain_at_the_flagship_shape(cuda):
    """(16, 256, 64, 64) bf16: every encoder resblock of the main step."""
    _check((16, 256, 64, 64), torch.bfloat16, "reflect", True, True, cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,padding", [
    ((3, 128, 12, 20), "reflect"), ((1, 256, 24, 40), "zero"), ((5, 128, 9, 33), "reflect"),
])
def test_resblock_kernels_match_plain_at_ragged_shapes(cuda, dtype, shape, padding):
    """Odd batches, H x W not a multiple of the 128-row M-tile (nor the
    padded grids of the conv and the wgrad's 64-pixel slabs), W != 64."""
    _check(shape, dtype, padding, True, True, cuda)


@pytest.mark.parametrize("shape", [(3, 128, 12, 20), (16, 256, 64, 64)])
def test_resblock_kernels_are_deterministic(cuda, shape):
    """No float atomics: two calls on the same inputs give the same bits
    (the wgrad's cluster adds its partials in rank order)."""
    x, w1, w2, gamma, beta, g = _inputs(shape, torch.bfloat16, True, 7, cuda)
    runs = []
    for _ in range(2):
        fwd = krb.resblock_fwd(x, w1, w2, gamma, beta)
        bwd = krb.resblock_bwd(x, fwd[1], fwd[2], g, fwd[3], w1, w2, gamma, beta)
        runs.append((*fwd, *bwd))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), i


def test_gradients_flow_into_the_style_projection_and_z(cuda):
    """The AdaIN block through kernels 9/10 against the same block composed
    (cuDNN convs, the moments and AdaIN kernels, autograd through the norms'
    Functions), in f32: one-pass against two-pass variance and other sum
    orders, so 1e-3 of each gradient's largest magnitude."""
    torch.manual_seed(0)
    block = AdaINResnetBlock(128, 8).to(cuda)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    x = _randn((2, 128, 8, 8), 20).to(cuda).requires_grad_()
    z = _randn((2, 8), 21).to(cuda).requires_grad_()
    g = _randn((2, 128, 8, 8), 22).to(cuda)
    grads = {}
    for mode in ("auto", "off"):
        before = krb.resblock_bwd.launches
        with krb.fused_train_trace(mode):
            out = block(x, z)
        params = [block.adain.style_proj.weight, block.adain.style_proj.bias,
                  block.conv1.conv.weight, block.conv2.conv.weight, x, z]
        grads[mode] = torch.autograd.grad((out * g).sum(), params)
        assert krb.resblock_bwd.launches == before + (mode == "auto")
    for i, (a, b) in enumerate(zip(grads["auto"], grads["off"])):
        assert torch.isfinite(a).all() and a.abs().max() > 0, i
        _close(a, b, 1e-3, f"grad {i}")


def test_resblock_kernels_refuse_what_they_cannot_take(cuda):
    """What the routing gate (C % 128 == 0, H, W >= 8) does not pass, and
    malformed arguments, raise before any launch."""
    x, w1, w2, gamma, beta, g = _inputs((2, 128, 8, 8), torch.float32, True, 1, cuda)
    with pytest.raises(ValueError):
        krb.resblock_fwd(x.double(), w1, w2, gamma, beta)
    with pytest.raises(ValueError):
        krb.resblock_fwd(x[:, :100].contiguous(), w1, w2, gamma, beta)
    with pytest.raises(ValueError):
        krb.resblock_fwd(x, w1.cpu(), w2, gamma, beta)
    with pytest.raises(ValueError):
        krb.resblock_fwd(x, w1, w2, gamma, beta, padding_type="replicate")
    for bad in ((2, 64, 8, 8), (2, 192, 8, 8), (2, 128, 7, 8), (2, 128, 8, 6)):
        xb, w1b, w2b, gb, bb, gg = _inputs(bad, torch.bfloat16, True, 1, cuda)
        with pytest.raises(ValueError, match="C % 128"):
            krb.resblock_fwd(xb, w1b, w2b, gb, bb)
        h = torch.zeros(bad[0], bad[2], bad[3], bad[1], device=cuda, dtype=torch.bfloat16)
        stats = torch.zeros(bad[0], 4, bad[1], device=cuda)
        with pytest.raises(ValueError, match="C % 128"):
            krb.resblock_bwd(xb, h, h, gg, stats, w1b, w2b, gb, bb)
