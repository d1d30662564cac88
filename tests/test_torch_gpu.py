"""Card-only tests: each CUDA kernel against its plain PyTorch version, and
the port's forward on the card against the same forward on the CPU.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).
"""
import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import moments as kmoments

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

# plane shapes: the decoder resblock map, a map whose planes are not 16-byte
# aligned (scalar path), and one with a ragged vector tail
SHAPES = [(2, 8, 64, 64), (2, 3, 5, 7), (1, 4, 33, 35), (2, 16, 128, 128)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _input(shape, dtype, device, seed=0, offset=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2.0 + offset
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_moments_kernel_matches_plain(cuda, shape, dtype):
    x = _input(shape, dtype, cuda)
    before = kmoments.moments.launches
    s, sq = kmoments.moments(x)
    torch.cuda.synchronize()
    assert kmoments.moments.launches == before + 1
    ref_s, ref_sq = kmoments.moments_plain(x)
    # both sum in f64 and round once to f32: the order does not show
    assert torch.equal(s.cpu(), ref_s.cpu()) and torch.equal(sq.cpu(), ref_sq.cpu())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_adain_kernel_matches_plain(cuda, shape, dtype):
    x = _input(shape, dtype, cuda, seed=1)
    g = _input(shape[:2], torch.float32, cuda, seed=2, offset=0.0) * 0.3
    b = _input(shape[:2], torch.float32, cuda, seed=3, offset=0.0) * 0.3
    before = kadain.adain.launches
    out = kadain.adain(x, g, b)
    torch.cuda.synchronize()
    assert kadain.adain.launches == before + 1
    ref = kadain.adain_plain(x, g, b)
    assert out.dtype == x.dtype and out.shape == x.shape
    # f32: outputs are O(1), statistics summed in another order -> 1e-4;
    # bf16: one rounding step of the output (2^-7 relative) either way
    tol = dict(rtol=0, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


SMALL = dict(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=2, seed=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_on_the_card_matches_the_cpu(cuda, dtype):
    """The same seeded weights on both devices. The CPU path is the one the
    other tests hold against the JAX package. f32 (TF32 off): other conv
    algorithms and summation orders, 1e-4 on tanh outputs; bf16: a few bf16
    rounding steps carried through the net, 5e-2."""
    args = default_test_args(compute_dtype=dtype, **SMALL)
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((2, 4)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[[0, 2]]
    on_card = AdaINModel(args)
    moments0, adain0 = kmoments.moments.launches, kadain.adain.launches
    out, seconds, mem = on_card.forward_random(img, z, c)
    assert out.device.type == "cuda" and seconds > 0 and mem > 0
    assert (kmoments.moments.launches - moments0, kadain.adain.launches - adain0) == (13, 8)
    ref, _, _ = AdaINModel(args, device="cpu").forward_random(img, z, c)
    tol = 1e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(out.float().cpu(), ref.float(), rtol=0, atol=tol)


def test_kernels_refuse_what_they_cannot_take(cuda):
    x = _input((2, 4, 8, 8), torch.float32, cuda)
    with pytest.raises(ValueError):
        kmoments.moments(x.transpose(2, 3))
    with pytest.raises(ValueError):
        kmoments.moments(x.half())
    g = torch.zeros(2, 4, device=cuda)
    with pytest.raises(ValueError):
        kadain.adain(x, g.bfloat16(), g)
    with pytest.raises(ValueError):
        kadain.adain(_input((1, 1, 256, 256), torch.float32, cuda), g[:1, :1], g[:1, :1])
    with pytest.raises(ValueError):
        kmoments.moments(x.double())
