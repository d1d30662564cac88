"""Card-only tests of quantization-aware training (``--int8_train``,
``ops/qat.py``): the weight quantize on the card, the straight-through
Functions on kernels 4, 7 and 5, and a small QAT step against the CPU.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_qat_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

- The weights quantize on the card to the CPU's bits (both divisions tensor
  by tensor, which CUDA rounds correctly).
- An STE conv's forward equals its kernel's plain version on the same card
  tensors, bit for bit (the int8 operands and int32 sums are exact, y =
  acc * scale + bias rounded once); its backward equals autograd of the
  float conv on the card within 1e-5 (f32) or 2^-7 (bf16, two bf16 steps)
  of each gradient's largest magnitude: the backward is the same cuDNN
  call, but cuDNN and the reflect pad's backward may add in another order
  from call to call.
- A small f32 QAT main step (crop 32, dim 8) on the card against the same
  step on the CPU from the same weights, amax tree and draws: the losses
  within 1e-3 relative (the float ops between the int8 convs sum in another
  order on each device, which can flip an int8 input by one step, as
  between the port and the JAX package, ``tests/test_torch_qat.py``), each
  kernel 4 / 7 / 5 launched as often as the JAX QAT step calls it, kernels
  9/10 never.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.ops import qat
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

SMALL = dict(crop_size=32, dim=8, latent_dim=4, num_domains=3, batch_size=2,
             use_dis_content=False, compute_dtype="float32", int8_train=True)
# kernel 4 / 7 / 5 launches per QAT main step (tests/test_torch_qat.py QAT_CALLS)
QAT_LAUNCHES = {"reference": (64, 8, 8), "fused": (56, 6, 8)}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


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


def _close(got, want, tol, what):
    scale = max(want.abs().max().item(), 1e-6)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, f"{what}: max error {err} > {tol} x {scale}"


@pytest.mark.parametrize("out_dim,shape", [(0, (256, 256, 3, 3)), (0, (128, 64, 3, 3)),
                                           (1, (256, 128, 3, 3)), (0, (73, 146, 3, 3))])
def test_weight_quantize_on_the_card_is_the_cpus(cuda, out_dim, shape):
    w = _randn(shape, 1, 0.05)
    w[0] *= 40.0  # one channel with a far larger range
    q_cpu, s_cpu = kq.quantize_weight(w, out_dim)
    q_card, s_card = kq.quantize_weight(w.to(cuda), out_dim)
    assert torch.equal(q_card.cpu(), q_cpu) and torch.equal(s_card.cpu(), s_cpu)
    if out_dim == 0:
        a, b = kq.quant_conv(w, None, 2.5, 1, "reflect"), kq.quant_conv(w.to(cuda), None, 2.5, 1,
                                                                          "reflect")
    else:
        a, b = kq.quant_deconv(w, _randn((shape[1],), 2), 2.5), kq.quant_deconv(
            w.to(cuda), _randn((shape[1],), 2).to(cuda), 2.5)
    for x, y in ((a.w, b.w), (a.scale, b.scale), (a.inv_sx, b.inv_sx), (a.bias, b.bias)):
        assert (x is None and y is None) or torch.equal(x, y.cpu())


# (kind, B, C, Co, H, W, padding, dtype): the QAT path's kinds at small maps
CASES = [
    ("conv", 2, 64, 64, 16, 16, "reflect", torch.bfloat16),
    ("conv", 3, 40, 24, 9, 11, "reflect", torch.float32),
    ("down", 2, 64, 128, 32, 32, "reflect", torch.bfloat16),
    ("down", 2, 24, 40, 13, 10, None, torch.float32),
    ("deconv", 2, 128, 64, 16, 16, None, torch.bfloat16),
    ("deconv", 3, 40, 24, 7, 9, None, torch.float32),
]


@pytest.mark.parametrize("kind,b,c,co,h,w,padding,dtype", CASES)
def test_ste_on_the_card(cuda, kind, b, c, co, h, w, padding, dtype):
    x = _randn((b, c, h, w), 3).to(cuda, dtype).requires_grad_(True)
    bias = _randn((co,), 4, 0.1).to(cuda).requires_grad_(True)
    amax = x.detach().abs().amax().float()
    if kind == "deconv":
        weight = _randn((c, co, 3, 3), 5, 0.05).to(cuda).requires_grad_(True)
        qc = kq.quant_deconv(weight, bias, amax)
        n0 = kq.deconv.launches
        y = qat.int8_deconv_ste(x, weight, bias, amax, dtype, qc)
        launched = kq.deconv.launches - n0
    else:
        stride = 2 if kind == "down" else 1
        weight = _randn((co, c, 3, 3), 5, 0.05).to(cuda).requires_grad_(True)
        qc = kq.quant_conv(weight, bias, amax, stride, padding)
        wrapper = kq.downconv if stride == 2 else kq.conv3x3
        n0 = wrapper.launches
        y = qat.int8_conv3x3_ste(x, weight, bias, amax, padding, stride, dtype, qc)
        launched = wrapper.launches - n0
    assert launched == 1 and y.dtype == dtype
    with torch.no_grad():
        want = kq.conv_plain(x.detach(), qc)
    assert torch.equal(y.detach(), want)
    g = _randn(tuple(y.shape), 6).to(cuda, dtype)
    grads = torch.autograd.grad(y, (x, weight, bias), g)
    xr, wr, br = (t.detach().clone().requires_grad_(True) for t in (x, weight, bias))
    if kind == "deconv":
        yf = F.conv_transpose2d(xr, wr.to(dtype), br.to(dtype), 2, 1, 1)
    else:
        xp, pad = xr, 1
        if padding == "reflect":
            xp, pad = F.pad(xr, (1, 1, 1, 1), mode="reflect"), 0
        yf = F.conv2d(xp, wr.to(dtype), br.to(dtype), 2 if kind == "down" else 1, pad)
    want_grads = torch.autograd.grad(yf, (xr, wr, br), g)
    for what, got, ref in zip(("dx", "dw", "db"), grads, want_grads):
        assert got.dtype == ref.dtype, what
        _close(got, ref, GRAD_TOL[dtype], what)


def _small(device, gan_step, seed=0):
    model = AdaINModel(default_train_args(**SMALL, gan_step=gan_step, seed=seed), device=device)
    model.initialize(seed)
    return model


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(x1=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                x2=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                y1=np.eye(3, dtype=np.float32)[[0, 2]], y2=np.eye(3, dtype=np.float32)[[1, 0]])


@pytest.mark.parametrize("gan_step", ["reference", "fused"])
def test_small_qat_step_on_the_card_matches_the_cpu(cuda, gan_step):
    batch = _batch()
    rng = np.random.default_rng(1)
    c = np.eye(3, dtype=np.float32)[[1, 2]]
    z, z_sr, z_sr2 = (torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
                      for _ in range(3))
    cpu = _small("cpu", gan_step)
    tree = cpu.calibrate_quant_train(batch, c, z)
    card = _small(cuda, gan_step)
    card.load_int8_train(tree)
    counters = (kq.conv3x3, kq.downconv, kq.deconv, krb.resblock_fwd, krb.resblock_bwd)
    before = [f.launches for f in counters]
    logs = card.optimize_parameters(batch, 0, StepDraws(z_sr=z_sr.to(cuda), z_sr2=z_sr2.to(cuda)))
    torch.cuda.synchronize()
    launched = tuple(f.launches - n for f, n in zip(counters, before))
    assert launched == (*QAT_LAUNCHES[gan_step], 0, 0)
    want = cpu.optimize_parameters(batch, 0, StepDraws(z_sr=z_sr, z_sr2=z_sr2))
    for k, v in want.items():
        got = float(logs[k])
        assert np.isfinite(got), k
        assert abs(got - float(v)) <= 1e-3 * max(abs(float(v)), 1e-3), (k, got, float(v))
