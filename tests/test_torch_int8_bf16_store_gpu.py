"""Card-only tests of how the stride-2 and transposed int8 convs (kernels 7
and 5) store y: by TMA box stores where y's rows are a multiple of 16 bytes
(f32 Wo % 4 == 0, bf16 Wo % 8 == 0; a transposed conv's rows are 2 Wo),
else by the threads. Each case runs on both sides of that rule and holds y
and the statistics bit for bit against the plain version on the same card,
and against a second call.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_int8_bf16_store_gpu.py -m gpu -q -s

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).
"""
import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.ops.kernels import int8_conv as kq

pytestmark = pytest.mark.gpu

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


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


# (kind, B, C, Co, H, W, y store in f32, in bf16). The box tile is bx = 32, 64
# or 128 output columns (the least that holds Wo, or 128) x by = min(128 /
# bx, Ho) rows; N tiles of 128 rows (R = Co, or 4 Co for the transposed
# conv) and a tail tile of its own.
CASES = [
    # stride 2, Wo 12: rows of 48 bytes in f32 (TMA), 24 in bf16 (threads);
    # Ho 7 off by 4; Cp 64 (64-channel slabs)
    ("down", 2, 40, 24, 14, 24, "tma", "threads"),
    # Wo 16: bx 32, by 4, a box wider than Wo; Ho 7; R 160 (a 32-row tail)
    ("down", 1, 48, 160, 13, 32, "tma", "tma"),
    # Wo 80: a 128-column box with 80 columns inside; Cp 96
    ("down", 1, 96, 64, 6, 160, "tma", "tma"),
    # Wo 135: neither dtype
    ("down", 1, 72, 40, 5, 270, "threads", "threads"),
    # the sample CLI's down1 at 540 x 960
    ("down", 1, 128, 256, 270, 480, "tma", "tma"),
    # transposed, Wo 6: rows of 12 outputs, 48 bytes in f32, 24 in bf16; R 80
    ("deconv", 2, 24, 20, 5, 6, "tma", "threads"),
    # Wo 80: 160 output columns from a 128-column box; R 192 (a 64-row tail)
    ("deconv", 1, 64, 48, 3, 80, "tma", "tma"),
    # Wo 24: bx 32, by 4, Ho 7 off by; R 144 (a 16-row tail at N 32)
    ("deconv", 1, 40, 36, 7, 24, "tma", "tma"),
    # BaseModel B's 276 -> 138: Cp 288, R 552 (a 40-row tail at N 64)
    ("deconv", 1, 276, 138, 4, 16, "tma", "tma"),
    # the sample CLI's up0 and up1 at 540 x 960
    ("deconv", 1, 256, 128, 135, 240, "tma", "tma"),
    ("deconv", 1, 128, 64, 270, 480, "tma", "tma"),
]


def _case(kind, b, c, co, h, w, dtype, device, seed):
    weight = _randn((c, co, 3, 3) if kind == "deconv" else (co, c, 3, 3), seed, 0.1)
    bias = _randn((co,), seed + 1, 0.2)
    x = _randn((b, c, h, w), seed + 2, 1.5).to(device=device, dtype=dtype)
    pending = None
    if kind == "down":  # the stride-2 convs take the previous norm as a prologue
        pending = kq.Pending((_randn((b, c), seed + 3).abs() + 0.5).to(device),
                             _randn((b, c), seed + 4, 0.3).to(device), True, 0.01)
    amax = kq.prologue_plain(x, pending).abs().amax()
    qc = (kq.quant_deconv(weight.to(device), bias.to(device), amax) if kind == "deconv"
          else kq.quant_conv(weight.to(device), bias.to(device), amax, 2, "reflect"))
    return x, qc, pending


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("kind,b,c,co,h,w,f32_store,bf16_store", CASES)
def test_strided_conv_stores_y_bit_for_bit(cuda, kind, b, c, co, h, w, f32_store, bf16_store,
                                           dtype_name):
    dtype = DTYPES[dtype_name]
    x, qc, pending = _case(kind, b, c, co, h, w, dtype, cuda, seed=c + co + w)
    route = kq.y_store(qc, w, dtype)
    print(f"{kind} {(b, c, h, w)} -> {co} {dtype_name}: y by {route}")
    assert route == {"f32": f32_store, "bf16": bf16_store}[dtype_name]
    fn = kq.downconv if kind == "down" else kq.deconv
    before = fn.launches
    got = fn(x, qc, pending, with_stats=True)
    again = fn(x, qc, pending, with_stats=True)
    want = kq.conv_plain(x, qc, pending, True)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert got[0].dtype == dtype and got[0].shape == want[0].shape
    for name, g, a, r in zip(("y", "sum", "sumsq"), got, again, want):
        assert torch.equal(g, r), f"{name} differs from the plain version"
        assert torch.equal(g, a), f"{name} differs between two calls"
