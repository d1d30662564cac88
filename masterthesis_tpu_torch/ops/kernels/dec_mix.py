"""One mix of BaseModel's decoder block, the norm to the second 1x1 conv.

``DecResnetBlock`` (``models/blocks.py``) runs, twice a block,

    y = relu(Wb . relu(Wa . [IN(x), z] + ba) + bb)   [+ r]

over NCHW maps: an instance norm, the style chunk z concatenated after it,
broadcast over H, W, two 1x1 convs with bias and relu, and in the second mix
the block's input r added. The concatenated channels are the same at every
pixel, so their part of the first conv is one vector per sample,
``v = Wa_z . z + ba`` with ``Wa = [Wa_h | Wa_z]`` split where the concat
joins (:func:`operands`); what remains is

    y = relu(Wb . relu(Wa_h . IN(x) + v) + bb)   [+ r].

``dec_mix`` is the wrapper, around the op ``masterthesis_tpu_torch::dec_mix``
(``library.py``): on a CPU tensor it runs :func:`dec_mix_plain`, on a CUDA
tensor it launches ``csrc/dec_mix.cu`` (:func:`dec_mix_cuda`) or raises. It
replaces no Pallas kernel: the JAX package leaves the chain to XLA. The
norm's statistics are inputs (``mean``, ``rstd`` per sample and channel,
from the moments kernel), so a caller that reduces them elsewhere can pass
its own. ``dec_mix.launches`` counts the kernel's launches.

Numerics. The plain version and the kernel take the operands the composed
block takes in its dtype (the weights and biases rounded to it) and sum in
f32; they round where the composed block rounds: IN(x) to the dtype (f32
subtract, then multiply, as ``ops/norms.py`` does), each conv's sum plus
bias, then relu, and the residual sum. Only the order of the sums differs,
and ``v``, which :func:`operands` computes in f32 from the rounded z, Wa_z
and ba.

The kernel takes 256 channels in and out and up to 512 hidden channels in
steps of 64 (:func:`takes`), in bf16. H x W that is not a multiple of 8
pixels (TMA's 16-byte row strides) is padded with zeros for the launch and
cut after.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.ops.kernels import build, library
from masterthesis_tpu_torch.utils import profiling

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
C = 256  # channels of x and y the kernel takes (csrc/dec_mix.cu kC)
CHUNK = 64  # hidden channels per step (kChunk)
MAX_HIDDEN = 512  # hidden channels at most (kMaxHidden)
PIXELS = 8  # H x W is padded to a multiple of this for the launch


def takes(features: int, hidden: int) -> bool:
    """Whether the kernel takes a mix of ``features`` channels in and out
    and ``hidden`` channels between the two convs."""
    return features == C and hidden % CHUNK == 0 and 0 < hidden <= MAX_HIDDEN


def operands(wa: torch.Tensor, ba: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
             z: torch.Tensor, dtype: torch.dtype):
    """The mix's operands from its two 1x1 convs' parameters, Wa (hidden,
    F + S, 1, 1), ba (hidden,), Wb (F, hidden, 1, 1), bb (F,), and the
    style chunk z (B, S), as the composed block rounds them to ``dtype``:
    (Wa_h (hidden, F), v (B, hidden) f32, Wb (F, hidden), bb (F,) f32),
    the weights in ``dtype``, ``v = Wa_z . z + ba`` summed in f32."""
    f = wb.shape[0]
    wa = wa.flatten(1).to(dtype)
    vec = torch.addmm(ba.to(dtype).float(), z.to(dtype).float(), wa[:, f:].float().t())
    return (wa[:, :f].contiguous(), vec, wb.flatten(1).to(dtype).contiguous(),
            bb.to(dtype).float())


def dec_mix_plain(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, wa: torch.Tensor,
                  vec: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
                  r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, F, H, W); mean, rstd (B, F) f32; wa (hidden, F), vec (B, hidden)
    f32, wb (F, hidden), bb (F,) as :func:`operands` gives them; r None or
    x's shape -> (B, F, H, W) in x's dtype."""
    dt = x.dtype
    b, c, h, w = x.shape
    xn = ((x.float() - mean[:, :, None, None]) * rstd[:, :, None, None]).to(dt)
    hid = torch.matmul(wa.float(), xn.float().reshape(b, c, h * w)) + vec.float()[:, :, None]
    hid = torch.relu(hid.to(dt))
    y = torch.matmul(wb.float(), hid.float()) + bb.float()[:, None]
    y = torch.relu(y.to(dt)).reshape(b, -1, h, w)
    return y if r is None else (r.float() + y.float()).to(dt)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("dec_mix")
    lib.mt_dec_mix.argtypes = [_P] * 9 + [_I64, _I64, _I64, _P]
    lib.mt_dec_mix.restype = ctypes.c_int
    return lib


def _check(x, mean, rstd, wa, vec, wb, bb, r) -> None:
    """Raise ValueError for anything the kernel does not take."""
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.shape[1] != C:
        raise ValueError(f"dec_mix: x must be contiguous bf16 (B, {C}, H, W), got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, hidden = x.shape[0], wa.shape[0]
    if not takes(C, hidden) or b >= 2**16 or x.data_ptr() % 16:
        raise ValueError(f"dec_mix: {hidden} hidden channels or batch {b} not taken, or x "
                         "not 16-byte aligned")
    checks = [("mean", mean, (b, C), torch.float32), ("rstd", rstd, (b, C), torch.float32),
              ("wa", wa, (hidden, C), torch.bfloat16), ("vec", vec, (b, hidden), torch.float32),
              ("wb", wb, (C, hidden), torch.bfloat16), ("bb", bb, (C,), torch.float32)]
    if r is not None:
        checks.append(("r", r, tuple(x.shape), torch.bfloat16))
    for name, t, shape, dtype in checks:  # TMA and 16-byte loads need wa, wb and r aligned
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous() \
                or t.device != x.device or (name in ("wa", "wb", "r") and t.data_ptr() % 16):
            raise ValueError(f"dec_mix: {name} must be contiguous {dtype} {shape} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"16-byte aligned for wa, wb and r")


def dec_mix(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, wa: torch.Tensor,
            vec: torch.Tensor, wb: torch.Tensor, bb: torch.Tensor,
            r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`dec_mix_plain` on the card, in one launch. Forward only: it
    raises where grad mode is on and any input needs a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, mean, rstd, wa, vec, wb, bb, r)):
        raise RuntimeError("dec_mix has no backward; call it under torch.inference_mode()")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dec_mix runs on CPU or CUDA tensors, not {x.device}")
    return library.call("dec_mix", x, mean, rstd, wa, vec, wb, bb, r)


def dec_mix_cuda(x, mean, rstd, wa, vec, wb, bb, r):
    """One launch of the kernel: :func:`dec_mix` on a CUDA tensor."""
    with profiling.span("mt.k.dec_mix"):
        _check(x, mean, rstd, wa, vec, wb, bb, r)
        b, c, h, w = x.shape
        p = h * w
        pp = -(-p // PIXELS) * PIXELS
        xs, rs = x.reshape(b, c, p), None if r is None else r.reshape(b, c, p)
        if pp != p:
            xs = F.pad(xs, (0, pp - p))
            rs = None if rs is None else F.pad(rs, (0, pp - p))
        out = torch.empty((b, c, pp), device=x.device, dtype=x.dtype)
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.mt_dec_mix(
                xs.data_ptr(), mean.data_ptr(), rstd.data_ptr(), wa.data_ptr(), vec.data_ptr(),
                wb.data_ptr(), bb.data_ptr(), None if rs is None else rs.data_ptr(),
                out.data_ptr(), b, pp, wa.shape[0], build.stream_of(x))
        build.check(lib, err, "dec_mix")
        dec_mix.launches += 1
        if pp != p:
            out = out[:, :, :p].contiguous()
        return out.reshape(b, c, h, w)


def _dec_mix_fake(x, mean, rstd, wa, vec, wb, bb, r):
    return x.new_empty((x.shape[0], wb.shape[0], x.shape[2], x.shape[3]))


dec_mix.launches = 0
library.register(
    "dec_mix", "(Tensor x, Tensor mean, Tensor rstd, Tensor wa, Tensor vec, Tensor wb, "
    "Tensor bb, Tensor? r) -> Tensor", dec_mix_plain, dec_mix_cuda, _dec_mix_fake)
