#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA card and hold every kernel of it
against its plain PyTorch version.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown of one forward

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the TF32 settings, which it turns off: f32 here is full f32.
2. Builds every kernel from ``masterthesis_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once).
3. For each kernel, at the shapes AdaINModel's forward gives it (256px,
   dim 64, B=8), in f32 and bf16: the kernel's error against its plain
   version on the same inputs, with the tolerance stated, and its device
   time (CUDA events over back-to-back calls on inputs that, rotated, do not
   fit in L2) beside the plain version's, the library yardstick's where one
   PyTorch call computes the same function, and the bound (bytes over
   3.35 TB/s, or f32 operations over 67 TFLOP/s: the H100 SXM's published
   rates). One JSON line per kernel and dtype.
   The int8 kernels likewise, in f32 (the int8 path's compute dtype), at
   each shape of the int8 forward: the quantized operands and the int32
   sums must equal the plain version's exactly given the same input and
   prologue affine (the sums checked with unit scales, where the f32 output
   holds them exactly); then each wrapper's f32 output and statistics must
   equal the plain version's (the head's within 1e-5: its 1x1 sum runs in
   another order), beside its device time, the bound (the larger of 2 x MACs
   over the int8 tensor-core peak, 1,979 TOP/s, and bytes over 3.35 TB/s)
   and, for reference, cuDNN's bf16 float conv at the same shape (no single
   PyTorch call computes the int8 function, so ``library_ms`` is null).
4. Builds AdaINModel with its own seeded init at 256px, dim 64, latent 8,
   4 domains, and in f32 and bf16 serves B=8 ``forward_random`` requests and
   one ``forward_reference`` with the launch counts set to 0 just before and
   read just after: every forward must launch the moments kernel 13 times and
   the AdaIN kernel 8 times. Outputs must be (8, 256, 256, 3), finite and in
   [-1, 1], and agree with the same forward through the plain versions on
   the card. Requests are timed in turns (plain, kernel, kernel, plain) and
   reported as img/s beside the card's name and power limit. A small model
   (32px, dim 8) on the card must agree with the same weights on the CPU,
   where the tests hold the port against the JAX package, in float and int8.
5. ``int8_serve``: the same model calibrated on two seeded B=8 batches
   serves the same requests in int8, timed in turns with the float f32 model
   (float, int8, int8, float), with the counts set to 0 before and read
   after: every int8 forward launches 2 down convs, 8 resblocks, 2
   transposed convs, 1 head and 1 moments. Outputs must be (8, 256, 256, 3),
   finite, in [-1, 1], above 25 dB PSNR from the float forward, and within
   1e-5 of the same int8 forward through the plain versions (every int8
   operand and statistic equal; only the head's sum order differs).
6. Last lines: the card, the ``{"kernels": [...]}`` line, then
   ``{"ok": true, "device": {...}}``.

Nothing is caught: any failure ends the script with a non-zero exit and no
result line. Without a card it exits 1 before doing anything.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import build
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import moments as kmoments

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores, published
INT8_OPS = 1979e12  # H100 SXM, int8 tensor cores, dense, published
L2_BYTES = 50 * 2**20
B = 8
# (NCHW shape, launches per forward) on AdaINModel at 256px, dim 64, B=8
MOMENTS_SHAPES = [
    ((B, 64, 256, 256), 2),  # stem instance norm, up1 layer norm
    ((B, 128, 128, 128), 2),  # down0 instance norm, up0 layer norm
    ((B, 256, 64, 64), 9),  # down1 instance norm, 8 encoder resblock norms
]
ADAIN_SHAPES = [((B, 256, 64, 64), 8)]  # 2 per decoder resblock
MOMENTS_PER_FORWARD = sum(n for _, n in MOMENTS_SHAPES)
ADAIN_PER_FORWARD = sum(n for _, n in ADAIN_SHAPES)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ARGS = dict(crop_size=256, dim=64, latent_dim=8, num_domains=4, batch_size=B, seed=0)
SMALL_ARGS = dict(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=2, seed=0)
# model outputs are tanh values: f32 kernel vs plain sums in another order;
# bf16 a few bf16 rounding steps carried through the net
MODEL_TOL = {"f32": 1e-3, "bf16": 5e-2}
CPU_TOL = {"f32": 1e-4, "bf16": 5e-2}
# int8 shapes on AdaINModel at 256px, dim 64, B=8: (NCHW input, Co, per forward)
DOWN_SHAPES = [((B, 64, 256, 256), 128, 1), ((B, 128, 128, 128), 256, 1)]
RES_SHAPES = [((B, 256, 64, 64), 256, 8)]  # 4 encoder blocks, 4 AdaIN blocks
DECONV_SHAPES = [((B, 256, 64, 64), 128, 1), ((B, 128, 128, 128), 64, 1)]
HEAD_SHAPES = [((B, 64, 256, 256), 3, 1)]
INT8_PER_FORWARD = {"int8_downconv": 2, "int8_resblock": 8, "int8_deconv": 2, "head": 1,
                    "moments": 1}
# The int8 chain on the card against the CPU: the float stem conv and the
# style projection sum in another order there (cuDNN/cuBLAS against the
# CPU's), so an int8 value at a rounding boundary can flip; bound the share
# of outputs that move and the largest move (tests/test_torch_int8.py states
# the same bounds against the JAX package). Kernel against plain version on
# the card: every int8 operand and statistic is equal, so only the head's
# 1x1 sum over C, in another order, differs.
FLIP_SHARE, FLIP_MAX = 0.05, 2e-2
HEAD_TOL = 1e-5
PSNR_MIN_DB = 25.0  # the JAX package's own bar, tests/test_int8_serving.py


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, arg_sets, iters: int = 30) -> float:
    """Device time per call: CUDA events around ``iters`` back-to-back calls,
    rotating over ``arg_sets``. A sleep kernel queued first keeps the card
    busy while the host enqueues, so host overhead leaves no gaps."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies(make, nbytes: int):
    """Enough input sets that rotating over them does not run from L2."""
    return [make(i) for i in range(max(2, math.ceil(3 * L2_BYTES / nbytes)))]


def bound(nbytes: int, flops: int, peak: float = F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _randn(shape, dtype, seed, scale=1.0, offset=0.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * scale + offset
    return x.to(dtype)


def check_moments(name: str, dtype: torch.dtype) -> dict:
    rows = []
    for shape, per_forward in MOMENTS_SHAPES:
        numel = math.prod(shape)
        nbytes = numel * dtype.itemsize
        sets = copies(lambda i: (_randn(shape, dtype, i, 2.0, 0.5),), nbytes)
        x = sets[0][0]
        s, sq = kmoments.moments(x)
        ps, psq = kmoments.moments_plain(x)
        torch.cuda.synchronize()
        n = shape[2] * shape[3]
        # error of what the norms consume, sum/n and sumsq/n; tolerance: a
        # few f32 ulps of the mean magnitude, as sums run in another order
        err = max((s - ps).abs().max().item(), (sq - psq).abs().max().item()) / n
        tol = 2e-5 * max(x.float().abs().mean().item(), x.float().square().mean().item())
        assert err <= tol, f"moments {name} {shape}: error {err} > {tol}"
        b_ms, by = bound(nbytes + 2 * shape[0] * shape[1] * 4, 3 * numel)
        rows.append(dict(
            shape=list(shape), per_forward=per_forward, max_abs_err=err, tol=tol,
            ms=device_ms(kmoments.moments, sets),
            plain_ms=device_ms(kmoments.moments_plain, sets),
            library_ms=device_ms(lambda t: torch.var_mean(t, dim=(2, 3), unbiased=False), sets),
            bound_ms=b_ms, bound_by=by,
        ))
    return summarize("moments", name, rows, "masterthesis_tpu/ops/pallas/moments.py:80",
                     "masterthesis_tpu_torch/csrc/moments.cu",
                     "torch.var_mean(x, dim=(2, 3), unbiased=False)")


def check_adain(name: str, dtype: torch.dtype) -> dict:
    rows = []
    for shape, per_forward in ADAIN_SHAPES:
        numel = math.prod(shape)
        nbytes = numel * dtype.itemsize
        bc = shape[:2]
        sets = copies(lambda i: (
            _randn(shape, dtype, 3 * i, 2.0, 0.5),
            _randn(bc, torch.float32, 3 * i + 1, 0.3),
            _randn(bc, torch.float32, 3 * i + 2, 0.3),
        ), nbytes)
        out = kadain.adain(*sets[0])
        ref = kadain.adain_plain(*sets[0])
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # f32: O(1) outputs, statistics summed in another order; bf16: one
        # rounding step of the output either way (|d| <= 1e-2 + 1e-2 |ref|)
        if dtype == torch.float32:
            tol, ok = 1e-4, err <= 1e-4
        else:
            tol = "1e-2 + 1e-2*|ref|"
            ok = bool(((out.float() - ref.float()).abs() <= 1e-2 + 1e-2 * ref.float().abs()).all())
        assert ok, f"adain {name} {shape}: error {err} > {tol}"
        b_ms, by = bound(2 * nbytes + 2 * bc[0] * bc[1] * 4, 6 * numel)
        rows.append(dict(
            shape=list(shape), per_forward=per_forward, max_abs_err=err, tol=tol,
            ms=device_ms(kadain.adain, sets),
            plain_ms=device_ms(kadain.adain_plain, sets),
            library_ms=None,  # no single PyTorch call computes AdaIN
            bound_ms=b_ms, bound_by=by,
        ))
    return summarize("adain", name, rows, "masterthesis_tpu/ops/pallas/adain.py:80",
                     "masterthesis_tpu_torch/csrc/adain.cu", None)


def summarize(kernel, dtype_name, rows, replaces, source, library, name=None) -> dict:
    """Per-kernel, per-dtype entry; times are per forward: each shape's time
    per call times the calls a forward makes at that shape."""
    def per_forward(key):
        if any(r.get(key) is None for r in rows):
            return None
        return sum(r[key] * r["per_forward"] for r in rows)

    detail = dict(kernel=kernel, dtype=dtype_name, library=library, shapes=rows)
    log(detail)
    entry = dict(
        name=name or f"{kernel}/{dtype_name}", route="cuda", source=source, replaces=replaces,
        launches=None, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
        bound_ms=per_forward("bound_ms"), bound_by=rows[0]["bound_by"],
        library_ms=per_forward("library_ms"), per="forward at B=8, 256px, dim 64",
    )
    if "bf16_cudnn_ms" in rows[0]:
        entry["bf16_cudnn_ms"] = per_forward("bf16_cudnn_ms")
    return entry


# ------------------------------------------------------------ int8 kernels --


def _check_exact(x, qc, pending) -> dict:
    """The kernel's int8 operands and int32 sums against the plain version's,
    on the same input and prologue affine: equal, or the script fails."""
    xq, xq_plain = kq.quant_pad_cuda(x, qc, pending), kq.quant_pad_plain(x, qc, pending)
    torch.cuda.synchronize()
    assert torch.equal(xq, xq_plain), "int8 operands differ from the plain version's"
    unit = kq.with_unit_scale(qc)
    acc, acc_plain = kq.conv_padded_cuda(xq, unit), kq.conv_padded_plain(xq_plain, unit)
    top = acc_plain.abs().max().item()
    assert top < 2**24, "the unit-scale check needs sums that f32 holds exactly"
    assert torch.equal(acc, acc_plain), "int32 sums differ from the plain version's"
    return dict(int8_operands_equal=True, int32_sums_equal=True, max_abs_sum=top)


def _card_pending(b, c, seed, alpha):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"scale": torch.rand((b, c), generator=g, device="cuda") + 0.5,
            "shift": torch.randn((b, c), generator=g, device="cuda") * 0.3,
            "relu": True, "alpha": alpha}


def _card_weight(shape, seed, scale=0.05):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda") * scale


def check_int8_conv(kind: str) -> dict:
    """Kernel 7 (``kind`` "down") or kernel 5 ("deconv") at the forward's shapes."""
    down = kind == "down"
    shapes, wrapper = (DOWN_SHAPES, kq.downconv) if down else (DECONV_SHAPES, kq.deconv)
    rows = []
    for i, (shape, co, per_forward) in enumerate(shapes):
        b, c, h, w = shape
        numel = math.prod(shape)
        sets = copies(lambda j: (_randn(shape, torch.float32, 100 + 10 * i + j),), 4 * numel)
        x = sets[0][0]
        # down0 takes the stem's IN + lrelu, down1 down0's IN + relu; up0
        # has no prologue, up1 takes up0's LayerNorm + relu
        pending = None if (not down and i == 0) else _card_pending(b, c, 200 + i, 0.01 if down and i == 0 else 0.0)
        amax = kq.prologue_plain(x, pending).abs().amax()
        wshape = (co, c, 3, 3) if down else (c, co, 3, 3)
        weight, bias = _card_weight(wshape, 300 + i), _card_weight((co,), 400 + i, 0.1)
        qc = kq.quant_conv(weight, bias, amax, 2, "reflect") if down else kq.quant_deconv(weight, bias, amax)
        exact = _check_exact(x, qc, pending)
        y, s1, s2 = wrapper(x, qc, pending, with_stats=True)
        ry, rs1, rs2 = kq.conv_plain(x, qc, pending, True)
        torch.cuda.synchronize()
        err = (y - ry).abs().max().item()
        assert err == 0.0, f"{kind} {shape}: output differs from the plain version's by {err}"
        assert torch.equal(s1, rs1) and torch.equal(s2, rs2), f"{kind} {shape}: statistics differ"
        out_numel = y.numel()
        macs = b * c * co * 9 * (h * w if not down else (h // 2) * (w // 2))
        nbytes = 4 * (numel + out_numel) + qc.w.numel() + 8 * b * co + (8 * b * c if pending else 0)
        b_ms, by = bound(nbytes, 2 * macs, INT8_OPS)
        wb = weight.bfloat16()
        bf_sets = [(t[0].bfloat16(),) for t in sets]
        cudnn = ((lambda t: F.conv2d(t, wb, None, 2, 1)) if down
                 else (lambda t: F.conv_transpose2d(t, wb, None, 2, 1, 1)))
        rows.append(dict(
            shape=list(shape), co=co, per_forward=per_forward, prologue=pending is not None,
            **exact, max_abs_err=err, tol=0.0, stats_equal=True,
            macs=macs, ms=device_ms(lambda t: wrapper(t, qc, pending, with_stats=True), sets),
            plain_ms=device_ms(lambda t: kq.conv_plain(t, qc, pending, True), sets, iters=5),
            bf16_cudnn_ms=device_ms(cudnn, bf_sets), library_ms=None,
            bound_ms=b_ms, bound_by=by,
        ))
    if down:
        return summarize("int8_downconv", "f32", rows, "masterthesis_tpu/ops/pallas/conv_int8.py:1303",
                         "masterthesis_tpu_torch/csrc/int8_conv.cu", None, name="int8_downconv")
    return summarize("int8_deconv", "f32", rows, "masterthesis_tpu/ops/pallas/conv_int8.py:577",
                     "masterthesis_tpu_torch/csrc/int8_conv.cu", None, name="int8_deconv")


def _flips(out, ref) -> tuple[float, float]:
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), (diff > 1e-4).float().mean().item()


def check_int8_resblock() -> dict:
    """Kernel 6 at the forward's shape, with random (1 + gamma, beta)."""
    rows = []
    for i, (shape, co, per_forward) in enumerate(RES_SHAPES):
        b, c, h, w = shape
        numel = math.prod(shape)
        sets = copies(lambda j: (_randn(shape, torch.float32, 500 + 10 * i + j),), 4 * numel)
        x = sets[0][0]
        gamma, beta = _card_weight((b, c), 600, 0.3), _card_weight((b, c), 601, 0.3)
        w1, w2 = _card_weight((c, c, 3, 3), 602), _card_weight((c, c, 3, 3), 603)
        q1 = kq.quant_conv(w1, None, x.abs().amax(), 1, "reflect")
        exact1 = _check_exact(x, q1, None)
        # conv2's operands, fed the plain version's prologue affine
        h1, s1, sq1 = kq.conv_plain(x, q1, None, True)
        a1, b1 = kq.norm_affine_plain(s1, sq1, h * w, gamma, beta)
        mid = {"scale": a1, "shift": b1, "relu": True, "alpha": 0.0}
        q2 = kq.quant_conv(w2, None, kq.prologue_plain(h1, mid).abs().amax(), 1, "reflect")
        exact2 = _check_exact(h1, q2, mid)
        y = kq.resblock(x, q1, q2, gamma, beta)
        ref = kq.resblock_plain(x, q1, q2, gamma, beta)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        assert err == 0.0, f"resblock {shape}: output differs from the plain version's by {err}"

        macs = 2 * b * h * w * c * co * 9
        nbytes = 8 * numel + q1.w.numel() + q2.w.numel() + 8 * b * c
        b_ms, by = bound(nbytes, 2 * macs, INT8_OPS)
        w1b, w2b = w1.bfloat16(), w2.bfloat16()
        bf_sets = [(t[0].bfloat16(),) for t in sets]
        rows.append(dict(
            shape=list(shape), co=co, per_forward=per_forward,
            conv1=exact1, conv2=exact2, max_abs_err=err, tol=0.0, macs=macs,
            ms=device_ms(lambda t: kq.resblock(t, q1, q2, gamma, beta), sets),
            plain_ms=device_ms(lambda t: kq.resblock_plain(t, q1, q2, gamma, beta), sets, iters=5),
            bf16_cudnn_ms=device_ms(
                lambda t: F.conv2d(F.conv2d(t, w1b, None, 1, 1), w2b, None, 1, 1), bf_sets),
            library_ms=None, bound_ms=b_ms, bound_by=by,
            cuda_launches_per_call=7,
        ))
    return summarize("int8_resblock", "f32", rows, "masterthesis_tpu/ops/pallas/conv_int8.py:989",
                     "masterthesis_tpu_torch/csrc/int8_conv.cu", None, name="int8_resblock")


def check_head() -> dict:
    """Kernel 8 at the forward's shape."""
    rows = []
    for i, (shape, co, per_forward) in enumerate(HEAD_SHAPES):
        b, c, h, w = shape
        numel = math.prod(shape)
        sets = copies(lambda j: (_randn(shape, torch.float32, 700 + 10 * i + j),), 4 * numel)
        pending = _card_pending(b, c, 800 + i, 0.0)
        weight = _card_weight((co, c), 801 + i, 0.1)
        y = khead.head(sets[0][0], pending, weight)
        ref = khead.head_plain(sets[0][0], pending, weight)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        assert err <= HEAD_TOL, f"head {shape}: error {err} > {HEAD_TOL}"
        macs = b * h * w * c * co
        b_ms, by = bound(4 * (numel + b * co * h * w) + 8 * b * c + 4 * co * c, 2 * macs)
        wb = weight.bfloat16()[:, :, None, None]
        bf_sets = [(t[0].bfloat16(),) for t in sets]
        rows.append(dict(
            shape=list(shape), co=co, per_forward=per_forward, max_abs_err=err, tol=HEAD_TOL,
            macs=macs, ms=device_ms(lambda t: khead.head(t, pending, weight), sets),
            plain_ms=device_ms(lambda t: khead.head_plain(t, pending, weight), sets),
            bf16_cudnn_ms=device_ms(lambda t: torch.tanh(F.conv2d(t, wb)), bf_sets),
            library_ms=None, bound_ms=b_ms, bound_by=by,
        ))
    return summarize("head", "f32", rows, "masterthesis_tpu/ops/pallas/conv_int8.py:1429",
                     "masterthesis_tpu_torch/csrc/head.cu", None, name="head")


PLAIN = [
    (kmoments, "moments", kmoments.moments_plain), (kadain, "adain", kadain.adain_plain),
    (kq, "downconv", kq.conv_plain), (kq, "deconv", kq.conv_plain),
    (kq, "resblock", kq.resblock_plain), (khead, "head", khead.head_plain),
]


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version (for comparison only)."""
    saved = [getattr(module, name) for module, name, _ in PLAIN]
    for module, name, plain in PLAIN:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(PLAIN, saved):
            setattr(module, name, fn)


def counts():
    return kmoments.moments.launches, kadain.adain.launches


def int8_counts() -> dict:
    return {"int8_downconv": kq.downconv.launches, "int8_resblock": kq.resblock.launches,
            "int8_deconv": kq.deconv.launches, "head": khead.head.launches,
            "moments": kmoments.moments.launches}


def zero_counts() -> None:
    for module, name, _ in PLAIN:
        getattr(module, name).launches = 0


def request_inputs(args, seed):
    rng = np.random.default_rng(seed)
    size, k = args["crop_size"], args["num_domains"]
    b = args["batch_size"]
    host = dict(
        img=rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
        ref=rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
        z=rng.standard_normal((b, args["latent_dim"])).astype(np.float32),
        c=np.eye(k, dtype=np.float32)[rng.integers(0, k, b)],
    )
    return host, {k_: torch.from_numpy(v).cuda() for k_, v in host.items()}


def compute_dtype(dtype_name: str) -> str:
    return {"f32": "float32", "bf16": "bfloat16"}[dtype_name]


def check_image(out, shape, what):
    assert tuple(out.shape) == shape, f"{what}: shape {tuple(out.shape)} != {shape}"
    assert torch.isfinite(out).all(), f"{what}: non-finite output"
    lo, hi = out.min().item(), out.max().item()
    assert -1.0 <= lo and hi <= 1.0, f"{what}: output outside [-1, 1]: [{lo}, {hi}]"


def check_small_against_cpu(dtype_name: str) -> None:
    args = default_test_args(compute_dtype=compute_dtype(dtype_name), **SMALL_ARGS)
    host, dev = request_inputs(SMALL_ARGS, seed=7)
    on_card, _, _ = AdaINModel(args).forward_random(dev["img"], dev["z"], dev["c"])
    on_cpu, _, _ = AdaINModel(args, device="cpu").forward_random(host["img"], host["z"], host["c"])
    err = (on_card.float().cpu() - on_cpu.float()).abs().max().item()
    log(dict(phase="card_vs_cpu", dtype=dtype_name, shape=list(on_cpu.shape),
             max_abs_err=err, tol=CPU_TOL[dtype_name]))
    assert err <= CPU_TOL[dtype_name], f"card vs CPU {dtype_name}: {err}"


def calibration_batches(args, seeds=(11, 12)):
    """Seeded B=8 calibration batches: (images, targets, styles) on the card."""
    batches = [request_inputs(args, seed)[1] for seed in seeds]
    return [b["img"] for b in batches], [b["c"] for b in batches], [b["z"] for b in batches]


def check_small_int8_against_cpu() -> None:
    """One amax tree, calibrated on the CPU, on both devices."""
    args = default_test_args(**SMALL_ARGS)
    host, dev = request_inputs(SMALL_ARGS, seed=7)
    on_cpu = AdaINModel(args, device="cpu")
    quant = on_cpu.calibrate_int8([host["img"]], [host["c"]], [host["z"]])
    on_card = AdaINModel(args)
    on_card.load_int8(quant)
    out, _, _ = on_card.forward_random(dev["img"], dev["z"], dev["c"])
    ref, _, _ = on_cpu.forward_random(host["img"], host["z"], host["c"])
    err, share = _flips(out.cpu(), ref)
    log(dict(phase="card_vs_cpu", dtype="int8", shape=list(ref.shape), max_abs_err=err,
             share_differing=share, tol=dict(max=FLIP_MAX, share=FLIP_SHARE)))
    assert err <= FLIP_MAX and share <= FLIP_SHARE, f"int8 card vs CPU: {err}, {share}"


def int8_serve(card: str) -> dict:
    """The int8 main path: calibrate, then serve the ``serve`` requests in
    turns with the float f32 model of the same weights. Returns the int8
    kernels' launches over the int8 forwards."""
    args = default_test_args(compute_dtype="float32", **ARGS)
    model_f, model_q = AdaINModel(args), AdaINModel(args)  # the same seeded weights
    _, dev = request_inputs(ARGS, seed=1)
    shape = (B, ARGS["crop_size"], ARGS["crop_size"], 3)
    t0 = time.perf_counter()
    quant = model_q.calibrate_int8(*calibration_batches(ARGS))
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0

    zero_counts()
    launched = dict.fromkeys(INT8_PER_FORWARD, 0)

    def checked(fn, *a, **kw):
        before = int8_counts()
        out = fn(*a, **kw)
        delta = {k: v - before[k] for k, v in int8_counts().items()}
        assert delta == INT8_PER_FORWARD, f"int8 launches per forward {delta}"
        for k, v in delta.items():
            launched[k] += v
        return out

    def int8_request():
        return checked(model_q.forward_random, dev["img"], dev["z"], dev["c"])

    def float_request():
        return model_f.forward_random(dev["img"], dev["z"], dev["c"])

    int8_request()  # warm-up: quantizes the weights, cuDNN picks its algorithms
    float_request()
    secs = {"int8": [], "float": []}
    outs = {}
    for kind in ("float", "int8", "int8", "float"):
        for _ in range(3):
            out, seconds, mem = int8_request() if kind == "int8" else float_request()
            secs[kind].append(seconds)
            outs[kind] = out
    gen = torch.Generator(device="cuda").manual_seed(2)
    ref_out, ref_s, _ = checked(model_q.forward_reference, dev["img"], dev["ref"], dev["c"],
                                generator=gen)
    with plain_kernels():
        plain_out, plain_s, _ = model_q.forward_random(dev["img"], dev["z"], dev["c"])

    for what, out in (("int8", outs["int8"]), ("float", outs["float"]), ("plain", plain_out)):
        check_image(out, shape, f"int8 forward_random {what}")
    check_image(ref_out, shape, "int8 forward_reference")
    mse = (outs["int8"] - outs["float"]).square().mean().item()
    psnr = 10 * math.log10(4.0 / max(mse, 1e-12))
    assert psnr > PSNR_MIN_DB, f"int8 vs float PSNR {psnr} dB"
    err, share = _flips(outs["int8"], plain_out)
    assert err <= HEAD_TOL, f"int8 kernels vs plain: max {err}, share {share}"
    log(dict(
        phase="int8_serve", card=card, batch=B, requests=len(secs["int8"]) + 2,
        img_per_s=B * len(secs["int8"]) / sum(secs["int8"]),
        img_per_s_float_f32=B * len(secs["float"]) / sum(secs["float"]),
        request_s=secs["int8"], request_s_float_f32=secs["float"],
        reference_request_s=ref_s, plain_request_s=plain_s, calibrate_s=calibrate_s,
        calibration_batches=2, amax_leaves={k: len(v) for k, v in quant.items()},
        memory_reserved_gb=mem, psnr_vs_float_db=psnr, psnr_min_db=PSNR_MIN_DB,
        max_abs_err_vs_plain=err, share_differing_vs_plain=share,
        tol=HEAD_TOL, launches=launched, per_forward=INT8_PER_FORWARD,
    ))
    return launched


def serve(dtype_name: str, card: str) -> tuple[int, int]:
    """The main path in one dtype; returns its (moments, adain) launch counts."""
    args = default_test_args(compute_dtype=compute_dtype(dtype_name), **ARGS)
    model = AdaINModel(args)
    _, dev = request_inputs(ARGS, seed=1)
    shape = (B, ARGS["crop_size"], ARGS["crop_size"], 3)

    def kernel_request():
        before = counts()
        out, seconds, mem = model.forward_random(dev["img"], dev["z"], dev["c"])
        after = counts()
        assert (after[0] - before[0], after[1] - before[1]) == (
            MOMENTS_PER_FORWARD, ADAIN_PER_FORWARD
        ), f"launches per forward {after[0] - before[0]}, {after[1] - before[1]}"
        return out, seconds, mem

    def plain_request():
        with plain_kernels():
            return model.forward_random(dev["img"], dev["z"], dev["c"])

    kmoments.moments.launches = 0
    kadain.adain.launches = 0
    kernel_request()  # warm-up: cuDNN picks its algorithms
    plain_request()
    secs = {"kernel": [], "plain": []}
    outs = {}
    for kind in ("plain", "kernel", "kernel", "plain"):
        for _ in range(3):
            out, seconds, mem = kernel_request() if kind == "kernel" else plain_request()
            secs[kind].append(seconds)
            outs[kind] = out
    before = counts()
    gen = torch.Generator(device="cuda").manual_seed(2)
    ref_out, ref_s, _ = model.forward_reference(dev["img"], dev["ref"], dev["c"], generator=gen)
    launches = counts()  # the whole run: warm-up, 6 random requests, 1 reference
    assert (launches[0] - before[0], launches[1] - before[1]) == (
        MOMENTS_PER_FORWARD, ADAIN_PER_FORWARD
    )

    for kind, out in outs.items():
        check_image(out, shape, f"forward_random {dtype_name} {kind}")
    check_image(ref_out, shape, f"forward_reference {dtype_name}")
    err = (outs["kernel"].float() - outs["plain"].float()).abs().max().item()
    assert err <= MODEL_TOL[dtype_name], f"kernels vs plain {dtype_name}: {err}"
    log(dict(
        phase="serve", dtype=dtype_name, card=card, batch=B, requests=len(secs["kernel"]) + 2,
        img_per_s=B * len(secs["kernel"]) / sum(secs["kernel"]),
        img_per_s_plain=B * len(secs["plain"]) / sum(secs["plain"]),
        request_s=secs["kernel"], request_s_plain=secs["plain"],
        reference_request_s=ref_s, memory_reserved_gb=mem,
        max_abs_err_vs_plain=err, tol=MODEL_TOL[dtype_name],
        launches=dict(moments=launches[0], adain=launches[1]),
        per_forward=dict(moments=MOMENTS_PER_FORWARD, adain=ADAIN_PER_FORWARD),
    ))
    return launches


def profile(dtype_name: str, int8: bool = False) -> None:
    """Device time by kernel over one forward_random (``--profile``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    args = default_test_args(compute_dtype=compute_dtype(dtype_name), **ARGS)
    model = AdaINModel(args)
    if int8:
        model.calibrate_int8(*calibration_batches(ARGS))
    _, dev = request_inputs(ARGS, seed=1)
    model.forward_random(dev["img"], dev["z"], dev["c"])
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds, _ = model.forward_random(dev["img"], dev["z"], dev["c"])
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows[e.key] = rows.get(e.key, 0.0) + us / 1e3
    total = sum(rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:15]
    # one stream, so kernel times do not overlap; the profiler's own host
    # overhead lengthens request_s, so the idle share is an upper bound
    log(dict(phase="profile", dtype="int8" if int8 else dtype_name, request_s=seconds,
             device_ms_total=total, device_idle_share=1.0 - total / (seconds * 1e3),
             top_kernels_ms=[[k[:90], v] for k, v in top]))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(card)
    log(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
             device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
             cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
             matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
             cudnn_benchmark=torch.backends.cudnn.benchmark))

    t0 = time.perf_counter()
    logs = build.build()
    log(dict(phase="build", seconds=time.perf_counter() - t0, built=sorted(logs)))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    entries = []
    for dtype_name, dtype in DTYPES.items():
        entries.append(check_moments(dtype_name, dtype))
        entries.append(check_adain(dtype_name, dtype))
    int8_entries = [check_int8_conv("down"), check_int8_resblock(), check_int8_conv("deconv"),
                    check_head()]
    torch.cuda.empty_cache()
    for dtype_name in DTYPES:
        check_small_against_cpu(dtype_name)
    check_small_int8_against_cpu()
    for dtype_name in DTYPES:
        m, a = serve(dtype_name, card)
        for e in entries:
            if e["name"] == f"moments/{dtype_name}":
                e["launches"] = m
            elif e["name"] == f"adain/{dtype_name}":
                e["launches"] = a
    launched = int8_serve(card)
    for e in int8_entries:
        e["launches"] = launched[e["name"]]
    entries += int8_entries
    if "--profile" in argv:
        for dtype_name in DTYPES:
            profile(dtype_name)
        profile("f32", int8=True)
    for e in entries:
        assert e["launches"], f"{e['name']} was not launched on the main path"

    log(card)
    log({"kernels": entries})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
