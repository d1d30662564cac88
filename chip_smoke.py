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
4. Builds AdaINModel with its own seeded init at 256px, dim 64, latent 8,
   4 domains, and in f32 and bf16 serves B=8 ``forward_random`` requests and
   one ``forward_reference`` with the launch counts set to 0 just before and
   read just after: every forward must launch the moments kernel 13 times and
   the AdaIN kernel 8 times. Outputs must be (8, 256, 256, 3), finite and in
   [-1, 1], and agree with the same forward through the plain versions on
   the card. Requests are timed in turns (plain, kernel, kernel, plain) and
   reported as img/s beside the card's name and power limit. A small model
   (32px, dim 8) on the card must agree with the same weights on the CPU,
   where the tests hold the port against the JAX package.
5. Last lines: the card, the ``{"kernels": [...]}`` line, then
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

from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import build
from masterthesis_tpu_torch.ops.kernels import moments as kmoments

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores, published
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


def bound(nbytes: int, flops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
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


def summarize(kernel, dtype_name, rows, replaces, source, library) -> dict:
    """Per-kernel, per-dtype entry; times are per forward: each shape's time
    per call times the calls a forward makes at that shape."""
    def per_forward(key):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * r["per_forward"] for r in rows)

    detail = dict(kernel=kernel, dtype=dtype_name, library=library, shapes=rows)
    log(detail)
    return dict(
        name=f"{kernel}/{dtype_name}", route="cuda", source=source, replaces=replaces,
        launches=None, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
        bound_ms=per_forward("bound_ms"), bound_by=rows[0]["bound_by"],
        library_ms=per_forward("library_ms"), per="forward at B=8, 256px, dim 64",
    )


@contextlib.contextmanager
def plain_kernels():
    """Route the norms through the plain versions (for comparison only)."""
    saved = kmoments.moments, kadain.adain
    kmoments.moments, kadain.adain = kmoments.moments_plain, kadain.adain_plain
    try:
        yield
    finally:
        kmoments.moments, kadain.adain = saved


def counts():
    return kmoments.moments.launches, kadain.adain.launches


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


def profile(dtype_name: str) -> None:
    """Device time by kernel over one forward_random (``--profile``)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    args = default_test_args(compute_dtype=compute_dtype(dtype_name), **ARGS)
    model = AdaINModel(args)
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
    log(dict(phase="profile", dtype=dtype_name, request_s=seconds, device_ms_total=total,
             device_idle_share=1.0 - total / (seconds * 1e3),
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
    for dtype_name in DTYPES:
        check_small_against_cpu(dtype_name)
    for dtype_name in DTYPES:
        m, a = serve(dtype_name, card)
        for e in entries:
            if e["name"] == f"moments/{dtype_name}":
                e["launches"] = m
            elif e["name"] == f"adain/{dtype_name}":
                e["launches"] = a
    if "--profile" in argv:
        for dtype_name in DTYPES:
            profile(dtype_name)
    for e in entries:
        assert e["launches"], f"{e['name']} was not launched on the main path"

    log(card)
    log({"kernels": entries})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
