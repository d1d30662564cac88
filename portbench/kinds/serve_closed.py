"""Closed-loop serving with one client: each request is one
``TranslationModel.forward_random`` of a batch from a pool staged on the
device, issued as soon as the previous one returned.

Traffic parameters (``traffic/<mix>.json``): ``batch`` images a request,
``pool`` distinct staged batches rotated through (sized so that the 50 MB L2
never serves a repeat), ``int8`` (calibrate the int8 serving path on
``calibration_batches`` seeded batches of ``calibration_batch`` images;
without ``int8`` those batches calibrate an int8 control only),
``flags`` (the compute dtype), ``warmup_requests``, ``checked_requests``
(how many requests of the window are compared with the reference: one
drawn from the seed per pool slot up to that count less one, and the
window's last), ``reference_bits`` (the arithmetic the reference computes
the program's answer in: null for float, 8 for int8), ``control_bits``
(the control's), ``ops_labels`` (the precision each kind of op runs in, for
``mfu.serve``), ``trace_seconds`` (the traced window's length) and
``check_block`` (images a reference call takes).

The request time is the benchmark's own clock from issue to return, and
``forward_random`` returns only after it synchronized the device.
"""
from __future__ import annotations

import random
import statistics
import time
from dataclasses import dataclass

from portbench import common
from portbench.reference import nets

NOT_FINITE = 1e30  # the number compared for an output that holds inf or nan


@dataclass
class State:
    model: object
    weights: dict
    pool: list
    calib: list


def setup(ctx, model=None) -> State:
    """The model with the seed's weights (calibrated for int8), the staged
    pool, and the warm-up requests."""
    import torch

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    f = cfg["flags"]
    if model is None:
        model = common.build_model(cfg, common.make_args(cfg, tr, "test"), ctx.device)
    weights = common.make_weights(model.nets, ctx.seed, ctx.device)
    model.load_params(weights)
    size, latent, domains = f["crop_size"], f["latent_dim"], f["num_domains"]
    gen = torch.Generator(device=ctx.device).manual_seed(common.sub_seed(ctx.seed, common.POOL))
    pool = [common.request_batch(gen, tr["batch"], size, latent, domains, ctx.device)
            for _ in range(tr["pool"])]
    # the calibration batches: the int8 path's, and an int8 control's
    cgen = torch.Generator(device=ctx.device).manual_seed(
        common.sub_seed(ctx.seed, common.CALIBRATION))
    calib = [common.request_batch(cgen, tr["calibration_batch"], size, latent, domains, ctx.device)
             for _ in range(tr.get("calibration_batches", 0))]
    if tr.get("int8"):
        model.calibrate_int8([b["img"] for b in calib], [b["c"] for b in calib],
                             [b["z"] for b in calib])
    for i in range(tr["warmup_requests"]):
        b = pool[i % len(pool)]
        model.forward_random(b["img"], b["z"], b["c"])
    return State(model, weights, pool, calib)


def checked_indices(seed: int, pool: int, count: int) -> list[int]:
    """Request numbers of the window whose outputs are kept for the check,
    besides the last: ``count - 1`` drawn from the seed among the first
    ``pool``, so that each is a different staged batch."""
    rng = random.Random(common.sub_seed(seed, common.SAMPLE))
    return sorted(rng.sample(range(pool), min(pool, count - 1)))


def window(state: State, seconds: float, keep: list[int], tracer=None):
    """Requests back to back for ``seconds``. Returns (latencies, start,
    end, kept outputs by request number: those of ``keep`` and the last)."""
    model, pool = state.model, state.pool
    lat, kept = [], {}
    start = time.perf_counter()
    end, i, out = start, 0, None
    while True:
        issue = time.perf_counter()
        if issue - start >= seconds and i > 0:
            break
        b = pool[i % len(pool)]
        if tracer is None:
            out, _, _ = model.forward_random(b["img"], b["z"], b["c"])
        else:
            with tracer.span("request"):
                out, _, _ = model.forward_random(b["img"], b["z"], b["c"])
        end = time.perf_counter()
        lat.append(end - issue)
        if i in keep:
            kept[i] = out
        i += 1
    kept[i - 1] = out
    return lat, start, end, kept


def image_rmse(got, want):
    """Root mean square difference of each image (NHWC), f32."""
    return (got.float() - want).square().mean(dim=(1, 2, 3)).sqrt()


def reference_answers(ctx, state: State, bits, requests, block: int):
    """The reference's outputs for the batches of ``requests`` (pool
    indices), in blocks of ``block`` images, at ``bits`` (None: float)."""
    import torch

    forward = common.reference(ctx.cell, "serve", ctx.root / "portbench").forward_random
    with nets.exact_f32(), torch.no_grad():
        amax = nets.calibrate(forward, state.weights, state.calib) if bits else None
        A = nets.Arith(bits=bits, amax=amax)
        for idx in requests:
            b = state.pool[idx % len(state.pool)]
            parts = [forward(state.weights, b["img"][s:s + block], b["z"][s:s + block],
                             b["c"][s:s + block], A)
                     for s in range(0, b["img"].shape[0], block)]
            yield idx, torch.cat(parts)


def worst_rmse(ctx, state: State, outputs: dict, bits, block: int) -> float:
    """The largest per-image RMS gap between ``outputs`` (request number ->
    NHWC images) and the reference at ``bits``."""
    import torch

    worst = 0.0
    shape = (ctx.cell.traffic["batch"], *state.pool[0]["img"].shape[1:])
    for idx, ref in reference_answers(ctx, state, bits, sorted(outputs), block):
        got = outputs[idx]
        if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
            return NOT_FINITE
        worst = max(worst, float(image_rmse(got, ref).max()))
    return worst


def run(ctx) -> dict:
    import torch

    tr = ctx.cell.traffic
    state = setup(ctx)
    common.plant(ctx, state.model)
    keep = checked_indices(ctx.seed, tr["pool"], tr["checked_requests"])
    if ctx.trace:
        from portbench.trace import Tracer

        tracer = Tracer(ctx.kernels, ctx.trace_path)
        setup_s = time.perf_counter() - ctx.t0
        seconds = min(ctx.seconds, tr["trace_seconds"])
        with tracer.device_window():
            lat, start, end, kept = window(state, seconds, keep, tracer)
        with tracer.kernel_window():
            window(state, seconds, [], tracer)
        summary = tracer.summary
        f = ctx.cell.config["flags"]
        summary.extra = {
            "host_s_to_sync": tracer.host_to_last_sync("request"),
            "ops_per_request": nets.serve_ops(
                common.reference(ctx.cell, "serve", ctx.root / "portbench").forward_random,
                state.weights, tr["batch"], f["crop_size"], f["latent_dim"], f["num_domains"],
                tr["ops_labels"]),
        }
    else:
        setup_s = time.perf_counter() - ctx.t0
        lat, start, end, kept = window(state, ctx.seconds, keep)
        summary = None
    peak = common.device_info(torch, ctx.cell.chips)["memory_peak_bytes"]
    e2e = {
        "serve_img_per_s": tr["batch"] * len(lat) / (end - start),
        "serve_p95_ms": 1e3 * (statistics.quantiles(lat, n=100)[94] if len(lat) > 1 else lat[0]),
        "setup_s": setup_s,
    }
    # the program's state is freed before the reference runs
    state.model = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    limit = ctx.cell.limits["worst_image_rmse"]
    value = worst_rmse(ctx, state, kept, tr["reference_bits"], tr["check_block"])
    return {
        "attempted": len(lat), "failed": 0, "e2e": e2e, "summary": summary,
        "memory_peak_bytes": peak,
        "compared": {"worst_image_rmse": {"value": value, "limit": limit}},
        "correct": value <= limit,
        "checked": sorted(kept),
    }
