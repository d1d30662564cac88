"""Training on the model's own schedule: ``optimize_parameters(batch,
global_iter, draws)`` back to back from ``global_iter`` 1, so that with
``d_iter`` d the iterations run d - 1 content-discriminator steps for each
main step.

Traffic parameters (``traffic/<mix>.json``): ``flags`` (the training flags:
GAN step, content discriminator, ``d_iter``, compute dtype, batch size, the
images of each side), ``pool`` distinct batches staged on the device and
rotated through, ``checked_steps`` (the first iterations, whose losses,
Adam moments and parameter changes are held against the reference),
``warmup_iterations`` (after those), ``trace_seconds``, and
``loss_floor`` (the magnitude below which a loss's gap is taken against the
floor instead of the loss).

Set-up builds one model, loads the seed's weights and drives it through the
checked steps with draws the benchmark made from the seed, through the same
call and feed as the window; the window's draws come from a seeded
generator on the device.
"""
from __future__ import annotations

import statistics
import time

from portbench import common

NOT_FINITE = 1e30


def make_batch(gen, b: int, size: int, domains: int, device) -> dict:
    import torch
    import torch.nn.functional as F

    out = {}
    for side in ("1", "2"):
        out[f"x{side}"] = common.smooth_images(gen, b, size, device)
        out[f"y{side}"] = F.one_hot(torch.randint(0, domains, (b,), generator=gen, device=device),
                                    domains).float()
    return out


def reference(ctx):
    """The cell's training reference: ``Step`` and ``draw_shapes``."""
    return common.reference(ctx.cell, "train", ctx.root / "portbench")


def make_draws(shapes: dict, gen, device) -> dict:
    import torch

    return {k: torch.randn(s, generator=gen, device=device) for k, s in shapes.items()}


class Capture:
    """Each net's Adam first moment after its first update, read by wrapping
    the program's optimizer step for the checked steps only."""

    def __init__(self, model):
        from masterthesis_tpu_torch.models import translation

        self.module, self.model = translation, model
        self.first_mu: dict = {}
        self.orig = translation.apply_updates

    def __enter__(self):
        names = {id(s): n for n, s in self.model.state.opt_state.items()}
        keys = {n: [k for k, _ in net.named_parameters()] for n, net in self.model.nets.items()}

        def apply_updates(params, grads, state, lr, **kw):
            self.orig(params, grads, state, lr, **kw)
            name = names.get(id(state))
            if name is not None and state.count == 1:
                self.first_mu[name] = {k: m.detach().clone() for k, m in zip(keys[name], state.mu)}

        self.module.apply_updates = apply_updates
        return self

    def __exit__(self, *exc):
        self.module.apply_updates = self.orig


def _floats(logs: dict) -> dict:
    return {k: float(v) for k, v in logs.items() if k != "lr"}


def leaf_gaps(prog: dict, want: dict, keep) -> dict:
    """Each leaf's gap of norms, |‖prog‖ - ‖want‖|, over the larger of the
    leaf's reference norm and the median leaf's, for the leaves of ``keep``;
    a leaf that is not finite in ``prog`` reads :data:`NOT_FINITE`."""
    norms = {k: float(want[k].norm()) for k in keep}
    if not norms:
        return {}
    median = statistics.median(norms.values())
    out = {}
    for k in keep:
        got = float(prog[k].float().norm()) if k in prog else float("nan")
        finite = got == got and abs(got) != float("inf")
        out[k] = abs(got - norms[k]) / max(norms[k], median, 1e-30) if finite else NOT_FINITE
    return out


def setup(ctx):
    import torch

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    f = {**cfg["flags"], **tr["flags"]}
    model = common.build_model(cfg, common.make_args(cfg, tr, "train"), ctx.device)
    weights = common.make_weights(model.nets, ctx.seed, ctx.device)
    model.load_params(weights)
    b, size = f["batch_size"], f["crop_size"]
    gen = torch.Generator(device=ctx.device).manual_seed(common.sub_seed(ctx.seed, common.POOL))
    pool = [make_batch(gen, b, size, f["num_domains"], ctx.device) for _ in range(tr["pool"])]
    code = model.nets.content_encoder.code_shape((b, f["input_dim"], size, size))
    dgen = torch.Generator(device=ctx.device).manual_seed(common.sub_seed(ctx.seed, common.DRAWS))
    shapes = reference(ctx).draw_shapes(b, f["latent_dim"], code)
    checked = [make_draws(shapes, dgen, ctx.device) for _ in range(tr["checked_steps"])]
    return model, weights, pool, checked, dgen


def iterate(model, pool, it: int, draws):
    from masterthesis_tpu_torch.models.translation import StepDraws

    return model.optimize_parameters(pool[(it - 1) % len(pool)], it, StepDraws(**draws)
                                     if isinstance(draws, dict) else StepDraws(draws))


def checked_steps(ctx, model, pool, checked):
    """The first iterations through the window's call, with the benchmark's
    draws: their losses and each net's first Adam moment."""
    logs = []
    with Capture(model) as cap:
        for i, draws in enumerate(checked, start=1):
            logs.append(_floats(iterate(model, pool, i, draws)))
    return logs, cap.first_mu


def reference_readings(ctx, weights, pool, checked, A=None):
    """The reference's losses, first Adam moments and parameters after the
    checked steps, from the same weights, batches and draws."""
    import numpy as np
    import torch

    from portbench.reference.nets import Arith, exact_f32

    d_iter = ctx.cell.traffic["flags"]["d_iter"]
    with exact_f32():
        step = reference(ctx).Step(weights, A or Arith(), lr=float(np.float32(1e-4)))
        logs = []
        for i, draws in enumerate(checked, start=1):
            batch = pool[(i - 1) % len(pool)]
            run = step.content_step if i % d_iter else step.main_step
            logs.append(_floats(run(batch, draws)))
    return logs, step


def compare(tr, prog_logs, prog_mu, prog_params, weights, ref_logs, step) -> dict:
    """The numbers compared (``loss_gap``, ``grad_gap``, ``update_gap``) and
    the ones beside them that are read but not compared (PERF.md says why).

    - ``loss_gap``: the mean over every logged loss of the checked steps of
      |program - reference| / max(|reference|, ``loss_floor``);
    - ``grad_gap``: the worst leaf's gap of norms of the first gradient as
      Adam holds it after each net's first update (its first moment): the
      one number that sees a gradient's magnitude, which Adam's update
      (about lr sign(g) at its first step) does not pass on;
    - ``update_gap``: the worst leaf's gap of norms of the parameters' change
      over the checked steps.

    Leaves whose gradient at the reference's first update is under a
    thousandth of the median leaf's (a bias before an instance norm) are
    left out of both leaf numbers."""
    floor = tr["loss_floor"]
    losses = []
    for p, r in zip(prog_logs, ref_logs):
        for k, v in r.items():
            got = p.get(k, float("nan"))
            gap = abs(got - v) / max(abs(v), floor)
            losses.append(NOT_FINITE if gap != gap else gap)
    grads = {(n, k): float(g) for n, gs in step.adam.first_grad.items() for k, g in gs.items()}
    median = statistics.median(grads.values())
    kept = {n: [k for k in step.params[n] if grads[(n, k)] >= 1e-3 * median]
            for n in step.params}
    moments = {}
    for n, mu in step.adam.first_mu.items():
        prog = prog_mu.get(n, {})
        moments.update({(n, k): g for k, g in leaf_gaps(prog, mu, kept[n]).items()})
    deltas_p, deltas_r = {}, {}
    for n, params in step.params.items():
        for k in kept[n]:
            deltas_p[(n, k)] = prog_params[n][k].float() - weights[n][k].float()
            deltas_r[(n, k)] = params[k].detach() - weights[n][k].float()
    updates = leaf_gaps(deltas_p, deltas_r, list(deltas_r))
    worst_m = max(moments, key=moments.get)
    worst_u = max(updates, key=updates.get)
    return {
        "loss_gap": statistics.mean(losses), "grad_gap": moments[worst_m],
        "update_gap": updates[worst_u],
        "loss_gap_worst": max(losses), "grad_gap_median": statistics.median(moments.values()),
        "grad_gap_worst_leaf": ".".join(worst_m), "update_gap_median":
        statistics.median(updates.values()), "update_gap_worst_leaf": ".".join(worst_u),
        "excluded_leaves": sum(len(step.params[n]) - len(kept[n]) for n in step.params),
    }


def cycle_ops(ctx, weights, pool, checked) -> dict:
    """Operations of one schedule cycle (d_iter - 1 content steps and a main
    step) of the reference, counted with torch's flop counter on the meta
    device, at bf16."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.nets import Arith

    meta = lambda t: t.detach().to("meta")  # noqa: E731
    mw = {n: {k: meta(v) for k, v in sd.items()} for n, sd in weights.items()}
    step = reference(ctx).Step(mw, Arith())
    d_iter = ctx.cell.traffic["flags"]["d_iter"]
    with FlopCounterMode(display=False) as fc:
        for i in range(1, d_iter + 1):
            batch = {k: meta(v) for k, v in pool[(i - 1) % len(pool)].items()}
            draws = {k: meta(v) for k, v in checked[0].items()}
            (step.content_step if i % d_iter else step.main_step)(batch, draws)
    return {"bf16": int(fc.get_total_flops())}


def window(model, pool, first_it: int, seconds: float, gen, d_iter: int, tracer=None):
    """Iterations back to back for ``seconds``, then a synchronize. Returns
    (iterations, start, end)."""
    import contextlib

    import torch

    it, start = first_it, time.perf_counter()
    while time.perf_counter() - start < seconds or it == first_it:
        name = "content_step" if it % d_iter else "main_step"
        with tracer.span(name) if tracer else contextlib.nullcontext():
            iterate(model, pool, it, gen)
        it += 1
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return it - first_it, start, time.perf_counter()


def run(ctx) -> dict:
    import torch

    tr = ctx.cell.traffic
    f = {**ctx.cell.config["flags"], **tr["flags"]}
    d_iter = f["d_iter"]
    model, weights, pool, checked, dgen = setup(ctx)
    common.plant(ctx, model)
    prog_logs, prog_mu = checked_steps(ctx, model, pool, checked)
    prog_params = {n: {k: v.detach().clone() for k, v in net.state_dict().items()}
                   for n, net in model.nets.items()}
    it = len(checked) + 1
    for _ in range(tr["warmup_iterations"]):
        iterate(model, pool, it, dgen)
        it += 1
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    summary = None
    setup_s = time.perf_counter() - ctx.t0
    if ctx.trace:
        from portbench.trace import Tracer

        tracer = Tracer(ctx.kernels, ctx.trace_path)
        seconds = min(ctx.seconds, tr["trace_seconds"])
        with tracer.device_window():
            n, start, end = window(model, pool, it, seconds, dgen, d_iter, tracer)
        with tracer.kernel_window():
            window(model, pool, it + n, seconds, dgen, d_iter, tracer)
        summary = tracer.summary
        summary.extra = {"ops_per_cycle": cycle_ops(ctx, weights, pool, checked),
                         "cycles": n / d_iter}
    else:
        n, start, end = window(model, pool, it, ctx.seconds, dgen, d_iter)
    peak = common.device_info(torch, ctx.cell.chips)["memory_peak_bytes"]
    e2e = {"train_img_per_s": 2 * f["batch_size"] * n / (end - start), "setup_s": setup_s}
    del model
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref_logs, step = reference_readings(ctx, weights, pool, checked)
    got = compare(tr, prog_logs, prog_mu, prog_params, weights, ref_logs, step)
    compared = {k: {"value": got[k], "limit": ctx.cell.limits[k]}
                for k in ("loss_gap", "grad_gap", "update_gap") if k in ctx.cell.limits}
    return {
        "attempted": n, "failed": 0, "e2e": e2e, "summary": summary, "memory_peak_bytes": peak,
        "compared": compared,
        "correct": all(c["value"] <= c["limit"] for c in compared.values()),
        "readings": got,
    }
