#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size (the benchmark's runs never run this).

    python3 portbench/readings.py --workload adain_256.serve_int8_b64 \\
        --seeds 101,102,... --control-seeds 201,202,203 [--fault half_batch]

For each ``--seeds`` seed: the program is set up as a run sets it up, runs
a short window at the cell's load, and its outputs are compared with the
reference: the lower readings. For each ``--control-seeds`` seed: the
control, the reference computed in the precision below the configuration's
(serving: ``control_bits`` of the mix; training: float8 e4m3 operands for a
bf16 configuration), is put in the program's place and compared the same
way: the upper readings. ``--fault`` plants one of the faults of
:data:`FAULTS` in the program instead, for the control seeds. One JSON line
per seed, then one summary line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402


def half_batch(model) -> None:
    """Training: every step learns from the first half of each side's rows
    only, the second half's rows replaced by copies of the first, so that
    each mean is taken over the rest (the draws keep their shapes)."""
    batch_of = model._batch

    def _batch(batch):
        h = len(batch["x1"]) // 2
        return batch_of({k: v[:h].repeat(2, *([1] * (v.dim() - 1))) for k, v in batch.items()})

    model._batch = _batch


def frozen_state(model) -> None:
    """Training: a step that leaves the parameters and the optimizer state as
    they were."""
    import torch

    for name in ("main_step", "content_step"):
        step = getattr(model, name)

        def frozen(batch, draws=None, _step=step):
            saved = {n: {k: v.detach().clone() for k, v in net.state_dict().items()}
                     for n, net in model.nets.items()}
            logs = _step(batch, draws)
            with torch.no_grad():
                for n, net in model.nets.items():
                    net.load_state_dict(saved[n])
            return logs

        setattr(model, name, frozen)


def altered_image(model) -> None:
    """Serving: the last image of every request comes out inverted."""
    impl = model._forward_random_impl

    def forward(img, z, c):
        out = impl(img, z, c).clone()
        out[-1] = -out[-1]
        return out

    model._forward_random_impl = forward


def dropped_half(model) -> None:
    """Serving: the second half of every request's images is left out (its
    outputs are zeros)."""
    impl = model._forward_random_impl

    import torch

    def forward(img, z, c):
        h = img.shape[0] // 2
        out = impl(img[:h], z[:h], c[:h])
        return torch.cat([out, torch.zeros_like(out[: img.shape[0] - h])])

    model._forward_random_impl = forward


def _resblock_bwd_fault(change):
    """A fault of kernel 10, the training resblock's backward: ``change``
    alters what ``resblock_bwd`` returns (dx, dw1, dw2, dgamma, dbeta). It
    patches the port's module, so it returns the function that takes it
    out again."""
    def plant(model):
        from masterthesis_tpu_torch.ops.kernels import resblock_train as krb

        sound = krb.resblock_bwd

        def faulty(*args, **kwargs):
            return change(*sound(*args, **kwargs))

        # the program's own launch counter increments the module-level name
        faulty.launches = getattr(sound, "launches", 0)
        krb.resblock_bwd = faulty

        def undo():
            krb.resblock_bwd = sound

        return undo

    return plant


# training: kernel 10's first conv's weight gradient twice what it is, and
# its gradient of the norms' scale left out
resblock_dw_double = _resblock_bwd_fault(lambda dx, dw1, dw2, dg, db: (dx, 2 * dw1, dw2, dg, db))
resblock_dgamma_zero = _resblock_bwd_fault(lambda dx, dw1, dw2, dg, db: (dx, dw1, dw2, 0 * dg, db))

FAULTS = {"half_batch": half_batch, "frozen_state": frozen_state,
          "altered_image": altered_image, "dropped_half": dropped_half,
          "resblock_dw_double": resblock_dw_double, "resblock_dgamma_zero": resblock_dgamma_zero}


def context(cell, seed: int, device, fault=None):
    return SimpleNamespace(cell=cell, seed=seed, seconds=0.0, trace=False,
                           device=device, root=ROOT, t0=time.perf_counter(), fault=fault,
                           undo=[], kernels={}, trace_path=None)


def serve_reading(cell, seed: int, device, control: bool, model=None, fault=None) -> dict:
    from portbench.kinds import serve_closed as d

    tr = cell.traffic
    ctx = context(cell, seed, device, fault)
    state = d.setup(ctx, model)
    common.plant(ctx, state.model)
    keep = d.checked_indices(seed, tr["pool"], tr["checked_requests"])
    keep.append(next(i for i in range(tr["pool"] + 1) if i not in keep))  # as a run's last
    try:
        if control and fault is None:
            # the control in the program's place: its answers for the checked batches
            outs = dict(d.reference_answers(ctx, state, tr["control_bits"], keep,
                                            tr["check_block"]))
        else:
            # the checked requests at the cell's load, through the timed call
            outs = {}
            for i in keep:
                b = state.pool[i % len(state.pool)]
                outs[i] = state.model.forward_random(b["img"], b["z"], b["c"])[0]
    finally:
        common.unplant(ctx)
    state.model = None
    n = len(outs)
    value = d.worst_rmse(ctx, state, outs, tr["reference_bits"], tr["check_block"])
    return {"worst_image_rmse": value, "requests": n}


def train_reading(cell, seed: int, device, control: bool, fault=None) -> dict:
    import torch

    from portbench.kinds import train_schedule as d
    from portbench.reference.nets import Arith, fp8

    tr = cell.traffic
    ctx = context(cell, seed, device, fault)
    model, weights, pool, checked, _ = d.setup(ctx)
    common.plant(ctx, model)
    try:
        if control and fault is None:
            logs, step = d.reference_readings(ctx, weights, pool, checked, Arith(cast=fp8))
            mu = step.adam.first_mu
            params = {n: {k: v.detach() for k, v in p.items()} for n, p in step.params.items()}
        else:
            logs, mu = d.checked_steps(ctx, model, pool, checked)
            params = {n: {k: v.detach().clone() for k, v in net.state_dict().items()}
                      for n, net in model.nets.items()}
    finally:
        common.unplant(ctx)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_logs, step = d.reference_readings(ctx, weights, pool, checked)
    return d.compare(tr, logs, mu, params, weights, ref_logs, step)


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.device == "cuda":
        from masterthesis_tpu_torch.ops.kernels import build

        build.build()
    cell = common.resolve(a.workload)
    device = torch.device(a.device)
    kind = cell.traffic["kind"]
    rows = []
    for label, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for s in filter(None, seeds.split(",")):
            t = time.perf_counter()
            fault = FAULTS[a.fault] if (a.fault and label == "control") else None
            if kind == "serve_closed":
                got = serve_reading(cell, int(s), device, label == "control", fault=fault)
            else:
                got = train_reading(cell, int(s), device, label == "control", fault=fault)
            row = {"workload": a.workload, "side": a.fault or label if label == "control"
                   else label, "seed": int(s), **got, "seconds": time.perf_counter() - t}
            rows.append(row)
            print(json.dumps(row), flush=True)
    keys = [k for k in rows[0] if "_gap" in k or k == "worst_image_rmse"] if rows else []
    summary = {side: {k: [r[k] for r in rows if r["side"] == side] for k in keys}
               for side in {r["side"] for r in rows}}
    print(json.dumps({"workload": a.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
