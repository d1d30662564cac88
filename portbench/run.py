#!/usr/bin/env python3
"""One run of one benchmark cell of ``masterthesis_tpu_torch`` on the card.

    python3 portbench/run.py --workload adain_256.serve_int8_b64 --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout. The cell (``BENCHMARK.json`` ``workloads``)
names a configuration and a traffic mix, whose files the run reads by name
(see ``portbench/common.py``); the mix's ``kind`` names the module in
``portbench/kinds/`` that runs it. The run builds the port's kernels (into
``build/kernels/`` of the checkout, once per checkout), makes the weights
and inputs on the card from ``--seed``, warms up, measures for
``--seconds``, then holds what the timed path produced against the plain
reference in ``portbench/reference/`` and prints, as its last lines, each
number compared beside its limit on standard error and one JSON result line
on standard output. With ``--trace 1`` the window runs under
``torch.profiler`` (the mix's ``trace_seconds`` at most), the line carries
the cell's per-layer metrics instead of its end-to-end ones, and the trace
is written to ``outputs/portbench/`` in the checkout.

Without a CUDA device, or with fewer than the cell asks for, it exits with
code 2 and prints no result. If a module whose top-level name is ``jax``,
``jaxlib``, ``flax``, ``orbax`` or ``masterthesis_tpu`` is loaded at the
start or once the window has closed, it names it on standard error and
exits with code 3.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # the set-up time counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402


class Refused(Exception):
    """A run that must print no result: ``code`` is its exit code."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def guard(when: str) -> None:
    bad = common.forbidden_modules()
    if bad:
        raise Refused(3, f"{when}: forbidden modules loaded: {', '.join(bad)}")


def witness(cell, summary) -> dict:
    """The traced run's check that the kernel windows saw what the cell
    drives: ``kernels_unseen``, the cell's kernels (``cells/<cell>.json``)
    with no wrapped call or no launch of their own under it, and
    ``launches_unwrapped``, launches of a kernel file's names that no
    wrapper's span holds. Each has the limit 0."""
    unseen = [k for k in cell.kernels
              if not summary.kernels.get(k, {}).get("calls")
              or not summary.kernels.get(k, {}).get("launches")]
    for k in unseen:
        print(f"portbench: kernel {k} not seen in the kernel window", file=sys.stderr)
    for name, n in summary.escaped.items():
        print(f"portbench: {n} launches of {name} under no kernel call", file=sys.stderr)
    return {"kernels_unseen": {"value": len(unseen), "limit": 0},
            "launches_unwrapped": {"value": sum(summary.escaped.values()), "limit": 0}}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: Path = ROOT, fault=None, cell=None, t0: float = T0) -> dict:
    """Run one cell; returns the traffic kind's result with the cell and the
    per-layer metrics. ``cell`` (a resolved :class:`common.Cell`) and
    ``fault`` (called with the model after set-up) are for tests."""
    import torch

    guard("start")
    common.env_caches(root)
    cell = cell or common.resolve(workload, common.benchmark(root), root)
    build_s = 0.0
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise Refused(2, f"{workload} needs {cell.chips} CUDA device(s); {n} available")
        from masterthesis_tpu_torch.ops.kernels import build

        t = time.perf_counter()
        build.build()
        build_s = time.perf_counter() - t
    trace_path = root / "outputs" / "portbench" / f"{workload}.seed{seed}.trace.json.gz"
    ctx = SimpleNamespace(cell=cell, seed=int(seed), seconds=float(seconds), trace=bool(trace),
                          device=torch.device(device), root=root, t0=t0, fault=fault, undo=[],
                          kernels=common.kernel_files(root / "portbench"), trace_path=trace_path,
                          build_s=build_s)
    try:
        result = common.traffic_kind(cell.traffic["kind"], root / "portbench").run(ctx)
    finally:
        common.unplant(ctx)
    guard("after the window")
    result["cell"] = cell
    result["build_s"] = build_s
    if trace and device == "cuda":
        seen = witness(cell, result["summary"])
        result["compared"].update(seen)
        result["correct"] = result["correct"] and all(
            c["value"] <= c["limit"] for c in seen.values())
    if trace:
        s = result["summary"]
        result["per_layer"] = {}
        for m in cell.per_layer:
            value = common.metric_reader(m["name"], root / "portbench")(s)
            if value is not None:
                result["per_layer"][m["name"]] = value
    return result


def result_line(result: dict, trace: bool) -> str:
    import torch

    cell = result["cell"]
    if trace:
        units = {m["name"]: m["unit"] for m in cell.per_layer}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in result["per_layer"].items()}
    else:
        metrics = {m["name"]: {"value": result["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = common.device_info(torch, cell.chips)
    device["memory_peak_bytes"] = int(result["memory_peak_bytes"])
    breakdown = None
    if trace:
        s = result["summary"]
        device["busy_s"] = s.busy_s
        device["window_s"] = s.window_s
        breakdown = s.breakdown
    # the kernel build's share of set-up, apart: only a checkout's first run builds
    parts = {"build_s": result["build_s"]}
    return common.result_line(result["correct"], result["attempted"], result["failed"], metrics,
                              device, result["compared"], breakdown, parts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    line = result_line(result, bool(a.trace))
    print(f"set-up: the kernel build took {result['build_s']!r} s of it", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {json.dumps(result['correct'])}", file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
