#!/usr/bin/env python3
"""Traced runs of benchmark cells with the program's span recorder on, its
spans placed on the device window's trace (``portbench/spans.py``).

    python3 scripts/program_spans.py --workload adain_256.train_fused_b8 \\
        --seed 7 --seconds 30 [--recorder off] [--out outputs/spans.jsonl]

From the root of a checkout, on the card. One process runs one cell as
``portbench/run.py --trace 1`` does, with two additions: the recorder
(``masterthesis_tpu_torch.utils.profiling``) is on from the start, off around
the kernel window and drained at the end; and the device window's chrome
trace is kept in memory for the reduction, with a ``time.time_ns()`` stamp
before each call of the runtime's synchronize (the clock's anchors) and
before each of the harness's own synchronizes. With ``--recorder off`` the
recorder stays off and the run is the harness's traced run: the pair gives
the recorder's cost. Prints one JSON line: the harness's per-layer metrics,
``correct`` and what it compared, the program's readings and clock check,
the idle gaps by span and by phase, the set-up spans, the kernels' launch
counters, the recorder's named counters (``profiling.totals()``) over the
device window, per request of it (serving, ``per_request``: among them
``concat_bytes_per_request.serve``, the bytes DecoderConcat's concats write,
and ``tail_launches_per_request.serve``, the int8 conv launches that ran a
tail N tile), the number of ``mt.`` events in every profiler trace the run
wrote (0 expected), and the card with its power limit.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from masterthesis_tpu_torch.utils import profiling  # noqa: E402
from portbench import run as harness  # noqa: E402
from portbench import spans, trace  # noqa: E402


class SpanTracer(trace.Tracer):
    """The harness's tracer, keeping the device window's trace and the
    stamps of its synchronizes; the recorder is off in the kernel window."""

    kept: dict = {}
    totals: dict = {}  # the recorder's named counters over the device window
    anchors: list = []  # before each of the harness's synchronizes
    inner: list = []  # before each runtime synchronize, inside torch.cuda.synchronize
    mt_events = 0

    @contextlib.contextmanager
    def device_window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        sync, runtime_sync = torch.cuda.synchronize, torch._C._cuda_synchronize

        def recorded_sync(*args, **kwargs):
            self.syncs.append(time.perf_counter())
            SpanTracer.anchors.append(time.time_ns())
            return sync(*args, **kwargs)

        def stamped_runtime_sync():
            SpanTracer.inner.append(time.time_ns())
            return runtime_sync()

        path = self.out.with_name(self.out.name.replace(".json", ".device.json"))
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.phase = "device"
        torch.cuda.synchronize = recorded_sync
        torch._C._cuda_synchronize = stamped_runtime_sync
        counted = profiling.totals()
        try:
            cuda = torch.cuda.is_available()
            activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
            with profile(activities=[activity]) as p:
                yield self
                if cuda:
                    sync()
            p.export_chrome_trace(str(path))
        finally:
            torch.cuda.synchronize = sync
            torch._C._cuda_synchronize = runtime_sync
            self.phase = None
        SpanTracer.totals = {k: n - counted.get(k, 0) for k, n in profiling.totals().items()}
        with gzip.open(path, "rt") as f:
            SpanTracer.kept = json.load(f)
        path.unlink()
        SpanTracer.mt_events += mt_count(SpanTracer.kept)
        self.device = trace.reduce(SpanTracer.kept["traceEvents"])
        self.device.spans = {}
        for name, host in self.host.items():
            events = self.events.get(name) or [None] * len(host)
            self.device.spans[name] = [
                {"host_s": t1 - t0, "device_s": ev[0].elapsed_time(ev[1]) / 1e3 if ev else None}
                for (t0, t1), ev in zip(host, events)]

    @contextlib.contextmanager
    def kernel_window(self):
        profiling.disable()
        with super().kernel_window():
            yield self
        with gzip.open(self.out, "rt") as f:
            SpanTracer.mt_events += mt_count(json.load(f))


def clock_detail(chrome: dict, recorded: list) -> dict:
    """The clock check for each kind of stamp apart: the sync spans' starts,
    the harness's synchronizes, and the runtime synchronize's call."""
    xs = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    if not xs:
        return {}
    base = int(chrome.get("baseTimeNanoseconds", 0))
    t0, t1 = min(e["ts"] for e in xs), max(e["ts"] + e["dur"] for e in xs)
    syncs = [e["ts"] for e in xs if e["name"] == spans.SYNC]
    kinds = {"sync_spans": [r[1] for r in recorded if r[0] == "mt.serve.sync"],
             "anchors": SpanTracer.anchors, "runtime_call": SpanTracer.inner}
    out = {}
    for kind, stamps in kinds.items():
        us = [(t - base) / 1e3 for t in stamps]
        out[kind] = spans.clock([t for t in us if t0 <= t <= t1], syncs)
    return out


def mt_count(chrome: dict) -> int:
    return sum(1 for e in chrome.get("traceEvents", []) if str(e.get("name", "")).startswith("mt."))


def per_request(totals: dict, requests: int) -> dict:
    """The device window's named counters per request, and the two that the
    serve cells' metrics would read ({} for a window without requests)."""
    if not requests:
        return {}
    out = {k: n / requests for k, n in sorted(totals.items())}
    tails = sum(n for k, n in totals.items() if k.endswith(".tail_launches"))
    out["concat_bytes_per_request.serve"] = totals.get("decode.concat_bytes", 0) / requests
    out["tail_launches_per_request.serve"] = tails / requests
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--recorder", choices=("on", "off"), default="on")
    p.add_argument("--out", default=None, help="also append the line to this file")
    a = p.parse_args(argv)
    if a.recorder == "on":
        profiling.enable()
    trace.Tracer = SpanTracer  # the traffic kinds look it up when they run
    before = profiling.counters()
    try:
        result = harness.run_cell(a.workload, a.seed, a.seconds, True, t0=T0)
    except harness.Refused as e:
        print(f"program_spans: {e}", file=sys.stderr)
        return e.code
    profiling.disable()
    recorded = profiling.drain()
    after = profiling.counters()
    s = result["summary"]
    cycles = s.extra.get("cycles")
    program = spans.reduce(SpanTracer.kept, recorded, tuple(SpanTracer.inner))
    idle = s.window_s - s.busy_s
    line = {
        "workload": a.workload, "seed": a.seed, "recorder": a.recorder, "card": card(),
        "correct": result["correct"],
        "compared": {k: v["value"] for k, v in result["compared"].items()},
        "per_layer": result["per_layer"], "program": spans.readings(program, cycles),
        "clock": program["clock"], "sync_lag": program["sync_lag"],
        "clock_detail": clock_detail(SpanTracer.kept, recorded),
        "covered": program["covered"], "spans": len(recorded),
        "window_s": s.window_s, "idle_s": idle, "cycles": cycles,
        "idle_by_phase": program["idle_by_phase"], "idle_spans": program["idle_spans"],
        "idle_gaps_kernel_window": s.breakdown.get("idle_gaps"),
        "by_name": program["by_name"], "host_s": program["host_s"],
        "roots": {k: [len(v), sum(v)] for k, v in program["roots"].items()},
        "setup_parts": {**program["setup_parts"], "build_s": result["build_s"]},
        "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
        "window_totals": SpanTracer.totals,
        "per_request": per_request(SpanTracer.totals, len(s.spans.get("request", []))),
        "mt_events_in_profiler_traces": SpanTracer.mt_events,
    }
    text = json.dumps(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
