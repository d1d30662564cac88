"""The program's own spans on the device window's trace.

``masterthesis_tpu_torch.utils.profiling`` records spans (``mt.*``) inside
the program on ``time.time_ns()``, the clock of ``torch.profiler``'s chrome
traces: a span starting at ``t_ns`` lies at ``(t_ns - baseTimeNanoseconds) /
1000`` on the trace's ``ts`` axis. :func:`reduce` places the spans of a
traced window (as ``profiling.drain()`` gives them) on that window's device
trace, which records the device alone, and gives:

- ``clock``: the check of that mapping. Each anchor, a ``time.time_ns()``
  stamp taken just before the runtime's synchronize is called, while the
  profiler recorded, is paired with the nearest ``cudaDeviceSynchronize``
  runtime event; the lag is the event's start less the mapped stamp. Where
  the median lag's size passes :data:`CLOCK_US`, the mapping is taken to
  have drifted and every span is moved by that median (``fitted_us``).
  ``sync_lag`` pairs each ``mt.serve.sync`` start so, and fits nothing: its
  lag also holds the host's time in ``torch.cuda.synchronize`` before the
  runtime call.
- each device operation (kernel, memcpy, memset) under the innermost span
  that holds its launch, matched by correlation id as ``trace.reduce`` does
  for the benchmark's own spans: a span of the launching thread, else of any
  thread (autograd's backward thread launches while the main thread waits
  in ``mt.opt.grad``). ``by_name`` sums, per span name, the device seconds
  and operations launched under it or under a span inside it, once each;
  a span's root (the request or iteration it serves) holds everything
  launched under it on any thread.
- ``idle_spans``: the window's longest idle gaps of the device, each named
  by the innermost span open on any thread at its midpoint, else
  ``between program spans``; ``idle_by_phase``: every gap's seconds by the
  phase (a span directly under a root) open at its midpoint, else the root,
  else ``between program spans``.
- the requests' and iterations' own times (``roots``), the set-up spans'
  seconds (``setup_parts``), and ``covered``, the share of the window's
  launches that lie inside a root.

The window is ``trace.reduce``'s: the trace has no ``pb.s.*`` span in the
device window, so it runs from the first launch to the last device
operation's end, and a root belongs to it when it overlaps it.
:func:`readings` turns a reduction into the per-layer numbers.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Optional

from portbench.trace import GPU_CATS, LAUNCH_CATS, TOP, _merge, _Spans

SYNC = "cudaDeviceSynchronize"
CLOCK_US = 50.0  # the largest lag of a synchronize the mapping may show unfitted
BETWEEN = "between program spans"
SETUP = {"mt.setup.initialize": "initialize_s", "mt.setup.load_params": "load_params_s",
         "mt.setup.calibrate_int8": "calibrate_s", "mt.setup.build": "build_spans_s"}
ROOTS = ("mt.serve.request", "mt.train.main_step", "mt.train.content_step")


def mapped(spans: list, base_ns: int, offset_us: float = 0.0) -> list[dict]:
    """Closed spans as dicts on the trace's ``ts`` axis (microseconds)."""
    return [{"i": i, "name": name, "ts": (start - base_ns) / 1e3 + offset_us,
             "dur": (end - start) / 1e3, "tid": thread, "parent": parent, "root": root,
             "attrs": attrs or {}}
            for i, (name, start, end, thread, parent, root, attrs) in enumerate(spans)
            if end is not None]


def clock(stamps_us: list[float], syncs_us: list[float]) -> dict:
    """Each stamp's lag to the nearest synchronize event: count, median and
    the worst size (microseconds), and the offset to fit where the median's
    size passes :data:`CLOCK_US`."""
    syncs_us = sorted(syncs_us)
    lags = []
    for t in stamps_us:
        i = bisect.bisect_left(syncs_us, t)
        near = [syncs_us[j] for j in (i - 1, i) if 0 <= j < len(syncs_us)]
        if near:
            lags.append(min(near, key=lambda s: abs(s - t)) - t)
    if not lags:
        return {"pairs": 0, "median_us": None, "worst_us": None, "fitted_us": 0.0}
    median = statistics.median(lags)
    return {"pairs": len(lags), "median_us": median, "worst_us": max(abs(x) for x in lags),
            "fitted_us": median if abs(median) > CLOCK_US else 0.0}


def reduce(trace: dict, spans: list, anchors_ns: tuple = ()) -> dict:
    """The reduction of ``spans`` (``profiling.drain()``) on ``trace`` (a
    device window's chrome trace, its top-level keys included);
    ``anchors_ns`` are ``time.time_ns()`` stamps each taken just before a
    call of the runtime's synchronize (``torch._C._cuda_synchronize``)."""
    events = trace.get("traceEvents", [])
    base = int(trace.get("baseTimeNanoseconds", 0))
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    gpu = [e for e in xs if e.get("cat") in GPU_CATS]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    syncs = [e["ts"] for e in xs if e.get("cat") in LAUNCH_CATS and e["name"] == SYNC]
    out = {"clock": clock([], []), "sync_lag": clock([], []), "roots": {}, "host_s": {},
           "enqueue_s": [], "by_name": {}, "idle_spans": [], "idle_by_phase": {}, "covered": None,
           "setup_parts": {}}
    for name, start, end, *_ in spans:
        if name in SETUP and end is not None:
            key = SETUP[name]
            out["setup_parts"][key] = out["setup_parts"].get(key, 0.0) + (end - start) / 1e9
    if not gpu or not spans:
        return out
    w0 = min([e["ts"] for e in launches.values()] + [e["ts"] for e in gpu])
    w1 = max(e["ts"] + e["dur"] for e in gpu)
    # the stamps taken while the profiler recorded (not those of the warm-up)
    t0, t1 = min(e["ts"] for e in xs), max(e["ts"] + e["dur"] for e in xs)
    anchors = [(t - base) / 1e3 for t in anchors_ns]
    out["clock"] = clock([t for t in anchors if t0 <= t <= t1], syncs)
    ms = mapped(spans, base)
    out["sync_lag"] = clock([s["ts"] for s in ms if s["name"] == "mt.serve.sync"
                             and t0 <= s["ts"] <= t1], syncs)
    if out["clock"]["fitted_us"]:
        ms = mapped(spans, base, out["clock"]["fitted_us"])
    by_i = {s["i"]: s for s in ms}
    in_window = [s for s in ms if s["ts"] < w1 and s["ts"] + s["dur"] > w0]
    host = defaultdict(float)
    for s in in_window:
        host[s["name"]] += s["dur"] / 1e6
        if s["name"] in ROOTS and s["parent"] == -1:
            out["roots"].setdefault(s["name"], []).append(s["dur"] / 1e6)
        if s["name"] == "mt.serve.sync" and by_i[s["parent"]]["name"] == "mt.serve.request":
            out["enqueue_s"].append((s["ts"] - by_i[s["parent"]]["ts"]) / 1e6)
    out["host_s"] = dict(host)

    threads = defaultdict(list)
    for s in in_window:
        threads[s["tid"]].append(s)
    own = {tid: _Spans(v) for tid, v in threads.items()}
    anyone = _Spans(in_window)

    def owner(t: float, tid) -> Optional[dict]:
        idx = own.get(tid)
        j = idx.owner(t) if idx else None
        if j is not None:
            return idx.spans[j]
        j = anyone.owner(t)
        return anyone.spans[j] if j is not None else None

    def names_over(s: dict) -> set:
        """The names of ``s``, the spans it lies in on its thread, and its root."""
        names, at = set(), s
        while at is not None:
            names.add(at["name"])
            at = by_i.get(at["parent"])
        root = by_i.get(s["root"])
        if root is not None:
            names.add(root["name"])
        return names

    roots = [s for s in in_window if s["name"] in ROOTS and s["parent"] == -1]
    root_index = _Spans(roots)
    device, count = defaultdict(float), defaultdict(int)
    inside = total = 0
    for e in gpu:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        total += 1
        inside += root_index.owner(launch["ts"]) is not None
        s = owner(launch["ts"], launch.get("tid"))
        if s is None:
            continue
        for name in names_over(s):
            device[name] += e["dur"] / 1e6
            count[name] += 1
    out["covered"] = inside / total if total else None
    out["by_name"] = {n: {"device_s": device[n], "ops": count[n]} for n in sorted(device)}

    # the idle gaps of the window, named by the spans open at their midpoints
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in gpu
                   if min(e["ts"] + e["dur"], w1) > max(e["ts"], w0)])
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    phases = _Spans([s for s in in_window if s["parent"] >= 0
                     and by_i.get(s["parent"], {}).get("parent") == -1
                     and by_i[s["parent"]]["name"] in ROOTS])
    named, by_phase = [], defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        j = anyone.owner(mid)
        named.append([anyone.spans[j]["name"] if j is not None else BETWEEN, (b - a) / 1e6])
        p, r = phases.owner(mid), root_index.owner(mid)
        phase = (phases.spans[p]["name"] if p is not None
                 else root_index.spans[r]["name"] if r is not None else BETWEEN)
        by_phase[phase] += (b - a) / 1e6
    out["idle_spans"] = sorted(named, key=lambda g: -g[1])[:TOP]
    out["idle_by_phase"] = dict(sorted(by_phase.items(), key=lambda kv: -kv[1]))
    return out


def readings(program: dict, cycles: Optional[float] = None) -> dict:
    """The per-layer numbers of a reduction; ``cycles`` is the window's
    training cycles (its iterations over ``d_iter``). A number with nothing
    to read is left out."""
    out = {}
    if program.get("enqueue_s"):
        out["enqueue_ms.serve"] = 1e3 * statistics.mean(program["enqueue_s"])
    steps = program.get("roots", {}).get("mt.train.main_step")
    if steps:
        out["step_host_ms.train"] = 1e3 * statistics.mean(steps)
    if cycles:
        by_name = program.get("by_name", {})
        if "mt.opt.adam" in program.get("host_s", {}):
            out["optimizer_host_ms.train"] = 1e3 * program["host_s"]["mt.opt.adam"] / cycles
        if "mt.opt.adam" in by_name:
            out["optimizer_device_ms.train"] = 1e3 * by_name["mt.opt.adam"]["device_s"] / cycles
        launched = sum(by_name.get(n, {}).get("ops", 0) for n in ROOTS if n.startswith("mt.train"))
        if launched:
            out["launches_per_cycle.train"] = launched / cycles
    return out
