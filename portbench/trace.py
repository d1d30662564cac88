"""The traced run: ``torch.profiler`` over a window, spans that the benchmark
puts around the program's calls, and the reduction of the trace to what
the per-layer readers read.

Spans come from the benchmark's own code, never from the program:

- ``pb.s.<name>`` around each call of the kernel window (a request, a
  training iteration), put by the traffic kind with :meth:`Tracer.span`;
- ``pb.k.<kernel>`` around each call of a hand-written kernel function,
  put by a wrapper that :class:`Tracer` installs, for the window only, in
  place of the function named by ``kernels/<kernel>.json``; the wrapper
  also hands the call's arguments and result to that file's work function
  in ``work.py``, which counts the call's operations and bytes.

A device operation (kernel, memcpy or memset) belongs to the innermost span
whose host interval holds the runtime call that launched it, matched by the
profiler's correlation id. So a kernel function's device time is all the
device work it enqueued, whatever launches implement it, and a span's
device extent runs from the start of its first device operation to the end
of its last.

The launches witness the wrappers: each ``kernels/<kernel>.json`` lists the
names of its function's device kernels (``launches``, regular expressions).
A launch that matches any kernel file's names but lies under no ``pb.k.*``
span came from a call that no wrapper saw (a path that binds the function
itself), and is counted in :attr:`Summary.escaped`; under its own span it
counts as that kernel's ``launches``.
"""
from __future__ import annotations

import bisect
import contextlib
import gzip
import importlib
import json
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from portbench import work

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class Summary:
    """What the per-layer readers read from one traced window."""

    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # kernel -> calls, launches, device_s, least_s, ...
    escaped: dict = field(default_factory=dict)  # launch name -> launches under no pb.k span
    spans: dict = field(default_factory=dict)  # span name -> [{"host_s", "device_s"}]
    extra: dict = field(default_factory=dict)  # the traffic kind's counts (ops per request, ...)
    breakdown: dict = field(default_factory=dict)


class _Calls:
    """The kernel calls of the window: per kernel, calls and summed work."""

    def __init__(self):
        self.by_kernel = defaultdict(lambda: {"calls": 0, "ops": defaultdict(int), "bytes": 0,
                                              "least_s": 0.0})

    def add(self, kernel: str, counted: dict) -> None:
        k = self.by_kernel[kernel]
        k["calls"] += 1
        for p, n in counted["ops"].items():
            k["ops"][p] += int(n)
        k["bytes"] += int(counted["bytes"])
        k["least_s"] += work.least_seconds(counted["ops"], counted["bytes"])


def _wrap(fn, kernel: str, count, calls: _Calls, record_function):
    def wrapper(*args, **kwargs):
        with record_function(f"pb.k.{kernel}"):
            out = fn(*args, **kwargs)
        calls.add(kernel, count(args, kwargs, out))
        return out

    # the program's own launch counters increment the module-level name
    wrapper.launches = getattr(fn, "launches", 0)
    return wrapper


class Tracer:
    """Profiles a traced run in two windows of the same traffic, one after
    the other; ``kernels`` is {name: kernels/<name>.json}, ``out`` the
    trace file kept (gzip JSON, the kernel window's).

    - :meth:`device_window`: the profiler records the device alone (CUDA
      activity: kernels, copies, the runtime calls), so the host runs at
      nearly its untraced pace. Its spans time each call by the host clock
      and by CUDA events around it. It gives the window, the device's busy
      time and its longest operations, the spans, and each call's host time
      up to its last ``torch.cuda.synchronize``.
    - :meth:`kernel_window`: the profiler records the host's operators too,
      and the kernel functions run through their counting wrappers under
      ``pb.k.*`` spans. It gives each kernel function's device time and
      work, and the idle gaps named by the host operation under way. Its
      own pace is slower (the operator records cost host time), which
      moves no device time.
    """

    def __init__(self, kernels: dict, out: Path):
        self.kernels, self.out = kernels, Path(out)
        self.phase: Optional[str] = None
        self.host = defaultdict(list)  # span name -> [(t_start, t_end)], device window
        self.events = defaultdict(list)  # span name -> [(CUDA event, CUDA event)]
        self.syncs: list[float] = []  # host clock at each torch.cuda.synchronize
        self.device: Optional[Summary] = None
        self.kernel: Optional[Summary] = None

    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        if self.phase == "kernels":
            from torch.profiler import record_function

            with record_function(f"pb.s.{name}"):
                yield
            return
        timed = torch.cuda.is_available()
        if timed:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        yield
        if timed:
            e1.record()
            self.events[name].append((e0, e1))
        self.host[name].append((t0, time.perf_counter()))

    def host_to_last_sync(self, name: str) -> list[float]:
        """Per span ``name`` of the device window: seconds from its start to
        the start of its last ``torch.cuda.synchronize``, the host's share of
        the call."""
        out = []
        for t0, t1 in self.host[name]:
            i = bisect.bisect_right(self.syncs, t1) - 1
            if i >= 0 and self.syncs[i] >= t0:
                out.append(self.syncs[i] - t0)
        return out

    @contextlib.contextmanager
    def device_window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        sync = torch.cuda.synchronize

        def recorded_sync(*args, **kwargs):
            self.syncs.append(time.perf_counter())
            return sync(*args, **kwargs)

        cuda = torch.cuda.is_available()
        path = self.out.with_name(self.out.name.replace(".json", ".device.json"))
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.phase = "device"
        torch.cuda.synchronize = recorded_sync
        try:
            with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as p:
                yield self
                if cuda:
                    sync()
            p.export_chrome_trace(str(path))
        finally:
            torch.cuda.synchronize = sync
            self.phase = None
        with gzip.open(path, "rt") as f:
            self.device = reduce(json.load(f)["traceEvents"])
        path.unlink()
        self.device.spans = {}
        for name, host in self.host.items():
            events = self.events.get(name) or [None] * len(host)
            self.device.spans[name] = [
                {"host_s": t1 - t0, "device_s": ev[0].elapsed_time(ev[1]) / 1e3 if ev else None}
                for (t0, t1), ev in zip(host, events)]

    @contextlib.contextmanager
    def kernel_window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        calls = _Calls()
        saved = []
        for name, spec in self.kernels.items():
            mod = importlib.import_module(spec["module"])
            fn = getattr(mod, spec["function"])
            saved.append((mod, spec["function"], fn))
            setattr(mod, spec["function"], _wrap(fn, name, getattr(work, spec["work"]), calls,
                                                  record_function))
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.out.parent.mkdir(parents=True, exist_ok=True)
        self.phase = "kernels"
        try:
            with profile(activities=activities) as p:
                yield self
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            p.export_chrome_trace(str(self.out))
        finally:
            self.phase = None
            for mod, fname, fn in saved:
                setattr(mod, fname, fn)
        with gzip.open(self.out, "rt") as f:
            self.kernel = reduce(json.load(f)["traceEvents"], calls, self.kernels)

    @property
    def summary(self) -> Summary:
        """The device window's window, busy time, spans and longest
        operations, with the kernel window's kernel functions and idle gaps."""
        d, k = self.device, self.kernel
        return Summary(window_s=d.window_s, busy_s=d.busy_s, kernels=k.kernels if k else {},
                       escaped=k.escaped if k else {}, spans=d.spans, breakdown={"device_ops": d.breakdown.get("device_ops", []),
                                                 "idle_gaps": (k or d).breakdown.get(
                                                     "idle_gaps", [])})


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Spans:
    """Host spans sorted by start, for the innermost one that holds a time."""

    def __init__(self, spans: list):
        self.spans = sorted(spans, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.spans]
        self.reach, end = [], float("-inf")  # the latest end of the spans up to each
        for e in self.spans:
            end = max(end, e["ts"] + e["dur"])
            self.reach.append(end)

    def owner(self, t) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            e = self.spans[i]
            if e["ts"] + e["dur"] >= t:
                return i
            i -= 1
        return None


def _matcher(kernels: dict):
    """{kernel: compiled pattern of its launches' names} and the union."""
    own = {k: re.compile("|".join(spec["launches"])) for k, spec in kernels.items()
           if spec.get("launches")}
    union = re.compile("|".join(f"(?:{p.pattern})" for p in own.values())) if own else None
    return own, union


def reduce(events: list, calls: Optional[_Calls] = None,
           kernels: Optional[dict] = None) -> Summary:
    """A :class:`Summary` of a chrome trace's events: the window is the
    first ``pb.s.*`` span's start to the last one's end. ``kernels``
    ({name: kernels/<name>.json}) names each kernel function's launches."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    gpu = [e for e in xs if e.get("cat") in GPU_CATS]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    pb = [e for e in xs if e.get("cat") == "user_annotation" and e["name"].startswith("pb.")]
    steps = sorted((e for e in pb if e["name"].startswith("pb.s.")), key=lambda e: e["ts"])
    kspans = sorted((e for e in pb if e["name"].startswith("pb.k.")), key=lambda e: e["ts"])
    s = Summary()
    if steps:
        w0, w1 = steps[0]["ts"], max(e["ts"] + e["dur"] for e in steps)
    elif gpu:
        # a trace without host spans: from the first launch to the last device op's end
        w0 = min([e["ts"] for e in launches.values()] + [e["ts"] for e in gpu])
        w1 = max(e["ts"] + e["dur"] for e in gpu)
    else:
        return s
    s.window_s = (w1 - w0) / 1e6

    own, union = _matcher(kernels or {})
    k_index, s_index = _Spans(kspans), _Spans(steps)
    kernel_dev, kernel_launches = defaultdict(float), defaultdict(int)
    step_ext = defaultdict(lambda: [float("inf"), float("-inf")])
    clipped, by_name = [], defaultdict(float)
    for e in gpu:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b > a:
            clipped.append((a, b))
            by_name[e["name"]] += (b - a) / 1e6
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        i = k_index.owner(launch["ts"])
        named = union is not None and union.search(e["name"]) is not None
        if i is not None:
            kernel = k_index.spans[i]["name"][len("pb.k."):]
            kernel_dev[kernel] += e["dur"] / 1e6
            if kernel in own and own[kernel].search(e["name"]):
                kernel_launches[kernel] += 1
        elif named and w0 <= launch["ts"] <= w1:
            s.escaped[e["name"][:200]] = s.escaped.get(e["name"][:200], 0) + 1
        j = s_index.owner(launch["ts"])
        if j is not None:
            ext = step_ext[j]
            ext[0], ext[1] = min(ext[0], e["ts"]), max(ext[1], e["ts"] + e["dur"])
    busy = _merge(clipped)
    s.busy_s = sum(b - a for a, b in busy) / 1e6
    for j, e in enumerate(s_index.spans):
        ext = step_ext.get(j)
        s.spans.setdefault(e["name"][len("pb.s."):], []).append({
            "host_s": e["dur"] / 1e6,
            "device_s": (ext[1] - ext[0]) / 1e6 if ext else None,
        })
    if calls is not None:
        for name, k in calls.by_kernel.items():
            s.kernels[name] = {"calls": k["calls"], "launches": kernel_launches.get(name, 0),
                               "ops": dict(k["ops"]), "bytes": k["bytes"],
                               "least_s": k["least_s"], "device_s": kernel_dev.get(name, 0.0)}
    # the longest idle gaps, each named by the innermost host event under way
    gaps, edge = [], w0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host = sorted((e for e in xs if e.get("cat") in HOST_CATS
                   and not e["name"].startswith("pb.s.")), key=lambda e: e["ts"])
    host_starts = [e["ts"] for e in host]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        under = [e for e in host[:bisect.bisect_right(host_starts, mid)]
                 if e["ts"] + e["dur"] >= mid]
        name = min(under, key=lambda e: e["dur"])["name"] if under else "host: no event"
        named.append([name, (b - a) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    s.breakdown = {"device_ops": [[n[:200], v] for n, v in top], "idle_gaps": named}
    return s
