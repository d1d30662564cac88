"""Device-side timing: ``torch.profiler`` kernel times and CUDA events.

The port of ``masterthesis_tpu/utils/devtime.py``, which reads the JAX
profiler's xplane: here a ``torch.profiler.profile`` holds the events, and
each kernel that ran on the card is an event of device type CUDA with its
own duration. :func:`device_module_times` and :func:`device_op_times` keep
the JAX package's names, keyed by kernel name; ``device="cpu"`` reads the
CPU operator events instead (what a CPU-only profile holds). :func:`measure`
times named thunks by CUDA events around each call and profiles the same
calls for the kernels they ran.

Used by perf experiments and chip checks; not on any hot path.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import Callable, Dict

import torch


def _events(prof, device: str):
    kind = torch.autograd.DeviceType.CUDA if device == "cuda" else torch.autograd.DeviceType.CPU
    return [e for e in prof.events() if e.device_type == kind]


def device_module_times(prof, device: str = "cuda") -> Dict[str, list]:
    """The duration (ms) of each event of ``device`` in the profile, by name
    (on the card: by kernel name, one entry per launch)."""
    out: Dict[str, list] = defaultdict(list)
    for e in _events(prof, device):
        out[e.name].append(e.time_range.elapsed_us() / 1e3)
    return dict(out)


def device_op_times(prof, device: str = "cuda") -> Dict[str, float]:
    """Total time (ms) per event name of ``device`` in the profile."""
    return {name: sum(times) for name, times in device_module_times(prof, device).items()}


def measure(fns: Dict[str, Callable], iters: int = 3):
    """Run each named thunk ``iters`` times after one warm-up call; returns
    ({name: median device ms per call, by CUDA events around the call},
    {name: {kernel name: device ms per call}}, from a profile of the same
    calls)."""
    if not torch.cuda.is_available():
        raise RuntimeError("devtime.measure times the card; no CUDA device is available")
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    medians, kernels = {}, {}
    for name, fn in fns.items():
        times = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        medians[name] = statistics.median(times)
        kernels[name] = {k: v / iters for k, v in device_op_times(prof).items()}
    return medians, kernels
