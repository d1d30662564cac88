"""Profiling and timing helpers.

The port of ``masterthesis_tpu/utils/profiling.py``: a ``torch.profiler``
trace (Chrome trace format, one file per trace in ``logdir``), a per-step
timer that synchronizes the device at each sync point, device memory
queries through ``torch.cuda``, the console section logger and the running
mean.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host and, with a card, device activity) and write
    ``logdir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Steps per second over each ``sync_every`` steps, with the device
    synchronized at each sync point, so that the time covers the device's
    work and not only its enqueueing."""

    def __init__(self, sync_every: int = 100, device="cpu"):
        self.sync_every = sync_every
        self.device = torch.device(device)
        self.reset()

    def reset(self):
        self._count = 0
        self._start = time.perf_counter()

    def lap(self) -> Optional[float]:
        """Count one step; returns steps/s at each sync point, else None."""
        self._count += 1
        if self._count % self.sync_every == 0:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - self._start
            rate = self.sync_every / dt
            self._start = time.perf_counter()
            return rate
        return None


def device_memory_stats(device=None) -> dict:
    """The card's memory in bytes (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved``); {} for the CPU or without a card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_reserved": torch.cuda.memory_reserved(device),
    }


def device_memory_gb(device=None) -> float:
    return device_memory_stats(device).get("bytes_in_use", 0) / (1024**3)


class TimerBlock:
    """Console section logger: a heading line, then elapsed-stamped entries."""

    def __init__(self, title: str):
        self._t0 = time.perf_counter()
        print(title, flush=True)

    def __enter__(self) -> "TimerBlock":
        self._t0 = time.perf_counter()
        return self

    def log(self, message: str) -> None:
        dt = time.perf_counter() - self._t0
        stamp = f"{dt:.3f}s" if dt <= 60 else f"{dt / 60:.3f}m"
        print(f"  [{stamp}] {message}", flush=True)

    def __exit__(self, exc_type, exc, tb) -> None:
        self.log("Operation failed\n" if exc_type else "Operation finished\n")


class AverageMeter:
    """Streaming weighted mean of a scalar, with display formatting."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def update(self, val, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n

    def __str__(self) -> str:
        spec = self.fmt.lstrip(":")
        return f"{self.name} {format(self.val, spec)} ({format(self.avg, spec)})"
