"""Profiling and timing helpers.

The port of ``masterthesis_tpu/utils/profiling.py``: the program's span
recorder and its exporter (:func:`trace`), a per-step timer that
synchronizes the device at each sync point, the console section logger and
the running mean.

The recorder. The program opens a span (:func:`span`) around each phase a
request or a training iteration goes through, each hand-written kernel
function's launches and each part of set-up; every name starts with
``mt.``. While the recorder is off, which it is unless :func:`enable` was
called, a span site costs one check of :data:`ON` and returns one shared
null context: no clock read, no allocation. While it is on, each span is
kept in memory as a tuple ``(name, start_ns, end_ns, thread, parent, root,
attrs)``: ``time.time_ns()`` at its start and end (the clock of
``torch.profiler``'s chrome traces, whose ``ts`` in microseconds is
``(t_ns - baseTimeNanoseconds) / 1000``), the native id of the thread that
opened it, the index of the innermost span open on that thread (-1 for
none), the index of the outermost span open on the main thread (the request
or iteration the span serves; the span itself where none is open) and its
attributes (a dict, or None). Spans opened on another thread, such as
autograd's backward thread on the card, keep their own parents and take the
main thread's root. No span enters ``torch.profiler``'s trace.

The launch counters are the kernel functions' own ``<function>.launches``
attributes; :func:`counters` reads them by kernel name. The program's other
counters are named totals that a site adds to (:func:`add`) only while the
recorder is on, so that a site costs one check of :data:`ON` while it is
off; :func:`totals` reads them:

- ``decode.concat_bytes``: the bytes that ``DecoderConcat``'s channel
  concats write (``models/networks.py``);
- ``<kernel>.tail_launches``: the conv launches of an int8 kernel function
  (``int8_conv3x3``, ``int8_downconv``, ``int8_deconv``, ``int8_resblock``)
  that ran a tail N tile (``ops/kernels/int8_conv.py``);
- ``head.term_launches``: the head's calls (kernel 8) with a per-image term
  (``ops/kernels/head.py``).
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import threading
import time
from typing import Optional

import torch

ON = False  # the recorder's switch, the one thing a span site checks

# kernel name -> (module, function) whose ``launches`` attribute counts it
KERNELS = {
    "moments": ("masterthesis_tpu_torch.ops.kernels.moments", "moments"),
    "adain": ("masterthesis_tpu_torch.ops.kernels.adain", "adain"),
    "adain_stats": ("masterthesis_tpu_torch.ops.kernels.adain", "adain_stats"),
    "int8_conv3x3": ("masterthesis_tpu_torch.ops.kernels.int8_conv", "conv3x3"),
    "int8_downconv": ("masterthesis_tpu_torch.ops.kernels.int8_conv", "downconv"),
    "int8_deconv": ("masterthesis_tpu_torch.ops.kernels.int8_conv", "deconv"),
    "int8_resblock": ("masterthesis_tpu_torch.ops.kernels.int8_conv", "resblock"),
    "head": ("masterthesis_tpu_torch.ops.kernels.head", "head"),
    "dec_mix": ("masterthesis_tpu_torch.ops.kernels.dec_mix", "dec_mix"),
    "resblock_fwd": ("masterthesis_tpu_torch.ops.kernels.resblock_train", "resblock_fwd"),
    "resblock_bwd": ("masterthesis_tpu_torch.ops.kernels.resblock_train", "resblock_bwd"),
}

_records: list = []  # [name, start_ns, end_ns, thread, parent, root, attrs] per span
_counts: dict = {}  # counter name -> total, see add()
# threading.get_ident() -> (native thread id, indices of its open spans, outermost first)
_threads: dict = {}
_lock = threading.Lock()
_MAIN = threading.main_thread().ident


class _Null:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "record", "stack")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        ident = threading.get_ident()
        thread = _threads.get(ident)
        if thread is None:  # the native id once per thread: a system call
            thread = _threads.setdefault(ident, (threading.get_native_id(), []))
        native, stack = thread
        with _lock:
            index = len(_records)
            main = _threads.get(_MAIN)
            base = (main[1] if main else None) or stack
            self.record = [self.name, time.time_ns(), None, native, stack[-1] if stack else -1,
                           base[0] if base else index, self.attrs]
            _records.append(self.record)
        stack.append(index)
        self.stack = stack
        return self

    def __exit__(self, exc_type, exc, tb):
        self.record[2] = time.time_ns()
        self.stack.pop()
        return None


def span(name: str, attrs: Optional[dict] = None):
    """A context manager that records the block as the span ``name`` while
    the recorder is on. Build ``attrs`` only when it is, so that the site
    allocates nothing while it is off: ``span("mt.x", ON and {"n": n})``."""
    if not ON:
        return _NULL
    return _Span(name, attrs or None)


def enable() -> None:
    """Turn the recorder on."""
    global ON
    ON = True


def disable() -> None:
    """Turn the recorder off; what it recorded stays until :func:`drain`."""
    global ON
    ON = False


def drain() -> list[tuple]:
    """The spans recorded since the last drain, in the order they opened,
    as tuples ``(name, start_ns, end_ns, thread, parent, root, attrs)``
    (``end_ns`` None for a span still open); parent and root index this
    list. Call it with no span open."""
    global _records
    with _lock:
        out, _records = _records, []
    return [tuple(r) for r in out]


def add(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``. A site calls it only while the
    recorder is on: ``if profiling.ON: profiling.add("x.bytes", n)``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def totals() -> dict[str, int]:
    """Each counter of :func:`add` so far, by name."""
    with _lock:
        return dict(_counts)


def counters() -> dict[str, int]:
    """Each hand-written kernel function's launches so far, by kernel name."""
    out = {}
    for kernel, (module, function) in KERNELS.items():
        out[kernel] = getattr(importlib.import_module(module), function).launches
    return out


def _chrome_events(spans: list[tuple], first: int = 0) -> list[dict]:
    """``spans`` (as :func:`drain` gives them; ``first`` the index of the
    first in the recorder's list) as chrome-trace complete events, ``ts`` in
    microseconds of ``time.time_ns()``, parent and root as indices into
    ``spans`` (-1: none among them)."""
    pid = os.getpid()
    at = lambda i: i - first if i >= first else -1  # noqa: E731
    return [{"name": name, "ph": "X", "ts": start / 1e3, "dur": (end - start) / 1e3,
             "pid": pid, "tid": thread,
             "args": {"parent": at(parent), "root": at(root), **(attrs or {})}}
            for name, start, end, thread, parent, root, attrs in spans if end is not None]


@contextlib.contextmanager
def trace(logdir: str):
    """Record the program's spans over the block and write them to
    ``logdir/trace.json`` (chrome-trace format, with each kernel's launches
    over the block under ``counters``). The recorder is left as it was
    found: where it was on, the block's spans also stay to be drained;
    where it was off, they go with the file. Drain nothing inside the
    block."""
    was_on = ON
    with _lock:
        first = len(_records)
    launches = counters()
    enable()
    try:
        yield
    finally:
        if not was_on:
            disable()
        with _lock:
            spans = [tuple(r) for r in _records[first:]]
            if not was_on:
                del _records[first:]
        after = counters()
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, "trace.json"), "w") as f:
            json.dump({"traceEvents": _chrome_events(spans, first), "displayTimeUnit": "ms",
                       "counters": {k: after[k] - launches[k] for k in after}}, f)


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
