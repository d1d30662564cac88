"""The program's spans placed on a device window's trace (``spans.py``), on
synthetic chrome traces: the clock check and its fit, device operations
under the span that launched them (by correlation id, on the launching
thread or else any), idle gaps named by span or ``between program spans``,
and the per-layer numbers read from the reduction. CPU only."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import spans  # noqa: E402

BASE = 1_790_000_000 * 10**9  # baseTimeNanoseconds
MAIN, BACKWARD = 11, 12  # thread ids


def ns(us: float) -> int:
    """A ``time.time_ns()`` stamp at ``us`` on the trace's axis."""
    return BASE + int(us * 1e3)


def span(name, t0, t1, parent=-1, root=0, thread=MAIN, attrs=None):
    return (name, ns(t0), ns(t1), thread, parent, root, attrs)


def launch(corr, ts, dev_ts, dur=10.0, tid=MAIN, name="void at::native::kernel"):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2.0,
             "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": dev_ts, "dur": dur,
             "args": {"correlation": corr}}]


def sync(ts, dur=5.0, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": ts,
            "dur": dur, "tid": tid, "args": {"correlation": 0}}


def trace(events, shift_us=0.0):
    """A chrome trace whose clock runs ``shift_us`` behind the spans'."""
    moved = [{**e, "ts": e["ts"] + shift_us} for e in events]
    return {"traceEvents": moved, "baseTimeNanoseconds": BASE}


def serving():
    """Two requests of 1000 us: content encoder, decoder, the synchronize;
    the device idles inside the decoder's enqueue and between requests."""
    program, events = [], []
    for r, t in enumerate((0.0, 1500.0)):
        root = 4 * r
        program += [span("mt.serve.request", t, t + 1000, root=root, attrs={"images": 64}),
                    span("mt.encode_content", t + 10, t + 300, root, root),
                    span("mt.decode", t + 300, t + 800, root, root),
                    span("mt.serve.sync", t + 800, t + 1000, root, root)]
        events += launch(10 * r + 1, t + 20, t + 30, dur=400)  # busy t+30..t+430
        events += launch(10 * r + 2, t + 350, t + 600, dur=390)  # idle t+430..t+600
        events.append(sync(t + 802))
    return program, events


def test_serving_spans_map_onto_the_trace_and_name_its_gaps():
    program, events = serving()
    got = spans.reduce(trace(events), program, anchors_ns=(ns(801.0), ns(2301.0)))
    assert got["clock"]["pairs"] == 2 and got["clock"]["median_us"] == pytest.approx(1.0)
    assert got["clock"]["fitted_us"] == 0.0
    assert got["sync_lag"]["pairs"] == 2 and got["sync_lag"]["median_us"] == pytest.approx(2.0)
    assert got["enqueue_s"] == pytest.approx([800e-6, 800e-6])
    assert got["roots"] == {"mt.serve.request": pytest.approx([1e-3, 1e-3])}
    # the decoder's launch lies under it, and both under the request
    assert got["by_name"]["mt.decode"] == {"device_s": pytest.approx(780e-6), "ops": 2}
    assert got["by_name"]["mt.serve.request"]["ops"] == 4
    assert got["covered"] == 1.0
    # gaps: 540 us between the requests, 170 us in each decode, and the 10 us
    # from the window's first launch to its kernel
    assert got["idle_spans"] == [[spans.BETWEEN, pytest.approx(540e-6)],
                                 ["mt.decode", pytest.approx(170e-6)],
                                 ["mt.decode", pytest.approx(170e-6)],
                                 ["mt.encode_content", pytest.approx(10e-6)]]
    assert got["idle_by_phase"] == {spans.BETWEEN: pytest.approx(540e-6),
                                    "mt.decode": pytest.approx(340e-6),
                                    "mt.encode_content": pytest.approx(10e-6)}
    assert spans.readings(got) == {"enqueue_ms.serve": pytest.approx(0.8)}


def test_a_drifted_clock_is_fitted_from_the_anchors_and_not_from_the_sync_spans():
    program, events = serving()
    anchors = (ns(801.0), ns(2301.0))
    got = spans.reduce(trace(events, shift_us=700.0), program, anchors)
    assert got["clock"]["median_us"] == pytest.approx(701.0)
    assert got["clock"]["fitted_us"] == pytest.approx(701.0)
    # once moved, the decoder's launches and gaps are its own again
    assert got["by_name"]["mt.decode"]["ops"] == 2
    assert got["idle_by_phase"]["mt.decode"] == pytest.approx(340e-6, rel=0.02)
    # a sync span's start lags by the host's time before the runtime call
    # too: reported, never fitted
    late = spans.reduce(trace([*launch(1, 5.0, 10.0), sync(900.0)]),
                        [span("mt.serve.request", 0, 950),
                         span("mt.serve.sync", 830, 950, 0, 0)], anchors_ns=(ns(898.0),))
    assert late["sync_lag"]["median_us"] == pytest.approx(70.0)
    assert late["clock"]["median_us"] == pytest.approx(2.0) and late["clock"]["fitted_us"] == 0.0


def training():
    """One main step (G update with a backward thread's launches, then Adam
    over one net) and one content step, d_iter 2: one cycle."""
    program = [span("mt.train.main_step", 0, 5000, attrs={"iter": 2}),
               span("mt.g.update", 100, 4000, 0, 0),
               span("mt.opt.grad", 100, 3000, 1, 0),
               span("mt.k.resblock_bwd", 500, 1000, -1, 0, thread=BACKWARD),
               span("mt.opt.adam", 3000, 4000, 1, 0, attrs={"net": "decoder", "leaves": 3}),
               span("mt.train.content_step", 6000, 8000, root=5, attrs={"iter": 3}),
               span("mt.opt.adam", 7000, 7500, 5, 5)]
    events = [*launch(1, 600, 700, 200, BACKWARD),  # kernel 10, under its own span
              *launch(2, 1500, 1600, 300, BACKWARD),  # backward ATen: under mt.opt.grad
              *launch(3, 3100, 3200, 100), *launch(4, 3200, 3400, 100),  # Adam, 2 ops
              *launch(5, 7100, 7200, 100),  # the content step's Adam
              *launch(6, 5500, 5600, 50)]  # between the steps: under no root
    return program, events


def test_training_ops_go_to_the_launching_threads_span_and_the_root():
    program, events = training()
    got = spans.reduce(trace(events), program)
    by = got["by_name"]
    assert by["mt.k.resblock_bwd"]["ops"] == 1 and "mt.opt.grad" in by
    assert by["mt.opt.grad"]["ops"] == 1  # the backward thread's ATen launch
    assert by["mt.train.main_step"]["ops"] == 4 and by["mt.train.content_step"]["ops"] == 1
    assert by["mt.opt.adam"] == {"device_s": pytest.approx(300e-6), "ops": 3}
    assert got["covered"] == pytest.approx(5 / 6)
    assert got["host_s"]["mt.opt.adam"] == pytest.approx(1.5e-3)
    # a gap is named by the innermost span on any thread (600-700 by kernel
    # 10's), by the root where no phase is open (3500-5600, 5650-7200)
    assert got["idle_spans"] == [["mt.train.main_step", pytest.approx(2.1e-3)],
                                 ["mt.train.content_step", pytest.approx(1.55e-3)],
                                 ["mt.opt.grad", pytest.approx(1.3e-3)],
                                 ["mt.opt.grad", pytest.approx(0.7e-3)],
                                 ["mt.k.resblock_bwd", pytest.approx(0.1e-3)],
                                 ["mt.opt.adam", pytest.approx(0.1e-3)]]
    assert got["idle_by_phase"] == {"mt.g.update": pytest.approx(2.2e-3),
                                    "mt.train.main_step": pytest.approx(2.1e-3),
                                    "mt.train.content_step": pytest.approx(1.55e-3)}
    read = spans.readings(got, cycles=1.0)
    assert read == {"step_host_ms.train": pytest.approx(5.0),
                    "optimizer_host_ms.train": pytest.approx(1.5),
                    "optimizer_device_ms.train": pytest.approx(0.3),
                    "launches_per_cycle.train": 5}


def test_set_up_spans_and_nothing_to_read():
    program = [span("mt.setup.initialize", 0, 2e6), span("mt.setup.load_params", 2e6, 2.5e6)]
    got = spans.reduce(trace([]), program)
    assert got["setup_parts"] == {"initialize_s": pytest.approx(2.0),
                                  "load_params_s": pytest.approx(0.5)}
    assert got["idle_spans"] == [] and got["clock"]["pairs"] == 0
    assert spans.readings(got, cycles=3.0) == {}
    assert spans.readings(spans.reduce(trace(serving()[1]), [])) == {}
