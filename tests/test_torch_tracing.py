"""The port's span recorder (``utils/profiling.py``) on the CPU: off by
default at no cost to a span site, the span trees of a serving request and
of the two training steps, spans of a second thread, the exporter, the
launch counters by kernel name, and the clock it shares with
``torch.profiler``'s chrome traces."""
import gzip
import json
import statistics
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from masterthesis_tpu_torch.arguments import default_test_args, default_train_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=2, logdir=None)

# the fused main step's phases in order, each with the spans directly under it
FUSED = [
    ("mt.g1.forward", ["mt.encode_content", "mt.encode_style", "mt.decode",
                       "mt.encode_content", "mt.encode_style", "mt.decode"]),
    ("mt.d1.update", ["mt.opt.grad", "mt.opt.adam"]),
    ("mt.d2.decode", ["mt.decode"]),
    ("mt.d2.update", ["mt.opt.grad", "mt.opt.adam"]),
    ("mt.g.adv", []),
    ("mt.g.update", ["mt.opt.grad", "mt.opt.adam", "mt.opt.adam", "mt.opt.adam"]),
    ("mt.g2.phase", ["mt.encode_content", "mt.decode", "mt.encode_style", "mt.opt.grad",
                     "mt.opt.adam", "mt.opt.adam"]),
]


@pytest.fixture
def recorder():
    """The recorder on and empty; off and drained after the test."""
    profiling.drain()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.drain()


def children(spans, parent):
    return [i for i, s in enumerate(spans) if s[4] == parent]


def check_nesting(spans):
    """Every span closed, inside its parent, on its parent's thread."""
    for name, start, end, thread, parent, root, _ in spans:
        assert end is not None and start <= end, name
        if parent >= 0:
            p = spans[parent]
            assert p[1] <= start and end <= p[2] and p[3] == thread, (name, p[0])


def test_off_by_default_a_site_returns_the_shared_null_and_records_nothing():
    assert not profiling.ON
    profiling.drain()
    a, b = profiling.span("mt.x"), profiling.span("mt.y", profiling.ON and {"n": 1})
    assert a is b
    with a as entered:
        assert entered is a
    with pytest.raises(ValueError):  # an exception passes through the null context
        with profiling.span("mt.x"):
            raise ValueError
    assert profiling.drain() == []


def test_the_span_tree_of_one_request(recorder):
    model = AdaINModel(default_test_args(**SHAPE), device="cpu")
    profiling.drain()
    g = torch.Generator().manual_seed(0)
    img, z = torch.rand((2, 32, 32, 3), generator=g) * 2 - 1, torch.randn((2, 4), generator=g)
    model.forward_random(img, z, torch.eye(4)[:2])
    spans = profiling.drain()
    check_nesting(spans)
    assert spans[0][0] == "mt.serve.request" and spans[0][4] == -1
    assert spans[0][6] == {"images": 2}
    # no synchronize on the CPU, so no mt.serve.sync
    assert [spans[i][0] for i in children(spans, 0)] == ["mt.encode_content", "mt.decode"]
    assert all(s[5] == 0 for s in spans)


def test_the_span_trees_of_a_content_step_and_a_fused_main_step(recorder):
    args = default_train_args(**SHAPE, dis_content_layers=1, dis_content_final_kernel=2,
                              use_dis_content=True, gan_step="fused", d_iter=2,
                              compute_dtype="float32")
    model = AdaINModel(args, device="cpu")
    setup = [s[0] for s in profiling.drain()]
    assert setup == ["mt.setup.initialize"]
    x = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    batch = {"x1": x[:2], "x2": x[2:], "y1": torch.eye(4)[:2], "y2": torch.eye(4)[2:]}
    draws = torch.Generator().manual_seed(2)
    for it in (1, 2):
        model.optimize_parameters(batch, it, StepDraws(draws))
    spans = profiling.drain()
    check_nesting(spans)
    roots = children(spans, -1)
    assert [spans[i][0] for i in roots] == ["mt.train.content_step", "mt.train.main_step"]
    assert [spans[i][6] for i in roots] == [{"iter": 1}, {"iter": 2}]
    for r in roots:  # each span's root is the step it serves
        end = next((j for j in roots if j > r), len(spans))
        assert all(spans[i][5] == r for i in range(r, end))
    content, main = roots
    assert [spans[i][0] for i in children(spans, content)] == [
        "mt.encode_content", "mt.opt.grad", "mt.opt.adam"]
    assert spans[children(spans, content)[-1]][6] == {"net": "content_discriminator", "leaves": 6}
    phases = children(spans, main)
    assert [(spans[p][0], [spans[c][0] for c in children(spans, p)]) for p in phases] == FUSED
    adam = [spans[i][6] for i in range(len(spans)) if spans[i][0] == "mt.opt.adam"]
    assert [a["net"] for a in adam[1:]] == ["discriminator1", "discriminator2", "content_encoder",
                                           "style_encoder", "decoder", "content_encoder",
                                           "decoder"]
    assert all(a["leaves"] == len(list(model.nets[a["net"]].parameters())) for a in adam)


def test_a_second_thread_keeps_its_own_parents_and_takes_the_main_root(recorder):
    opened, done = threading.Event(), threading.Event()

    def worker():
        with profiling.span("mt.worker"):
            with profiling.span("mt.worker.inner"):
                opened.set()
                done.wait(10)

    with profiling.span("mt.request"):
        with profiling.span("mt.phase"):
            t = threading.Thread(target=worker)
            t.start()
            assert opened.wait(10)
            with profiling.span("mt.main.inner"):
                pass
            done.set()
            t.join(10)
    assert not t.is_alive()
    spans = {s[0]: (i, s) for i, s in enumerate(profiling.drain())}
    request, phase = spans["mt.request"][0], spans["mt.phase"][0]
    worker_i, worker_s = spans["mt.worker"]
    inner = spans["mt.worker.inner"][1]
    assert worker_s[4] == -1 and inner[4] == worker_i  # its own thread's parents
    assert worker_s[5] == request and inner[5] == request  # the main thread's root
    assert worker_s[3] != spans["mt.request"][1][3]
    assert spans["mt.main.inner"][1][4] == phase


def test_trace_writes_the_spans_and_leaves_the_recorder_off(tmp_path):
    profiling.drain()
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("mt.outer", profiling.ON and {"images": 3}):
            with profiling.span("mt.inner"):
                pass
    assert not profiling.ON and profiling.drain() == []
    got = json.loads((tmp_path / "prof" / "trace.json").read_text())
    events = {e["name"]: e for e in got["traceEvents"]}
    assert set(events) == {"mt.outer", "mt.inner"}
    outer, inner = events["mt.outer"], events["mt.inner"]
    assert outer["ph"] == "X" and outer["args"] == {"parent": -1, "root": 0, "images": 3}
    assert inner["args"] == {"parent": 0, "root": 0}
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert abs(outer["ts"] - time.time_ns() / 1e3) < 60e6
    assert set(got["counters"]) == set(profiling.KERNELS)


def test_counters_name_every_kernel_file_and_read_its_launches():
    files = {p.stem for p in (ROOT / "portbench" / "kernels").glob("*.json")}
    counts = profiling.counters()
    # dec_mix has no kernel file yet: the benchmark does not count its work
    assert set(counts) == files | {"adain_stats", "dec_mix"}
    assert all(isinstance(n, int) and n >= 0 for n in counts.values())


def test_the_clock_is_the_profiler_traces(tmp_path, recorder):
    """A program span and a ``record_function`` opened together: the span's
    start, as ``(t_ns - baseTimeNanoseconds) / 1000``, lies within 200 us
    of the annotation's ``ts``, by the median over 20 pairs; no ``mt.``
    span enters the profiler's trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with record_function(f"anchor{i}"), profiling.span(f"mt.anchor{i}"):
                torch.ones(64).sum()
    path = tmp_path / "trace.json.gz"
    prof.export_chrome_trace(str(path))
    with gzip.open(path, "rt") as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    anchors = {e["name"]: e["ts"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert not any(name.startswith("mt.") for name in anchors)
    spans = profiling.drain()
    gaps = [abs((start - base) / 1e3 - anchors[name[len("mt."):]])
            for name, start, *_ in spans]
    assert len(gaps) == 20 and statistics.median(gaps) < 200
