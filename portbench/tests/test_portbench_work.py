"""The kernel yardstick (``work.py``) against hand counts at the flagship
shapes, and the trace reduction and the share readers on synthetic
profiles. CPU only."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import common, work  # noqa: E402
from portbench.trace import Summary, reduce  # noqa: E402

B = 64  # the serving cells' batch


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def qc(cin, cout, stride=1, phases=1, bias=True):
    return SimpleNamespace(cin=cin, cout=cout, stride=stride, phases=phases,
                           bias=meta(cout, dtype=torch.float32) if bias else None)


def test_int8_resblock_at_the_flagship_shape():
    x = meta(B, 256, 64, 64)
    got = work.int8_resblock((x, qc(256, 256, bias=False), qc(256, 256, bias=False),
                              meta(B, 256, dtype=torch.float32), meta(B, 256, dtype=torch.float32)),
                             {}, meta(B, 256, 64, 64))
    # two convs of 64 x 256 x 64 x 64 outputs, each summing 256 x 9 products
    assert got["ops"]["int8"] == 2 * 2 * (64 * 256 * 64 * 64) * (256 * 9)
    # x and y in bf16; two int8 kernels, their f32 scales and the activation
    # scale; gamma and beta (64, 256) f32; no h1 or h2
    assert got["bytes"] == (2 * 64 * 256 * 64 * 64 * 2 + 2 * (256 * 256 * 9 + 256 * 4 + 4)
                            + 2 * 64 * 256 * 4)


def test_int8_downconv_with_prologue_and_statistics():
    x = meta(B, 64, 256, 256)
    pending = {"scale": meta(B, 64, dtype=torch.float32), "shift": meta(B, 64, dtype=torch.float32)}
    y, s, q = meta(B, 128, 128, 128), meta(B, 128, dtype=torch.float32), meta(B, 128,
                                                                               dtype=torch.float32)
    got = work.int8_conv((x, qc(64, 128, stride=2), pending, True), {}, (y, s, q))
    assert got["ops"]["int8"] == 2 * (64 * 128 * 128 * 128) * (64 * 9)
    assert got["bytes"] == (64 * 64 * 256 * 256 * 2 + 2 * 64 * 64 * 4
                            + (128 * 64 * 9 + 128 * 4 + 128 * 4 + 4)
                            + 64 * 128 * 128 * 128 * 2 + 2 * 64 * 128 * 4)


def test_int8_deconv_counts_the_taps_that_land():
    x = meta(B, 256, 64, 64)
    y = meta(B, 128, 128, 128)
    got = work.int8_conv((x, qc(256, 128, phases=4), None, False), {}, y)
    # per axis, of the 3 x 64 (input, tap) pairs of a k3/s2/p1/op1 transposed
    # conv only the tap 0 of input 0 falls outside the 128 outputs: 191
    assert got["ops"]["int8"] == 2 * 64 * 256 * 128 * 191 * 191
    assert got["bytes"] == (64 * 256 * 64 * 64 * 2 + (128 * 256 * 9 + 128 * 4 + 128 * 4 + 4)
                            + 64 * 128 * 128 * 128 * 2)


def test_head_moments_adain():
    x = meta(B, 64, 256, 256)
    pending = {"scale": meta(B, 64, dtype=torch.float32), "shift": meta(B, 64, dtype=torch.float32)}
    got = work.head((x, pending, meta(64, 3, dtype=torch.float32)), {}, meta(B, 3, 256, 256))
    assert got["ops"]["f32"] == 2 * 64 * 256 * 256 * 64 * 3 + 3 * x.numel() + 64 * 3 * 256 * 256
    assert got["bytes"] == (x.numel() * 2 + 2 * 64 * 64 * 4 + 64 * 3 * 4 + 64 * 3 * 256 * 256 * 2)
    x = meta(8, 256, 64, 64)
    sums = (meta(8, 256, dtype=torch.float32), meta(8, 256, dtype=torch.float32))
    assert work.moments((x,), {}, sums)["bytes"] == 8 * 256 * 64 * 64 * 2 + 2 * 8 * 256 * 4
    g = meta(8, 256, dtype=torch.float32)
    assert work.adain((x, g, g), {}, x)["bytes"] == 2 * 8 * 256 * 64 * 64 * 2 + 2 * 8 * 256 * 4


def test_training_resblock_forward_and_backward():
    x = meta(16, 256, 64, 64)
    w = meta(256, 256, 3, 3, dtype=torch.float32)
    g = meta(16, 256, dtype=torch.float32)
    h = meta(16, 64, 64, 256)
    stats = meta(16, 4, 256, dtype=torch.float32)
    fwd = work.resblock_fwd((x, w, w, g, g), {}, (x, h, h, stats))
    assert fwd["ops"]["bf16"] == 2 * 2 * (16 * 256 * 64 * 64) * (256 * 9)
    act = 16 * 256 * 64 * 64 * 2
    assert fwd["bytes"] == act + 2 * 256 * 256 * 9 * 4 + 2 * 16 * 256 * 4 + 3 * act + 16 * 4 * 256 * 4
    bwd = work.resblock_bwd((x, h, h, x, stats, w, w, g, g), {}, (x, w, w, g, g))
    assert bwd["ops"]["bf16"] == 2 * 4 * (16 * 256 * 64 * 64) * (256 * 9)


def test_least_time_is_the_slower_of_compute_and_memory():
    assert work.least_seconds({"int8": 1979e12}, 0) == pytest.approx(1.0)
    assert work.least_seconds({"bf16": 989e12}, 3.35e12 * 2) == pytest.approx(2.0)


def _trace(kernel_us, idle_us):
    """One request span with one kernel call launched inside it: the kernel
    runs ``kernel_us``, then the device idles ``idle_us``."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": "pb.s.request", "ts": 0.0,
         "dur": kernel_us + idle_us, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.k.int8_resblock", "ts": 0.0, "dur": 1.0,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.5, "dur": 0.1,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "conv", "ts": 0.0, "dur": kernel_us,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": kernel_us, "dur": idle_us,
         "tid": 1},
    ]


class _Calls:
    def __init__(self, least_s):
        self.by_kernel = {"int8_resblock": {"calls": 1, "ops": {"int8": 1}, "bytes": 1,
                                            "least_s": least_s}}


@pytest.mark.parametrize("kernel_us,idle_us", [(100.0, 0.0), (100.0, 300.0), (400.0, 100.0)])
def test_shares_cannot_pass_100_on_a_synthetic_profile(kernel_us, idle_us):
    least = 100e-6  # the kernel's least time; it never runs faster
    s = reduce(_trace(kernel_us, idle_us), _Calls(least))
    assert s.window_s == pytest.approx((kernel_us + idle_us) / 1e6)
    assert s.busy_s == pytest.approx(kernel_us / 1e6)
    assert s.kernels["int8_resblock"]["device_s"] == pytest.approx(kernel_us / 1e6)
    roof = common.metric_reader("kernel_roofline.serve")(s)
    assert roof == pytest.approx(100.0 * least / (kernel_us / 1e6)) and roof <= 100.0 + 1e-9
    idle = common.metric_reader("idle_share.serve")(s)
    assert idle == pytest.approx(100.0 * idle_us / (kernel_us + idle_us))
    # an mfu of operations that need the whole request at peak is 100 %
    s.extra["ops_per_request"] = {"int8": work.PEAKS["int8"] * (kernel_us + idle_us) / 1e6}
    assert common.metric_reader("mfu.serve")(s) == pytest.approx(100.0)
    assert s.breakdown["device_ops"] == [["conv", kernel_us / 1e6]]
    if idle_us:
        assert s.breakdown["idle_gaps"] == [["aten::copy_", idle_us / 1e6]]


def test_readers_return_nothing_without_something_to_read():
    empty = Summary()
    for m in common.benchmark()["per_layer"]:
        assert common.metric_reader(m["name"])(empty) is None, m["name"]


SPECS = {"int8_resblock": {"launches": ["::conv_s1_wgmma_kernel<", "::residual_nhwc_kernel<"]},
         "int8_conv3x3": {"launches": ["::conv_s1_wgmma_kernel<"]}}
CONV = "void (anonymous namespace)::conv_s1_wgmma_kernel<256, __nv_bfloat16>(CUtensorMap_st)"


def _launch(corr, ts, name, kernel_ts):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 0.1,
             "tid": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": kernel_ts, "dur": 10.0,
             "args": {"correlation": corr}}]


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _counted(*kernels):
    calls = type("C", (), {})()
    calls.by_kernel = {k: {"calls": 1, "ops": {}, "bytes": 0, "least_s": 0.0} for k in kernels}
    return calls


def test_a_launch_outside_every_kernel_call_is_counted_as_escaped():
    """A call of the conv that no wrapper saw (a path binding the function
    itself) launches under no pb.k span; an ATen launch matches no name."""
    events = [_span("pb.s.request", 0.0, 100.0), _span("pb.k.int8_resblock", 1.0, 5.0),
              *_launch(1, 2.0, CONV, 10.0), *_launch(2, 20.0, CONV, 30.0),
              *_launch(3, 25.0, "void at::native::elementwise_kernel<128, 4>", 50.0)]
    s = reduce(events, _counted("int8_resblock"), SPECS)
    assert s.kernels["int8_resblock"]["launches"] == 1
    assert s.escaped == {CONV: 1}


def test_nested_kernel_calls_own_their_launches():
    """A launch after a nested call has ended belongs to the outer call."""
    events = [_span("pb.s.request", 0.0, 100.0), _span("pb.k.int8_resblock", 1.0, 20.0),
              _span("pb.k.int8_conv3x3", 2.0, 3.0), *_launch(1, 3.0, CONV, 10.0),
              *_launch(2, 10.0, CONV, 30.0)]
    s = reduce(events, _counted("int8_resblock", "int8_conv3x3"), SPECS)
    assert s.kernels["int8_conv3x3"]["launches"] == 1
    assert s.kernels["int8_resblock"]["launches"] == 1
    assert s.escaped == {}


def test_the_witness_fails_a_cell_whose_kernel_was_not_seen():
    from portbench import run

    cell = common.resolve("adain_256.serve_bf16_b64")
    seen = Summary(kernels={"moments": {"calls": 3, "launches": 3},
                            "adain": {"calls": 2, "launches": 0}})
    assert run.witness(cell, seen)["kernels_unseen"]["value"] == 1
    seen.kernels["adain"]["launches"] = 2
    got = run.witness(cell, seen)
    assert got["kernels_unseen"]["value"] == 0 and got["launches_unwrapped"]["value"] == 0
    seen.escaped = {CONV: 4}
    assert run.witness(cell, seen)["launches_unwrapped"] == {"value": 4, "limit": 0}
