#!/usr/bin/env python3
"""What bounds the int8 stride-1 conv (kernels 4 and 6) on an NVIDIA card:
timing knobs compiled into copies of ``masterthesis_tpu_torch/csrc/int8_conv.cu``.

    python3 scripts/int8_conv_knobs.py          # needs nvcc and a card

Each variant is the committed source with one change applied as a text
substitution (the script fails if a substitution no longer applies), built
into ``build/int8_conv_knobs/`` by the package's own build helper, with its
flags, and loaded with the wrappers' entry-point types:

- ``base``: the source as it is;
- ``no_epilogue``: the conv returns after its main loop (no staging, no
  statistics, no stores);
- ``no_store``: the epilogue without its global stores of y;
- ``loads_once``: the producer loads A and B only while the ring fills and
  the later k-steps reuse stale tiles (what TMA costs the main loop);
- ``quant_pad_c32`` / ``quant_pad_c64``: the NCHW quantize-and-pad with 32
  or 64 channels per block instead of 128.

The conv variants are timed (CUDA events over back-to-back launches on
rotating inputs) at (8, 256, 64, 64) -> 256 with NCHW y, with NCHW y and
statistics, and with NHWC y and statistics; the quantize-and-pad ones at
(8, 256, 64, 64) -> (8, 66, 66, 256) without and with a prologue. Results
are wrong for the knobs that skip work: they time, they do not check. One
JSON line per variant, after the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from masterthesis_tpu_torch.ops.kernels import build  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq  # noqa: E402

CSRC = ROOT / "masterthesis_tpu_torch" / "csrc"
OUT = ROOT / "build" / "int8_conv_knobs"
B, C, H, W = 8, 256, 64, 64
MAIN_LOOP_END = "  wgmma_wait<0>();\n  fence_acc(acc);\n\n  // the epilogue"
PRODUCER = """        mbar_expect_tx(&full[stage], kWABytes + kNW * kWK);
        const int tap = k / cslabs, c0 = (k % cslabs) * kWK;
        tma_load_2d(ring_a + stage * kWABytes, &map_in, &full[stage], c0,
                    row0 + (tap / 3) * p.Wp + tap % 3);
        tma_load_3d(ring_b + stage * kWBBytes, &map_w, &full[stage], c0, tap, n0);"""
VARIANTS = {
    "base": [],
    "no_epilogue": [(MAIN_LOOP_END, MAIN_LOOP_END.replace(
        "\n\n  // the epilogue",
        "\n  if (acc[0] == 123456789) p.y[0] = 1.f;  // keeps the main loop\n  return;\n\n"
        "  // the epilogue"))],
    "no_store": [("        ycol[px] = v;", "        (void)ycol;"),
                 ("          orow[c] = v;", "          (void)orow;")],
    "loads_once": [(PRODUCER, """        const bool load = k < kWStages;
        mbar_expect_tx(&full[stage], load ? kWABytes + kNW * kWK : 0);
        const int tap = k / cslabs, c0 = (k % cslabs) * kWK;
        if (load) tma_load_2d(ring_a + stage * kWABytes, &map_in, &full[stage], c0,
                              row0 + (tap / 3) * p.Wp + tap % 3);
        if (load) tma_load_3d(ring_b + stage * kWBBytes, &map_w, &full[stage], c0, tap, n0);""")],
    "quant_pad_c32": [("constexpr int kQC = 128;", "constexpr int kQC = 32;")],
    "quant_pad_c64": [("constexpr int kQC = 128;", "constexpr int kQC = 64;")],
}


def compile_variants() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    src = (CSRC / "int8_conv.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the substitution no longer applies: {old[:60]!r}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        jobs[name] = (OUT / f"{name}.cu", OUT / f"lib{name}.so")
    build.compile_sources(jobs)
    return {name: kq.typed(ctypes.CDLL(str(lib))) for name, (_, lib) in jobs.items()}


def device_ms(call, n_sets: int, iters: int = 30) -> float:
    for i in range(2):
        call(i % n_sets)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(iters):
        call(i % n_sets)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_conv_knobs: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = compile_variants()
    hp, wp, r = H + 2, W + 2, C
    tiles = libs["base"].mt_int8_stat_tiles(1, 0, H, W, wp, ctypes.byref(ctypes.c_int64()))
    n_sets = 6  # rotating inputs: 6 x (8.9 MB in + 33.5 MB out) exceed L2
    xq = [torch.randint(-127, 128, (B, hp, wp, C), dtype=torch.int8, device="cuda") for _ in range(n_sets)]
    ys = [torch.empty(B * r * H * W, device="cuda") for _ in range(n_sets)]
    ps = [torch.empty(2, B * tiles * r, dtype=torch.int64, device="cuda") for _ in range(n_sets)]
    w = torch.randint(-127, 128, (r, 9, C), dtype=torch.int8, device="cuda")
    scale = torch.rand(r, device="cuda")
    xs = [torch.randn(B, C, H, W, device="cuda") for _ in range(4)]
    inv = torch.tensor([20.0], device="cuda")
    pa, pb = torch.rand(B, C, device="cuda") + 0.5, torch.randn(B, C, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def conv(lib, stats, nhwc):
        def call(i):
            err = lib.mt_int8_conv(xq[i].data_ptr(), w.data_ptr(), scale.data_ptr(), None,
                                   ys[i].data_ptr(), ps[i][0].data_ptr() if stats else None,
                                   ps[i][1].data_ptr() if stats else None, B, hp, wp, C, r, 9, 3, 1,
                                   H, W, r, tiles, 0, int(nhwc), stream)
            assert err == 0, err
        return call

    def quant_pad(lib, prologue):
        def call(i):
            err = lib.mt_int8_quant_pad(xs[i % 4].data_ptr(), xq[i].data_ptr(), inv.data_ptr(),
                                        pa.data_ptr() if prologue else None,
                                        pb.data_ptr() if prologue else None, 1, 0.0, B, C, H, W, C,
                                        hp, wp, 1, 1, 1, stream)
            assert err == 0, err
        return call

    for name, lib in libs.items():
        row = dict(variant=name, shape=[B, C, H, W], co=r)
        if name.startswith("quant_pad") or name == "base":
            row.update(quant_pad_ms=device_ms(quant_pad(lib, False), n_sets),
                       quant_pad_prologue_ms=device_ms(quant_pad(lib, True), n_sets))
        if not name.startswith("quant_pad"):
            row.update(conv_nchw_ms=device_ms(conv(lib, False, False), n_sets),
                       conv_nchw_stats_ms=device_ms(conv(lib, True, False), n_sets),
                       conv_nhwc_stats_ms=device_ms(conv(lib, True, True), n_sets))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
