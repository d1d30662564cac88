#!/usr/bin/env python3
"""What bounds the int8 conv template (kernels 4-7) on an NVIDIA card:
timing knobs compiled into copies of ``masterthesis_tpu_torch/csrc/int8_conv.cu``.

    python3 scripts/int8_conv_knobs.py          # needs nvcc and a card
    python3 scripts/int8_conv_knobs.py base grid_m_fastest grid_m_fastest base
                                                # only these, in this order (in turns)

Each variant is the committed source with one change applied as text
substitutions (the script fails if one no longer applies), built
into ``build/int8_conv_knobs/`` by the package's own build helper, with its
flags, and loaded with the wrappers' entry-point types:

- ``base``: the source as it is;
- ``no_epilogue``: the conv returns after its main loop (no staging, no
  statistics, no stores);
- ``no_store``: the epilogue without its global stores of y;
- ``loads_once``: the producer loads A and B only while the ring fills and
  the later k-steps reuse stale slabs (what TMA costs the main loop);
- ``thread_stores``: the stride-2 and transposed convs store y from the
  threads (a warp per staged row) instead of by TMA stores, in either
  dtype;
- ``no_stats`` / ``no_y_staging``: their epilogue without the int64
  partials, or without staging y for the stores;
- ``grid_m_fastest``: their grid runs every M tile of N tile 0 before N
  tile 1's (the source runs the N tiles of one M tile back to back);
- ``box_n256``: their N tiles 256 wide (one block per SM; the path's R
  leave no tail tile);
- ``slab_128``: their 64-channel inputs (down0) in 128-channel slabs, half
  zeros, as wider inputs are;
- ``quant_pad_c64`` / ``quant_pad_c128``: the NCHW quantize-and-pad with 64
  or 128 channels per block at every width (the source takes 64 for inputs
  of at most 64 channels, else 128).

The conv variants are timed (CUDA events over back-to-back launches on
rotating inputs that exceed L2) at the stride-1 conv's (8, 256, 64, 64) ->
256 with NCHW y, with NCHW y and statistics, and with NHWC y and
statistics; and at the AdaINModel int8 forward's stride-2 convs (down0:
(8, 64, 256, 256) -> 128, down1: (8, 128, 128, 128) -> 256) and transposed
convs (up0: (8, 256, 64, 64) -> 128, up1: (8, 128, 128, 128) -> 64; and
BaseModel B's, upB0: Cp 288 -> 138, upB1: (8, 160, 128, 128) -> 73), with
statistics as on the path, y f32 and bf16 (``*_bf16_ms``). The
quantize-and-pad ones at (8, 256, 64, 64) -> (8, 66, 66, 256) without and
with a prologue, and at down0's (8, 64, 256, 256) -> (8, 258, 258, 64)
with one, x f32 and bf16. Results are wrong for the
knobs that skip work: they time, they do not check. One JSON line per
variant, after the card's name and power limit.
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
# the end of the main loop, in both kernels
MAIN_LOOP_END = "\n\n  // the epilogue, over the ring"
# the producer's step, shared by both kernels
PRODUCER = """    mbar_expect_tx(&full[stage], bytes);
    load(ring_a + stage * kA, ring_b + stage * kB, k, &full[stage]);
"""
VARIANTS = {
    "base": [],
    "no_epilogue": [(MAIN_LOOP_END, "\n  if (acc[0] == 123456789) p.psum[0] = 1;  // keeps the "
                     "main loop\n  return;" + MAIN_LOOP_END, 2)],
    "no_store": [("        ycol[px] = mt::from_float<TOut>(v);", "        (void)ycol;"),
                 ("          orow[c] = mt::from_float<TOut>(v);", "          (void)orow;"),
                 ("  if (p.tma_y) {\n", "  if (p.tma_y) {\n    return;\n"),
                 ("  for (int row = gw; row < chunks * chunk_rows; row += 8) {",
                  "  for (int row = gw; row < 0; row += 8) {")],
    "loads_once": [(PRODUCER, """    const bool ld = k < kStages;
    mbar_expect_tx(&full[stage], ld ? bytes : 0);
    if (ld) load(ring_a + stage * kA, ring_b + stage * kB, k, &full[stage]);
""")],
    "thread_stores": [("mt_int8_y_by_tma(stride, phases, Wo, y_bf16) && aligned(y)", "false")],
    "quant_pad_c64": [("const int qc = Cp <= 64 ? 64 : 128;", "const int qc = 64;")],
    "quant_pad_c128": [("const int qc = Cp <= 64 ? 64 : 128;", "const int qc = 128;")],
    "no_stats": [("  if (p.psum != nullptr) {\n    const int c = threadIdx.x % 128, r0 = wg * 64;",
                  "  if (false) {\n    const int c = threadIdx.x % 128, r0 = wg * 64;")],
    "no_y_staging": [("#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n    const int r = wg * 64 + warp * 16 "
                      "+ lane / 4 + 8 * h, ly = r >> lg, lx = r & (p.bx - 1);\n    if (ly >= by) "
                      "continue;  // past a box of fewer than 128 pixels\n#pragma unroll\n    for (int e",
                      "#pragma unroll\n  for (int h = 0; h < 0; ++h) {\n    const int r = wg * 64 + warp * 16 "
                      "+ lane / 4 + 8 * h, ly = r >> lg, lx = r & (p.bx - 1);\n    if (ly >= by) "
                      "continue;  // past a box of fewer than 128 pixels\n#pragma unroll\n    for (int e")],
    "box_n256": [("constexpr int kBoxNW = 128;", "constexpr int kBoxNW = 256;"),
                 ("__launch_bounds__(kWThreads, 2)\n    conv_box_kernel",
                  "__launch_bounds__(kWThreads, 1)\n    conv_box_kernel")],
    "slab_128": [("const bool narrow = Cp <= 64;\n  const uint32_t slab",
                  "const bool narrow = false;\n  const uint32_t slab")],
    "grid_m_fastest": [("const int mt = blockIdx.x / p.ntiles, nt = blockIdx.x % p.ntiles;",
                        "const int mt = blockIdx.x % (gridDim.x / p.ntiles), "
                        "nt = blockIdx.x / (gridDim.x / p.ntiles);")],
}


def variant_sources() -> dict:
    """Each variant's source: the committed one with its substitutions, each
    of which must match as many times as it says (once by default)."""
    src = (CSRC / "int8_conv.cu").read_text()
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new, *count in subs:
            if text.count(old) != (count[0] if count else 1):
                raise RuntimeError(f"{name}: the substitution no longer applies as it should: "
                                   f"{old[:60]!r} is found {text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def compile_variants(names=None) -> dict:
    sources = {k: v for k, v in variant_sources().items() if names is None or k in names}
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    jobs = {}
    for name, text in sources.items():
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


# the stride-2 and transposed convs of the AdaINModel int8 forward and
# BaseModel B's transposed convs: (name, B, C (= Cp), H, W, Co, stride, phases)
PATH_CONVS = [("down0", 8, 64, 256, 256, 128, 2, False), ("down1", 8, 128, 128, 128, 256, 2, False),
              ("up0", 8, 256, 64, 64, 128, 1, True), ("up1", 8, 128, 128, 128, 64, 1, True),
              # BaseModel B's (DecoderConcat: 276 -> 138, 146 -> 73)
              ("upB0", 8, 288, 64, 64, 138, 1, True), ("upB1", 8, 160, 128, 128, 73, 1, True)]


def conv_case(lib, b, c, h, w, co, stride, phases, nhwc=False, stats=True, y_bf16=False):
    """A timed call of ``lib``'s conv at one shape, y f32 or with ``y_bf16``
    bf16, on rotating buffers that exceed L2, and the number of buffer
    sets."""
    if phases:
        hp, wp, ho, wo, r, taps, kw = h + 1, w + 1, h, w, 4 * co, 4, 2
    else:
        hp, wp, r, taps, kw = h + 2, w + 2, co, 9, 3
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    tiles = lib.mt_int8_stat_tiles(stride, int(phases), ho, wo, wp, ctypes.byref(ctypes.c_int64()))
    out = b * r * ho * wo
    n_sets = max(2, -(-3 * 50 * 2**20 // (b * hp * wp * c + (2 if y_bf16 else 4) * out)))
    xq = [torch.randint(-127, 128, (b, hp, wp, c), dtype=torch.int8, device="cuda")
          for _ in range(n_sets)]
    ys = [torch.empty(out, device="cuda", dtype=torch.bfloat16 if y_bf16 else torch.float32)
          for _ in range(n_sets)]
    ps = [torch.empty(2, b * tiles * r, dtype=torch.int64, device="cuda") for _ in range(n_sets)]
    wt = torch.randint(-127, 128, (r, taps, c), dtype=torch.int8, device="cuda")
    scale = torch.rand(r, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(i):
        err = lib.mt_int8_conv(xq[i].data_ptr(), wt.data_ptr(), scale.data_ptr(), None,
                               ys[i].data_ptr(), ps[i][0].data_ptr() if stats else None,
                               ps[i][1].data_ptr() if stats else None, b, hp, wp, c, r, taps, kw,
                               stride, ho, wo, co, tiles, int(phases), int(nhwc), int(y_bf16),
                               stream)
        assert err == 0, err
    return call, n_sets


def quant_pad_case(lib, b, c, h, w, prologue, x_bf16=False):
    """A timed call of ``lib``'s NCHW quantize-and-pad (reflect, pad 1, an
    lrelu prologue) at one shape, x f32 or with ``x_bf16`` bf16, on rotating
    buffers that exceed L2."""
    cp = -(-c // 32) * 32
    dtype = torch.bfloat16 if x_bf16 else torch.float32
    n_sets = max(2, -(-3 * 50 * 2**20 // (dtype.itemsize * b * c * h * w)))
    xs = [torch.randn(b, c, h, w, device="cuda", dtype=dtype) for _ in range(n_sets)]
    out = [torch.empty((b, h + 2, w + 2, cp), dtype=torch.int8, device="cuda")
           for _ in range(n_sets)]
    inv = torch.tensor([20.0], device="cuda")
    pa, pb = torch.rand(b, c, device="cuda") + 0.5, torch.randn(b, c, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(i):
        err = lib.mt_int8_quant_pad(xs[i].data_ptr(), out[i].data_ptr(), inv.data_ptr(),
                                    pa.data_ptr() if prologue else None,
                                    pb.data_ptr() if prologue else None, 1, 0.01, b, c, h, w, cp,
                                    h + 2, w + 2, 1, 1, 1, int(x_bf16), stream)
        assert err == 0, err
    return call, n_sets


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_conv_knobs: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    libs = compile_variants(set(names))

    def timed(case, lib, *args, **kw):
        call, n_sets = case(lib, *args, **kw)
        ms = device_ms(call, n_sets)
        torch.cuda.empty_cache()
        return ms

    for name in names:
        lib = libs[name]
        row = dict(variant=name, shape=[B, C, H, W], co=C)
        if name.startswith("quant_pad") or name == "base":
            row.update(quant_pad_ms=timed(quant_pad_case, lib, B, C, H, W, False),
                       quant_pad_prologue_ms=timed(quant_pad_case, lib, B, C, H, W, True),
                       # down0's: 64 channels, 258 padded columns
                       down0_quant_pad_prologue_ms=timed(quant_pad_case, lib, 8, 64, 256, 256, True),
                       down0_quant_pad_prologue_bf16_ms=timed(quant_pad_case, lib, 8, 64, 256, 256,
                                                              True, x_bf16=True),
                       quant_pad_bf16_ms=timed(quant_pad_case, lib, B, C, H, W, False,
                                               x_bf16=True))
        if not name.startswith("quant_pad"):
            if name not in ("thread_stores", "no_stats", "no_y_staging", "box_n256", "slab_128"):
                row.update(conv_nchw_ms=timed(conv_case, lib, B, C, H, W, C, 1, False, stats=False),
                           conv_nchw_stats_ms=timed(conv_case, lib, B, C, H, W, C, 1, False),
                           conv_nhwc_stats_ms=timed(conv_case, lib, B, C, H, W, C, 1, False,
                                                    nhwc=True))
            for case, *shape in PATH_CONVS:
                row[f"{case}_ms"] = timed(conv_case, lib, *shape)
                row[f"{case}_bf16_ms"] = timed(conv_case, lib, *shape, y_bf16=True)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
