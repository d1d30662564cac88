#!/usr/bin/env python3
"""What bounds the int8 head (kernel 8) on an NVIDIA card: compiled knobs of
``masterthesis_tpu_torch/csrc/head.cu``, timed through the wrapper.

    python3 scripts/head_knobs.py          # needs nvcc and a card

Each variant is the committed source with one change applied as a text
substitution (the script fails if one no longer applies), built into
``build/head_knobs/`` by the package's own build helper, with its flags, and
swapped in under ``ops/kernels/head.py``'s wrapper, which computes the
tiling as it does on the serving path:

- ``base``: the source as it is;
- ``stages2`` / ``stages4``: 2 or 4 stages in each thread's ring of
  cp.async copies in place of 3;
- ``batch8`` / ``batch8_stages2``: 8 channel planes per stage in place of 4;
- ``threads128``: blocks of 128 threads (the tiling too);
- ``l2_prefetch``: each copy asks L2 to fetch 256 bytes around it;
- ``plain_stores``: out written by plain stores in place of the streaming
  ``__stcs``;
- ``registers``: no ring: each batch's planes are loaded into registers
  (16-byte ``__ldcs``) just before they are used, so a thread has loads in
  flight only while it waits, not while it computes;
- ``host_weight_rounding``: the base kernel, with the weights and bias
  rounded to bf16 values by two torch casts per call on the card before the
  launch, as the wrapper did before the kernel rounded them itself.

Every variant is held to the plain version (1e-5 in f32, 2^-7 in bf16) at
each shape, then timed (CUDA events over back-to-back calls on inputs that,
rotated, exceed L2) at the serving paths' shapes: (8, 64, 256, 256) -> 3 in
bf16 and f32, (64, 64, 256, 256) and (4, 64, 540, 960) in bf16. One JSON line
per variant, each shape's ms beside its bytes bound and their ratio
(``bound_share``), after the card's name and power limit and ptxas's
registers and spills for each variant's kernels.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import build  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import head as khead  # noqa: E402

CSRC = ROOT / "masterthesis_tpu_torch" / "csrc"
OUT = ROOT / "build" / "head_knobs"
SHAPES = [((8, 64, 256, 256), "bf16"), ((64, 64, 256, 256), "bf16"),
          ((4, 64, 540, 960), "bf16"), ((8, 64, 256, 256), "f32")]
CO = 3
STAGES = "constexpr int kStages = 3;"
BATCH = "constexpr int kBatch = 4;"
VARIANTS = {
    "base": [],
    "stages2": [(STAGES, "constexpr int kStages = 2;")],
    "stages4": [(STAGES, "constexpr int kStages = 4;")],
    "batch8": [(BATCH, "constexpr int kBatch = 8;")],
    "batch8_stages2": [(BATCH, "constexpr int kBatch = 8;"),
                       (STAGES, "constexpr int kStages = 2;")],
    "threads128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "l2_prefetch": [("cp.async.cg.shared.global [%0], [%1], 16, %2;",
                     "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;")],
    "plain_stores": [("__stcs(reinterpret_cast<uint4*>(op + r * E), mt::Vec<T>::pack(y));",
                      "*reinterpret_cast<uint4*>(op + r * E) = mt::Vec<T>::pack(y);")],
    "registers": [("#pragma unroll\n    for (int k = 0; k < kStages - 1; ++k) copy(k);", ""),
                  ("""      cp_async_wait<kStages - 2>();  // batch k's copies have landed
      copy(k + kStages - 1);         // into the stage batch k - 1 freed
""", """      uint4 regs[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        regs[u] = make_uint4(0u, 0u, 0u, 0u);
        if (live && r * E < hw && c0 + u < C) {
          regs[u] = __ldcs(reinterpret_cast<const uint4*>(xs + (c0 + u) * hw + r * E));
        }
      }
"""), ("mt::Vec<T>::unpack(ring[((k % kStages) * kBatch + u) * kThreads + threadIdx.x], v);",
       "mt::Vec<T>::unpack(regs[u], v);")],
}
THREADS = {"threads128": 128}


def compile_variants() -> tuple[dict, dict]:
    src = (CSRC / "head.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, OUT / h.name)
    jobs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old[:60]!r} is found {text.count(old)} times")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        jobs[name] = (OUT / f"{name}.cu", OUT / f"lib{name}.so")
    logs = build.compile_sources(jobs)
    libs = {}
    for name, (_, lib) in jobs.items():
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].mt_error_string.argtypes = [ctypes.c_int]
        libs[name].mt_error_string.restype = ctypes.c_char_p
    return libs, logs


def typed(lib):
    """``lib`` with the wrapper's argument types (as ``khead._library`` sets them)."""
    real = khead.build.load
    khead.build.load = lambda name: lib
    try:
        khead._library.cache_clear()
        return khead._library()
    finally:
        khead.build.load = real
        khead._library.cache_clear()


def measure(shape, dtype_name) -> dict:
    """The wrapper as it stands (variant swapped in) at one shape: its error
    against the plain version, then its time."""
    dtype = cs.DTYPES[dtype_name]
    b, c, h, w = shape
    esize = dtype.itemsize
    numel = math.prod(shape)
    sets = cs.copies(lambda j: (cs._randn(shape, dtype, 900 + j),), esize * numel)
    pending = cs._card_pending(b, c, 910, 0.0)
    weight = cs._card_weight((CO, c), 911, 0.1)
    y = khead.head(sets[0][0], pending, weight)
    ref = khead.head_plain(sets[0][0], pending, weight)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    del y, ref
    tol = cs.HEAD_TOL if dtype_name == "f32" else khead.BF16_TOL
    assert err <= tol, f"{shape} {dtype_name}: error {err} > {tol}"
    ms = cs.device_ms(lambda t: khead.head(t, pending, weight), sets)
    b_ms, _ = cs.bound(esize * (numel + b * CO * h * w) + 8 * b * c + 4 * CO * c,
                       2 * b * h * w * c * CO)
    del sets
    torch.cuda.empty_cache()
    return dict(shape=list(shape), dtype=dtype_name, max_abs_err=err, ms=ms, bound_ms=b_ms,
                bound_share=b_ms / ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("head_knobs: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    libs, logs = compile_variants()
    for name, text in logs.items():
        fn = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for", 1)[1].strip()
            if "registers" in line or "spill" in line:
                print(f"  {name}: {fn} | {line.strip()}", flush=True)
    libs = {name: typed(lib) for name, lib in libs.items()}
    real_library, real_threads, real_checked = khead._library, khead.THREADS, khead._checked

    def host_rounding(x, pending, weight, bias):
        weight, bias = real_checked(x, pending, weight, bias)
        if x.dtype == torch.bfloat16:
            weight = weight.to(torch.bfloat16).float()
            bias = None if bias is None else bias.to(torch.bfloat16).float()
        return weight, bias

    try:
        for variant, lib_name in [(name, name) for name in libs] + [("host_weight_rounding",
                                                                     "base")]:
            khead._library = lambda lib=libs[lib_name]: lib
            khead.THREADS = THREADS.get(variant, real_threads)
            khead._checked = host_rounding if variant == "host_weight_rounding" else real_checked
            rows = [measure(shape, dtype_name) for shape, dtype_name in SHAPES]
            print(json.dumps(dict(variant=variant, co=CO, rows=rows)), flush=True)
    finally:
        khead._library, khead.THREADS, khead._checked = real_library, real_threads, real_checked
    return 0


if __name__ == "__main__":
    sys.exit(main())
