"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``masterthesis_tpu_torch/csrc/<name>.cu`` compiles on its own into
``lib<name>-<hash>.so`` under ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``). The hash covers the source, the shared headers
and the flags, so an edited source builds anew and an unchanged one is built
once. The libraries have a plain C interface and include no PyTorch header:
pointers and the stream travel as ``ctypes.c_void_p``, sizes as
``ctypes.c_int64``, and every entry point returns ``cudaGetLastError()``,
which :func:`check` turns into an exception.

Nothing builds at import: a wrapper builds its library at its first launch,
and ``chip_smoke.py`` calls :func:`build` first so that all sources compile at
once, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from masterthesis_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("moments", "adain", "int8_conv", "head", "resblock_bf16", "dec_mix")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, in the build log
)

_libraries: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed"
        )
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile each named source whose library is missing, all at once.

    Returns the compiler's output per source it compiled (``-Xptxas -v``
    reports registers and spills there). Raises with that output if any
    compile fails.
    """
    with profiling.span("mt.setup.build"):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {name: (CSRC / f"{name}.cu", library_path(name)) for name in names}
        return compile_sources({name: job for name, job in jobs.items() if not job[1].exists()})


def compile_sources(jobs: dict[str, tuple[Path, Path]]) -> dict[str, str]:
    """Compile each ``name: (source, library)`` of ``jobs`` with ``nvcc``,
    one process per source, all started at once. Returns the compiler's
    output per name; raises with it if any compile fails. A library is
    written under a temporary name and renamed, so a concurrent build never
    loads a half-written file.
    """
    running = {}
    try:
        for name, (src, lib) in jobs.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            running[name] = (proc, tmp, lib)
        logs, failed = {}, []
        for name, (proc, tmp, lib) in running.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{logs[name]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib)
    finally:
        for proc, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.mt_error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.mt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as the kernels take it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
