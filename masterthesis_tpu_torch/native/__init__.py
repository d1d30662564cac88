"""Native host preprocessing (C++/libjpeg through ctypes).

The port of ``masterthesis_tpu/native``: builds ``preproc.cc`` with ``g++``
and ``-ljpeg`` at first use into ``libmtpreproc-<hash>.so`` under
``build/native/`` at the root of the checkout (listed in ``.gitignore``),
the hash covering the source and the flags, as the CUDA kernels build
(``ops/kernels/build.py``). It exposes the fused decode -> resize -> crop ->
flip -> normalize pipeline; ctypes releases the GIL during the C call, so
the loader's thread overlaps with the device. This is host decoding, not a
device kernel: where the library cannot be built (no ``g++`` or no libjpeg
headers), ``available()`` is False, ``build_error()`` says why, and the
transforms take PIL's route.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "preproc.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libmtpreproc-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    """Compile into ``lib`` (through a temporary name, so that a concurrent
    build never loads a half-written file); the error text, or None."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-ljpeg", "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ invocation failed: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"g++ failed: {proc.stderr[-2000:]}"
    os.replace(tmp, lib)
    return None


def _load() -> None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return
        path = library_path()
        if not path.exists():
            err = _build(path)
            if err:
                _build_error = err
                return
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = str(e)
            return
        lib.mt_preprocess.restype = ctypes.c_int
        lib.mt_preprocess.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.mt_decode_resize.restype = ctypes.c_int
        lib.mt_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        _lib = lib


def available() -> bool:
    _load()
    return _lib is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _require():
    _load()
    if _lib is None:
        raise RuntimeError(f"native preproc unavailable: {_build_error}")
    return _lib


def preprocess_jpeg(
    data: bytes,
    load_size: int,
    crop_size: int,
    crop_top: int,
    crop_left: int,
    flip: bool = False,
    normalize: bool = True,
) -> np.ndarray:
    """Fused decode -> resize(load, load) -> crop -> flip [-> normalize]:
    (crop, crop, 3) f32 in [-1, 1], or uint8 without ``normalize``."""
    lib = _require()
    out = np.empty((crop_size, crop_size, 3), np.float32 if normalize else np.uint8)
    rc = lib.mt_preprocess(
        data, len(data), load_size, load_size, crop_top, crop_left, crop_size,
        1 if flip else 0, 1 if normalize else 0,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise ValueError(f"mt_preprocess failed with code {rc}")
    return out


def decode_resize_jpeg(data: bytes, load_size: int) -> np.ndarray:
    """Decode + antialiased bicubic resize to (load, load, 3) uint8."""
    lib = _require()
    out = np.empty((load_size, load_size, 3), np.uint8)
    rc = lib.mt_decode_resize(data, len(data), load_size, load_size,
                              out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"mt_decode_resize failed with code {rc}")
    return out
