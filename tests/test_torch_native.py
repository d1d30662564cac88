"""The port's native host preprocessing: its own build under ``build/``,
byte-equal to the JAX package's library on the same JPEG, and the JAX
package's ``tests/test_native.py`` cases. Where ``g++`` or libjpeg's headers
are missing the library does not build: the tests that need it skip while
they run (the ``lib`` fixture), never at collection.
"""
import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from masterthesis_tpu import native as jnative
from masterthesis_tpu_torch import native
from masterthesis_tpu_torch.data.transforms import TrainTransform

ROOT = Path(__file__).resolve().parents[1]


def _jpeg_bytes(h=120, w=150, quality=95):
    xx, yy = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
    arr = np.stack([xx * 255, yy * 255, (xx + yy) / 2 * 255], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip(f"native preproc unavailable: {native.build_error()}")
    return native


def test_library_builds_into_the_ignored_build_directory(lib):
    path = native.library_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert "/build/" in (ROOT / ".gitignore").read_text().split()
    assert path != Path(jnative._LIB_PATH)


@pytest.mark.parametrize("size", [(120, 150), (300, 420)])
def test_bytes_equal_to_the_jax_library(lib, size):
    """Float and uint8 crops, with and without flip, and the uint8 resize
    (at 300 x 420 libjpeg decodes at 1/2 scale first)."""
    if not jnative.available():
        pytest.skip(f"the JAX package's native library did not build: {jnative.build_error()}")
    data = _jpeg_bytes(*size)
    for flip in (False, True):
        for normalize in (True, False):
            args = (data, 64, 48, 5, 7, flip, normalize)
            a, b = lib.preprocess_jpeg(*args), jnative.preprocess_jpeg(*args)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert lib.decode_resize_jpeg(data, 64).tobytes() == jnative.decode_resize_jpeg(data, 64).tobytes()


def test_native_matches_pil_pipeline(lib):
    data = _jpeg_bytes()
    out = lib.preprocess_jpeg(data, 64, 48, 5, 7, flip=False)
    img = Image.open(io.BytesIO(data)).convert("RGB").resize((64, 64), Image.BICUBIC)
    ref = np.asarray(img, np.float32)[5:53, 7:55] / 255.0 * 2 - 1
    assert out.shape == (48, 48, 3)
    assert np.abs(out - ref).mean() < 1e-3
    assert np.abs(out - ref).max() < 0.05


def test_native_flip_and_u8(lib):
    data = _jpeg_bytes()
    a = lib.preprocess_jpeg(data, 64, 48, 0, 0, flip=False)
    b = lib.preprocess_jpeg(data, 64, 48, 0, 0, flip=True)
    np.testing.assert_allclose(b, a[:, ::-1])
    u8 = lib.decode_resize_jpeg(data, 64)
    assert u8.shape == (64, 64, 3) and u8.dtype == np.uint8


def test_native_rejects_bad_crop(lib):
    with pytest.raises(ValueError):
        lib.preprocess_jpeg(_jpeg_bytes(), 64, 48, 30, 0)  # 30 + 48 > 64


def test_train_transform_native_path(lib, tmp_path):
    p = str(tmp_path / "img.jpg")
    with open(p, "wb") as f:
        f.write(_jpeg_bytes())
    t = TrainTransform(load_size=40, crop_size=32, train=True)
    out_native = t.load_file(p, np.random.default_rng(3))
    t_pil = TrainTransform(load_size=40, crop_size=32, train=True, use_native=False)
    out_pil = t_pil.load_file(p, np.random.default_rng(3))
    # the same rng gives the same crop and flip; the pixels nearly equal
    assert out_native.shape == out_pil.shape == (32, 32, 3)
    assert np.abs(out_native - out_pil).mean() < 1e-2


def test_train_transform_pil_fallback_png(tmp_path):
    p = str(tmp_path / "img.png")
    Image.fromarray(np.zeros((50, 50, 3), np.uint8)).save(p)
    out = TrainTransform(load_size=40, crop_size=32, train=False).load_file(
        p, np.random.default_rng(0))
    assert out.shape == (32, 32, 3)
    np.testing.assert_allclose(out, -1.0)


def test_a_failed_build_reports_and_leaves_pil(monkeypatch, tmp_path):
    """Without libjpeg's headers the build fails: ``available()`` is False,
    ``build_error()`` says why, and a JPEG takes PIL's route."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "GXX_FLAGS", (*native.GXX_FLAGS, "-include", "no_such.h"))
    assert not native.available()
    assert "g++" in native.build_error()
    p = str(tmp_path / "img.jpg")
    with open(p, "wb") as f:
        f.write(_jpeg_bytes())
    t = TrainTransform(load_size=40, crop_size=32, train=False)
    ref = TrainTransform(load_size=40, crop_size=32, train=False, use_native=False)
    np.testing.assert_array_equal(t.load_file(p), ref.load_file(p))
