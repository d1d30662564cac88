"""The port's on-device preprocessing against the JAX package's.

``preprocess`` on the same uint8 images and crop parameters equals JAX's
``preprocess`` within 1 ulp of f32 at the output's scale, 2^-23 absolute:
both compute ``x * (2/255) - 1`` in f32, XLA's jit as one fused
multiply-add (one rounding), torch as a multiply and a subtract (two; the
product in [0, 2] rounds by at most 2^-23, the subtraction of 1 is then
exact);
``sample_crop_params`` draws uniform origins and flips with probability 1/2
(centred and unflipped for evaluation); ``preprocess_pair_batch`` touches
only uint8 images; ``RawResizeTransform`` gives the JAX package's uint8
images.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masterthesis_tpu.data import device_preproc as jdp
from masterthesis_tpu_torch.data.device_preproc import (
    RawResizeTransform,
    preprocess,
    preprocess_pair_batch,
    sample_crop_params,
)

from conftest import make_image_tree


ULP = float(np.finfo(np.float32).eps)  # 2^-23, one f32 ulp of 1.0


@pytest.mark.parametrize("crop", [32, 17])
def test_preprocess_within_one_ulp_of_jax(crop):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (6, 40, 40, 3), dtype=np.uint8)
    span = 40 - crop
    tops = rng.integers(0, span + 1, 6)
    lefts = rng.integers(0, span + 1, 6)
    flips = np.array([False, True, False, True, True, False])
    want = np.asarray(jdp.preprocess(
        jnp.asarray(imgs), {"tops": jnp.asarray(tops), "lefts": jnp.asarray(lefts),
                            "flips": jnp.asarray(flips)}, crop_size=crop))
    got = preprocess(torch.from_numpy(imgs), {"tops": torch.from_numpy(tops),
                                              "lefts": torch.from_numpy(lefts),
                                              "flips": torch.from_numpy(flips)}, crop).numpy()
    assert got.shape == want.shape == (6, crop, crop, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= ULP
    # the crop and flip themselves are exact: the same uint8 values land in place
    for i in range(6):
        ref = imgs[i, tops[i]:tops[i] + crop, lefts[i]:lefts[i] + crop]
        if flips[i]:
            ref = ref[:, ::-1]
        assert np.array_equal(np.rint((got[i] + 1.0) * 127.5).astype(np.uint8), ref)


def test_sample_crop_params_distribution():
    g = torch.Generator().manual_seed(0)
    params = sample_crop_params(g, 256, 40, 32, train=True)
    tops = params["tops"].numpy()
    assert tops.min() >= 0 and tops.max() <= 8
    assert len(np.unique(tops)) > 3
    assert len(np.unique(params["lefts"].numpy())) > 3
    assert 0.2 < params["flips"].float().mean().item() < 0.8
    p_eval = sample_crop_params(g, 8, 40, 32, train=False)
    assert (p_eval["tops"] == 4).all() and (p_eval["lefts"] == 4).all()
    assert not p_eval["flips"].any()
    assert not sample_crop_params(g, 8, 40, 32, no_flip=True)["flips"].any()
    # the same seed gives the same draws
    a = sample_crop_params(torch.Generator().manual_seed(5), 8, 40, 32)
    b = sample_crop_params(torch.Generator().manual_seed(5), 8, 40, 32)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_preprocess_pair_batch_only_touches_uint8():
    rng = np.random.default_rng(1)
    batch = {
        "x1": torch.from_numpy(rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)),
        "x2": torch.from_numpy(rng.integers(0, 256, (2, 40, 40, 3), dtype=np.uint8)),
        "y1": torch.eye(4)[[0, 1]],
        "y2": torch.eye(4)[[2, 3]],
    }
    out = preprocess_pair_batch(batch, torch.Generator().manual_seed(0), 40, 32)
    assert out["x1"].shape == (2, 32, 32, 3) and out["x1"].dtype == torch.float32
    assert out["x1"].abs().max().item() <= 1.0 + 1e-6
    assert out["y1"] is batch["y1"] and out["y2"] is batch["y2"]
    assert not torch.allclose(out["x1"], out["x2"])
    # images already preprocessed on the host pass through
    again = preprocess_pair_batch(out, torch.Generator().manual_seed(0), 40, 32)
    assert again["x1"] is out["x1"] and again["x2"] is out["x2"]


def test_raw_resize_transform_equals_jax(tmp_path):
    make_image_tree(tmp_path, num_domains=1, per_domain=1, size=50)
    path = str(tmp_path / "train" / "cloud" / "img0.jpg")
    for use_native in (True, False):
        arr = RawResizeTransform(load_size=36, use_native=use_native).load_file(path)
        want = jdp.RawResizeTransform(load_size=36, use_native=use_native).load_file(path)
        assert arr.shape == (36, 36, 3) and arr.dtype == np.uint8
        assert np.array_equal(arr, want)
