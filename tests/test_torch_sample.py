"""The port's sample CLI against the JAX package's, on the CPU.

Each case of the JAX package's ``tests/test_cli_integration.py`` for the
sampler runs both ``Sampler``s on the same tiny args (AdaINModel, dim 8,
latent 4, 4 domains, 32x32 eval transform, 40x40 input JPEGs), both from
one ``model_N.ckpt`` that the JAX package wrote (the port reads it with
``--resume``), and compares the files they write: the same names, and
images of the same sizes. The draws differ (``jax.random`` against
``torch.Generator``), so pixels are compared only where the draws are
injected: ``translate`` with the same style code, or the same VAE eps,
within ``TOL`` (f32, the bound of ``tests/test_torch_model.py``).
"""
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

pytest.importorskip("flax")

from conftest import make_image_tree

from masterthesis_tpu.arguments import default_test_args as jax_test_args
from masterthesis_tpu.data.transforms import EvalTransform as JaxEvalTransform
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel
from masterthesis_tpu.sample import Sampler as JaxSampler
from masterthesis_tpu_torch import arguments
from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.data.transforms import EvalTransform
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.sample import Sampler
from tests.torch_jax_init import compiled_jax_init

torch.set_num_threads(2)

SHAPE = dict(batch_size=1, num_domains=4, latent_dim=4, dim=8, crop_size=32, num_workers=0)
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX AdaINModel's ``model_0.ckpt``, its weights moved off their
    init (so that a tanh output spans its range)."""
    ckdir = str(tmp_path_factory.mktemp("ckpt"))
    jm = JaxAdaINModel(jax_test_args(model=JaxAdaINModel, checkpoint_dir=ckdir, **SHAPE))
    with compiled_jax_init():  # the values are moved off the init and saved for both
        state = jm.initialize()
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.standard_normal(np.shape(a)) * 0.1).astype(np.float32),
        state.params)
    jm.save(state.replace(params=params), 0)
    return os.path.join(ckdir, "model_0.ckpt")


def _files(root) -> dict:
    """{path under root: image size (w, h), or frame count and size of a video}."""
    out = {}
    for d, _, names in os.walk(str(root)):
        for n in names:
            path = os.path.join(d, n)
            rel = os.path.relpath(path, str(root))
            if n.endswith(".txt"):
                continue
            if n.endswith(".avi"):
                import cv2

                cap = cv2.VideoCapture(path)
                count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                ok, frame = cap.read()
                cap.release()
                out[rel] = (count, frame.shape if ok else None)
            else:
                with Image.open(path) as im:
                    out[rel] = im.size
    return out


def _pair(tmp_path, jax_ckpt, data, **overrides):
    """(JAX sampler, model, state, loader, args) and (port sampler, model,
    loader, args), each writing under its own directory."""
    ja = jax_test_args(dataroot=data, model=JaxAdaINModel, resume=jax_ckpt,
                       display_dir=str(tmp_path / "jax"), result_dir=str(tmp_path / "jax"),
                       **SHAPE, **overrides)
    js = JaxSampler()
    js.transforms = JaxEvalTransform(size=(32, 32))
    jm, state = js.load_model(ja)
    jl = js.load_dataset(ja)
    pa = default_test_args(dataroot=data, model=AdaINModel, resume=jax_ckpt,
                           display_dir=str(tmp_path / "port"), result_dir=str(tmp_path / "port"),
                           **SHAPE, **overrides)
    ps = Sampler(device="cpu")
    ps.transforms = EvalTransform(size=(32, 32))
    pm = ps.load_model(pa)
    pl = ps.load_dataset(pa)
    return (SimpleNamespace(s=js, m=jm, state=state, loader=jl, args=ja),
            SimpleNamespace(s=ps, m=pm, loader=pl, args=pa))


def _same_files(tmp_path):
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert want and got == want, (sorted(got), sorted(want))
    return got


def test_sampler_writes_translations(tmp_path, jax_ckpt):
    make_image_tree(tmp_path / "data", num_domains=2, per_domain=1, mode="imgs", size=40)
    j, p = _pair(tmp_path, jax_ckpt, str(tmp_path / "data" / "imgs"))
    j.s.sample(j.args, j.m, j.state, j.loader, trgs=[1])
    p.s.sample(p.args, p.m, p.loader, trgs=[1])
    files = _same_files(tmp_path)
    assert files == {os.path.join("1", f"image0_{i}_0.jpg"): (32, 32) for i in range(2)}
    assert p.s.translated == 2


def test_sampler_diverse_mode(tmp_path, jax_ckpt):
    make_image_tree(tmp_path / "data", num_domains=1, per_domain=1, mode="imgs", size=40)
    j, p = _pair(tmp_path, jax_ckpt, str(tmp_path / "data" / "imgs"))
    j.s.sample_diverse(j.args, j.m, j.state, j.loader, trgs=[2])
    p.s.sample_diverse(p.args, p.m, p.loader, trgs=[2])
    assert _same_files(tmp_path) == {os.path.join("0", "0_0.jpg"): (32, 32)}


def test_sampler_int8_serving(tmp_path, jax_ckpt):
    make_image_tree(tmp_path / "data", num_domains=2, per_domain=2, mode="imgs", size=40)
    j, p = _pair(tmp_path, jax_ckpt, str(tmp_path / "data" / "imgs"))
    j.m.calibrate_int8(j.state, [np.asarray(b) for b in j.loader][:2])
    quant = p.s.calibrate(p.args, p.m, p.loader)
    assert j.m.quant_cols and set(quant) == set(j.m.quant_cols)
    j.s.sample(j.args, j.m, j.state, j.loader, trgs=[1])
    p.s.sample(p.args, p.m, p.loader, trgs=[1])
    assert len(_same_files(tmp_path)) == 4


def test_sampler_video_in_video_out(tmp_path, jax_ckpt):
    import cv2

    vid = str(tmp_path / "in.avi")
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (40, 40))
    rng = np.random.default_rng(0)
    for _ in range(5):
        writer.write(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8))
    writer.release()
    j, p = _pair(tmp_path, jax_ckpt, vid, out_fmt="video", vid_fname="clip.avi")
    assert p.loader.dataset.fps == 10.0
    j.s.sample_video(j.args, j.m, j.state, j.loader, trgs=[1])
    p.s.sample_video(p.args, p.m, p.loader, trgs=[1])
    files = _same_files(tmp_path)
    count, shape = files["clip_fog.avi"]
    assert count >= 4 and shape == (32, 32, 3)


def test_sampler_multi_iter_styles(tmp_path, jax_ckpt):
    make_image_tree(tmp_path / "data", num_domains=1, per_domain=1, mode="imgs", size=40)
    j, p = _pair(tmp_path, jax_ckpt, str(tmp_path / "data" / "imgs"), multi_iter=2)
    j.s.sample(j.args, j.m, j.state, j.loader, trgs=[1])
    p.s.sample(p.args, p.m, p.loader, trgs=[1])
    assert set(_same_files(tmp_path)) == {os.path.join("1", f"image0_0_0_s{k}.jpg")
                                          for k in range(2)}


def test_translate_matches_jax(tmp_path, jax_ckpt):
    """The same batch, target and style: a random style code, and a
    reference image's style with the VAE eps that JAX's key draws."""
    make_image_tree(tmp_path / "data", num_domains=1, per_domain=1, mode="imgs", size=40)
    data = str(tmp_path / "data" / "imgs")
    j, p = _pair(tmp_path, jax_ckpt, data)
    batch = next(iter(p.loader))
    np.testing.assert_array_equal(batch, np.asarray(next(iter(j.loader))))
    z = np.random.default_rng(4).standard_normal((1, 4)).astype(np.float32)
    want, _, _ = j.s.translate(j.args, j.m, j.state, batch, 2, style_code=z)
    got, _, _ = p.s.translate(p.args, p.m, batch, 2, style_code=z)
    want = np.asarray(want)
    assert np.abs(want).max() > 0.3, "outputs must span the tanh range to test anything"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    ref = os.path.join(data, "cloud", "img0.jpg")
    key = jax.random.PRNGKey(7)
    want, _, _ = j.s.translate(j.args, j.m, j.state, batch, 3, style_path=ref, rng=key)
    c = np.eye(4, dtype=np.float32)[[3]]
    zz, mu, logvar = j.m.encode_style(j.state.params, j.s._style_image(j.args, ref), c, key,
                                      sample=True)
    eps = ((np.asarray(zz) - np.asarray(mu)) / np.exp(0.5 * np.asarray(logvar))).astype(np.float32)
    got, _, _ = p.s.translate(p.args, p.m, batch, 3, style_path=ref, eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # the pipelined route gives the same images as the timed one
    queued, _, _ = p.s.translate(p.args, p.m, batch, 2, style_code=z, sync=False)
    timed, _, _ = p.s.translate(p.args, p.m, batch, 2, style_code=z)
    assert torch.equal(queued, timed)


@pytest.mark.parametrize("mode", ["image_grid", "multiple_styles"])
def test_grids_match_jax(tmp_path, jax_ckpt, mode, capsys):
    make_image_tree(tmp_path / "data", num_domains=2, per_domain=1, mode="imgs", size=40)
    j, p = _pair(tmp_path, jax_ckpt, str(tmp_path / "data" / "imgs"))
    if mode == "image_grid":
        j.s.generate_image_grid(j.args, j.m, j.state, j.loader, trgs=[0, 2])
        timings = p.s.generate_image_grid(p.args, p.m, p.loader, trgs=[0, 2])
        assert len(timings) == 4 and "mean forward time" in capsys.readouterr().out
    else:
        batch = next(iter(p.loader))
        j.s.generate_multiple_styles(j.args, j.m, j.state, batch, 1)
        p.s.generate_multiple_styles(p.args, p.m, batch, 1)
    files = _same_files(tmp_path)
    assert list(files) == ["grid.png"]


def _argv(tmp_path, jax_ckpt, *extra):
    make_image_tree(tmp_path / "data", num_domains=2, per_domain=1, mode="imgs", size=40)
    return ["--dataroot", str(tmp_path / "data" / "imgs"), "--model", "AdaINModel",
            "--dim", "8", "--latent_dim", "4", "--num_domains", "4", "--batch_size", "1",
            "--num_workers", "0", "--resume", jax_ckpt, "--result_dir", str(tmp_path / "out"),
            "--sample_size", "32", "32", *extra]


def test_the_cli_serves_a_jax_checkpoint_in_int8(tmp_path, jax_ckpt):
    """``arguments.TestArguments().parse`` and ``Sampler.run``: --targets by name,
    --int8 calibrated on the input, a JAX checkpoint through --resume."""
    args = arguments.TestArguments().parse(_argv(tmp_path, jax_ckpt, "--targets", "fog", "sun",
                                                 "--int8", "--int8_calib_batches", "1"))
    sampler = Sampler(device="cpu")
    model = sampler.run(args)
    assert model.quant is not None and sampler.translated == 4
    files = _files(tmp_path / "out" / "images")
    assert files == {os.path.join(str(t), f"image{k}_{i}_0.jpg"): (32, 32)
                     for k, t in enumerate((1, 3)) for i in range(2)}


def test_gen_style_needs_a_target(tmp_path, jax_ckpt):
    args = arguments.TestArguments().parse(_argv(tmp_path, jax_ckpt, "--gen_style"))
    with pytest.raises(SystemExit, match="--targets"):
        Sampler(device="cpu").run(args)


def test_num_devices_is_not_read_as_in_the_jax_sampler(tmp_path, jax_ckpt):
    """The JAX sampler samples on one device whatever ``--num_devices`` says."""
    args = arguments.TestArguments().parse(_argv(tmp_path, jax_ckpt, "--num_devices", "2"))
    model = Sampler(device="cpu").load_model(args)
    assert model.mesh is None


def test_the_sampler_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler()
