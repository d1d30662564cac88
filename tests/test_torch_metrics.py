"""The port's metrics and metric tools against the JAX package's, on the CPU.

Weights: the JAX nets' own param trees (``init``), perturbed with seeded
numpy draws so that every leaf matters (He-scaled conv kernels, batch-norm
statistics off identity, LPIPS heads some negative), flattened with ``/``
joins and loaded into the port's nets by ``load_flat_params``: the function
that reads the metric npz files, which the dir-level cases read from disk.

Tolerances (f32 on both sides, sums in other orders):
- ``fid_score`` and the streaming ``FID``'s accumulators on the same
  features: equal to f64 rounding (``F64_REL``, 1e-12 relative; the math is
  the same numpy on the host).
- the resize: within 1e-5 (``RESIZE_TOL``) of ``jax.image.resize`` at
  32²→299², 256²→4² and 540×960→299² ([0, 1] inputs; torch's antialiased
  weights are normalised in another order).
- InceptionV3's 2048-d features: within ``INCEPTION_REL`` (1e-4) of the
  mean |feature|, ~95 f32 convs deep.
- LPIPS distances and the dir tools' scores: ``METRIC_REL`` (1e-4)
  relative.
- ``convert_weights``: array for array equal; ``extract``: frame for frame
  equal.
"""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

pytest.importorskip("flax")
from flax import traverse_util  # noqa: E402

from masterthesis_tpu.metrics import fid as jfid  # noqa: E402
from masterthesis_tpu.metrics import inception as jinception  # noqa: E402
from masterthesis_tpu.metrics import lpips as jlpips  # noqa: E402
from masterthesis_tpu.tools import convert_weights as jconvert  # noqa: E402
from masterthesis_tpu_torch.metrics import fid as pfid  # noqa: E402
from masterthesis_tpu_torch.metrics import inception as pinception  # noqa: E402
from masterthesis_tpu_torch.metrics import lpips as plpips  # noqa: E402
from masterthesis_tpu_torch.metrics.metrics import load_flat_params  # noqa: E402
from masterthesis_tpu_torch.tools import convert_weights as pconvert  # noqa: E402

torch.set_num_threads(2)

F64_REL = 1e-12
RESIZE_TOL = 1e-5
INCEPTION_REL = 1e-4
METRIC_REL = 1e-4
pytestmark = pytest.mark.filterwarnings("ignore:.*RANDOM weights")


def _flat(tree) -> dict:
    return dict(traverse_util.flatten_dict(tree, sep="/"))


def _tree(flat: dict):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def _perturb(flat: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        leaf, shape = k.split("/")[-1], v.shape
        if leaf == "kernel":
            std = np.sqrt(2.0 / np.prod(shape[:3]))
            out[k] = rng.standard_normal(shape) * std
        elif leaf == "bn_scale":
            out[k] = rng.uniform(0.8, 1.2, shape)
        elif leaf == "bn_var":
            out[k] = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("bn_bias", "bn_mean"):
            out[k] = rng.normal(0.0, 0.1, shape)
        elif leaf == "bias":
            out[k] = rng.normal(0.0, 0.02, shape)
        else:  # LPIPS's lin{i} heads: some negative, which relu drops
            out[k] = rng.uniform(-0.2, 1.0, shape)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.fixture(scope="module")
def inception_flat():
    init = jinception.InceptionV3(resize_input=False).init  # traced for its shapes only
    params = jax.eval_shape(init, jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3)))["params"]
    return _perturb(_flat(params), seed=1)


@pytest.fixture(scope="module")
def lpips_flat():
    x = jnp.zeros((1, 64, 64, 3))
    params = jax.eval_shape(jlpips.LPIPS().init, jax.random.PRNGKey(0), x, x)["params"]
    return _perturb(_flat(params), seed=2)


_JAX_INCEPTION = {}


def _jax_inception(flat: dict, resize: bool):
    """The JAX InceptionV3 on ``flat``'s weights, jitted once per resize
    setting (``make_inception_extractor`` would also run its eager init)."""
    if resize not in _JAX_INCEPTION:
        model = jinception.InceptionV3(resize_input=resize)
        _JAX_INCEPTION[resize] = jax.jit(lambda p, x: model.apply({"params": p}, x))
    fn, params = _JAX_INCEPTION[resize], _tree(flat)
    return lambda x: fn(params, jnp.asarray(x))


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).mean())


def _close(got: float, want: float, rel: float) -> bool:
    return abs(got - want) <= rel * max(abs(want), 1e-12)


# ------------------------------------------------------------------- FID --

@pytest.mark.parametrize("shift,batch", [(0.0, 16), (0.5, 16), (2.0, 13)])
def test_streaming_fid_equals_jax(shift, batch):
    rng = np.random.default_rng(1)
    f1 = rng.normal(size=(64, 16)).astype(np.float32)
    f2 = rng.normal(loc=shift, size=(64, 16)).astype(np.float32)
    got = pfid.FID(num_features=16, device="cpu")
    want = jfid.FID(num_features=16, feature_extractor=lambda x: x)
    for i in range(0, 64, batch):
        got.update((f1[i:i + batch], f2[i:i + batch]))
        want.update((f1[i:i + batch], f2[i:i + batch]))
    for name in ("_train_total", "_train_sigma", "_test_total", "_test_sigma"):
        a, b = getattr(got, name), getattr(want, name)
        assert np.abs(a - b).max() <= F64_REL * np.abs(b).max(), name
    assert _close(got.compute(), want.compute(), F64_REL)
    mu1, mu2 = f1.mean(0), f2.mean(0)
    s1, s2 = np.cov(f1, rowvar=False), np.cov(f2, rowvar=False)
    assert _close(pfid.fid_score(mu1, mu2, s1, s2), jfid.fid_score(mu1, mu2, s1, s2), F64_REL)


@pytest.mark.parametrize("case", ["single_example", "shape_mismatch", "width_mismatch"])
def test_fid_errors_as_jax(case):
    def run(fid_cls, **kw):
        fid = fid_cls(num_features=4, feature_extractor=lambda x: x, **kw)
        if case == "single_example":
            fid.update((np.ones((1, 4)), np.ones((1, 4))))
            fid.compute()
        elif case == "shape_mismatch":
            fid.update((np.zeros((2, 4)), np.zeros((3, 4))))
        else:
            fid.update((np.zeros((2, 5)), np.zeros((2, 5))))

    with pytest.raises(ValueError) as want:
        run(jfid.FID)
    with pytest.raises(ValueError) as got:
        run(pfid.FID, device="cpu")
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------- resize --

@pytest.mark.parametrize("src,dst", [((32, 32), (299, 299)), ((256, 256), (4, 4)),
                                     ((540, 960), (299, 299))])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(0).uniform(0, 1, (2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), "bilinear"))
    got = pinception.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= RESIZE_TOL


# -------------------------------------------------------------- the nets --

@pytest.mark.parametrize("size,resize", [(75, False), (40, True)])
def test_inception_features_match_jax(inception_flat, size, resize):
    """75x75 is the smallest input the trunk takes without the resize; 40
    goes through the 299 resize."""
    x = np.random.default_rng(3).uniform(0, 1, (4, size, size, 3)).astype(np.float32)
    want = np.asarray(_jax_inception(inception_flat, resize)(x))
    model = pinception.InceptionV3(resize_input=resize)
    load_flat_params(model, inception_flat)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 2048)
    assert np.abs(want).mean() > 1e-2  # the perturbed weights keep features O(1)
    assert _rel(got, want) <= INCEPTION_REL


def test_lpips_distances_match_jax(lpips_flat):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    params = {"params": _tree(lpips_flat)}
    want = np.asarray(jlpips.LPIPS().apply(params, jnp.asarray(x), jnp.asarray(y)))
    model = plpips.LPIPS()
    load_flat_params(model, lpips_flat)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        zero = model(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    assert got.shape == (3,) and np.abs(got - want).max() <= METRIC_REL * np.abs(want).max()
    assert np.abs(zero).max() < 1e-6


@pytest.mark.parametrize("net,case", [("inception", "stray"), ("inception", "missing"),
                                      ("inception", "shape"), ("lpips", "stray"),
                                      ("lpips", "missing")])
def test_loaders_raise_on_a_stray_or_missing_key(net, case, inception_flat, lpips_flat, tmp_path):
    flat = dict(inception_flat if net == "inception" else lpips_flat)
    key = next(k for k in flat if k.endswith("kernel"))
    if case == "stray":
        flat["Mixed_9z/conv/kernel"] = flat[key]
    elif case == "missing":
        del flat[key]
    else:
        flat[key] = flat[key][..., :-1]
    path = str(tmp_path / "w.npz")
    np.savez(path, **flat)
    load = pinception.load_inception_params if net == "inception" else plpips.load_lpips_params
    with pytest.raises(ValueError if case == "shape" else KeyError):
        load(path)


# -------------------------------------------------------------- the tools --

def _write_images(d, n, seed, size=40, names=None):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, name in enumerate(names or [f"img{i:02d}.png" for i in range(n)]):
        arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(d, name))


@pytest.mark.parametrize("mode", ["plain", "clean"])
def test_compute_fid_from_dirs_matches_jax(mode, inception_flat, tmp_path):
    """Both modes over two dirs of 12 images in batches of 4, the Inception
    of the same weights sliced to 8 features (a well-conditioned covariance
    at 12 samples); the port's read from an npz."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    _write_images(d1, 12, seed=5)
    _write_images(d2, 12, seed=6)
    npz = str(tmp_path / "inception.npz")
    np.savez(npz, **inception_flat)
    resize = mode == "plain"
    jex = _jax_inception(inception_flat, resize)
    pex = pinception.make_inception_extractor(npz, resize_input=resize, device="cpu")
    want = jfid.compute_fid_from_dirs(d1, d2, batch_size=4, num_features=8, mode=mode,
                                      feature_extractor=lambda x: jex(x)[:, :8])
    got = pfid.compute_fid_from_dirs(d1, d2, batch_size=4, num_features=8, mode=mode,
                                     feature_extractor=lambda x: pex(x)[:, :8], device="cpu")
    assert want > 0 and _close(got, want, 1e-3), (got, want)


def test_compute_lpips_from_dirs_report_matches_jax(lpips_flat, tmp_path):
    d0, d1 = str(tmp_path / "d0"), str(tmp_path / "d1")
    _write_images(d0, 3, seed=7, names=["a.png", "b.png", "c.png"])
    _write_images(d1, 2, seed=8, names=["a.png", "c.png"])  # b.png is skipped
    npz = str(tmp_path / "lpips.npz")
    np.savez(npz, **lpips_flat)
    reports = {}
    for name, fn, kw in [("jax", jlpips.compute_lpips_from_dirs, {}),
                         ("port", plpips.compute_lpips_from_dirs, {"device": "cpu"})]:
        out = str(tmp_path / f"{name}.txt")
        avg = fn(d0, d1, out, npz, **kw)
        with open(out) as f:
            lines = f.read().splitlines()
        reports[name] = (avg, lines)
    (javg, jlines), (pavg, plines) = reports["jax"], reports["port"]
    assert _close(pavg, javg, METRIC_REL)
    assert len(plines) == len(jlines) == 1
    pat = re.compile(r"^(\S+): (\d+\.\d{6})$")
    (pname, pval), (jname, jval) = pat.match(plines[0]).groups(), pat.match(jlines[0]).groups()
    assert pname == jname == "c.png" and _close(float(pval), float(jval), 1e-5)


def _torch_sd(kind: str, seed: int) -> dict:
    """A random torchvision-layout state_dict of ``kind`` (numpy arrays)."""
    rng = np.random.default_rng(seed)
    sd = {}
    if kind.startswith("vgg"):
        from masterthesis_tpu_torch.models.losses import VGG_CONFIGS

        c, i = 3, 0
        for v in VGG_CONFIGS[kind]:
            if v == "M":
                i += 1
                continue
            sd[f"features.{i}.weight"] = rng.standard_normal((v, c, 3, 3)).astype(np.float32)
            sd[f"features.{i}.bias"] = rng.standard_normal(v).astype(np.float32)
            c, i = v, i + 2
    elif kind == "inception":
        for name, m in pinception.InceptionV3().named_modules():
            if isinstance(m, pinception.BasicConv):
                sd[f"{name}.conv.weight"] = rng.standard_normal(m.conv.weight.shape).astype(
                    np.float32)
                for k in ("weight", "bias", "running_mean", "running_var"):
                    sd[f"{name}.bn.{k}"] = rng.standard_normal(m.bn_scale.shape).astype(
                        np.float32)
    else:
        for idx, conv in zip((0, 3, 6, 8, 10), plpips.AlexNetFeatures().children()):
            sd[f"features.{idx}.weight"] = rng.standard_normal(conv.weight.shape).astype(
                np.float32)
            sd[f"features.{idx}.bias"] = rng.standard_normal(conv.bias.shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("kind,lpips_heads", [("vgg19", False), ("vgg16", False),
                                              ("inception", False), ("alexnet", False),
                                              ("alexnet", True)])
def test_convert_weights_matches_jax_tool(kind, lpips_heads, tmp_path, monkeypatch):
    """``main`` on the same .pth: the same npz array for array; the
    metric nets' npz loads into the port's net (every key, every param)."""
    sd = _torch_sd(kind, seed=9)
    src, dst = str(tmp_path / "w.pth"), {n: str(tmp_path / f"{n}.npz") for n in ("jax", "port")}
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src)
    extra = []
    if lpips_heads:
        lp = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
              for i, c in enumerate((64, 192, 384, 256, 256))}
        torch.save(lp, str(tmp_path / "lp.pth"))
        extra = ["--lpips", str(tmp_path / "lp.pth")]
    monkeypatch.setattr(sys, "argv", ["convert_weights", kind, src, dst["jax"], *extra])
    jconvert.main()  # the JAX tool parses sys.argv
    pconvert.main([kind, src, dst["port"], *extra])
    with np.load(dst["jax"]) as want, np.load(dst["port"]) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert np.array_equal(got[k], want[k]), k
        flat = {k: got[k] for k in got.files}
    if kind == "inception":
        pinception.load_inception_params(dst["port"])
    elif lpips_heads:
        load_flat_params(plpips.LPIPS(), flat)


def test_extract_matches_jax_tool(tmp_path):
    pytest.importorskip("cv2")
    from masterthesis_tpu.tools import extract as jextract
    from masterthesis_tpu_torch.tools import extract as pextract
    from masterthesis_tpu_torch.tools.videoreaders import FrameWriter

    clips = tmp_path / "clips"
    clips.mkdir()
    writer = FrameWriter(str(clips), "video", fname="clip.avi", fps=5.0)
    rng = np.random.default_rng(0)
    for i in range(12):
        writer.write(rng.integers(0, 255, (32, 48, 3), dtype=np.uint8), i)
    writer.close()
    for name, tool in (("jax", jextract), ("port", pextract)):
        tool.main([str(clips), "-o", str(tmp_path / name), "--stride", "4", "--limit", "2",
                   "--per-video-dirs"])
    want = sorted(os.listdir(tmp_path / "jax" / "clip"))
    assert want == ["frame_000000.png", "frame_000004.png"]
    assert sorted(os.listdir(tmp_path / "port" / "clip")) == want
    for name in want:
        a = np.asarray(Image.open(tmp_path / "jax" / "clip" / name))
        b = np.asarray(Image.open(tmp_path / "port" / "clip" / name))
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        pextract.collect_videos([str(tmp_path / "jax" / "clip")])
