"""The port's evaluate against the JAX package's, on the CPU.

Both packages score the same tiny validation tree (``make_image_tree``,
40x40 JPEGs, two domains) with the same AdaINModel weights (a JAX model's
params, perturbed off their init; the port reads them from the JAX
package's ``model_0.ckpt`` through its CLI, ``--resume``, or converted by
``params_from_jax``), the same metric weights (one npz each for
``--fid_weights`` and ``--lpips_weights``, the JAX nets' param trees
perturbed, read by both packages) and the same seeded style codes,
injected into both models' ``get_z_random`` (the port cannot reproduce
``jax.random``). FID is compared only where it is well conditioned: pixel
FID (48-d) at 64 samples per side, and ``--fid_features 8`` at 16.

Tolerances, relative, per domain: ``F32_REL`` (1e-5) for the float model's
FID and LPIPS diversity (f32 forwards ~1e-5 apart, and the metric nets'
f32 convs; 5e-7 seen); ``INT8_REL`` (1e-2) for ``--int8`` with JAX's amax
tree loaded (``quant_from_jax``): the two packages' float convs round
differently before a quantize, so a few activations land one int8 step
apart (1.5e-3 seen, in an LPIPS diversity). The
identity model's FID: below 1e-3 in both, as ``tests/test_evaluate.py``
asks of the JAX package.
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")
from flax import traverse_util  # noqa: E402

from conftest import make_image_tree  # noqa: E402

from masterthesis_tpu.arguments import default_test_args as jax_test_args  # noqa: E402
from masterthesis_tpu.checkpoint import save_pytree  # noqa: E402
from masterthesis_tpu.evaluate import evaluate as jax_evaluate  # noqa: E402
from masterthesis_tpu.metrics import inception as jinception  # noqa: E402
from masterthesis_tpu.metrics.inception import InceptionV3 as JaxInceptionV3  # noqa: E402
from masterthesis_tpu.metrics.lpips import LPIPS as JaxLPIPS  # noqa: E402
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel  # noqa: E402
from masterthesis_tpu.utils import AttributeDict  # noqa: E402
from masterthesis_tpu_torch.arguments import default_test_args  # noqa: E402
from masterthesis_tpu_torch.evaluate import Evaluator, parse_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import params_from_jax, quant_from_jax  # noqa: E402

torch.set_num_threads(2)

SHAPE = dict(num_domains=2, latent_dim=4, dim=8, crop_size=32, load_size=36)
F32_REL = 1e-5
INT8_REL = 1e-2
pytestmark = pytest.mark.filterwarnings("ignore:.*RANDOM weights", "ignore::DeprecationWarning")


def _jax_params(jm, seed=0):
    """Params of the JAX model's nets, of the shapes its ``initialize``
    gives (traced, not run): each leaf its init value (LayerNorm scales 1,
    the rest 0) plus N(0, 0.1) draws, so that a tanh output spans its range."""
    rng, params = np.random.default_rng(seed), {}
    for name, net in jm.nets.items():
        a, kw = jm._dummy_inputs(name)
        shapes = jax.eval_shape(lambda: net.init({"params": jax.random.PRNGKey(0)}, *a, **kw))
        flat = traverse_util.flatten_dict(shapes["params"])
        params[name] = traverse_util.unflatten_dict({
            k: (float(k[-1] == "scale") + rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            for k, v in flat.items()})
    return params


def _metric_npz(path, module, seed, *inputs):
    """The JAX metric net's param tree (its shapes), drawn from ``seed``:
    He-scaled kernels, small biases, batch-norm statistics off identity,
    LPIPS heads in [0, 1); saved flat with ``/`` joins."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in traverse_util.flatten_dict(shapes, sep="/").items():
        leaf = k.split("/")[-1]
        if leaf == "kernel":
            a = rng.standard_normal(v.shape) * np.sqrt(2.0 / np.prod(v.shape[:3]))
        elif leaf in ("bn_scale", "bn_var"):
            a = rng.uniform(0.8, 1.2, v.shape)
        elif leaf in ("bias", "bn_bias", "bn_mean"):
            a = rng.normal(0.0, 0.05, v.shape)
        else:
            a = rng.uniform(0.0, 1.0, v.shape)
        flat[k] = a.astype(np.float32)
    np.savez(path, **flat)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    ckdir = str(root / "ckpt")
    jm = JaxAdaINModel(jax_test_args(model=JaxAdaINModel, checkpoint_dir=ckdir, **SHAPE))
    state = SimpleNamespace(params=_jax_params(jm))
    # the file JAX's Model.save writes: the params and each net's (empty) extra tree
    save_pytree({"params": state.params, "extra": {n: {} for n in state.params}},
                os.path.join(ckdir, "model_0.ckpt"))
    for n in (64, 16):
        make_image_tree(root / f"data{n}", num_domains=2, per_domain=n, size=40, mode="val")
    x = jnp.zeros((1, 75, 75, 3))
    return SimpleNamespace(
        root=root, jm=jm, state=state, ckpt=os.path.join(ckdir, "model_0.ckpt"),
        fid_weights=_metric_npz(root / "fid.npz", JaxInceptionV3(resize_input=False), 1, x),
        lpips_weights=_metric_npz(root / "lpips.npz", JaxLPIPS(), 2, x, x))


def _zs(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((8, SHAPE["latent_dim"])).astype(np.float32) for _ in range(n)]


_JAX_EXTRACTORS = {}


def _jax_inception_extractor(weights_path=None, dtype=jnp.float32, jit=True,
                             resize_input=True):
    """``make_inception_extractor`` of the JAX package for an npz, without
    its eager random init (which the npz replaces), jitted once per file."""
    key = (weights_path, resize_input)
    if key not in _JAX_EXTRACTORS:
        model = JaxInceptionV3(dtype=dtype, resize_input=resize_input)
        params = jinception.load_inception_params(weights_path)
        _JAX_EXTRACTORS[key] = jax.jit(lambda x: model.apply({"params": params}, x))
    return _JAX_EXTRACTORS[key]


def _jax_run(s, dataroot, zs, num_styles=2, **flags):
    s.jm.__dict__.pop("get_z_random", None)  # a former run's codes
    it = iter(zs)
    s.jm.get_z_random = lambda key, n: jnp.asarray(next(it)[:n])
    args = AttributeDict(jax_test_args(**SHAPE), dataroot=dataroot, mode="val", seed=0,
                         fid_weights=s.fid_weights, lpips_weights=s.lpips_weights,
                         display_dir=str(s.root / "jax_visuals"), **flags)
    return jax_evaluate(args, s.jm, s.state, num_styles=num_styles)


class InjectedEvaluator(Evaluator):
    """The CLI's evaluator on the CPU with the style codes given."""

    def __init__(self, zs):
        super().__init__(device="cpu")
        self.zs = iter(zs)

    def load_model(self, args):
        model = super().load_model(args)
        model.get_z_random = lambda n, g=None: torch.from_numpy(next(self.zs)[:n])
        return model


def _port_model(s):
    pm = AdaINModel(default_test_args(**SHAPE), device="cpu")
    pm.load_params(params_from_jax(jax.tree_util.tree_map(np.asarray, s.state.params), pm))
    return pm


def _compare(got, want, rel):
    assert set(got) == set(want) == {"cloud", "fog"}
    for domain in want:
        for key in ("fid", "lpips_diversity"):
            g, w = got[domain][key], want[domain][key]
            assert np.isfinite(w) and abs(g - w) <= rel * abs(w), (domain, key, g, w)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def test_evaluate_cli_pixel_fid_and_visuals(setup, tmp_path):
    """The port's CLI (``parse_args``, ``Evaluator.run``; the model from the
    JAX ``model_0.ckpt``) with ``--fid_extractor pixel --save_visuals``."""
    s = setup
    data = str(s.root / "data64")
    zs = _zs(2 * 8 * 2)
    want = _jax_run(s, data, zs, fid_extractor="pixel", save_visuals=True)
    argv = ["--dataroot", data, "--model", "AdaINModel", "--resume", s.ckpt,
            "--result_dir", str(tmp_path / "port"), "--fid_extractor", "pixel",
            "--save_visuals", "--lpips_weights", s.lpips_weights,
            *[a for k, v in SHAPE.items() for a in (f"--{k}", str(v))]]
    ev = InjectedEvaluator(zs)
    got = ev.run(parse_args(argv))
    _compare(got, want, F32_REL)
    assert ev.scored == 2 * 64 * 2
    visuals = _files(str(tmp_path / "port" / "images"))
    assert visuals == _files(str(s.root / "jax_visuals"))
    assert len(visuals) == 2 * 64 * 2 and "fog/63_1.jpg" in visuals


@pytest.mark.parametrize("case", ["fid_features", "int8"])
def test_evaluate_matches_jax(setup, case, monkeypatch):
    """``--fid_features 8`` (the Inception of the shared npz) on 16 images
    per domain; ``--int8`` (pixel FID, 64 per domain) with JAX's amax tree
    loaded into the port, after the port's own calibration has run."""
    s = setup
    pm = _port_model(s)
    if case == "int8":
        data, flags, rel = str(s.root / "data64"), dict(fid_extractor="pixel"), INT8_REL
        ours = Evaluator(device="cpu").calibrate(
            default_test_args(**SHAPE, dataroot=data, mode="val", int8_calib_batches=2), pm)
        # the JAX CLI's calibration: the split's first 16 images, in 2 batches
        s.jm.__dict__.pop("get_z_random", None)
        quant = s.jm.calibrate_int8(s.state, np.array_split(np.stack(_calib_images(data)), 2))
        quant = quant_from_jax(jax.tree_util.tree_map(np.asarray, quant), pm)
        assert {n: set(t) for n, t in ours.items()} == {n: set(t) for n, t in quant.items()}
        pm.load_int8(quant)
    else:
        data, flags, rel = str(s.root / "data16"), dict(fid_features=8), F32_REL
        monkeypatch.setattr(jinception, "make_inception_extractor", _jax_inception_extractor)
    zs = _zs(2 * (64 if case == "int8" else 16) // 8 * 2)
    try:
        want = _jax_run(s, data, zs, **flags)
    finally:
        s.jm.disable_int8()
    it = iter(zs)
    pm.get_z_random = lambda b, g=None: torch.from_numpy(next(it)[:b])
    args = default_test_args(**SHAPE, dataroot=data, mode="val", seed=0,
                             fid_weights=s.fid_weights, lpips_weights=s.lpips_weights, **flags)
    got = Evaluator(device="cpu").evaluate(args, pm)
    _compare(got, want, rel)


def _calib_images(data):
    """The 16 calibration images that both packages' CLIs take: the split's
    first 8 per batch, sorted, through the eval transform."""
    from masterthesis_tpu_torch.data.datasets import ImageList
    from masterthesis_tpu_torch.data.transforms import TrainTransform

    ds = ImageList(os.path.join(data, "val"), transform=TrainTransform(36, 32, train=False))
    return [ds[i] for i in range(16)]


def test_evaluate_identity_fid_is_zero(setup, tmp_path):
    """Two domains of the same 64 files and a model that returns its input:
    the translated side equals the target's reals, so FID is ~0 in both."""
    src = setup.root / "data64" / "val" / "cloud"
    for d in ("cloud", "fog"):
        (tmp_path / "val" / d).mkdir(parents=True)
        for f in src.iterdir():
            (tmp_path / "val" / d / f.name).write_bytes(f.read_bytes())

    class JaxIdentity:
        def get_z_random(self, key, n):
            return jnp.zeros((n, 4), jnp.float32)

        def forward_random(self, state, img, z, trg):
            return img, 0.0, 0.0

    class PortIdentity:
        device = torch.device("cpu")

        def get_z_random(self, n, generator=None):
            return torch.zeros((n, 4))

        def forward_random(self, img, z, trg):
            return img, 0.0, 0.0

    flags = dict(dataroot=str(tmp_path), mode="val", seed=0, fid_extractor="pixel",
                 lpips_weights=setup.lpips_weights)
    want = jax_evaluate(AttributeDict(jax_test_args(**SHAPE), **flags), JaxIdentity(), None,
                        num_styles=1)
    got = Evaluator(device="cpu").evaluate(default_test_args(**SHAPE, **flags), PortIdentity(),
                                           num_styles=1)
    for results in (want, got):
        assert set(results) == {"cloud", "fog"}
        for r in results.values():
            assert abs(r["fid"]) < 1e-3 and np.isnan(r["lpips_diversity"])
