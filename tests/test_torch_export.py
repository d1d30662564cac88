"""The serving-bundle export (``tools/export_serving.py``) and the kernels'
``torch.library`` ops (``ops/kernels/library.py``), on the CPU.

The twin of ``tests/test_export_serving.py``, at its size (B 2, 64 px, dim
16, latent 8, 4 domains, f32): the bundle's ``forward_random`` and
``forward_reference`` replay the eager forwards bit for bit (the replay
calls the same ops, on the CPU their plain versions); an int8 bundle keeps
its calibration after the model drops it; the CLI round-trips a saved
checkpoint. Beside them: the port's bundle against the JAX package's bundle
exported from the same weights, within the f32 serving parity bound of
``tests/test_torch_model.py`` (1e-4 of max(1, the largest |output|)); and
``torch.library.opcheck`` (schema, fake tensors, autograd registration,
AOT dispatch) on every registered op with CPU inputs.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_test_args as jax_test_args  # noqa: E402
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel  # noqa: E402
from masterthesis_tpu.tools import export_serving as jexport  # noqa: E402
from masterthesis_tpu_torch import checkpoint as ckpt  # noqa: E402
from masterthesis_tpu_torch.arguments import default_test_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import library  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import params_from_jax  # noqa: E402
from masterthesis_tpu_torch.tools.export_serving import (  # noqa: E402
    export_bundle,
    load_bundle,
)
from masterthesis_tpu_torch.tools.export_serving import main as export_main  # noqa: E402
from tests.torch_train_steps import jax_tree  # noqa: E402

torch.set_num_threads(2)

B, S, DIM, LATENT, ND = 2, 64, 16, 8, 4
TOL = 1e-4  # tests/test_torch_model.py's f32 bound, of max(1, max |reference|)


@pytest.fixture(scope="module")
def weights():
    """The port at its seeded init, and the JAX model with the same weights
    (``params_from_jax`` inverted: no Flax init runs)."""
    args = dict(crop_size=S, dim=DIM, latent_dim=LATENT, num_domains=ND, batch_size=B,
                compute_dtype="float32", logdir=None)
    tm = AdaINModel(default_test_args(**args), device="cpu")
    tm.initialize(0)
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree(tm))
    assert all(torch.equal(v, params_from_jax(params, tm)[n][k])
               for n, net in tm.nets.items() for k, v in net.state_dict().items())
    return JaxAdaINModel(jax_test_args(**args)), params, tm


@pytest.fixture(scope="module")
def float_bundle(weights, tmp_path_factory):
    """The port's f32 bundle of both functions, exported once."""
    path = tmp_path_factory.mktemp("float_bundle")
    manifest = export_bundle(weights[2], str(path), B, S)
    return manifest, load_bundle(str(path))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    z = rng.standard_normal((B, LATENT)).astype(np.float32)
    c = np.eye(ND, dtype=np.float32)[np.arange(B) % ND]
    return torch.from_numpy(img), torch.from_numpy(z), torch.from_numpy(c)


def test_bundle_replays_forward_random(weights, float_bundle):
    _, _, tm = weights
    img, z, c = _inputs()
    manifest, bundle = float_bundle
    assert manifest["int8"] is False and manifest["platforms"] == ["cpu"]
    assert set(manifest["functions"]) == {"forward_random", "forward_reference"}
    assert set(manifest) == {"model", "batch_size", "crop_size", "input_dim", "num_domains",
                             "latent_dim", "int8", "functions", "platforms", "torch_version",
                             "framework_rev"}
    assert torch.equal(bundle.forward_random(img, z, c), tm.forward_random(img, z, c)[0])


def test_bundle_replays_forward_reference(weights, float_bundle):
    _, _, tm = weights
    img, _, c = _inputs()
    ref = _inputs(seed=3)[0]
    bundle = float_bundle[1]
    eps = torch.randn((B, LATENT), generator=torch.Generator().manual_seed(7))
    assert torch.equal(bundle.forward_reference(img, ref, c, eps),
                       tm.forward_reference(img, ref, c, eps)[0])
    # without eps both draw it from a generator seeded 0 on the device
    assert torch.equal(bundle.forward_reference(img, ref, c), tm.forward_reference(img, ref, c)[0])


def test_int8_bundle_bakes_calibration(weights, tmp_path):
    _, _, tm = weights
    img, z, c = _inputs()
    tm.calibrate_int8([img.numpy()], [c], [z])
    try:
        manifest = export_bundle(tm, str(tmp_path), B, S, fns=("forward_random",))
        want = tm.forward_random(img, z, c)[0]
    finally:
        tm.disable_int8()  # the bundle must still serve int8 numerics
    assert manifest["int8"] is True
    bundle = load_bundle(str(tmp_path))
    got = bundle.forward_random(img, z, c)
    assert torch.equal(got, want)
    # and differ from the float path (quantization is baked in)
    assert (got - tm.forward_random(img, z, c)[0]).abs().max() > 1e-6
    ops = [str(n.target) for n in bundle.programs["forward_random"].graph.nodes
           if "masterthesis_tpu_torch" in str(n.target)]
    counts = {name: sum(name + "." in op for op in ops) for name in library.OPS}
    assert counts == {"moments": 1, "adain": 0, "int8_downconv": 2, "int8_resblock": 8,
                      "int8_conv3x3": 0, "int8_deconv": 2, "head": 1, "dec_mix": 0}


def test_float_bundle_calls_the_kernel_ops(float_bundle):
    """The traced float forward calls kernels 1 and 3 as the eager one
    launches them (13 and 8 per forward)."""
    program = float_bundle[1].programs["forward_random"]
    ops = [str(n.target) for n in program.graph.nodes]
    assert sum("masterthesis_tpu_torch.moments" in op for op in ops) == 13
    assert sum("masterthesis_tpu_torch.adain" in op for op in ops) == 8


def test_cli_roundtrip(weights, tmp_path, capsys):
    _, _, tm = weights
    path = tmp_path / "model_0.ckpt"
    ckpt.save_pytree({"params": {n: net.state_dict() for n, net in tm.nets.items()}}, str(path))
    out = tmp_path / "bundle"
    export_main([
        "--model", "AdaINModel", "--resume", str(path), "--out", str(out),
        "--batch_size", str(B), "--crop_size", str(S), "--dim", str(DIM),
        "--latent_dim", str(LATENT), "--num_domains", str(ND),
        "--compute_dtype", "float32", "--skip_reference", "--device", "cpu",
    ])
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["functions"] == ["forward_random"]
    assert os.path.exists(out / "forward_random.pt2")
    printed = capsys.readouterr().out  # the checkpoint's load messages, then the manifest
    assert json.loads(printed[printed.index("{\n"):]) == manifest
    img, z, c = _inputs()
    assert torch.equal(load_bundle(str(out)).forward_random(img, z, c),
                       tm.forward_random(img, z, c)[0])


def test_bundle_matches_the_jax_bundle(weights, float_bundle, tmp_path):
    """Both packages' bundles of the same weights on the same inputs."""
    jm, params, _ = weights
    img, z, c = _inputs(seed=5)
    jexport.export_bundle(jm, params, str(tmp_path), B, S, fns=("forward_random",))
    want = np.asarray(jexport.load_bundle(str(tmp_path)).forward_random(
        jnp.asarray(img.numpy()), jnp.asarray(z.numpy()), jnp.asarray(c.numpy())))
    got = float_bundle[1].forward_random(img, z, c).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())))


# ------------------------------------------------------------------ ops --


def _op_cases():
    """(op name, CPU arguments) for every registered op, with and without
    the optional operands."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    x = randn(2, 12, 9, 7)
    gamma, beta = randn(2, 12, scale=0.2), randn(2, 12, scale=0.2)
    pre = (1.0 + randn(2, 12, scale=0.1), randn(2, 12, scale=0.1))
    conv = kq.quant_conv(randn(10, 12, 3, 3, scale=0.1), randn(10, scale=0.1), 2.5, 1, "reflect")
    down = kq.quant_conv(randn(10, 12, 3, 3, scale=0.1), None, 2.5, 2, None)
    up = kq.quant_deconv(randn(12, 6, 3, 3, scale=0.1), randn(6, scale=0.1), 2.5)
    res1 = kq.quant_conv(randn(12, 12, 3, 3, scale=0.1), None, 2.5, 1, "reflect")
    res2 = kq.quant_conv(randn(12, 12, 3, 3, scale=0.1), None, 3.0, 1, "reflect")

    def q(qc):
        return (qc.w, qc.scale, qc.bias, qc.inv_sx)

    cases = [
        ("moments", (x,)),
        ("moments", (x.to(torch.bfloat16),)),
        ("adain", (x, gamma, beta, 1e-5)),
        ("head", (x, *pre, True, 0.0, randn(3, 12, scale=0.2), randn(3, scale=0.1), True)),
        ("head", (x.to(torch.bfloat16), *pre, False, 0.0, randn(3, 12, scale=0.2), None, False)),
        ("head", (x, *pre, True, 0.0, randn(3, 12, scale=0.2), None, True, randn(2, 3))),
        ("int8_resblock", (x, *q(res1), True, *q(res2), True, gamma, beta, True, 1e-5)),
    ]
    xb = x.to(torch.bfloat16)
    mix = (xb, randn(2, 12), 1.0 + randn(2, 12, scale=0.1).abs(),
           randn(32, 12, scale=0.3).to(torch.bfloat16), randn(2, 32, scale=0.1),
           randn(12, 32, scale=0.2).to(torch.bfloat16), randn(12, scale=0.1))
    cases += [("dec_mix", (*mix, None)), ("dec_mix", (*mix, randn(2, 12, 9, 7).to(torch.bfloat16)))]
    for name, qc in (("int8_conv3x3", conv), ("int8_downconv", down), ("int8_deconv", up)):
        cases.append((name, (x, *q(qc), None, None, False, 0.0, qc.reflect, False)))
        cases.append((name, (x, *q(qc), *pre, True, 0.01, qc.reflect, True)))
    return cases


@pytest.mark.parametrize("name,args", _op_cases(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_opcheck(name, args):
    assert name in library.OPS
    torch.library.opcheck(library.OPS[name], args)


def test_wrappers_check_the_channels_before_the_op():
    """An op takes C from x: the wrapper checks x against its QuantConv."""
    qc = kq.quant_conv(torch.randn(8, 8, 3, 3), None, 1.0, 1, "reflect")
    x = torch.randn(1, 4, 6, 6)
    with pytest.raises(ValueError, match="x must be"):
        kq.conv3x3(x, qc)
    with pytest.raises(ValueError, match="C->C"):
        kq.resblock(x, qc, qc, torch.zeros(1, 4), torch.zeros(1, 4))


def test_every_op_is_checked():
    assert {name for name, _ in _op_cases()} == set(library.OPS)


def test_conv_ops_give_statistics_only_when_asked():
    """A conv op returns [y], or with ``with_stats`` [y, sum, sumsq]: no
    placeholder tensors are made for statistics nobody asked for. The
    wrappers call the ops through ``library.CALLS`` and give y, or the
    three tensors, as the ops do."""
    assert library.CALLS == dict(library.OPS)
    g = torch.Generator().manual_seed(1)

    def w(*shape):
        return 0.1 * torch.randn(shape, generator=g)

    x = torch.randn((2, 12, 9, 7), generator=g)
    cases = (("int8_conv3x3", kq.conv3x3, kq.quant_conv(w(10, 12, 3, 3), None, 2.5, 1, "reflect")),
             ("int8_downconv", kq.downconv, kq.quant_conv(w(10, 12, 3, 3), None, 2.5, 2, None)),
             ("int8_deconv", kq.deconv, kq.quant_deconv(w(12, 6, 3, 3), None, 2.5)))
    for name, wrapper, qc in cases:
        args = (x, qc.w, qc.scale, qc.bias, qc.inv_sx, None, None, False, 0.0, qc.reflect)
        (y,) = library.OPS[name](*args, False)
        stats = library.OPS[name](*args, True)
        assert len(stats) == 3 and torch.equal(stats[0], y), name
        assert torch.equal(wrapper(x, qc), y), name
        assert all(torch.equal(a, b) for a, b in zip(wrapper(x, qc, with_stats=True), stats)), name
