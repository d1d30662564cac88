"""The rest of the model surface, block by block, against the JAX package.

- ``depth_to_space`` and ``upsample_nearest`` against JAX's, bit for bit
  (JAX's channel order: output channel c at phase (i, j) reads input
  channel (2i + j)·C + c, not ``F.pixel_shuffle``'s 4c + 2i + j).
- ``UpsampleBlock`` with ``nearest`` and ``pixelshuffle`` (a ConvBlock
  named ``conv``, so ``up.conv.conv.weight``), ``BatchNorm2d``, the
  ResnetBlock decoder (``AdaINDecoder`` with ``res_norm`` "instance") and
  ``ResnetGenerator`` against their Flax modules, from a Flax init with
  every bias and norm affine redrawn, carried by ``params_from_jax``.
  Tolerances, of max(1, max|reference|): blocks f32 1e-5, nets f32 1e-4
  (a few norms deep; tests/test_torch_model.py's bound), bf16 5e-2 (the
  port's bf16 bound, tests/test_torch_model.py).
- The ResnetBlock decoder in int8: each of its blocks is one kernel 6
  launch (``_int8_block_serving``), the ups kernel 5 and the head kernel 8;
  against the JAX decoder with the same amax tree, held to
  tests/test_torch_int8.py's ``_forward_close`` bounds (at most 5 % of the
  outputs moved by more than 1e-4, none by more than 2e-2).
- The inits: the std of each draw within 5 % of the JAX formula's at a
  (3, 3, 64, 64) conv and a (3, 3, 64, 32) transposed conv; no xavier or
  kaiming draw beyond the truncation at 2 sigma; ``orthogonal``'s WᵀW =
  gain²·I (within 1e-5) on the HWIO flattening, read back from the port's
  conv and transposed-conv weights; in a model, conv biases zero and the
  Linear layers at torch's default.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

unfreeze = pytest.importorskip("flax.core").unfreeze

from masterthesis_tpu.models import blocks as jb  # noqa: E402
from masterthesis_tpu.models import networks as jn  # noqa: E402
from masterthesis_tpu.ops.initializers import get_conv_init  # noqa: E402
from masterthesis_tpu_torch.arguments import default_test_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel  # noqa: E402
from masterthesis_tpu_torch.models import blocks as tb  # noqa: E402
from masterthesis_tpu_torch.models import networks as tn  # noqa: E402
from masterthesis_tpu_torch.models.functions import init_net  # noqa: E402
from masterthesis_tpu_torch.models.quantize import int8_convs  # noqa: E402
from masterthesis_tpu_torch.ops import initializers as ti  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import head as khead  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq  # noqa: E402
from masterthesis_tpu_torch.ops.kernels import moments as kmoments  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import net_from_jax  # noqa: E402

torch.set_num_threads(2)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]
BLOCK_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
NET_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _perturb(tree, rng):
    """Redraw biases and norm affines, which Flax inits to 0 and 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "bias":
            out[k] = (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol, rtol=0)


def _carry(jmod, tmod, x, *extra, seed=0):
    """Flax init of ``jmod`` at ``x``, perturbed, loaded into ``tmod``;
    returns the params."""
    params = unfreeze(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), *extra))["params"]
    params = _perturb(params, np.random.default_rng(seed + 1))
    tmod.load_state_dict(net_from_jax("net", tmod, params), strict=True)
    return params


# ----------------------------------------------------------- the reshapes --


@pytest.mark.parametrize("dtype", DTYPES)
def test_depth_to_space_is_jaxs_bit_for_bit(dtype):
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 12)).astype(np.float32)
    want = np.asarray(jb.depth_to_space(jnp.asarray(x, JDT[dtype]), 2).astype(jnp.float32))
    got = tb.depth_to_space(_nchw(x).to(dtype), 2)
    assert got.shape == (2, 3, 10, 14) and got.dtype == dtype
    np.testing.assert_array_equal(_nhwc(got), want)
    # not torch's channel order: c reads (2i + j)·C + c
    assert not torch.equal(got, torch.nn.functional.pixel_shuffle(_nchw(x).to(dtype), 2))
    np.testing.assert_array_equal(got[:, 1, 1::2, 0::2].float().numpy(),
                                  _nchw(x)[:, 2 * 3 + 1].to(dtype).float().numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_upsample_nearest_is_jaxs_bit_for_bit(dtype):
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jb.upsample_nearest(jnp.asarray(x, JDT[dtype]), 2).astype(jnp.float32))
    got = tb.upsample_nearest(_nchw(x).to(dtype), 2)
    assert got.shape == (2, 3, 10, 14) and got.dtype == dtype
    np.testing.assert_array_equal(_nhwc(got), want)


# -------------------------------------------------------------- the blocks --


UP_CASES = [("nearest", "layer", "relu"), ("pixelshuffle", "layer", "relu"),
            ("nearest", "batch", "relu"), ("pixelshuffle", "instance", None)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("up_type,norm,act", UP_CASES)
def test_upsample_block_matches_flax(up_type, norm, act, dtype):
    x = np.random.default_rng(2).standard_normal((2, 6, 5, 8)).astype(np.float32)
    jmod = jb.UpsampleBlock(4, 3, 2, 1, 1, use_bias=True, norm=norm, activation=act,
                            up_type=up_type, dtype=JDT[dtype])
    tmod = tb.UpsampleBlock(8, 4, 3, 2, 1, 1, use_bias=True, norm=norm, activation=act,
                            up_type=up_type, dtype=dtype)
    params = _carry(jmod, tmod, np.zeros_like(x))
    width = 16 if up_type == "pixelshuffle" else 4
    assert params["conv"]["conv"]["kernel"].shape == (3, 3, 8, width)
    assert tmod.conv.conv.weight.shape == (width, 8, 3, 3)
    want = jmod.apply({"params": params}, jnp.asarray(x, JDT[dtype])).astype(jnp.float32)
    with torch.inference_mode():
        got = tmod(_nchw(x).to(dtype))
    assert got.shape == (2, 4, 12, 10) and got.dtype == dtype
    _close(_nhwc(got), want, BLOCK_TOL[dtype])


def test_a_pending_affine_is_applied_before_a_nearest_upsample():
    """The JAX block applies a deferred norm from the previous block inline
    (``blocks.py:717-720``)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    jmod = jb.UpsampleBlock(4, 3, 2, 1, 1, use_bias=True, norm="layer", activation="relu",
                            up_type="nearest")
    tmod = tb.UpsampleBlock(8, 4, 3, 2, 1, 1, use_bias=True, norm="layer", activation="relu",
                            up_type="nearest")
    params = _carry(jmod, tmod, x)
    pend = {"scale": rng.uniform(0.5, 1.5, (2, 8)).astype(np.float32),
            "shift": rng.standard_normal((2, 8)).astype(np.float32), "relu": True, "alpha": 0.0}
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      pending={k: jnp.asarray(v) if k in ("scale", "shift") else v
                               for k, v in pend.items()})
    with torch.inference_mode():
        got = tmod(_nchw(x), kq.Pending(torch.from_numpy(pend["scale"]),
                                        torch.from_numpy(pend["shift"]), True, 0.0))
    _close(_nhwc(got), want, BLOCK_TOL[torch.float32])


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_norm_matches_flax(dtype):
    x = (np.random.default_rng(4).standard_normal((3, 6, 5, 7)) * 2 + 0.5).astype(np.float32)
    jmod = jb.BatchNorm2d()
    tmod = tb.BatchNorm2d(7)
    params = _carry(jmod, tmod, x)
    want = jmod.apply({"params": params}, jnp.asarray(x, JDT[dtype])).astype(jnp.float32)
    with torch.inference_mode():
        got = tmod(_nchw(x).to(dtype))
    assert got.dtype == dtype
    _close(_nhwc(got), want, BLOCK_TOL[dtype])


def test_batch_norm_uses_the_batch_in_train_and_eval_alike():
    x = torch.randn(4, 5, 6, 6, generator=torch.Generator().manual_seed(0)) * 3 + 1
    bn = tb.BatchNorm2d(5)
    with torch.no_grad():
        bn.scale.uniform_(0.5, 1.5)
        bn.bias.normal_()
    train = bn.train()(x)
    evaluated = bn.eval()(x)
    assert torch.equal(train, evaluated)
    assert not any(b is not None for b in bn.buffers())  # no running statistics
    y = (train - bn.bias[:, None, None]) / bn.scale[:, None, None]
    torch.testing.assert_close(y.mean(dim=(0, 2, 3)), torch.zeros(5), atol=1e-5, rtol=0)
    torch.testing.assert_close(y.var(dim=(0, 2, 3), unbiased=False), torch.ones(5),
                               atol=1e-4, rtol=0)


# ---------------------------------------------------------------- the nets --


@pytest.fixture(scope="module")
def resnet_decoder():
    """The ResnetBlock decoder (dim 32, 3 blocks, transposed ups) with its
    Flax params and inputs."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    z = rng.standard_normal((2, 4)).astype(np.float32)
    c = np.eye(3, dtype=np.float32)[[0, 2]]
    jmod = jn.AdaINDecoder(output_dim=3, dim=32, n_blocks=3, num_domains=3, latent_dim=4,
                           res_norm="instance")
    tmod = tn.AdaINDecoder(output_dim=3, dim=32, n_blocks=3, num_domains=3, latent_dim=4,
                           res_norm="instance")
    params = _carry(jmod, tmod, x, jnp.asarray(z), jnp.asarray(c))
    return SimpleNamespace(x=x, z=z, c=c, jmod=jmod, tmod=tmod, params=params)


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_resnet_block_decoder_matches_flax(resnet_decoder, dtype):
    d = resnet_decoder
    assert "linear" not in d.params and not hasattr(d.tmod, "linear")
    assert isinstance(d.tmod.dec1_0, tb.ResnetBlock)
    jmod = d.jmod.clone(dtype=JDT[dtype])
    want = jmod.apply({"params": d.params}, jnp.asarray(d.x, JDT[dtype]), jnp.asarray(d.z),
                      jnp.asarray(d.c)).astype(jnp.float32)
    tmod = tn.AdaINDecoder(output_dim=3, dim=32, n_blocks=3, num_domains=3, latent_dim=4,
                           res_norm="instance", dtype=dtype)
    tmod.load_state_dict(d.tmod.state_dict())
    with torch.inference_mode():
        got = tmod(_nchw(d.x).to(dtype), torch.from_numpy(d.z), torch.from_numpy(d.c))
    assert got.shape == (2, 3, 32, 32)
    _close(_nhwc(got), want, NET_TOL[dtype])


def _count(monkeypatch, calls):
    def counting(module, name):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    for name in ("resblock", "conv3x3", "deconv"):
        counting(kq, name)
    counting(khead, "head")
    counting(kmoments, "moments")


def test_the_resnet_block_decoder_serves_int8_through_kernel_6(resnet_decoder, monkeypatch):
    """The JAX decoder's calibrated amax tree installed in both; each
    ResnetBlock is one kernel 6 launch, as ``_int8_block_serving`` routes."""
    d = resnet_decoder
    args = (jnp.asarray(d.x), jnp.asarray(d.z), jnp.asarray(d.c))
    _, cal = d.jmod.apply({"params": d.params}, *args, mutable=["calib"])
    quant = jax.tree_util.tree_map(np.asarray, unfreeze(cal["calib"]))
    want = np.asarray(d.jmod.apply({"params": d.params, "quant": quant}, *args))
    ref_float = np.asarray(d.jmod.apply({"params": d.params}, *args))
    assert np.abs(want - ref_float).max() > 1e-3, "the JAX decoder must run int8"
    convs = int8_convs(d.tmod)
    try:
        for path, m in convs.items():
            node = quant
            for k in path.split("."):
                node = node[k]
            m.set_amax(float(node["amax_in"]))
        calls = dict.fromkeys(("resblock", "conv3x3", "deconv", "head", "moments"), 0)
        _count(monkeypatch, calls)
        with torch.inference_mode():
            got = _nhwc(d.tmod(_nchw(d.x), torch.from_numpy(d.z), torch.from_numpy(d.c)))
        monkeypatch.undo()
    finally:
        for m in convs.values():
            m.set_amax(None)
    assert calls == dict(resblock=3, conv3x3=0, deconv=2, head=1, moments=0)
    diff = np.abs(got - want)
    assert diff.max() <= 2e-2 and (diff > 1e-4).mean() <= 0.05, diff.max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm,padding_type", [(None, None), ("instance", "reflect"),
                                               ("batch", None)])
def test_resnet_generator_matches_flax(norm, padding_type, dtype):
    """Its residual blocks included (DESIGN.md divergence 9)."""
    x = np.random.default_rng(6).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jmod = jn.ResnetGenerator(dim=8, n_blocks=2, norm=norm, activation="relu",
                              padding_type=padding_type, dtype=JDT[dtype])
    tmod = tn.ResnetGenerator(dim=8, n_blocks=2, norm=norm, activation="relu",
                              padding_type=padding_type, dtype=dtype)
    params = _carry(jmod, tmod, x)
    assert set(params) == {"stem", "down0", "down1", "res0", "res1", "up0", "up1", "head"}
    want = jmod.apply({"params": params}, jnp.asarray(x, JDT[dtype])).astype(jnp.float32)
    with torch.inference_mode():
        got = tmod(_nchw(x).to(dtype))
    assert got.shape == (2, 3, 16, 16) and got.dtype == dtype
    _close(_nhwc(got), want, NET_TOL[dtype])


# --------------------------------------------------------------- the inits --

CONV, DECONV = (64, 64, 3, 3), (64, 32, 3, 3)  # OIHW, and IOHW (in 64, out 32)
NEW_INITS = ["xavier", "xavier_normal_exact", "kaiming", "orthogonal"]


def _jax_std(init_type, gain, hwio):
    fan_in, fan_out = hwio[0] * hwio[1] * hwio[2], hwio[0] * hwio[1] * hwio[3]
    return {"xavier": gain * (2.0 / (fan_in + fan_out)) ** 0.5,
            "xavier_normal_exact": (2.0 / (fan_in + fan_out)) ** 0.5,
            "kaiming": (2.0 / fan_in) ** 0.5,
            "orthogonal": gain / max(fan_in, hwio[3]) ** 0.5}[init_type]


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "deconv"])
@pytest.mark.parametrize("init_type", NEW_INITS)
def test_init_stds_follow_the_jax_formula(init_type, transposed):
    gain = 0.5
    shape = DECONV if transposed else CONV
    hwio = ti.hwio_shape(shape, transposed)
    w = ti.conv_kernel(shape, torch.Generator().manual_seed(0), init_type, gain, transposed)
    assert tuple(w.shape) == shape
    want = _jax_std(init_type, gain, hwio)
    jw = np.asarray(get_conv_init(init_type, gain)(jax.random.PRNGKey(0), hwio))
    assert abs(float(jw.std()) / want - 1) < 0.05  # the formula is JAX's
    assert abs(float(w.std()) / want - 1) < 0.05, (float(w.std()), want)
    assert abs(float(w.mean())) < 0.05 * want
    if init_type in ("xavier", "kaiming"):
        # truncated at 2 sigma of the underlying normal, std / 0.87962566
        assert float(w.abs().max()) <= 2 * want / ti.TRUNCATED_STD * (1 + 1e-6)
        assert float(w.abs().max()) > 1.8 * want / ti.TRUNCATED_STD


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "deconv"])
def test_orthogonal_columns_on_the_hwio_flattening(transposed):
    gain = 0.7
    shape = DECONV if transposed else CONV
    w = ti.conv_kernel(shape, torch.Generator().manual_seed(1), "orthogonal", gain, transposed)
    if transposed:  # IOHW with the flip -> HWIO, as tools/convert_jax.py inverts it
        hwio = w.permute(2, 3, 0, 1).flip(0, 1)
    else:
        hwio = w.permute(2, 3, 1, 0)
    m = hwio.reshape(-1, hwio.shape[-1]).double()
    torch.testing.assert_close(m.t() @ m, gain ** 2 * torch.eye(m.shape[1], dtype=torch.float64),
                               atol=1e-5, rtol=0)
    # torch's own orthogonal_ on the IOHW weight would orthogonalize the input axis
    if transposed:
        io = w.reshape(w.shape[0], -1).double()
        assert not torch.allclose(io @ io.t(), gain ** 2 * torch.eye(w.shape[0],
                                                                     dtype=torch.float64))


def test_orthogonal_rows_when_there_are_fewer_of_them():
    """(1, 1, 8, 24): 8 rows, 24 columns; JAX orthogonalizes the rows."""
    w = ti.conv_kernel((24, 8, 1, 1), torch.Generator().manual_seed(2), "orthogonal", 1.0)
    m = w.permute(2, 3, 1, 0).reshape(8, 24).double()
    torch.testing.assert_close(m @ m.t(), torch.eye(8, dtype=torch.float64), atol=1e-5, rtol=0)


@pytest.mark.parametrize("init_type", NEW_INITS)
def test_a_model_inits_its_convs_and_leaves_biases_and_linears(init_type):
    args = dict(crop_size=16, dim=8, latent_dim=4, num_domains=3, up_type="pixelshuffle",
                dec_norm="batch", seed=4)
    model = AdaINModel(default_test_args(init_type=init_type, **args), device="cpu")
    default = AdaINModel(default_test_args(init_type=None, **args), device="cpu")
    convs = 0
    for net in model.nets.values():
        for m in net.modules():
            if isinstance(m, (tb.Conv2d, tb.ConvTranspose2d)):
                convs += 1
                if m.bias is not None:
                    assert not m.bias.any()
            elif isinstance(m, torch.nn.Linear):
                bound = m.in_features ** -0.5
                assert float(m.weight.abs().max()) <= bound
                assert float(m.bias.abs().max()) <= bound and m.bias.any()
            elif isinstance(m, tb.BatchNorm2d):
                assert bool((m.scale == 1).all()) and not m.bias.any()
    assert convs > 20
    w = model.nets.decoder.dec2.up0.conv.conv.weight
    hwio = ti.hwio_shape(w.shape)
    assert abs(float(w.std()) / _jax_std(init_type, 0.02, hwio) - 1) < 0.1
    # the same seed draws other conv weights than the default init
    assert not torch.equal(w, default.nets.decoder.dec2.up0.conv.conv.weight)


def test_init_net_draws_every_conv_by_the_init_type():
    net = tn.ResnetGenerator(dim=8, n_blocks=1, norm="batch")
    init_net(net, torch.Generator().manual_seed(0), "orthogonal", 1.0)
    for m in net.modules():
        if isinstance(m, (tb.Conv2d, tb.ConvTranspose2d)):
            transposed = isinstance(m, tb.ConvTranspose2d)
            w = m.weight.detach()
            hwio = w.permute(2, 3, 0, 1).flip(0, 1) if transposed else w.permute(2, 3, 1, 0)
            mat = hwio.reshape(-1, hwio.shape[-1]).double()
            small = mat.t() @ mat if mat.shape[0] >= mat.shape[1] else mat @ mat.t()
            torch.testing.assert_close(small, torch.eye(small.shape[0], dtype=torch.float64),
                                       atol=1e-5, rtol=0)
