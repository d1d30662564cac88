"""Checkpoints the JAX package wrote, read by the port without Flax or msgpack.

The JAX package writes Flax msgpack (``masterthesis_tpu/checkpoint.py``
``save_pytree``); the port's ``checkpoint.load_pytree`` tells such a file
from its own ``torch.save`` zip by its first bytes and decodes it with its
own reader. The leaves must equal ``flax.serialization.msgpack_restore``'s
bit for bit. ``Model.load`` then restores a JAX ``model_{it}.ckpt`` net by
net (a training checkpoint holds discriminators that a serving model does
not build), with the JAX package's messages, and the restored model serves
within ``TOL`` (f32, the bound of ``tests/test_torch_model.py``) of the JAX
model restored from the same file. Small models: crop 32, dim 8, latent 4,
4 domains, B=2.
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("flax")
from flax import serialization

from masterthesis_tpu import checkpoint as jax_ckpt
from masterthesis_tpu.arguments import default_test_args as jax_test_args
from masterthesis_tpu.arguments import default_train_args as jax_train_args
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel
from masterthesis_tpu_torch import checkpoint as ckpt
from masterthesis_tpu_torch.arguments import default_test_args, default_train_args
from masterthesis_tpu_torch.models import AdaINModel
from tests.torch_jax_init import compiled_jax_init

torch.set_num_threads(2)

SIZE, B, K, LATENT = 32, 2, 4, 4
SHAPE = dict(crop_size=SIZE, dim=8, latent_dim=LATENT, num_domains=K, batch_size=B)
TOL = 1e-4  # tests/test_torch_model.py, f32


def _leaves_equal(got, want):
    """The port's tree against Flax's: the same structure, tensors against
    arrays with the same dtype, shape and bits, numbers equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _leaves_equal(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
        if want.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _leaves_equal(g, w)
    else:
        assert got == want and type(got) is type(want)


LEAVES = {
    "f32": lambda r: r.standard_normal((3, 5, 2)).astype(np.float32),
    "bf16": lambda r: np.asarray(jnp.asarray(r.standard_normal((4, 7))).astype(jnp.bfloat16)),
    "int32": lambda r: r.integers(-2**31, 2**31 - 1, (6,), dtype=np.int32),
    "int64_scalar_array": lambda r: np.asarray(7, np.int64),
    "numpy_scalar": lambda r: np.float32(2.5),
    # msgpack's own types (the JAX package's save_pytree makes every leaf an
    # array; these come through msgpack_serialize as they are)
    "numbers": lambda r: {"i": -5, "big": 2**40, "f": 1.25, "s": "name", "none": None,
                          "t": True, "l": [1, -300, 2.5]},
}


@pytest.mark.parametrize("kind", list(LEAVES))
def test_reader_matches_flax(tmp_path, kind):
    tree = {"params": {"net": {"leaf": LEAVES[kind](np.random.default_rng(0))}}, "step": 3}
    path = str(tmp_path / "model_3.ckpt")
    if kind == "numbers":
        with open(path, "wb") as f:
            f.write(serialization.msgpack_serialize(tree))
    else:
        jax_ckpt.save_pytree(tree, path)
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    assert ckpt.is_flax_file(path)
    _leaves_equal(ckpt.load_pytree(path), want)


def test_reader_joins_chunked_arrays(tmp_path, monkeypatch):
    """Flax splits an array above MAX_CHUNK_SIZE bytes into chunks; a small
    limit here makes two arrays chunked, one of them bf16."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((9, 7)).astype(np.float32),
            "b": np.asarray(jnp.asarray(rng.standard_normal(100)).astype(jnp.bfloat16)),
            "small": np.arange(3, dtype=np.int32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = ckpt.msgpack_restore(data)
    _leaves_equal(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])


def test_reader_refuses_other_types():
    with pytest.raises(ValueError, match="ext type 2"):
        ckpt.msgpack_restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="0xc1"):
        ckpt.msgpack_restore(b"\x81\xa1a\xc1")
    with pytest.raises(ValueError, match="ends inside"):
        ckpt.msgpack_restore(serialization.msgpack_serialize({"a": np.zeros(4, np.float32)})[:-3])


def test_the_ports_own_files_still_load(tmp_path):
    path = str(tmp_path / "model_1.ckpt")
    ckpt.save_pytree({"params": {"n": {"w": torch.ones(2)}}}, path)
    assert not ckpt.is_flax_file(path)
    assert torch.equal(ckpt.load_pytree(path)["params"]["n"]["w"], torch.ones(2))


# ------------------------------------------------------------ the models --


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX training AdaINModel (content discriminator and spectrally
    normalized discriminators too) saved with ``Model.save``, and a JAX
    serving model restored from it."""
    ckdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    jm = JaxAdaINModel(jax_train_args(checkpoint_dir=ckdir, logdir=None, use_dis_content=True,
                                      dis_sn=True, dis_content_layers=1,
                                      dis_content_final_kernel=2, **SHAPE))
    with compiled_jax_init():  # the weights are moved off the init below
        state = jm.initialize()
    rng = np.random.default_rng(0)
    # move the weights off their init, so that a net left unloaded shows
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.standard_normal(np.shape(a)) * 0.05).astype(np.float32),
        state.params)
    extra = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a))).astype(np.float32), state.extra)
    state = state.replace(params=params, extra=extra)
    jm.save(state, 5)
    model_path = os.path.join(ckdir, "model_5.ckpt")
    served = JaxAdaINModel(jax_test_args(resume=model_path, **SHAPE))
    with compiled_jax_init():  # restored from the checkpoint
        serve_state = served.initialize()
    return SimpleNamespace(model=model_path, opt=os.path.join(ckdir, "opt_5.ckpt"),
                           params=params, extra=extra, served=served, serve_state=serve_state)


def test_a_jax_training_checkpoint_restores_per_net(jax_checkpoint, capsys):
    s = jax_checkpoint
    tm = AdaINModel(default_test_args(resume=s.model, **SHAPE), device="cpu")
    tm.initialize()
    out = capsys.readouterr().out
    for name in ("content_encoder", "style_encoder", "decoder"):
        assert f"Loading checkpoint for : {name}" in out
    for name in ("discriminator1", "discriminator2", "content_discriminator"):
        assert f"Checkpoint for {name} network is not found." in out
    kernel = np.asarray(s.params["decoder"]["dec2"]["head"]["conv"]["kernel"])
    got = tm.nets.decoder.dec2.head.conv.weight.detach().numpy()
    np.testing.assert_array_equal(got, np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1)))


def test_a_restored_model_serves_as_jax_does(jax_checkpoint):
    s = jax_checkpoint
    tm = AdaINModel(default_test_args(resume=s.model, **SHAPE), device="cpu")
    tm.initialize()
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    z = rng.standard_normal((B, LATENT)).astype(np.float32)
    c = np.eye(K, dtype=np.float32)[[0, 3]]
    want, _, _ = s.served.forward_random(s.serve_state, img, z, c)
    got, _, _ = tm.forward_random(img, z, c)
    want = np.asarray(want)
    assert np.abs(want).max() > 0.3, "outputs must span the tanh range to test anything"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * max(1.0, np.abs(want).max()))


def test_a_jax_checkpoint_restores_the_spectral_vectors(jax_checkpoint, capsys):
    """A training port model with ``--dis_sn`` (which initializes, and so
    restores, as it is built) takes the discriminators too, their spectral
    ``u`` from the file's extra tree."""
    s = jax_checkpoint
    capsys.readouterr()
    tm = AdaINModel(default_train_args(resume=s.model, use_dis_content=True, dis_sn=True,
                                       dis_content_layers=1, dis_content_final_kernel=2,
                                       logdir=None, **SHAPE), device="cpu")
    out = capsys.readouterr().out
    assert "not found" not in out
    assert out.count("Loading checkpoint for : discriminator1") == 2  # params, then spectral
    u = np.asarray(s.extra["discriminator1"]["layer0"]["conv"]["sn"]["u"])
    np.testing.assert_array_equal(tm.nets.discriminator1.layer0.conv.sn.u.numpy(), u)

