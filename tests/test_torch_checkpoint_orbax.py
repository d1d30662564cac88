"""``--ckpt_format orbax`` in the port, on the CPU.

The JAX package writes ``model_{it}.orbax/`` and ``opt_{it}.orbax/`` with
orbax (``masterthesis_tpu/checkpoint.py``); the port reads them with
``checkpoint_orbax`` (numpy and the system's libzstd, no JAX, orbax or
tensorstore) and writes its own ``.orbax`` directories as
``torch.distributed.checkpoint`` stores. Held here:

- a tiny AdaINModel train state (``tests/test_checkpoint.py::
  test_orbax_format_flag``'s setup, with the content discriminator; the
  weights moved off the init, the Adam moments and counts filled) saved
  by the JAX package's own ``Model.save`` in both formats loads through
  the port's ``Model.load`` (``--resume``, ``--resume_opt``) into nets,
  Adam state and step bit for bit equal to the msgpack route's;
- the reader's tree equals ``msgpack_restore``'s of the same state leaf for
  leaf (f32, bf16, int32, 0-d; optax's empty states as ``{}``);
- an array sharded over the 8 host devices of ``tests/conftest.py`` (one
  zarr chunk per device) reads back whole;
- the port's own ``.orbax`` round trip, bit for bit (params, spectral
  ``u``, Adam moments and counts, step), and its per-net tolerance;
- the ``Trainer`` saving and resuming with ``--ckpt_format orbax``: the
  resumed run ends on the unbroken run's state bit for bit;
- the ``Sampler`` with ``--ckpt_format orbax`` and a JAX ``.orbax``
  ``--resume`` writes what it writes from the same state's ``.ckpt``;
- ``tools/port_reference`` to a ``.orbax`` destination;
- the errors: a directory of neither format, a file of neither, and a
  missing libzstd.

The JAX model initializes with each net's init compiled
(``torch_jax_init.compiled_jax_init``): its values are moved off the init
before anything reads them.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

pytest.importorskip("flax")
pytest.importorskip("orbax.checkpoint")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from masterthesis_tpu import checkpoint as jax_ckpt  # noqa: E402
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel  # noqa: E402
from masterthesis_tpu_torch import arguments, checkpoint_orbax, data, models  # noqa: E402
from masterthesis_tpu_torch import checkpoint as ckpt  # noqa: E402
from masterthesis_tpu_torch.arguments import default_test_args, default_train_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel  # noqa: E402
from masterthesis_tpu_torch.sample import Sampler  # noqa: E402
from masterthesis_tpu_torch.train import Trainer  # noqa: E402
from tests.torch_jax_init import compiled_jax_init  # noqa: E402

from conftest import make_image_tree, tiny_train_args  # noqa: E402

torch.set_num_threads(2)

# tests/conftest.py's tiny_train_args, as the port's flags
TINY = dict(crop_size=32, load_size=36, dim=8, latent_dim=4, num_domains=4, batch_size=2,
            logdir=None, dis_content_layers=1, dis_content_final_kernel=2)
NETS = ("content_encoder", "style_encoder", "decoder", "discriminator1", "discriminator2",
        "content_discriminator")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same_tree(got, want, path=""):
    """Nested dicts of tensors: the same keys, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert isinstance(got, torch.Tensor) and isinstance(want, torch.Tensor), path
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert torch.equal(_bits(got), _bits(want)), path


def _filled(tree, rng):
    """Every float leaf drawn anew, every integer leaf (Adam's count) 3."""
    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return np.full(a.shape, 3, a.dtype)
        return (rng.standard_normal(a.shape) * 0.05).astype(a.dtype) + a
    return jax.tree_util.tree_map(leaf, tree)


@pytest.fixture(scope="module")
def jax_stores(tmp_path_factory):
    """The JAX package's train state saved by its ``Model.save`` as
    ``model_5.orbax``/``opt_5.orbax`` and, from the same state,
    ``model_5.ckpt``/``opt_5.ckpt``."""
    ckdir = str(tmp_path_factory.mktemp("jax_stores"))
    jm = JaxAdaINModel(tiny_train_args(checkpoint_dir=ckdir, ckpt_format="orbax",
                                       use_dis_content=True))
    with compiled_jax_init():
        state = jm.initialize()
    rng = np.random.default_rng(0)
    state = state.replace(params=_filled(state.params, rng),
                          opt_state=_filled(state.opt_state, rng),
                          step=jnp.asarray(5, jnp.int32))
    jm.save(state, 5)
    jm.args.ckpt_format = "msgpack"
    jm.save(state, 5)
    return ckdir


def _port(ckdir, ext, **flags):
    return AdaINModel(default_train_args(**TINY, use_dis_content=True, seed=9,
                                         resume=os.path.join(ckdir, f"model_5{ext}"),
                                         resume_opt=os.path.join(ckdir, f"opt_5{ext}"),
                                         last_iter=0, **flags), device="cpu")


def test_a_jax_orbax_state_loads_as_its_msgpack_twin(jax_stores, capsys):
    assert os.path.isdir(os.path.join(jax_stores, "model_5.orbax"))
    assert ckpt.checkpoint_format(os.path.join(jax_stores, "opt_5.orbax")) == "jax_orbax"
    a = _port(jax_stores, ".orbax")
    log_a = capsys.readouterr().out
    b = _port(jax_stores, ".ckpt")
    assert capsys.readouterr().out == log_a
    assert all(f"Loading checkpoint for : {n}" in log_a for n in NETS)
    fresh = AdaINModel(default_train_args(**TINY, use_dis_content=True, seed=9), device="cpu")
    for name in NETS:
        sa, sb = a.nets[name].state_dict(), b.nets[name].state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
        # the checkpoint's values, not the port's own init
        assert any(not torch.equal(v, fresh.nets[name].state_dict()[k]) for k, v in sa.items())
        oa, ob = a.state.opt_state[name], b.state.opt_state[name]
        assert oa.count == ob.count == 3
        for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu):
            assert torch.equal(x, y) and bool(x.abs().sum() > 0), name
    assert a.state.step == b.state.step == 5


@pytest.mark.parametrize("name", ["model_5", "opt_5"])
def test_the_reader_gives_msgpack_restores_tree(jax_stores, name):
    with open(os.path.join(jax_stores, f"{name}.ckpt"), "rb") as f:
        want = ckpt.msgpack_restore(f.read())
    _same_tree(checkpoint_orbax.read_store(os.path.join(jax_stores, f"{name}.orbax")), want)


def test_the_reader_takes_every_dtype_and_empty_states(tmp_path):
    """f32, bf16, int32 and 0-d leaves, a tuple, an optax chain with its
    ``EmptyState()`` and an empty dict, against ``msgpack_restore``."""
    import optax

    rng = np.random.default_rng(1)
    p = {"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32),
         "b": jnp.asarray(rng.standard_normal(7), jnp.bfloat16)}
    tree = {"params": p, "ints": jnp.arange(6, dtype=jnp.int32).reshape(2, 3),
            "scalar": jnp.asarray(2.5, jnp.float32), "count": jnp.asarray(11, jnp.int32),
            "pair": (jnp.ones(2), jnp.zeros((1, 2), jnp.bfloat16)),
            "opt": optax.chain(optax.add_decayed_weights(1e-4), optax.scale_by_adam()).init(p),
            "extra": {}}
    jax_ckpt.save_pytree(tree, str(tmp_path / "t.orbax"))
    jax_ckpt.save_pytree(tree, str(tmp_path / "t.ckpt"))
    with open(tmp_path / "t.ckpt", "rb") as f:
        want = ckpt.msgpack_restore(f.read())
    got = checkpoint_orbax.read_store(str(tmp_path / "t.orbax"))
    _same_tree(got, want)
    assert got["opt"]["0"] == {} and got["extra"] == {}
    assert got["params"]["b"].dtype == torch.bfloat16 and got["scalar"].shape == ()
    assert got["ints"].dtype == torch.int32


def test_a_sharded_array_reads_back_whole(tmp_path):
    mesh = Mesh(np.array(jax.devices()), ("data",))
    assert mesh.devices.size == 8
    whole = np.arange(64 * 300, dtype=np.float32).reshape(64, 300)
    tree = {"s": jax.device_put(whole, NamedSharding(mesh, P("data"))),
            "r": jax.device_put(jnp.ones((4, 4), jnp.bfloat16), NamedSharding(mesh, P()))}
    path = str(tmp_path / "sharded.orbax")
    jax_ckpt.save_pytree(tree, path)
    store = checkpoint_orbax.OcdbtStore(path)
    assert [k for k in store.keys() if k.startswith("s/") and k != "s/.zarray"] == [
        f"s/{i}.0" for i in range(8)]
    got = ckpt.load_pytree(path)
    np.testing.assert_array_equal(got["s"].numpy(), whole)
    assert torch.equal(got["r"], torch.ones(4, 4, dtype=torch.bfloat16))


def _moved(model, seed=0):
    """Every param and buffer (spectral u) of the model's nets moved, and its
    Adam state filled."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in model.nets.values():
            for t in [*net.parameters(), *net.buffers()]:
                t.add_(torch.randn(t.shape, generator=g) * 0.05)
        for s in model.state.opt_state.values():
            for t in s.mu + s.nu:
                t.copy_(torch.rand(t.shape, generator=g))
            s.count = 4
    model.state.step = 8
    return model


def test_the_ports_own_store_round_trips_per_net(tmp_path, capsys):
    flags = dict(TINY, use_dis_content=True, dis_sn=True, checkpoint_dir=str(tmp_path),
                 ckpt_format="orbax")
    model = _moved(AdaINModel(default_train_args(**flags, seed=1), device="cpu"))
    model.save(3)
    for name in ("model_3.orbax", "opt_3.orbax"):
        assert ckpt.checkpoint_format(str(tmp_path / name)) == "dcp"
        assert not ckpt.written_by_jax(str(tmp_path / name))
    back = AdaINModel(default_train_args(**flags, seed=2, resume=str(tmp_path / "model_3.orbax"),
                                         resume_opt=str(tmp_path / "opt_3.orbax"), last_iter=0),
                      device="cpu")
    for name, net in model.nets.items():
        want = net.state_dict()
        got = back.nets[name].state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
        mine, theirs = model.state.opt_state[name], back.state.opt_state[name]
        assert theirs.count == mine.count == 4
        assert all(torch.equal(x, y) for x, y in zip(theirs.mu + theirs.nu, mine.mu + mine.nu))
    assert back.state.step == 8
    capsys.readouterr()
    # a serving model has no discriminators: skipped with the JAX package's message
    served = AdaINModel(default_test_args(**{k: v for k, v in TINY.items() if k != "load_size"},
                                          resume=str(tmp_path / "model_3.orbax")), device="cpu")
    out = capsys.readouterr().out
    assert "Checkpoint for discriminator1 network is not found." in out
    assert torch.equal(served.nets.decoder.dec2.head.conv.weight,
                       model.nets.decoder.dec2.head.conv.weight)
    # a store without a net leaves that net as it was
    ckpt.save_pytree({"params": {"decoder": model.nets.decoder.state_dict()}},
                     str(tmp_path / "decoder.orbax"))
    other = AdaINModel(default_train_args(**flags, seed=5), device="cpu")
    before = other.nets.style_encoder.state_dict()
    other.load(str(tmp_path / "decoder.orbax"))
    assert torch.equal(other.nets.decoder.dec2.head.conv.weight,
                       model.nets.decoder.dec2.head.conv.weight)
    assert all(torch.equal(v, before[k]) for k, v in other.nets.style_encoder.state_dict().items())


def _dirs(root, name) -> dict:
    out = dict(checkpoint_dir=str(root / name / "ckpt"), display_dir=str(root / name / "images"))
    for d in out.values():
        os.makedirs(d)
    return out


def test_the_trainer_saves_and_resumes_orbax_stores(tmp_path):
    """tests/test_torch_trainer.py's resume case under ``--ckpt_format
    orbax``: 3 unbroken iterations against 1 and a resume of 2 from its
    ``model_2.orbax``/``opt_2.orbax``, bit for bit."""
    make_image_tree(tmp_path / "data", num_domains=4, per_domain=3)
    base = dict(TINY, dataroot=str(tmp_path / "data"), dataset=data.PairedDataset,
                model=models.AdaINModel, use_dis_content=True, d_iter=2, dis_sn=True,
                gan_step="fused", shuffle=True, num_workers=0, ckpt_format="orbax",
                print_freq=100, save_freq=100, display_freq=100)
    unbroken = default_train_args(**base, n_iters=3, max_iter=3, **_dirs(tmp_path, "a"))
    Trainer(device="cpu").run(unbroken)
    first = default_train_args(**base, n_iters=1, max_iter=1, **_dirs(tmp_path, "b"))
    Trainer(device="cpu").run(first)
    assert sorted(os.listdir(first.checkpoint_dir)) == [
        "model_0.orbax", "model_2.orbax", "opt_0.orbax", "opt_2.orbax"]
    saved = first.checkpoint_dir
    resumed = default_train_args(**base, n_iters=3, max_iter=3, last_iter=1,
                                 resume=os.path.join(saved, "model_2.orbax"),
                                 resume_opt=os.path.join(saved, "opt_2.orbax"),
                                 **_dirs(tmp_path, "c"))
    model = Trainer(device="cpu").run(resumed)
    assert model.state.step == 4
    for name in ("model_4.orbax", "opt_4.orbax"):
        a = ckpt.load_pytree(os.path.join(unbroken.checkpoint_dir, name))
        b = ckpt.load_pytree(os.path.join(resumed.checkpoint_dir, name))
        assert a.keys() == b.keys()
        flat_a, flat_b = dict(_leaves(a)), dict(_leaves(b))
        assert flat_a.keys() == flat_b.keys()
        for k, v in flat_a.items():
            assert torch.equal(v, flat_b[k]) if isinstance(v, torch.Tensor) else v == flat_b[k], k


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix, tree


def _images(root) -> dict:
    out = {}
    for d, _, names in os.walk(str(root)):
        for n in names:
            if n.endswith(".jpg"):
                out[os.path.relpath(os.path.join(d, n), str(root))] = np.asarray(
                    Image.open(os.path.join(d, n)))
    return out


def test_the_sampler_serves_a_jax_orbax_store(tmp_path, jax_stores):
    """``--ckpt_format orbax`` (read, as by the JAX sampler, only to pick what
    a run writes) and ``--resume model_5.orbax``: the same images as from
    ``model_5.ckpt``."""
    make_image_tree(tmp_path / "data", num_domains=2, per_domain=1, mode="imgs", size=40)
    written = {}
    for ext in (".orbax", ".ckpt"):
        out = tmp_path / f"out{ext}"
        args = arguments.TestArguments().parse([
            "--dataroot", str(tmp_path / "data" / "imgs"), "--model", "AdaINModel", "--dim", "8",
            "--latent_dim", "4", "--num_domains", "4", "--batch_size", "1", "--num_workers", "0",
            "--resume", os.path.join(jax_stores, f"model_5{ext}"), "--result_dir", str(out),
            "--sample_size", "32", "32", "--targets", "fog", "--ckpt_format", "orbax"])
        Sampler(device="cpu").run(args)
        written[ext] = _images(out)
    assert written[".orbax"].keys() == written[".ckpt"].keys() and written[".ckpt"]
    for k, v in written[".ckpt"].items():
        np.testing.assert_array_equal(written[".orbax"][k], v, err_msg=k)


def test_port_reference_writes_an_orbax_destination(tmp_path, capsys):
    from tests.test_torch_port_reference import SHAPE as REF_SHAPE
    from tests.test_torch_port_reference import _reference_sd, _setup
    from masterthesis_tpu_torch.tools import port_reference as tpr

    tm, jm, tree, _ = _setup("AdaIN")
    ref = {n: _reference_sd(jm.nets[n], tree[n], net) for n, net in tm.nets.items()
           if n != "content_discriminator"}  # as tests/test_torch_port_reference.py
    src = str(tmp_path / "model_100.ckpt")
    torch.save(ref, src)
    served = {}
    for dst in ("ported.orbax", "ported.ckpt"):
        tpr.main([src, str(tmp_path / dst), "--model", "AdaINModel", "--dim", "8",
                  "--latent_dim", "4", "--num_domains", "3", "--crop_size", "32",
                  "--device", "cpu"])
        assert "wrote 5 net(s)" in capsys.readouterr().out
        served[dst] = AdaINModel(default_test_args(resume=str(tmp_path / dst), seed=9,
                                                   **REF_SHAPE), device="cpu")
    assert os.path.isdir(tmp_path / "ported.orbax")
    for name, net in served["ported.ckpt"].nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(served["ported.orbax"].nets[name].state_dict()[k], v), (name, k)


def test_what_is_no_checkpoint_raises(tmp_path, jax_stores, monkeypatch):
    (tmp_path / "empty.orbax").mkdir()
    with pytest.raises(ValueError, match="it reads a torch.save file"):
        ckpt.load_pytree(str(tmp_path / "empty.orbax"))
    (tmp_path / "notes.ckpt").write_text("not a checkpoint")
    with pytest.raises(ValueError, match="orbax directory"):
        ckpt.load_pytree(str(tmp_path / "notes.ckpt"))
    # without the zstd library the JAX store does not read, and says why
    monkeypatch.setattr(checkpoint_orbax, "ZSTD_LIBRARY", "libzstd-missing.so.1")
    monkeypatch.setattr(checkpoint_orbax, "_zstd_lib", None)
    with pytest.raises(OSError, match="libzstd-missing.so.1"):
        ckpt.load_pytree(os.path.join(jax_stores, "model_5.orbax"))
