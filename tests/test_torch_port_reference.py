"""The original's (PyTorch) checkpoints loaded into the port's nets
(``masterthesis_tpu_torch/tools/port_reference.py``), and the device-time
helpers' parse (``masterthesis_tpu_torch/utils/devtime.py``).

The original's package is not in this repository, so each reference
state_dict is synthetic: the inverse of the JAX package's mapping
(``masterthesis_tpu/tools/port_reference.py``), applied to a JAX param tree
of the port's seeded weights. The inverse is found by probing: the JAX
importer runs on a state_dict that answers every key with an array full of
a fresh id, which tells which key each JAX leaf comes from; the leaf then
goes back through the inverse of its transform (conv HWIO -> OIHW,
transposed conv HWIO -> IOHW with the flip undone, Dense transposed, a
norm affine to (C, 1, 1)). The JAX importer must give the tree back
exactly, and the port's importer must give exactly ``net_from_jax`` of
the JAX import, for every kind of net and ``ResnetGenerator``; its CLI
writes a checkpoint that ``Model.load`` reads.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("flax")

from masterthesis_tpu.arguments import default_train_args as jax_train_args  # noqa: E402
from masterthesis_tpu.models import AdaINModel as JaxAdaINModel  # noqa: E402
from masterthesis_tpu.models import BaseModel as JaxBaseModel  # noqa: E402
from masterthesis_tpu.models import networks as jn  # noqa: E402
from masterthesis_tpu.tools import port_reference as jpr  # noqa: E402
from masterthesis_tpu_torch.arguments import default_test_args, default_train_args  # noqa: E402
from masterthesis_tpu_torch.models import AdaINModel, BaseModel  # noqa: E402
from masterthesis_tpu_torch.models import networks as tn  # noqa: E402
from masterthesis_tpu_torch.models.blocks import ConvTranspose2d  # noqa: E402
from masterthesis_tpu_torch.models.functions import init_net  # noqa: E402
from masterthesis_tpu_torch.tools import port_reference as tpr  # noqa: E402
from masterthesis_tpu_torch.tools.convert_jax import net_from_jax  # noqa: E402
from masterthesis_tpu_torch.utils import devtime  # noqa: E402
from tests import torch_train_steps as S  # noqa: E402

torch.set_num_threads(2)

SHAPE = dict(crop_size=32, dim=8, latent_dim=4, num_domains=3, batch_size=2)
MODELS = {
    "AdaIN": (AdaINModel, JaxAdaINModel, dict(use_dis_content=True, dis_content_layers=1,
                                              dis_content_final_kernel=2)),
    "AdaIN_sn_nearest": (AdaINModel, JaxAdaINModel, dict(dis_sn=True, up_type="nearest")),
    "A_ms": (BaseModel, JaxBaseModel, dict(ms_dis=True, dis_n_layers=3)),
    "B_nearest": (BaseModel, JaxBaseModel, dict(concat=True, reparam=True, up_type="nearest")),
}
NETS = {
    "resnet_decoder": (dict(dim=16, n_blocks=2, num_domains=3, latent_dim=4, res_norm="instance"),
                       jn.AdaINDecoder, tn.AdaINDecoder),
    "resnet_generator": (dict(dim=8, n_blocks=0), jn.ResnetGenerator, tn.ResnetGenerator),
    "resnet_generator_reflect": (dict(dim=8, n_blocks=0, padding_type="reflect", norm="instance"),
                                 jn.ResnetGenerator, tn.ResnetGenerator),
}


class _Probe(dict):
    """A state_dict with every key: each answers with an array full of a
    fresh id (spectral norm's ``weight_orig`` is never asked for: its
    ``weight`` is there)."""

    def __init__(self):
        super().__init__()
        self.ids = {}

    def __contains__(self, key):
        return not key.endswith("_orig")

    def __getitem__(self, key):
        i = self.ids.setdefault(key, float(len(self.ids) + 1))
        return np.full((1, 1, 1, 1) if key.endswith("weight") else (1,), i, np.float32)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _reference_sd(jmod, tree, net, sn=False):
    """The original's state_dict that the JAX importer maps to ``tree``."""
    probe = _Probe()
    probed = jpr._IMPORTERS[type(jmod).__name__](probe, jmod)
    key_of = {i: k for k, i in probe.ids.items()}
    leaves = dict(_flat(tree))
    sd = {}
    for path, ids in _flat(probed):
        key = key_of[float(ids.reshape(-1)[0])]
        v = leaves[path]
        mod_path = [p for p in path[:-1] if p != "Dense_0"]
        module = net.get_submodule(".".join(mod_path)) if mod_path else net
        if path[-1] == "kernel" and v.ndim == 4:
            if isinstance(module, ConvTranspose2d):
                v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
            else:
                v = np.transpose(v, (3, 2, 0, 1))
        elif path[-1] == "kernel":
            v = v.T
        elif "norm" in path[-2]:
            v = v.reshape(-1, 1, 1)
        if sn and v.ndim == 4:
            key = key.replace(".weight", ".weight_orig")
        sd[key] = torch.from_numpy(np.array(v, np.float32, copy=True))
    assert len(sd) == len(probe.ids)
    return sd


def _check(jmod, tree, net, name, sn=False):
    sd = _reference_sd(jmod, tree, net, sn)
    back = jpr.import_net_params(jmod, sd)  # JAX's importer round-trips it
    want = dict(_flat(tree))
    got = dict(_flat(back))
    assert set(got) == set(want), name
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))
    ours = tpr.import_net_params(net, sd)
    theirs = net_from_jax(name, net, back)
    assert set(ours) == set(theirs) == set(dict(net.named_parameters())), name
    for k, v in theirs.items():
        assert torch.equal(ours[k], v), (name, k)
    return sd


def _setup(config):
    tcls, jcls, flags = MODELS[config]
    tm = tcls(default_train_args(seed=2, logdir=None, **SHAPE, **flags), device="cpu")
    jm = jcls(jax_train_args(logdir=None, **SHAPE, **flags))
    return tm, jm, S.jax_tree(tm), flags


@pytest.mark.parametrize("config", list(MODELS))
def test_every_net_of_a_model_imports_as_jax_and_params_from_jax_do(config):
    tm, jm, tree, flags = _setup(config)
    assert set(tm.nets) == set(jm.nets)
    for name, net in tm.nets.items():
        sn = flags.get("dis_sn", False) and name.startswith("discriminator")
        sd = _check(jm.nets[name], tree[name], net, name, sn)
        assert any(k.endswith("weight_orig") for k in sd) == sn


@pytest.mark.parametrize("kind", list(NETS))
def test_a_net_imports_as_jax_and_params_from_jax_do(kind):
    kw, jcls, tcls = NETS[kind]
    net = tcls(**kw)
    init_net(net, torch.Generator().manual_seed(0))  # built with empty weights
    tree = S.jax_tree(SimpleNamespace(nets={"net": net}))["net"]
    _check(jcls(**kw), tree, net, kind)


def test_what_jax_refuses_the_port_refuses():
    net = tn.ResnetGenerator(dim=8, n_blocks=2)
    with pytest.raises(ValueError, match="n_blocks=0"):
        tpr.import_net_params(net, {})
    dec = tn.AdaINDecoder(dim=16, n_blocks=1, num_domains=3, latent_dim=4, up_type="pixelshuffle")
    with pytest.raises(NotImplementedError, match="pixelshuffle"):
        tpr.decoder_tail(_Probe(), "dec2", dec.dec2, "dec2")
    with pytest.raises(KeyError, match="no reference importer"):
        tpr.import_net_params(torch.nn.Linear(2, 2), {})


def test_a_missing_key_or_a_wrong_shape_raises():
    tm, jm, tree, _ = _setup("AdaIN")
    net = tm.nets.style_encoder
    sd = _reference_sd(jm.nets["style_encoder"], tree["style_encoder"], net)
    del sd["fcVar.bias"]
    with pytest.raises(KeyError, match="fcVar.bias"):
        tpr.import_net_params(net, sd)
    sd = _reference_sd(jm.nets["style_encoder"], tree["style_encoder"], net)
    sd["fc.weight"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="fc.weight"):
        tpr.import_net_params(net, sd)


def test_the_cli_writes_a_checkpoint_that_model_load_reads(tmp_path, capsys):
    tm, jm, tree, _ = _setup("AdaIN")
    ref = {n: _reference_sd(jm.nets[n], tree[n], net) for n, net in tm.nets.items()
           if n != "content_discriminator"}  # a net the file lacks is skipped
    src, dst = str(tmp_path / "model_100.ckpt"), str(tmp_path / "ported.ckpt")
    torch.save(ref, src)
    tpr.main([src, dst, "--model", "AdaINModel", "--dim", "8", "--latent_dim", "4",
              "--num_domains", "3", "--crop_size", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "wrote 5 net(s)" in out
    assert os.path.exists(dst)
    served = AdaINModel(default_test_args(resume=dst, seed=9, **SHAPE), device="cpu")
    assert "Loading checkpoint for : decoder" in capsys.readouterr().out
    for name in ("content_encoder", "style_encoder", "decoder"):
        want = tpr.import_net_params(served.nets[name], ref[name])
        for k, v in served.nets[name].named_parameters():
            assert torch.equal(v, want[k]), (name, k)
    # and the weights serve as the model they came from
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((2, 4)).astype(np.float32)
    c = np.eye(3, dtype=np.float32)[[0, 2]]
    source = AdaINModel(default_test_args(seed=2, **SHAPE), device="cpu")
    a, _, _ = served.forward_random(img, z, c)
    b, _, _ = source.forward_random(img, z, c)
    assert torch.equal(a, b)


# ---------------------------------------------------------------- devtime --


def test_devtime_parses_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            torch.mm(a, b)
        torch.relu(a)
    times = devtime.device_module_times(prof, "cpu")
    assert len(times["aten::mm"]) == 3 and all(t > 0 for t in times["aten::mm"])
    assert len(times["aten::relu"]) == 1
    totals = devtime.device_op_times(prof, "cpu")
    assert totals["aten::mm"] == pytest.approx(sum(times["aten::mm"]))
    assert devtime.device_op_times(prof) == {}  # a CPU profile holds no card kernels


def test_devtime_measure_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devtime.measure({"mm": lambda: None})
