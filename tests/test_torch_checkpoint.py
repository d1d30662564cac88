"""The port's checkpoints: ``model_{it}.ckpt`` and ``opt_{it}.ckpt`` with the
JAX package's layout, a bit-exact round trip (params, spectral ``u``, Adam
moments and counts, step), the tolerant per-net restore with the JAX
package's messages and the step set by ``--resume_opt``/``--last_iter``:
the behaviours of ``tests/test_checkpoint.py`` (``--ckpt_format orbax``:
tests/test_torch_checkpoint_orbax.py).
"""
import os

import numpy as np
import pytest
import torch

from masterthesis_tpu_torch import checkpoint as ckpt
from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import AdaINModel

torch.set_num_threads(2)

SHAPE = dict(crop_size=32, load_size=36, dim=8, latent_dim=4, num_domains=4, batch_size=2,
             dis_content_layers=1, dis_content_final_kernel=2, use_dis_content=True, dis_sn=True)


def _args(**kw):
    return default_train_args(**{**SHAPE, **kw})


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    y = np.eye(4, dtype=np.float32)
    return dict(x1=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                x2=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                y1=y[[0, 1]], y2=y[[2, 3]])


def _trained(tmp_path):
    """A model after one main step and one content step, saved at 1."""
    m = AdaINModel(_args(checkpoint_dir=str(tmp_path), d_iter=2), device="cpu")
    m.optimize_parameters(_batch(0), 0)
    m.optimize_parameters(_batch(1), 1)
    m.save(1)
    return m


def _state_equal(a, b) -> None:
    for n in a.nets:
        sa, sb = a.nets[n].state_dict(), b.nets[n].state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (n, k)
    for n, s in a.state.opt_state.items():
        t = b.state.opt_state[n]
        assert s.count == t.count, n
        assert all(torch.equal(x, y) for x, y in zip(s.mu + s.nu, t.mu + t.nu)), n
    assert a.state.step == b.state.step


def test_pytree_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4), "n": [1, 2]}}
    path = str(tmp_path / "sub" / "t.ckpt")
    ckpt.save_pytree(tree, path)
    back = ckpt.load_pytree(path)
    assert torch.equal(back["a"], tree["a"]) and torch.equal(back["b"]["c"], tree["b"]["c"])
    assert back["b"]["n"] == [1, 2]
    assert os.listdir(tmp_path / "sub") == ["t.ckpt"]  # no temporary file left


def test_model_save_load_roundtrip(tmp_path):
    m = _trained(tmp_path)
    assert os.path.exists(tmp_path / "model_1.ckpt") and os.path.exists(tmp_path / "opt_1.ckpt")
    model_file = ckpt.load_pytree(str(tmp_path / "model_1.ckpt"))
    assert set(model_file) == {"params"} and set(model_file["params"]) == set(m.nets)
    assert any(k.endswith("sn.u") for k in model_file["params"]["discriminator1"])
    opt_file = ckpt.load_pytree(str(tmp_path / "opt_1.ckpt"))
    assert set(opt_file) == {"opt_state", "step"} and opt_file["step"] == 2
    assert set(opt_file["opt_state"]["decoder"]) == {"count", "mu", "nu"}

    m2 = AdaINModel(_args(checkpoint_dir=str(tmp_path), seed=1), device="cpu")
    assert not torch.equal(m2.nets.decoder.dec2.head.conv.weight, m.nets.decoder.dec2.head.conv.weight)
    m2.load(str(tmp_path / "model_1.ckpt"), str(tmp_path / "opt_1.ckpt"))
    _state_equal(m, m2)


def test_tolerant_load_skips_missing_net(tmp_path, capsys):
    m = AdaINModel(_args(), device="cpu")
    partial = {"params": {"decoder": {k: v + 1.0 for k, v in m.nets.decoder.state_dict().items()},
                          "bogus_net": {"w": torch.ones(3)}}}
    path = str(tmp_path / "partial.ckpt")
    ckpt.save_pytree(partial, path)
    before = {k: v.clone() for k, v in m.nets.style_encoder.state_dict().items()}
    m.load(path)
    out = capsys.readouterr().out
    assert "Loading checkpoint for : decoder" in out
    assert "Checkpoint for bogus_net network is not found." in out
    for k, v in m.nets.decoder.state_dict().items():
        assert torch.equal(v, partial["params"]["decoder"][k]), k
    assert all(torch.equal(v, before[k]) for k, v in m.nets.style_encoder.state_dict().items())


def test_resume_sets_step(tmp_path):
    m = _trained(tmp_path)
    m2 = AdaINModel(_args(resume=str(tmp_path / "model_1.ckpt"),
                          resume_opt=str(tmp_path / "opt_1.ckpt"), last_iter=1), device="cpu")
    _state_equal(m, m2)
    assert m2.state.step == 2
    # without a step in the optimizer file, --last_iter sets it
    opt = ckpt.load_pytree(str(tmp_path / "opt_1.ckpt"))
    del opt["step"]
    ckpt.save_pytree(opt, str(tmp_path / "opt_nostep.ckpt"))
    m3 = AdaINModel(_args(resume_opt=str(tmp_path / "opt_nostep.ckpt"), last_iter=6), device="cpu")
    assert m3.state.step == 7


def test_missing_resume_path_fails_first(tmp_path):
    with pytest.raises(FileNotFoundError, match="--resume_opt"):
        AdaINModel(_args(resume_opt=str(tmp_path / "nope.ckpt")), device="cpu")

