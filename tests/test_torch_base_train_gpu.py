"""Card-only tests of BaseModel's training step and of the dropout draw:
a small f32 main step of configs A and B, and of each with
``--use_dropout``, on the card (kernels 9/10 under ``--fused_resblock
auto``) against the same step on the CPU (their plain versions under
"on"), from the same weights, batch and draws.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_base_train_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

Tolerances, as ``chip_smoke.py``'s small steps: losses within 1e-4
relative; at most 1 % of the params beyond 0.1 lr apart (the G phases' f32
gradients carry about 1 % noise, so an Adam step whose decayed gradient is
near 0 may go either way).
"""
import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import BaseModel
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

SHAPE = dict(crop_size=32, dim=32, latent_dim=4, num_domains=3, batch_size=2,
             use_dis_content=True, dis_content_layers=1, dis_content_final_kernel=2,
             compute_dtype="float32", seed=0)
CONFIGS = {"A": {}, "B": dict(concat=True, reparam=True)}
# kernel 9 / 10 launches per main step, as the JAX package routes them
PER_STEP = {"A": (16, 12), "B": (20, 15)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(seed):
    rng = np.random.default_rng(seed)
    y = np.eye(3, dtype=np.float32)
    return dict(x1=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                x2=rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
                y1=y[[0, 2]], y2=y[[1, 0]])


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_small_step_on_the_card_matches_the_cpu(cuda, config, dropout):
    flags = dict(CONFIGS[config], use_dropout=dropout)
    card = BaseModel(default_train_args(fused_resblock="auto", **flags, **SHAPE))
    cpu = BaseModel(default_train_args(fused_resblock="on", **flags, **SHAPE), device="cpu")
    rng = np.random.default_rng(1)
    z = [torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32)) for _ in range(2)]
    # with dropout every draw of the step comes from the card's generator
    draws = StepDraws(card.generator if dropout else None, z_sr=z[0].to(cuda), z_sr2=z[1].to(cuda))
    batch = _batch(2)
    before = (krb.resblock_fwd.launches, krb.resblock_bwd.launches)
    got = card.main_step({k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}, draws)
    assert (krb.resblock_fwd.launches - before[0],
            krb.resblock_bwd.launches - before[1]) == PER_STEP[config]
    masks = {k: v for k, v in draws.given.items() if ".drop" in k}
    if dropout:
        blocks = {"A": 4, "B": 3}[config]
        assert len(masks) == 4 * blocks
        assert all(m.is_cuda and m.dtype == torch.bool for m in masks.values())
        share = torch.cat([m.flatten() for m in masks.values()]).float().mean().item()
        assert 0.45 < share < 0.55, share
    else:
        assert not masks
    want = cpu.main_step(batch, StepDraws(**{k: v.cpu() for k, v in draws.given.items()}))
    for k, v in want.items():
        v = float(v)
        assert abs(float(got[k]) - v) <= 1e-4 * max(abs(v), 1e-6), (k, float(got[k]), v)
    lr = float(want["lr"])
    diffs = torch.cat([(p.detach().cpu() - q.detach()).abs().flatten()
                       for n in cpu.nets for p, q in zip(card.nets[n].parameters(),
                                                         cpu.nets[n].parameters())])
    assert (diffs > 0.1 * lr).float().mean().item() <= 1e-2


@pytest.mark.parametrize("config", list(CONFIGS))
def test_content_step_launches_no_training_kernel(cuda, config):
    model = BaseModel(default_train_args(fused_resblock="auto", **CONFIGS[config], **SHAPE))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _batch(3).items()}
    before = (krb.resblock_fwd.launches, krb.resblock_bwd.launches)
    logs = model.optimize_parameters(batch, 1)
    assert set(logs) == {"d_content_cls"} and np.isfinite(float(logs["d_content_cls"]))
    assert (krb.resblock_fwd.launches, krb.resblock_bwd.launches) == before
