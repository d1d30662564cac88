"""Card-only tests of distribution: kernel 3's stats-given entry
(``adain.adain_stats``, ``csrc/adain.cu`` ``mt_adain_stats_*``) bit for bit
against its plain version, and one NCCL rank's training step against the
bare step.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_parallel_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

Tolerances: the entry rounds each product and sum on its own, in the plain
version's order, so the two agree exactly in f32 and bf16. A one-rank
process group all-reduces each gradient over itself (a copy, then a sum of
one, then a division by one), so the step's logs and params equal the bare
step's bit for bit, or, since reflect padding's backward adds with atomics
on the card, lie within three times what two bare steps differ by (the
gap of one pair is itself a sample of that spread).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

# the spatial forward's AdaIN shapes on a 2 x 2 mesh (B=8, 256 px, dim 64:
# 4 images and 32 of the 64 bottleneck rows a rank), and ragged ones
SHAPES = [(4, 256, 32, 64), (3, 5, 7, 9), (2, 3, 1, 1027)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale + offset).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_adain_stats_equals_its_plain_version(cuda, shape, dtype):
    b, c = shape[:2]
    x = _randn(shape, 0, 2.0, 0.5).to(cuda, dtype)
    mean, gamma, beta = (_randn((b, c), s).to(cuda) for s in (1, 2, 3))
    rstd = _randn((b, c), 4).abs().to(cuda) + 0.1
    before = kadain.adain_stats.launches
    got = kadain.adain_stats(x, mean, rstd, gamma, beta)
    torch.cuda.synchronize()
    assert kadain.adain_stats.launches == before + 1
    want = kadain.adain_stats_plain(x, mean, rstd, gamma, beta)
    assert got.dtype == dtype and torch.equal(got, want)


def test_adain_stats_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((2, 3, 4, 5), device=cuda)
    ok = torch.zeros((2, 3), device=cuda)
    with pytest.raises(ValueError, match="rstd must be contiguous f32"):
        kadain.adain_stats(x, ok, ok.double(), ok, ok)
    with pytest.raises(ValueError, match="contiguous 4-D"):
        kadain.adain_stats(x.transpose(2, 3), ok, ok, ok, ok)


def _small_model(device):
    args = default_train_args(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=4,
                              logdir=None, use_dis_content=True, dis_content_layers=1,
                              dis_content_final_kernel=2, gan_step="fused", seed=2)
    return AdaINModel(args, device=device)


def _batch(device):
    rng = np.random.default_rng(0)
    y = np.eye(4, dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in dict(
        x1=rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32),
        x2=rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32),
        y1=y[rng.integers(0, 4, 4)], y2=y[rng.integers(0, 4, 4)]).items()}


def _step(device, mesh=None):
    """The small fused step's logs and updated params, from the seeded init
    and draws; data parallel over ``mesh`` where given."""
    model = _small_model(device)
    if mesh is not None:
        pmesh.replicate(model, mesh)
        assert model.mesh.group("data") is not None
    logs = model.optimize_parameters(_batch(device), 0,
                                     StepDraws(torch.Generator(device).manual_seed(5)))
    params = {f"{n}.{k}": v.detach().clone() for n, net in model.nets.items()
              for k, v in net.state_dict().items()}
    return {k: float(v) for k, v in logs.items()}, params


def _gap(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) if isinstance(a[k], torch.Tensor)
               else abs(a[k] - b[k]) for k in a)


def test_one_nccl_rank_gives_the_bare_step(cuda):
    bare = [_step(cuda) for _ in range(2)]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{pmesh.free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        got = _step(cuda, pmesh.make_mesh(1))
    finally:
        dist.destroy_process_group()
    for i in range(2):  # logs, params
        assert set(got[i]) == set(bare[0][i])
        spread = _gap(bare[1][i], bare[0][i])
        assert _gap(got[i], bare[0][i]) <= 3.0 * spread, (i, _gap(got[i], bare[0][i]), spread)
