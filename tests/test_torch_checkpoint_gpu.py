"""Card-only tests of ``--ckpt_format orbax`` and of the int8 training
calibration's MAX all-reduce.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_checkpoint_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

- The port's ``.orbax`` store (a ``torch.distributed.checkpoint``
  directory) of a small model trained on the card restores params, Adam
  state and step onto the card bit for bit.
- The system's libzstd, which the reader of the JAX package's orbax stores
  binds, loads on the card's machine and round-trips.
- ``parallel.mesh.all_reduce_max`` over two gloo ranks sharing cuda:0 takes
  CUDA tensors and gives every rank the elementwise maximum, a rank's zeros
  never winning.
"""
import os

import pytest
import torch

from masterthesis_tpu_torch import checkpoint as ckpt
from masterthesis_tpu_torch import checkpoint_orbax
from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.parallel import mesh as pmesh

pytestmark = pytest.mark.gpu

SMALL = dict(crop_size=32, dim=8, latent_dim=4, num_domains=3, batch_size=2,
             use_dis_content=False, compute_dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_an_orbax_store_round_trips_on_the_card(cuda, tmp_path):
    args = dict(SMALL, checkpoint_dir=str(tmp_path), ckpt_format="orbax")
    model = AdaINModel(default_train_args(**args, seed=1), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {k: torch.rand(2, 32, 32, 3, generator=g, device=cuda) * 2 - 1 for k in ("x1", "x2")}
    batch.update(y1=torch.eye(3, device=cuda)[[0, 1]], y2=torch.eye(3, device=cuda)[[2, 0]])
    model.optimize_parameters(batch, 0, StepDraws(g))
    model.save(1)
    assert ckpt.checkpoint_format(str(tmp_path / "model_1.orbax")) == "dcp"
    back = AdaINModel(default_train_args(**args, seed=2, resume=str(tmp_path / "model_1.orbax"),
                                         resume_opt=str(tmp_path / "opt_1.orbax"), last_iter=0),
                      device=cuda)
    assert back.state.step == model.state.step == 1
    for name, net in model.nets.items():
        for k, v in net.state_dict().items():
            got = back.nets[name].state_dict()[k]
            assert got.device.type == "cuda" and torch.equal(got, v), (name, k)
        mine, theirs = model.state.opt_state[name], back.state.opt_state[name]
        assert theirs.count == mine.count
        assert all(torch.equal(a, b) for a, b in zip(theirs.mu + theirs.nu, mine.mu + mine.nu))


def test_libzstd_loads_and_round_trips(cuda):
    assert checkpoint_orbax.zstd_version().startswith("1.")
    data = os.urandom(1 << 16) + bytes(1 << 18)
    frame = checkpoint_orbax.zstd_compress(data, 3)
    assert len(frame) < len(data)
    assert checkpoint_orbax.zstd_decompress(frame) == data
    assert checkpoint_orbax.zstd_decompress(frame, len(data)) == data


def _max_rank(rank: int, out_dir: str) -> None:
    """One of two gloo ranks sharing cuda:0: ``all_reduce_max`` of a CUDA
    vector whose entries each rank sets apart (rank 1's zeros where rank 0's
    are positive); writes the result to ``out_dir/max{rank}.pt``."""
    torch.cuda.set_device(0)
    x = torch.tensor([[0.5, 3.0, 0.0, 7.25], [2.0, 0.0, 0.0, 1.0]][rank], device="cuda")
    y = pmesh.all_reduce_max(x, pmesh.make_mesh(2).group("data"))
    torch.save(dict(device=str(y.device), y=y.cpu()), os.path.join(out_dir, f"max{rank}.pt"))


def test_gloo_takes_a_max_all_reduce_of_cuda_tensors(cuda, tmp_path):
    # the ranks are spawned and import this module again: it imports no JAX
    pmesh.run_ranks(_max_rank, 2, args=(str(tmp_path),), timeout=120)
    want = torch.tensor([2.0, 3.0, 0.0, 7.25])
    for r in range(2):
        got = torch.load(tmp_path / f"max{r}.pt")
        assert got["device"].startswith("cuda")
        assert torch.equal(got["y"], want), (r, got)
