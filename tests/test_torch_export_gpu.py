"""Card-only tests of the serving-bundle export: a bundle traced on the card
replays the eager forward bit for bit and launches the same kernels.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_export_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import). A small AdaINModel (64 px,
dim 16, B 2) in f32, and int8 at bf16 compute: the replay calls the same
kernels through their ``torch.library`` ops on the same inputs, so its
output equals the eager one's, and each kernel's launches per forward are
the eager forward's (float: 13 moments, 8 AdaIN; int8: 1 moments, 2 down
convs, 8 resblocks, 2 transposed convs, 1 head). Both run with cuDNN's
deterministic algorithms: with its default ones two eager f32 forwards
part by about 1e-7.
"""
import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.arguments import default_test_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import moments as kmoments
from masterthesis_tpu_torch.tools.export_serving import export_bundle, load_bundle

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

B, S, LATENT, ND = 2, 64, 8, 4
COUNTERS = {"moments": kmoments.moments, "adain": kadain.adain, "downconv": kq.downconv,
            "resblock": kq.resblock, "conv3x3": kq.conv3x3, "deconv": kq.deconv,
            "head": khead.head}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run with -m gpu on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def _launches(fn) -> dict:
    before = {k: f.launches for k, f in COUNTERS.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches - before[k] for k, f in COUNTERS.items()}


@pytest.mark.parametrize("dtype,int8", [("float32", False), ("bfloat16", True)])
def test_bundle_on_the_card_replays_eager(cuda, tmp_path, dtype, int8):
    args = default_test_args(crop_size=S, dim=16, latent_dim=LATENT, num_domains=ND,
                             batch_size=B, compute_dtype=dtype, logdir=None)
    model = AdaINModel(args, device=cuda)
    model.initialize(0)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)).to(cuda)
    ref = torch.from_numpy(rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)).to(cuda)
    z = torch.from_numpy(rng.standard_normal((B, LATENT)).astype(np.float32)).to(cuda)
    c = torch.eye(ND, device=cuda)[[1, 3]]
    if int8:
        model.calibrate_int8([img], [c], [z])
    export_bundle(model, str(tmp_path), B, S)
    bundle = load_bundle(str(tmp_path))
    assert bundle.manifest["platforms"] == ["cuda"] and bundle.manifest["int8"] is int8
    eager, n_eager = _launches(lambda: model.forward_random(img, z, c)[0])
    replay, n_replay = _launches(lambda: bundle.forward_random(img, z, c))
    assert torch.equal(replay, eager)
    assert n_replay == n_eager
    want = ({"moments": 1, "adain": 0, "downconv": 2, "resblock": 8, "conv3x3": 0, "deconv": 2,
             "head": 1} if int8 else {**dict.fromkeys(COUNTERS, 0), "moments": 13, "adain": 8})
    assert n_eager == want
    eps = torch.randn((B, LATENT), device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    eager, n_eager = _launches(lambda: model.forward_reference(img, ref, c, eps)[0])
    replay, n_replay = _launches(lambda: bundle.forward_reference(img, ref, c, eps))
    assert torch.equal(replay, eager) and n_replay == n_eager


def test_eager_calls_skip_the_dispatcher_and_tracers_take_the_op(cuda):
    """A wrapper on a plain CUDA tensor runs its CUDA implementation without
    the dispatcher (``library.CALLS`` is not called) and launches its
    kernel; under a dispatch mode, as under a tracer, it calls the op, which
    launches the same kernel with the same result."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from masterthesis_tpu_torch.ops.kernels import library

    class Passing(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    seen = []
    saved = library.CALLS["moments"]
    library.CALLS["moments"] = lambda x: seen.append(x.shape) or saved(x)
    try:
        x = torch.randn((2, 3, 8, 8), device=cuda)
        n = kmoments.moments.launches
        eager = kmoments.moments(x)
        assert seen == [] and kmoments.moments.launches == n + 1
        with Passing():
            traced = kmoments.moments(x)
        assert seen == [x.shape] and kmoments.moments.launches == n + 2
        assert all(torch.equal(a, b) for a, b in zip(eager, traced))
    finally:
        library.CALLS["moments"] = saved
