"""Card-only tests of the training variants: a small f32 main step of each
training flag on the card (kernels 9/10 under ``--fused_resblock auto``, the
moments kernel) against the same step on the CPU (their plain versions
under "on"), from the same weights, batch and draws, every draw (noise,
eps, WGAN-GP's eps) made on the card; and WGAN-GP's penalty with
instance-normed discriminators, whose double backward runs through the
moments kernel's autograd Function, on the card against the CPU (the
whole WGAN-GP step keeps the default discriminator: with instance-normed
ones its G gradients are too ill-conditioned in f32 for the 1 % bound on
params, two CPU paths of that step parting by more).

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_train_variants_gpu.py -m gpu -q

Every test takes the ``cuda`` fixture, which skips when no card is present
(decided while the test runs, never at import).

Tolerances, as ``chip_smoke.py``'s small variant steps: losses within 1e-4
of max(|loss|, 1e-2) (hinge's and WGAN's G terms are means of signed logits
that cancel: hinge's g_adv is about -1e-6 at these inits); at most 1 % of
the params beyond 0.1 lr apart (the G phases' f32
gradients carry about 1 % noise, so an Adam step whose decayed gradient is
near 0 may go either way). The penalty within 1e-5 relative, its gradient
in D's params within 1e-5 of the net's largest (measured: up to 7e-8 and
2e-7 for the default discriminator, 2e-7 and 8e-7 for the multi-scale
one). The multi-scale trunk's 4x4/s2 zero-padded f32 convs run without
cuDNN here: the penalty, mean((|g| - 1)^2), scales a conv's relative error
in g by 2 / ||g| - 1|, and with cuDNN (TF32 off) the penalty parted from
the CPU's by 1.9e-4 relative and dis_head's penalty gradient by 1e-2 of the
net's largest, while without cuDNN, with the moments kernel or its plain
version, the card gives the CPU's within the bounds above (on the card,
``python -m masterthesis_tpu_torch.tools.wgangp_card_vs_cpu`` prints all
four ways). The penalty's discriminators at 3 layers: at 32 px a sixth
would instance-norm a 1x1 map to 0, which leaves no gradient to compare.

The route training takes is held by its own test, with cuDNN on: since the
penalty runs its D forward and the gradient at the interpolates without
cuDNN on the card (``TranslationModel._gradient_penalty``; the double
backward into D's params keeps cuDNN), the multi-scale penalty and its
gradient in D's params are within the bounds above of one f64 evaluation on
the CPU (measured with that tool: cuDNN in the forward 1.9e-4 and 9.7e-3
from f64, the CPU's f32 1.3e-8 and 8.4e-7, the route 2.0e-7 and 7.7e-7).
"""
import numpy as np
import pytest
import torch

from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import AdaINModel, BaseModel
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.ops.kernels import moments as kmoments
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb
from masterthesis_tpu_torch.tools import wgangp_card_vs_cpu as gp_tool

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

SHAPE = dict(crop_size=32, dim=32, latent_dim=4, num_domains=3, batch_size=2,
             use_dis_content=True, dis_content_layers=1, dis_content_final_kernel=2,
             compute_dtype="float32", seed=0)
MS = dict(ms_dis=True, dis_n_layers=3, num_scales=2)
# (model, flags, kernel 9 / 10 launches per main step)
CASES = {
    "fused": (AdaINModel, dict(gan_step="fused"), (28, 24)),
    "fused_base_a": (BaseModel, dict(gan_step="fused"), (12, 12)),
    "fused_base_b": (BaseModel, dict(gan_step="fused", concat=True, reparam=True), (16, 15)),
    "hinge": (AdaINModel, dict(gan_mode="hinge"), (32, 24)),
    "ragan": (AdaINModel, dict(use_ragan=True), (32, 24)),
    "wgangp": (AdaINModel, dict(gan_mode="wgangp", lambda_gp=10.0), (32, 24)),
    "dis_sn": (BaseModel, dict(dis_sn=True), (16, 12)),
    "ms_dis": (AdaINModel, MS, (32, 24)),
    "vgg_l2": (AdaINModel, dict(vgg_loss="l2", norm_feat=True), (32, 24)),
    "remat": (AdaINModel, dict(remat=True), (56, 24)),
    "remat_fused": (AdaINModel, dict(remat=True, gan_step="fused"), (52, 24)),
}


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


@pytest.mark.parametrize("name", list(CASES))
def test_small_variant_step_on_the_card_matches_the_cpu(cuda, name):
    model_cls, flags, per_step = CASES[name]
    card = model_cls(default_train_args(fused_resblock="auto", **flags, **SHAPE))
    cpu = model_cls(default_train_args(fused_resblock="on", **flags, **SHAPE), device="cpu")
    rng = np.random.default_rng(1)
    z = [torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32)) for _ in range(2)]
    draws = StepDraws(card.generator, z_sr=z[0].to(cuda), z_sr2=z[1].to(cuda))
    batch = _batch(2)
    before = (krb.resblock_fwd.launches, krb.resblock_bwd.launches, kmoments.moments.launches)
    got = card.main_step({k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}, draws)
    assert (krb.resblock_fwd.launches - before[0],
            krb.resblock_bwd.launches - before[1]) == per_step
    assert kmoments.moments.launches > before[2]
    if "lambda_gp" in flags:
        assert {"d1.gp_eps", "d2.gp_eps"} <= set(draws.given) and "d_gp" in got
    want = cpu.main_step(batch, StepDraws(**{k: v.cpu() for k, v in draws.given.items()}))
    assert set(got) == set(want)
    for k, v in want.items():
        v = float(v)
        assert abs(float(got[k]) - v) <= 1e-4 * max(abs(v), 1e-2), (k, float(got[k]), v)
    lr = float(want["lr"])
    diffs = torch.cat([(p.detach().cpu() - q.detach()).abs().flatten()
                       for n in cpu.nets for p, q in zip(card.nets[n].parameters(),
                                                         cpu.nets[n].parameters())])
    assert (diffs > 0.1 * lr).float().mean().item() <= 1e-2
    for n in cpu.nets:
        for (key, a), b in zip(card.nets[n].named_buffers(), cpu.nets[n].buffers()):
            if key.endswith("sn.u"):
                assert torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-6), (n, key)


@pytest.mark.parametrize("flags", [dict(dis_n_layers=3, dis_norm="instance"),
                                   dict(MS, dis_norm="instance")])
def test_gradient_penalty_double_backward_on_the_card_matches_the_cpu(cuda, flags):
    """The penalty's double backward through the moments kernel's Function
    and the convs: on the card (the multi-scale trunk's convs without
    cuDNN, see the module docstring) against the CPU."""
    args = dict(gan_mode="wgangp", lambda_gp=10.0, **flags, **SHAPE)
    card = AdaINModel(default_train_args(**args))
    cpu = AdaINModel(default_train_args(**args), device="cpu")
    rng = np.random.default_rng(3)
    real = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32))
    fake = torch.from_numpy(np.tanh(rng.standard_normal((4, 3, 32, 32))).astype(np.float32))
    eps = torch.from_numpy(rng.uniform(0, 1, (4, 1, 1, 1)).astype(np.float32))
    out = []
    for model, dev in ((card, cuda), (cpu, torch.device("cpu"))):
        before = kmoments.moments.launches
        # not torch.backends.cudnn.flags(), which sets TF32 on unless told
        torch.backends.cudnn.enabled = not flags.get("ms_dis")
        try:
            gp = model._gradient_penalty("discriminator1", real.to(dev), fake.to(dev),
                                         eps.to(dev))
            net = model.nets.discriminator1
            grads = torch.autograd.grad(gp, list(net.parameters()), allow_unused=True)
        finally:
            torch.backends.cudnn.enabled = True
        if dev.type == "cuda":
            assert kmoments.moments.launches > before
        out.append((gp.item(), {k: (torch.zeros_like(p) if g is None else g.detach()).cpu()
                                for (k, p), g in zip(net.named_parameters(), grads)}))
    (gp_card, g_card), (gp_cpu, g_cpu) = out
    assert abs(gp_card - gp_cpu) <= 1e-5 * abs(gp_cpu), (gp_card, gp_cpu)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    errs = {k: float((g_card[k] - g).abs().max()) for k, g in g_cpu.items()}
    assert scale > 0 and max(errs.values()) <= 1e-5 * scale, (scale, errs)


@pytest.mark.parametrize("flags", [dict(MS, dis_norm="instance"), dict(dis_n_layers=3)])
def test_gradient_penalty_on_the_training_route_matches_f64(cuda, flags):
    """The penalty as training computes it on the card, cuDNN enabled,
    against the same penalty in f64 on the CPU (``tools/wgangp_card_vs_cpu``)."""
    args = dict(gan_mode="wgangp", lambda_gp=10.0, **flags, **SHAPE)
    rng = np.random.default_rng(3)
    real = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32))
    fake = torch.from_numpy(np.tanh(rng.standard_normal((4, 3, 32, 32))).astype(np.float32))
    eps = torch.from_numpy(rng.uniform(0, 1, (4, 1, 1, 1)).astype(np.float32))
    assert torch.backends.cudnn.enabled
    gp64, g64 = gp_tool.penalty(args, "cpu", real, fake, eps, f64=True)
    gp, g = gp_tool.penalty(args, "cuda", real, fake, eps)
    assert torch.backends.cudnn.enabled
    rel, worst, grad = gp_tool.distances(gp, g, gp64, g64)
    assert rel <= 1e-5, (gp, gp64)
    assert grad <= 1e-5, (worst, grad)
