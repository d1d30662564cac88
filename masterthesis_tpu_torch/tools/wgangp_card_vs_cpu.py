"""WGAN-GP's penalty and its gradient in a discriminator's params, each way
the port can compute them, against one f64 evaluation on the CPU: the CPU
in f32, and the card several ways: with cuDNN as training runs it, with
cuDNN's deterministic algorithms, with its benchmarked ones, without cuDNN
in the penalty's forward and first backward only, in its double backward
only, or in all three, with the moments kernel's plain version, and with
that and no cuDNN. Shows whether a way departs from the exact value by
itself or only as far as the CPU's f32 does, and which pass moves it.

    python -m masterthesis_tpu_torch.tools.wgangp_card_vs_cpu   # on a machine with an NVIDIA card

AdaINModel's discriminator at crop 32, f32 (TF32 off), 3 layers: the
multi-scale one (4x4/s2 zero-padded convs) and the default one (3x3/s2
reflect-padded), instance-normed, and the default one without a norm. The
f64 evaluation is the same discriminator, weights and inputs, with every
module computing in f64 on the CPU. One line per case and way: the
penalty's relative distance from the f64 value and from the CPU's f32
value, and the largest gradient distance over the net's largest |f64
gradient| (and over the largest |CPU f32 gradient|, against the CPU).
"""
import contextlib
import sys

import numpy as np
import torch

from masterthesis_tpu_torch.arguments import default_train_args
from masterthesis_tpu_torch.models import AdaINModel
from masterthesis_tpu_torch.ops.kernels import moments as kmoments

SHAPE = dict(crop_size=32, dim=32, latent_dim=4, num_domains=3, batch_size=2,
             use_dis_content=True, dis_content_layers=1, dis_content_final_kernel=2,
             compute_dtype="float32", seed=0)
CASES = [dict(ms_dis=True, dis_n_layers=3, num_scales=2, dis_norm="instance"),
         dict(dis_n_layers=3, dis_norm="instance"), dict(dis_n_layers=3)]
OFF = dict(enabled=False)
# way -> cuDNN flags in the penalty's forward and first backward (fwd) and in
# its double backward, the gradient in D's params (bwd); the moments kernel's
# plain version (plain)
WAYS = {
    "cudnn": {},
    "cudnn deterministic": dict(fwd=dict(deterministic=True), bwd=dict(deterministic=True)),
    "cudnn benchmark": dict(fwd=dict(benchmark=True), bwd=dict(benchmark=True)),
    "no cudnn in fwd": dict(fwd=OFF),
    "no cudnn in double bwd": dict(bwd=OFF),
    "no cudnn": dict(fwd=OFF, bwd=OFF),
    "plain moments": dict(plain=True),
    "no cudnn + plain moments": dict(fwd=OFF, bwd=OFF, plain=True),
}


def _to_f64(net: torch.nn.Module) -> None:
    """Every module of ``net`` computes in f64 (the blocks cast to their
    ``dtype``), its params and buffers f64."""
    for m in net.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    net.double()


@contextlib.contextmanager
def cudnn_flags(**flags):
    """Set ``torch.backends.cudnn``'s attributes inside the block (not
    ``torch.backends.cudnn.flags()``, which sets TF32 on unless told)."""
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


def penalty(args, device, real, fake, eps, fwd=None, bwd=None, plain=False, f64=False):
    """(penalty, {param: gradient on the CPU, f64}) of discriminator1, with
    the cuDNN flags ``fwd`` for the penalty and ``bwd`` for its gradient."""
    model = AdaINModel(default_train_args(**args), device=device)
    net = model.nets.discriminator1
    if f64:
        _to_f64(net)
        real, fake, eps = real.double(), fake.double(), eps.double()
    kernel = kmoments.moments
    if plain:
        kmoments.moments = kmoments.moments_plain
    try:
        with cudnn_flags(**(fwd or {})):
            gp = model._gradient_penalty("discriminator1", real.to(device), fake.to(device),
                                         eps.to(device))
        with cudnn_flags(**(bwd or {})):
            grads = torch.autograd.grad(gp, list(net.parameters()), allow_unused=True)
    finally:
        kmoments.moments = kernel
    return gp.item(), {k: (torch.zeros_like(p) if g is None else g.detach()).cpu().double()
                       for (k, p), g in zip(net.named_parameters(), grads)}


def distances(gp, g, gp_ref, g_ref) -> tuple[float, str, float]:
    """(penalty's relative distance, the worst param, its gradient distance
    over the net's largest |reference gradient|)."""
    scale = max(float(w.abs().max()) for w in g_ref.values())
    errs = {k: float((g[k] - w).abs().max()) / scale for k, w in g_ref.items()}
    worst = max(errs, key=errs.get)
    return abs(gp - gp_ref) / abs(gp_ref), worst, errs[worst]


def main() -> int:
    if not torch.cuda.is_available():
        print("wgangp_card_vs_cpu: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    real = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32))
    fake = torch.from_numpy(np.tanh(rng.standard_normal((4, 3, 32, 32))).astype(np.float32))
    eps = torch.from_numpy(rng.uniform(0, 1, (4, 1, 1, 1)).astype(np.float32))
    print(torch.cuda.get_device_name(0))
    for flags in CASES:
        args = dict(gan_mode="wgangp", lambda_gp=10.0, **flags, **SHAPE)
        gp64, g64 = penalty(args, "cpu", real, fake, eps, f64=True)
        gp_cpu, g_cpu = penalty(args, "cpu", real, fake, eps)
        rel, worst, grad = distances(gp_cpu, g_cpu, gp64, g64)
        print(dict(flags=flags, way="cpu f32", penalty=gp_cpu, penalty_f64=gp64,
                   penalty_rel_f64=rel, worst_f64=worst, grad_rel_f64=grad))
        for way, kw in WAYS.items():
            gp, g = penalty(args, "cuda", real, fake, eps, **kw)
            rel, worst, grad = distances(gp, g, gp64, g64)
            rel_cpu, worst_cpu, grad_cpu = distances(gp, g, gp_cpu, g_cpu)
            print(dict(flags=flags, way=way, penalty_rel_f64=rel, worst_f64=worst,
                       grad_rel_f64=grad, penalty_rel_cpu=rel_cpu, worst_cpu=worst_cpu,
                       grad_rel_cpu=grad_cpu))
    return 0


if __name__ == "__main__":
    sys.exit(main())
