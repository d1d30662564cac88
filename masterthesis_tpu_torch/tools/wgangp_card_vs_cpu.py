"""WGAN-GP's penalty and its gradient in a discriminator's params on the
card against the CPU, four ways: with cuDNN, without cuDNN, with the
moments kernel's plain version, and with both. Shows which part of the card
path moves the double backward away from the CPU's.

    python -m masterthesis_tpu_torch.tools.wgangp_card_vs_cpu   # on a machine with an NVIDIA card

AdaINModel's discriminator at crop 32, f32 (TF32 off), 3 layers: the
multi-scale one (4x4/s2 zero-padded convs) and the default one (3x3/s2
reflect-padded), instance-normed, and the default one without a norm. One
line per case and way: the penalty's relative distance from the CPU's and
the largest gradient distance over the net's largest |CPU gradient|.
"""
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
WAYS = {"cudnn": {}, "no cudnn": dict(cudnn=False), "plain moments": dict(plain=True),
        "no cudnn + plain moments": dict(cudnn=False, plain=True)}


def penalty(args, device, real, fake, eps, cudnn=True, plain=False):
    """(penalty, {param: gradient on the CPU}) of discriminator1."""
    model = AdaINModel(default_train_args(**args), device=device)
    kernel = kmoments.moments
    if plain:
        kmoments.moments = kmoments.moments_plain
    # not torch.backends.cudnn.flags(), which sets TF32 on unless told
    torch.backends.cudnn.enabled = cudnn
    try:
        gp = model._gradient_penalty("discriminator1", real.to(device), fake.to(device),
                                     eps.to(device))
        net = model.nets.discriminator1
        grads = torch.autograd.grad(gp, list(net.parameters()), allow_unused=True)
    finally:
        kmoments.moments = kernel
        torch.backends.cudnn.enabled = True
    return gp.item(), {k: (torch.zeros_like(p) if g is None else g.detach()).cpu()
                       for (k, p), g in zip(net.named_parameters(), grads)}


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
        gp_cpu, g_cpu = penalty(args, "cpu", real, fake, eps)
        scale = max(float(g.abs().max()) for g in g_cpu.values())
        for way, kw in WAYS.items():
            gp, g = penalty(args, "cuda", real, fake, eps, **kw)
            errs = {k: float((g[k] - w).abs().max()) / scale for k, w in g_cpu.items()}
            worst = max(errs, key=errs.get)
            print(dict(flags=flags, way=way, penalty_rel=abs(gp - gp_cpu) / abs(gp_cpu),
                       worst=worst, grad_rel_to_net_max=errs[worst]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
