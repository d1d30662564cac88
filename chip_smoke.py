#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA card and hold every kernel of it
against its plain PyTorch version.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown of one forward
                                       # (f32, bf16, int8; BaseModel A int8) and of one
                                       # training main step (AdaINModel, reference and
                                       # fused GAN step; BaseModel A, B)

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the TF32 settings, which it turns off: f32 here is full f32.
2. Builds every kernel from ``masterthesis_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once).
3. For each kernel, at the shapes AdaINModel's forward gives it (256px,
   dim 64, B=8), in f32 and bf16: the kernel's error against its plain
   version on the same inputs, with the tolerance stated, and its device
   time (CUDA events over back-to-back calls on inputs that, rotated, do not
   fit in L2) beside the plain version's, the library yardstick's where one
   PyTorch call computes the same function, and the bound (bytes over
   3.35 TB/s, or f32 operations over 67 TFLOP/s: the H100 SXM's published
   rates). One JSON line per kernel and dtype. AdaIN's library yardstick is
   ``F.instance_norm`` on the (1, B*C, H, W) view with weight 1 + gamma and
   bias beta, which computes the same function.
   The int8 kernels likewise, in f32 (the int8 path's compute dtype), at
   each shape of the int8 forwards (kernel 4, the stride-1 3x3 conv, at
   BaseModel A's (8, 256, 64, 64) -> 256, and held exact also with a
   prologue and statistics, at DecoderConcat's unaligned 268 channels
   with zero padding and at a ragged shape, as is kernel 6, each also
   against a second call): the quantized operands and the int32
   sums must equal the plain version's exactly given the same input and
   prologue affine (the sums checked with unit scales, where the f32 output
   holds them exactly); then each wrapper's f32 output and statistics must
   equal the plain version's (the head's within 1e-5: its 1x1 sum runs in
   another order), beside its device time, the bound (the larger of 2 x MACs
   over the int8 tensor-core peak, 1,979 TOP/s, and bytes over 3.35 TB/s)
   and, for reference, cuDNN's bf16 float conv at the same shape (no single
   PyTorch call computes the int8 function, so ``library_ms`` is null).
   Kernels 7 and 5 are also held exact, and to a second call, at ragged
   stride-2 shapes, at BaseModel B's deconv widths (276 -> 138, 146 -> 73)
   and at widths whose box tile holds fewer columns than its 128 (Wo 80).
   ``int8_breakdown``: each launch of kernels 6 and 4 at (8, 256, 64, 64)
   and at (8, 268, 64, 64) (a tail N tile's launch of its own), and of
   kernels 7 and 5 at the AdaINModel int8 forward's four shapes and
   BaseModel B's two deconvs, by its device time (torch.profiler's kernel
   records) beside its own bound.
4. Builds AdaINModel with its own seeded init at 256px, dim 64, latent 8,
   4 domains, and in f32 and bf16 serves B=8 ``forward_random`` requests and
   one ``forward_reference`` with the launch counts set to 0 just before and
   read just after: every forward must launch the moments kernel 13 times and
   the AdaIN kernel 8 times. Outputs must be (8, 256, 256, 3), finite and in
   [-1, 1], and agree with the same forward through the plain versions on
   the card. Requests are timed in turns (plain, kernel, kernel, plain) and
   reported as img/s beside the card's name and power limit. A small model
   (32px, dim 8) on the card must agree with the same weights on the CPU,
   where the tests hold the port against the JAX package, in float and int8.
5. ``int8_serve``: the same model calibrated on two seeded B=8 batches
   serves the same requests in int8, timed in turns with the float f32 model
   (float, int8, int8, float), with the counts set to 0 before and read
   after: every int8 forward launches 2 down convs, 8 resblocks, 2
   transposed convs, 1 head and 1 moments. Outputs must be (8, 256, 256, 3),
   finite, in [-1, 1], above 25 dB PSNR from the float forward, and within
   1e-5 of the same int8 forward through the plain versions (every int8
   operand and statistic equal; only the head's sum order differs).
6. ``base_serve``: BaseModel at the same shape, config A (the CLI
   default: plain style encoder, ``Decoder`` with ``DecResnetBlock``s) and B
   (``--concat --reparam``, the JAX bench's BaseModel config), each served
   as in 4 (f32, bf16; 21 moments launches per float forward) and 5 (int8:
   A launches 2 down convs, 4 resblocks, 8 stride-1 convs (kernel 4), 2
   transposed convs, 1 head, 9 moments; B 2 down convs, 8 resblocks (four
   at DecoderConcat's 268 channels), 2 transposed convs at 276 -> 138 and
   146 -> 73, 1 moments), with the same checks, and a small config-A model
   on the card against the CPU, float and int8.
7. ``train``: AdaINModel's training main path at the JAX package's
   flagship training config (``bench.py``: 256px, dim 64, latent 8, 4
   domains, batch 8 per side, bf16, the content discriminator with d_iter
   3, the reference GAN step, ``--fused_resblock auto``). Kernels 9 and 10
   (``resblock_fwd``/``resblock_bwd``) are first held against their plain
   versions at the step's shapes, (16, 256, 64, 64) and (32, 256, 64, 64)
   bf16, and at ragged shapes (odd B, H x W off the M-tile, W != 64),
   within 2e-2 of each tensor's largest magnitude; two calls must give the
   same bits. They are timed beside their bound (bf16 operations over the
   989 TFLOP/s dense peak), the plain version and the port's composed block
   (cuDNN bf16 convs, the AdaIN kernel, torch elementwise; its autograd for
   the backward), and each of their launches at (16, 256, 64, 64) beside its
   own bound (``resblock_breakdown``). A small f32
   main step on the card must match the same step on the CPU (losses within
   1e-4, at most 1 % of params beyond 0.1 lr). Then a warm-up main step,
   three timed main steps and a timed d_iter cycle (main + 2 content
   steps), with the counts set to 0 before and read after: every main step
   launches kernel 9 32 times and kernel 10 24 times. Losses must be finite,
   the main steps must move every net but the content discriminator, the
   cycle every net; the same first step with ``--fused_resblock off`` from
   the same weights and draws must give losses within 3 %, and three more
   composed main steps are timed beside the fused ones. Prints main-step
   it/s (fused and composed), schedule img/s (2 x batch per iteration),
   seconds per step and peak device memory.
8. ``base_train``: BaseModel's training main path at the same config, A
   (the CLI default) and B (``--concat --reparam``), each as in 7: a warm-up,
   three timed fused main steps, a timed d_iter cycle and three timed
   composed main steps, with the counts set to 0 before and read after.
   Kernels 9/10 run on the content encoder's blocks (A: 16 / 12 launches
   per main step) and on DecoderConcat's ``dec_share`` (B: 20 / 15), as
   the JAX package routes them; the moments kernel runs on the other norms.
   A small f32 step of each config on the card must match the CPU, and so
   must a small AdaINModel step with ``--use_dropout`` whose masks (and
   noise and eps) are drawn on the card and handed to the CPU run. Prints
   the same metrics and kernel 9/10 ms per main step (per-call times of 7
   times the calls).
   In 7 and 8 the warm-up main step records every (shape, dtype) that it
   gives the moments kernel (2B and 4B images; DecoderConcat's 268, 138 and
   73 channels; 256-px maps; the content discriminator), and each
   timed main step must launch it that many times. After the timed runs the
   kernel is held against its plain version at each of those shapes with
   3's tolerance and timed there: its launches and ms per main step, by
   dtype, go into the kernels line (``per_main_step``, beside kernels 9/10's
   launches per main step of each phase).
9. ``train_variants``: first a small f32 main step of each training flag
   on the card against the CPU (tolerances of 7), every draw (noise, eps,
   dropout masks, WGAN-GP's eps) made on the card: the fused GAN step on
   AdaINModel and BaseModel A, hinge, RaGAN, WGAN-GP at ``--lambda_gp 10``,
   spectral norm, the multi-scale discriminator, the VGG
   perceptual loss (l2) and ``--remat``. Then AdaINModel at 7's config
   with ``bench.py``'s GAN step (``--gan_step fused``, bench.py:160-185): a
   warm-up main step without draws, three timed main steps, each launching
   kernel 9 28 times and kernel 10 24 times, and a timed d_iter cycle;
   then the reference GAN step from the same weights, whose first step
   without draws must give losses within 3 % (both compute one update),
   and three of its main steps timed. The moments kernel is held at the
   fused step's shapes as in 7. Then each other flag alone on that config
   (hinge, RaGAN, WGAN-GP, spectral norm, the multi-scale discriminator, the
   VGG perceptual loss, ``--remat``): a warm-up and two timed main steps
   with their launches asserted (``--remat``: kernel 9 52 times, the 24
   blocks of G1 and G2 recomputed in backward), finite losses, every net
   but the content discriminator moved; seconds per step and peak memory
   beside the fused step's. Cumulative seconds are printed after 7, 8, 9.
10. ``train_cli``: the train CLI, ``TrainArguments().parse(argv)`` and
   ``Trainer().run(args)``, at 9's fused config (AdaINModel, 286 -> 256 px,
   dim 64, latent 8, 4 domains, batch 8, bf16, the content discriminator
   with d_iter 3, ``--gan_step fused``, ``--fused_resblock auto``) over a
   seeded tree of 4 x 8 JPEGs at 540 x 960 (written under ``chiprun_out/``
   and removed after), 15 iterations (five d_iter cycles), once with host
   transforms (the native decode where its library builds, else PIL's) and
   once with ``--device_preproc``, the launch counts set to 0 before each
   run and read after. Every main step must launch kernels 9/10 28 / 24
   times and the moments kernel as often as in 9; losses finite;
   ``model_{k}.ckpt``/``opt_{k}.ckpt`` at 0, 9 and the final 15, and
   ``gen_0.jpg``, ``gen_9.jpg``, as the JAX package's cadence gives. A
   fresh trainer resumed from the checkpoint at 9 (``--resume``,
   ``--resume_opt``, ``--last_iter 9``) must restore params, Adam state and
   step bit for bit, and its iterations 10-12 give the unbroken run's
   losses within 1e-5 relative. Prints the trainer's it/s per cycle and
   schedule img/s beside 9's fused step, host syncs inside the steps of one
   cycle, the device idle share over that cycle (torch.profiler),
   checkpoint seconds and sizes; then the loader alone in img/s (native,
   PIL, the host side of ``--device_preproc``) and the device preprocess in
   ms per batch. Cumulative seconds are printed after it.
11. ``int8_serve_bf16``: int8 serving at compute dtype bf16 (kernels 4-8
   take and give bf16). First kernels 4-8 in bf16 at the int8 forwards'
   shapes, as in 3 (kernels 4-7 equal to their plain versions, y and
   statistics; the head within 2^-7, two bf16 steps, its sum over C in
   another order; the head also timed at B=64 and at the sample CLI's
   (4, 64, 540, 960), each shape's ``bound_share`` beside its ms, and held
   to its plain version in f32 and bf16 at two ragged shapes, one launch
   per call), and at the sample CLI's 540 x 960 shapes at one image
   (``int8_bf16_540x960``: a bottleneck of 135 rows). Then AdaINModel (B = 8
   and 64), BaseModel A (kernel 4) and B, and AdaINModel with ``--dec_norm
   instance``, each calibrated and served in turns with the float bf16
   model and the int8 model at compute dtype f32 of the same weights, the
   counts checked per forward; outputs bf16, finite, in [-1, 1], above 25
   dB from the float bf16 forward, within 2^-7 of the plain versions'
   forward. The bf16 kernel entries' launches are this phase's.
12. ``sample_cli``: the sample CLI, ``TestArguments().parse(argv)`` and
   ``Sampler().run(args)`` on the card, from a ``Model.save`` checkpoint of
   the flagship AdaINModel (full width, seeded), over 8 seeded 540 x 960
   JPEGs and a 16-frame video (under ``chiprun_out/``, removed after), at
   ``--batch_size 4 --compute_dtype bfloat16``: all four targets, the same
   with ``--int8``, ``--gen_grid`` and ``--out_fmt video``. The files the
   JAX package's sampler writes must exist and decode to 540 x 960 (the
   grid to 5 x 960 by 2 x 540, the videos to 12 frames each), every
   translation be finite bf16, the launches per forward be the float or
   int8 path's, and the first batch equal the bare ``forward_random`` on
   its inputs and style within 5e-2. Prints translations/s from the CLI
   beside the bare forward's at the same batch, the loader alone, the JPEG
   encode alone, the device idle share over a profiled pass over the
   batches, calibration seconds and peak memory.
13. ``model_surface``: the rest of the model surface at 4's shape
   (256 px, dim 64, latent 8, 4 domains, B=8, seed 0). Kernel 4 in f32 and
   bf16 at each up conv's shape that ``--up_type nearest`` and
   ``pixelshuffle`` give it (AdaINModel (8, 256, 128, 128) -> 128, (8, 128,
   256, 256) -> 64, (8, 256, 64, 64) -> 512, (8, 128, 128, 128) -> 256;
   BaseModel B (8, 276, 128, 128) -> 138, (8, 146, 256, 256) -> 73, (8, 276,
   64, 64) -> 552, (8, 146, 128, 128) -> 292; zero padding, no prologue or
   statistics, as the up blocks call it): operands, int32 sums and y equal
   to the plain version's, a second call equal to the first, ms per launch
   beside the bound, the plain version and cuDNN's bf16 conv. Then
   AdaINModel with each up type (transpose, nearest, pixelshuffle) in float
   bf16, int8 at compute dtype f32 and int8 at bf16 from the same weights,
   served in turns with the counts set to 0 before and read after: an int8
   forward of a nearest or pixelshuffle tail launches 2 down convs, 8
   resblocks, 2 stride-1 convs (kernel 4), no transposed conv or head, 3
   moments; outputs finite, in [-1, 1], int8 above 25 dB from the float
   bf16 output and within 1e-5 (f32) or 2^-7 (bf16) of the plain versions'
   forward; img/s of each. BaseModel A with ``--enc_norm batch --dec_norm
   batch`` (batch norm is plain torch, as the JAX package's two means are)
   small against the CPU and served in bf16; small f32 steps against the
   CPU (AdaINModel ``--up_type pixelshuffle --dec_norm batch --init_type
   orthogonal``, BaseModel B ``--up_type nearest``), every draw on the card;
   the fused main step at 9's config with ``--up_type nearest`` beside the
   transposed tail (it/s, peak memory). Kernel 4's kernels-line entries gain
   ``model_surface``: these shapes' rows and its launches on AdaINModel's
   nearest and pixelshuffle paths. Cumulative seconds are printed after it.
14. ``evaluate``: the evaluate CLI, ``parse_args(argv)`` and
   ``Evaluator().run(args)`` as its ``main`` does, on the card, from a
   ``Model.save`` checkpoint of the flagship AdaINModel over a seeded
   validation tree of 4 domains x 64 JPEGs at 360 x 640 (under
   ``chiprun_out/``, removed after; load 286, crop 256), batch 8, bf16, 2
   styles: the 2048-d InceptionV3 FID and LPIPS (seeded random weights: the
   repository holds no pretrained npz), ``--fid_extractor pixel``, and
   ``--int8 --fid_extractor pixel`` (int8 at bf16 compute), 64 forwards
   each. The launches per forward must be exactly the float path's (13
   moments, 8 AdaIN) or the int8 path's over the whole run, so the metric
   nets reach no kernel; results finite; each run repeated through the
   plain versions (which must launch nothing), the FID accumulators within 1e-2 of their largest
   magnitude and pixel FID and LPIPS diversity within 2e-2 relative (the
   2048-d repeat skips its host sqrtm). Prints translations scored per
   second beside the bare ``forward_random`` at B=8, FID's host seconds per
   domain (the 2048-d run's is its host sqrtm), the device idle share over
   one profiled domain (pixel run), InceptionV3 img/s and LPIPS pairs/s
   alone (B=8, f32, 256 x 256); an identity model's pixel FID below
   1e-3 on the card; a small evaluate (32 px, dim 8, 2 domains x 64 images,
   f32) on the card within 1e-3 of the CPU with the same weights and style
   codes. The kernels line's float and int8 bf16 entries gain ``evaluate``:
   their launches per run. Cumulative seconds are printed after it.
15. Last lines: the card, the ``{"kernels": [...]}`` line, then
   ``{"ok": true, "device": {...}}``.

Nothing is caught: any failure ends the script with a non-zero exit and no
result line. Without a card it exits 1 before doing anything.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity
from torch.profiler import profile as torch_profile

from masterthesis_tpu_torch import checkpoint as ckpt
from masterthesis_tpu_torch import native
from masterthesis_tpu_torch.arguments import (
    TestArguments,
    TrainArguments,
    default_test_args,
    default_train_args,
)
from masterthesis_tpu_torch.data import DataLoader, PairedDataset, infinite
from masterthesis_tpu_torch.data.device_preproc import preprocess_pair_batch
from masterthesis_tpu_torch.evaluate import Evaluator, parse_args
from masterthesis_tpu_torch.evaluate import evaluate as evaluate_model
from masterthesis_tpu_torch.metrics.inception import make_inception_extractor
from masterthesis_tpu_torch.metrics.lpips import make_lpips_fn
from masterthesis_tpu_torch.models import AdaINModel, BaseModel
from masterthesis_tpu_torch.models.translation import StepDraws
from masterthesis_tpu_torch.ops import norms
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import build
from masterthesis_tpu_torch.ops.kernels import head as khead
from masterthesis_tpu_torch.ops.kernels import int8_conv as kq
from masterthesis_tpu_torch.ops.kernels import moments as kmoments
from masterthesis_tpu_torch.ops.kernels import resblock_train as krb
from masterthesis_tpu_torch.sample import Sampler
from masterthesis_tpu_torch.train import STEP, Trainer, iteration_generator
from masterthesis_tpu_torch.utils import devtime
from masterthesis_tpu_torch.utils.images import save_images

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores, published
INT8_OPS = 1979e12  # H100 SXM, int8 tensor cores, dense, published
L2_BYTES = 50 * 2**20
B = 8
# (NCHW shape, launches per forward) on AdaINModel at 256px, dim 64, B=8
MOMENTS_SHAPES = [
    ((B, 64, 256, 256), 2),  # stem instance norm, up1 layer norm
    ((B, 128, 128, 128), 2),  # down0 instance norm, up0 layer norm
    ((B, 256, 64, 64), 9),  # down1 instance norm, 8 encoder resblock norms
]
ADAIN_SHAPES = [((B, 256, 64, 64), 8)]  # 2 per decoder resblock
MOMENTS_PER_FORWARD = sum(n for _, n in MOMENTS_SHAPES)
ADAIN_PER_FORWARD = sum(n for _, n in ADAIN_SHAPES)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
ARGS = dict(crop_size=256, dim=64, latent_dim=8, num_domains=4, batch_size=B, seed=0)
SMALL_ARGS = dict(crop_size=32, dim=8, latent_dim=4, num_domains=4, batch_size=2, seed=0)
# model outputs are tanh values: f32 kernel vs plain sums in another order;
# bf16 a few bf16 rounding steps carried through the net
MODEL_TOL = {"f32": 1e-3, "bf16": 5e-2}
CPU_TOL = {"f32": 1e-4, "bf16": 5e-2}
# int8 shapes on AdaINModel at 256px, dim 64, B=8: (NCHW input, Co, per forward)
DOWN_SHAPES = [((B, 64, 256, 256), 128, 1), ((B, 128, 128, 128), 256, 1)]
RES_SHAPES = [((B, 256, 64, 64), 256, 8)]  # 4 encoder blocks, 4 AdaIN blocks
DECONV_SHAPES = [((B, 256, 64, 64), 128, 1), ((B, 128, 128, 128), 64, 1)]
# BaseModel B's deconvs (DecoderConcat: 276 -> 138, Cp 288, R 552; 146 -> 73,
# Cp 160, R 292), one each per forward
DECONV_B_SHAPES = [((B, 276, 64, 64), 138, 1), ((B, 146, 128, 128), 73, 1)]
# kernel 8 by dtype: (NCHW input, Co, launches per forward at B=8, route).
# The B=64 and 540 x 960 rows are other serving paths' shapes (int8 at bf16
# compute at B=64; the sample CLI, B=4): timed beside, not in the per-forward sum
HEAD_SHAPES = {
    "f32": [((B, 64, 256, 256), 3, 1, "int8 forward, f32 compute, B=8")],
    "bf16": [((B, 64, 256, 256), 3, 1, "int8 forward, bf16 compute, B=8"),
             ((64, 64, 256, 256), 3, 0, "int8_serve_bf16, B=64"),
             ((4, 64, 540, 960), 3, 0, "sample CLI, 540x960, B=4")],
}
# and held to its plain version at ragged shapes: odd B, hw off the 16-byte
# vector (scalar runs) or on it with a cut warp group, C off the channel
# batch, Co 5 with a bias, relu with alpha 0.2, no activation
HEAD_RAGGED = [((3, 21, 37, 53), 5), ((3, 20, 37, 56), 5)]
CONV3X3_SHAPES = [((B, 256, 64, 64), 256, 8)]  # BaseModel A: conv1/conv2 of 4 DecResnetBlocks
# kernels 4 and 6 are also held to their plain versions at DecoderConcat's
# unaligned width and at a ragged shape that reaches every edge of the
# stride-1 template: odd B, a tail k-slab (Cp 320), a second N tile, W + 2
# above the 128-row M tile, Ho x Wp off it
CONV3X3_UNALIGNED = ((B, 268, 64, 64), 268)
INT8_RAGGED = ((3, 300, 9, 140), 300)
# kernel 7 is also held to its plain version, and to a second call, at a
# ragged shape: odd B, odd H and W (the padded input rounded up to an even
# size), Wo above the 128-column M tile, Cp 96 (part of a k-slab), R 40 (a
# tail N tile); and at Wo 80, one row of a 128-column box with 80 columns
# inside (TMA stores); kernel 5 so at BaseModel B's two deconvs
# (DECONV_B_SHAPES) and at W 80 (DECONV_RAGGED)
DOWN_RAGGED = [((3, 72, 21, 269), 40), ((2, 96, 10, 160), 64)]
DECONV_RAGGED = [((2, 64, 6, 80), 48)]
INT8_PER_FORWARD = {"int8_downconv": 2, "int8_resblock": 8, "int8_conv3x3": 0, "int8_deconv": 2,
                    "head": 1, "moments": 1}
# BaseModel serving: A is the CLI default (plain style encoder, Decoder with
# DecResnetBlocks); B is --concat --reparam, the JAX bench's BaseModel config
# (bench.py:107-159). Both at ARGS, with --dec_norm layer, --up_type transpose.
BASE_CONFIGS = {"A": {}, "B": dict(concat=True, reparam=True)}
# float: 11 encoder norms, 8 decoder instance norms, 2 LayerNorms
BASE_FLOAT_PER_FORWARD = (21, 0)
BASE_INT8_PER_FORWARD = {
    "A": {"int8_downconv": 2, "int8_resblock": 4, "int8_conv3x3": 8, "int8_deconv": 2, "head": 1,
          "moments": 9},
    # dec_share and dec1_0..2 at C=268 run kernel 6; the 1x1 dec4 stays float
    "B": {"int8_downconv": 2, "int8_resblock": 8, "int8_conv3x3": 0, "int8_deconv": 2, "head": 0,
          "moments": 1},
}
# The int8 chain on the card against the CPU: the float stem conv and the
# style projection sum in another order there (cuDNN/cuBLAS against the
# CPU's), so an int8 value at a rounding boundary can flip; bound the share
# of outputs that move and the largest move (tests/test_torch_int8.py states
# the same bounds against the JAX package). Kernel against plain version on
# the card: every int8 operand and statistic is equal, so only the head's
# 1x1 sum over C, in another order, differs.
FLIP_SHARE, FLIP_MAX = 0.05, 2e-2
HEAD_TOL = 1e-5
PSNR_MIN_DB = 25.0  # the JAX package's own bar, tests/test_int8_serving.py
# training: AdaINModel's main step at the JAX package's flagship training
# config (bench.py:180-185), with the reference GAN step and the whole-block
# resblock kernels on the card
BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense, published
TRAIN_ARGS = dict(crop_size=256, dim=64, latent_dim=8, num_domains=4, batch_size=B,
                  compute_dtype="bfloat16", use_dis_content=True, d_iter=3, gan_mode="vanilla",
                  gan_step="reference", fused_resblock="auto", seed=0)
SMALL_TRAIN_ARGS = dict(crop_size=32, dim=32, latent_dim=4, num_domains=3, batch_size=2,
                        use_dis_content=True, dis_content_layers=1, dis_content_final_kernel=2,
                        compute_dtype="float32", seed=0)
# (NCHW shape, calls per main step): 2B images through the encoder's blocks
# (D fakes, G1 twice, G2: 16 calls) and G1's cycle and G2's decodes (8); 4B
# through the D fakes' and G1's first decode (8). Backward: G1 and G2 only.
RESBLOCK_FWD_SHAPES = [((2 * B, 256, 64, 64), 24), ((4 * B, 256, 64, 64), 8)]
RESBLOCK_BWD_SHAPES = [((2 * B, 256, 64, 64), 20), ((4 * B, 256, 64, 64), 4)]
FUSED_PER_STEP = {"resblock_fwd": 32, "resblock_bwd": 24}
# kernel against plain version in bf16: a conv sum in another order can round
# an h or dgrad value to the neighbouring bf16 value, which the next conv
# carries on; relative to each tensor's largest magnitude
RESBLOCK_TOL = 2e-2
# kernels 9 and 10 are also held to their plain versions at ragged shapes: odd
# batches, H x W not a multiple of the conv's 128-row M-tile, W != 64
RESBLOCK_RAGGED_SHAPES = [(3, 128, 12, 20), (1, 256, 24, 40)]
TRAIN_LOSS_TOL = 0.03  # fused against composed: the JAX package's own bar
# the small f32 step on the card against the CPU: the CPU tests' loss bound;
# params may differ by Adam steps of another sign where a decayed gradient is
# near 0: the G phases' f32 gradients carry noise of about 1 % (the cycle
# term, tests/torch_train_steps.py), and two CPU paths of the same step
# (--fused_resblock on against off) leave 1.0e-3 of the params beyond 0.1 lr
TRAIN_CPU_LOSS_TOL, TRAIN_CPU_FLIP_SHARE = 1e-4, 1e-2
# BaseModel training at TRAIN_ARGS, configs A and B: kernel 9/10 calls per
# main step by batch, as the JAX package routes them. A: the content
# encoder's four blocks at 2B images (D fakes, G1 twice, G2; backward in G1
# and G2). B adds dec_share once per decode: 4B in the D fakes and G1's
# first decode, 2B in G1's cycle and G2 (the 268-wide dec1_* blocks compose)
BASE_RESBLOCK_CALLS = {
    "A": {"resblock_fwd": {2 * B: 16}, "resblock_bwd": {2 * B: 12}},
    "B": {"resblock_fwd": {2 * B: 18, 4 * B: 2}, "resblock_bwd": {2 * B: 14, 4 * B: 1}},
}
BASE_PER_STEP = {cfg: {k: sum(v.values()) for k, v in calls.items()}
                 for cfg, calls in BASE_RESBLOCK_CALLS.items()}
# the small steps on the card against the CPU: at SMALL_TRAIN_ARGS (dim 32,
# 128-wide blocks) the routing is the full width's; AdaINModel with
# --use_dropout keeps only its encoder's blocks on kernels 9/10
SMALL_PER_STEP = {"A": BASE_PER_STEP["A"], "B": BASE_PER_STEP["B"],
                  "dropout": {"resblock_fwd": 16, "resblock_bwd": 12}}
# train_variants: AdaINModel at TRAIN_ARGS with bench.py's GAN step
# (bench.py:160-185: --gan_step fused), then each other training flag alone
# on that config. The fused step runs kernel 9 28 times per main step (G1's
# two encodes and two decodes 16, the D2 decode 4, G2 8) and kernel 10 24.
FUSED_GAN_ARGS = dict(TRAIN_ARGS, gan_step="fused")
# kernel 9/10 calls per main step by batch: 2B images through G1's encodes
# and cycle decode, the D2 decode and G2 (24; backward 20), 4B through G1's
# first decode (4; backward 4); --remat runs kernel 9 again for each block
# recomputed in G1's and G2's backward (2B 20, 4B 4)
FUSED_GAN_CALLS = {"resblock_fwd": {2 * B: 24, 4 * B: 4}, "resblock_bwd": {2 * B: 20, 4 * B: 4}}
REMAT_CALLS = {"resblock_fwd": {2 * B: 44, 4 * B: 8}, "resblock_bwd": {2 * B: 20, 4 * B: 4}}
FUSED_GAN_PER_STEP = {k: sum(v.values()) for k, v in FUSED_GAN_CALLS.items()}
REMAT_PER_STEP = {k: sum(v.values()) for k, v in REMAT_CALLS.items()}
VARIANT_FLAGS = {
    "hinge": dict(gan_mode="hinge"),
    "ragan": dict(use_ragan=True),
    "wgangp": dict(gan_mode="wgangp", lambda_gp=10.0),
    "dis_sn": dict(dis_sn=True),
    "ms_dis": dict(ms_dis=True),
    "vgg_l2": dict(vgg_loss="l2"),
    "remat": dict(remat=True),
}
# small steps against the CPU, every draw made on the card: each flag on
# AdaINModel's reference step (the multi-scale discriminator at 3 layers, 2
# scales), the fused step on AdaINModel and on BaseModel A. WGAN-GP's step
# keeps the default discriminator: with instance-normed ones its G
# gradients are too ill-conditioned in f32 for the 1 % bound on params
# (two CPU paths of that step part by more), so the double backward through
# the moments kernel is held alone, by the card tests' penalty test
REF_PER_STEP = FUSED_PER_STEP
# hinge's and WGAN's G terms are means of signed logits, which cancel to far
# below the logits themselves (hinge's small step: g_adv about -1.3e-6 at
# this init, card and CPU 4e-4 of it apart); the variant steps hold each
# loss within TRAIN_CPU_LOSS_TOL of max(|loss|, 1e-2): 1e-6 absolute below
# 1e-2
VARIANT_LOSS_FLOOR = 1e-2
SMALL_VARIANTS = {
    "fused": (AdaINModel, dict(gan_step="fused"), FUSED_GAN_PER_STEP),
    "base_A_fused": (BaseModel, dict(gan_step="fused"),
                     {"resblock_fwd": 12, "resblock_bwd": 12}),
    "hinge": (AdaINModel, dict(gan_mode="hinge"), REF_PER_STEP),
    "ragan": (AdaINModel, dict(use_ragan=True), REF_PER_STEP),
    "wgangp": (AdaINModel, dict(gan_mode="wgangp", lambda_gp=10.0), REF_PER_STEP),
    "dis_sn": (AdaINModel, dict(dis_sn=True), REF_PER_STEP),
    "ms_dis": (AdaINModel, dict(ms_dis=True, dis_n_layers=3, num_scales=2), REF_PER_STEP),
    "vgg_l2": (AdaINModel, dict(vgg_loss="l2"), REF_PER_STEP),
    "remat": (AdaINModel, dict(remat=True), {"resblock_fwd": 32 + 24, "resblock_bwd": 24}),
}


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, arg_sets, iters: int = 30) -> float:
    """Device time per call: CUDA events around ``iters`` back-to-back calls,
    rotating over ``arg_sets``. A sleep kernel queued first keeps the card
    busy while the host enqueues, so host overhead leaves no gaps."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies(make, nbytes: int):
    """Enough input sets that rotating over them does not run from L2."""
    return [make(i) for i in range(max(2, math.ceil(3 * L2_BYTES / nbytes)))]


def bound(nbytes: int, flops: int, peak: float = F32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _randn(shape, dtype, seed, scale=1.0, offset=0.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * scale + offset
    return x.to(dtype)


def _moments_case(shape, dtype: torch.dtype, what: str):
    """The moments kernel against its plain version on seeded inputs of
    ``shape``: (input sets for timing, error, tolerance, bound ms, bound by)."""
    numel = math.prod(shape)
    nbytes = numel * dtype.itemsize
    sets = copies(lambda i: (_randn(shape, dtype, i, 2.0, 0.5),), nbytes)
    x = sets[0][0]
    s, sq = kmoments.moments(x)
    ps, psq = kmoments.moments_plain(x)
    torch.cuda.synchronize()
    n = shape[2] * shape[3]
    # error of what the norms consume, sum/n and sumsq/n; tolerance: a few
    # f32 ulps of the mean magnitude, as sums run in another order
    err = max((s - ps).abs().max().item(), (sq - psq).abs().max().item()) / n
    tol = 2e-5 * max(x.float().abs().mean().item(), x.float().square().mean().item())
    assert err <= tol, f"moments {what} {tuple(shape)}: error {err} > {tol}"
    return (sets, err, tol, *bound(nbytes + 2 * shape[0] * shape[1] * 4, 3 * numel))


def check_moments(name: str, dtype: torch.dtype) -> dict:
    rows = []
    for shape, per_forward in MOMENTS_SHAPES:
        sets, err, tol, b_ms, by = _moments_case(shape, dtype, name)
        rows.append(dict(
            shape=list(shape), per_forward=per_forward, max_abs_err=err, tol=tol,
            ms=device_ms(kmoments.moments, sets),
            plain_ms=device_ms(kmoments.moments_plain, sets),
            library_ms=device_ms(lambda t: torch.var_mean(t, dim=(2, 3), unbiased=False), sets),
            bound_ms=b_ms, bound_by=by,
        ))
    return summarize("moments", name, rows, "masterthesis_tpu/ops/pallas/moments.py:80",
                     "masterthesis_tpu_torch/csrc/moments.cu",
                     "torch.var_mean(x, dim=(2, 3), unbiased=False)")


@contextlib.contextmanager
def recording_moments(calls: collections.Counter):
    """Counts the moments kernel's calls by (shape, dtype) while active, at
    ``norms.moments``, its one caller (each call launches it once on the
    card); the launch count stays the wrapper's own."""
    real = norms.moments

    def recording(x, per_sample=False):
        calls[(tuple(x.shape), x.dtype)] += 1
        return real(x, per_sample)

    norms.moments = recording
    try:
        yield calls
    finally:
        norms.moments = real


def check_moments_path(phase: str, calls: collections.Counter) -> dict:
    """The moments kernel against its plain version at every (shape, dtype)
    that one main step of ``phase`` gave it (``calls``: the launches at
    each), with check_moments' tolerance, and timed there. Returns, by dtype
    name, its launches, ms, bound ms and largest error per main step."""
    names = {dtype: name for name, dtype in DTYPES.items()}
    rows, per_step = [], {}
    for (shape, dtype), n in sorted(calls.items(), key=lambda kv: (names[kv[0][1]], kv[0][0])):
        sets, err, tol, b_ms, by = _moments_case(shape, dtype, phase)
        ms = device_ms(kmoments.moments, sets)
        del sets
        rows.append(dict(shape=list(shape), dtype=names[dtype], per_main_step=n, max_abs_err=err,
                         tol=tol, ms=ms, bound_ms=b_ms, bound_by=by))
        d = per_step.setdefault(names[dtype], dict(launches=0, ms=0.0, bound_ms=0.0,
                                                   max_abs_err=0.0))
        d["launches"] += n
        d["ms"] += n * ms
        d["bound_ms"] += n * b_ms
        d["max_abs_err"] = max(d["max_abs_err"], err)
    torch.cuda.empty_cache()
    log(dict(phase=phase, kernel="moments", shapes=rows, per_main_step=per_step))
    return per_step


def check_adain(name: str, dtype: torch.dtype) -> dict:
    rows = []
    for shape, per_forward in ADAIN_SHAPES:
        numel = math.prod(shape)
        nbytes = numel * dtype.itemsize
        bc = shape[:2]
        sets = copies(lambda i: (
            _randn(shape, dtype, 3 * i, 2.0, 0.5),
            _randn(bc, torch.float32, 3 * i + 1, 0.3),
            _randn(bc, torch.float32, 3 * i + 2, 0.3),
        ), nbytes)
        out = kadain.adain(*sets[0])
        ref = kadain.adain_plain(*sets[0])
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        # f32: O(1) outputs, statistics summed in another order; bf16: one
        # rounding step of the output either way (|d| <= 1e-2 + 1e-2 |ref|)
        if dtype == torch.float32:
            tol, ok = 1e-4, err <= 1e-4
        else:
            tol = "1e-2 + 1e-2*|ref|"
            ok = bool(((out.float() - ref.float()).abs() <= 1e-2 + 1e-2 * ref.float().abs()).all())
        assert ok, f"adain {name} {shape}: error {err} > {tol}"
        b_ms, by = bound(2 * nbytes + 2 * bc[0] * bc[1] * 4, 6 * numel)
        # the library yardstick: AdaIN is instance norm of the (1, B*C, H, W)
        # view with per-plane weight 1 + gamma and bias beta, one call
        lib_sets = [(t.view(1, -1, *shape[2:]), (1.0 + g).flatten(), bt.flatten())
                    for t, g, bt in sets]
        lib = library_adain(*lib_sets[0]).view(shape)
        torch.cuda.synchronize()
        rows.append(dict(
            shape=list(shape), per_forward=per_forward, max_abs_err=err, tol=tol,
            ms=device_ms(kadain.adain, sets),
            plain_ms=device_ms(kadain.adain_plain, sets),
            library_ms=device_ms(library_adain, lib_sets),
            library_max_abs_err=(lib.float() - ref.float()).abs().max().item(),
            bound_ms=b_ms, bound_by=by,
        ))
    return summarize("adain", name, rows, "masterthesis_tpu/ops/pallas/adain.py:80",
                     "masterthesis_tpu_torch/csrc/adain.cu", LIBRARY_ADAIN)


LIBRARY_ADAIN = "F.instance_norm(x.view(1, B*C, H, W), weight=(1+gamma).flatten(), bias=beta.flatten())"


def library_adain(x, weight, bias):
    return F.instance_norm(x, weight=weight, bias=bias, eps=norms.EPS)


def summarize(kernel, dtype_name, rows, replaces, source, library, name=None,
              per="forward at B=8, 256px, dim 64", count="per_forward") -> dict:
    """Per-kernel, per-dtype entry; times are per forward (or per main step):
    each shape's time per call times the calls a forward makes at that shape."""
    def per_forward(key):
        if any(r.get(key) is None for r in rows):
            return None
        return sum(r[key] * r[count] for r in rows)

    detail = dict(kernel=kernel, dtype=dtype_name, library=library, shapes=rows)
    log(detail)
    entry = dict(
        name=name or f"{kernel}/{dtype_name}", route="cuda", source=source, replaces=replaces,
        launches=None, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
        bound_ms=per_forward("bound_ms"), bound_by=rows[0]["bound_by"],
        library_ms=per_forward("library_ms"), per=per,
    )
    if "bf16_cudnn_ms" in rows[0]:
        entry["bf16_cudnn_ms"] = per_forward("bf16_cudnn_ms")
    return entry


# ------------------------------------------------------------ int8 kernels --


def _check_exact(x, qc, pending) -> dict:
    """The kernel's int8 operands and int32 sums against the plain version's,
    on the same input and prologue affine: equal, or the script fails."""
    xq, xq_plain = kq.quant_pad_cuda(x, qc, pending), kq.quant_pad_plain(x, qc, pending)
    torch.cuda.synchronize()
    assert torch.equal(xq, xq_plain), "int8 operands differ from the plain version's"
    unit = kq.with_unit_scale(qc)
    acc, acc_plain = kq.conv_padded_cuda(xq, unit), kq.conv_padded_plain(xq_plain, unit)
    top = acc_plain.abs().max().item()
    assert top < 2**24, "the unit-scale check needs sums that f32 holds exactly"
    assert torch.equal(acc, acc_plain), "int32 sums differ from the plain version's"
    return dict(int8_operands_equal=True, int32_sums_equal=True, max_abs_sum=top)


def _card_pending(b, c, seed, alpha):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"scale": torch.rand((b, c), generator=g, device="cuda") + 0.5,
            "shift": torch.randn((b, c), generator=g, device="cuda") * 0.3,
            "relu": True, "alpha": alpha}


def _card_weight(shape, seed, scale=0.05):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda") * scale


INT8_CONVS = {  # kind: (shapes, wrapper name, TPU kernel, statistics on the path)
    "down": (DOWN_SHAPES, "downconv", "masterthesis_tpu/ops/pallas/conv_int8.py:1303", True),
    "conv3x3": (CONV3X3_SHAPES, "conv3x3", "masterthesis_tpu/ops/pallas/conv_int8.py:187", False),
    "deconv": (DECONV_SHAPES, "deconv", "masterthesis_tpu/ops/pallas/conv_int8.py:577", True),
}


def _path_pending(kind, i, b, c):
    """The prologue the path gives the conv: down0 takes the stem's IN +
    lrelu, down1 down0's IN + relu; up0 has no prologue, up1 takes up0's
    LayerNorm + relu; BaseModel's stride-1 convs have none."""
    if kind == "conv3x3" or (kind == "deconv" and i == 0):
        return None
    return _card_pending(b, c, 200 + i, 0.01 if kind == "down" and i == 0 else 0.0)


def _zero_pad_case(shape, co, seed, dtype=torch.float32):
    """x, a stride-1 zero-padded QuantConv with bias, and a prologue."""
    x = _randn(shape, dtype, seed)
    pending = _card_pending(shape[0], shape[1], seed + 1, 0.01)
    qc = kq.quant_conv(_card_weight((co, shape[1], 3, 3), seed + 2),
                       _card_weight((co,), seed + 3, 0.1),
                       kq.prologue_plain(x, pending).abs().amax(), 1, None)
    return x, qc, pending


def _conv3x3_exact_cases(x, qc, shape, dtype=torch.float32) -> dict:
    """Kernel 4 with a prologue and statistics at the path's shape, at
    DecoderConcat's unaligned width with zero padding and at the ragged
    shape: operands, sums, y and statistics equal to the plain version's,
    and a second call equal to the first."""
    b, c = shape[:2]
    out = {}
    ushape, uco = CONV3X3_UNALIGNED
    rshape, rco = INT8_RAGGED
    for name, (t, q, p) in {"prologue_stats": (x, qc, _card_pending(b, c, 250, 0.0)),
                            f"unaligned_{ushape[1]}_zero_pad": _zero_pad_case(ushape, uco, 260,
                                                                              dtype),
                            f"ragged_{rshape}": _zero_pad_case(rshape, rco, 265, dtype)}.items():
        exact = _check_exact(t, q, p)
        got, want = kq.conv3x3(t, q, p, with_stats=True), kq.conv_plain(t, q, p, True)
        again = kq.conv3x3(t, q, p, with_stats=True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), f"conv3x3 {name}: differs"
        assert all(torch.equal(g, a) for g, a in zip(got, again)), f"conv3x3 {name}: two calls differ"
        out[name] = dict(**exact, outputs_and_stats_equal=True, bit_equal_repeat=True,
                         shape=list(t.shape), cp=q.cp, co=q.cout)
    return out


def _strided_exact_cases(kind, dtype=torch.float32) -> dict:
    """Kernel 7 at the ragged shapes (with a prologue), kernel 5 at BaseModel
    B's deconvs (without one, as on that path) and at its ragged shape, with
    statistics: operands, sums, y and statistics equal to the plain
    version's, and a second call equal to the first."""
    down = kind == "down"
    out = {}
    for i, (shape, co) in enumerate(DOWN_RAGGED if down else
                                    [(s, co) for s, co, _ in DECONV_B_SHAPES] + DECONV_RAGGED):
        b, c = shape[:2]
        x = _randn(shape, dtype, 270 + i)
        pending = _card_pending(b, c, 275 + i, 0.01) if down else None
        amax = kq.prologue_plain(x, pending).abs().amax()
        weight = _card_weight((co, c, 3, 3) if down else (c, co, 3, 3), 280 + i)
        bias = _card_weight((co,), 285 + i, 0.1)
        qc = (kq.quant_conv(weight, bias, amax, 2, "reflect") if down
              else kq.quant_deconv(weight, bias, amax))
        exact = _check_exact(x, qc, pending)
        wrapper = kq.downconv if down else kq.deconv
        got, want = wrapper(x, qc, pending, with_stats=True), kq.conv_plain(x, qc, pending, True)
        again = wrapper(x, qc, pending, with_stats=True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), f"{kind} {shape}: differs"
        assert all(torch.equal(g, a) for g, a in zip(got, again)), f"{kind} {shape}: two calls differ"
        out[f"{list(shape)} -> {co}"] = dict(**exact, outputs_and_stats_equal=True,
                                            bit_equal_repeat=True, cp=qc.cp, rows=qc.w.shape[0])
    return out


def check_int8_conv(kind: str, dtype_name: str = "f32") -> dict:
    """Kernel 7 ("down"), 4 ("conv3x3") or 5 ("deconv") at the path's shapes
    with activations (x in, y out) in ``dtype_name``, with a second call
    equal to the first; 7 also at a ragged shape, 5 also at BaseModel B's
    widths."""
    shapes, wname, replaces, stats = INT8_CONVS[kind]
    wrapper = getattr(kq, wname)
    dtype = DTYPES[dtype_name]
    esize = torch.finfo(dtype).bits // 8
    rows = []
    for i, (shape, co, per_forward) in enumerate(shapes):
        b, c, h, w = shape
        numel = math.prod(shape)
        sets = copies(lambda j: (_randn(shape, dtype, 100 + 10 * i + j),), esize * numel)
        x = sets[0][0]
        pending = _path_pending(kind, i, b, c)
        amax = kq.prologue_plain(x, pending).abs().amax()
        wshape = (c, co, 3, 3) if kind == "deconv" else (co, c, 3, 3)
        weight, bias = _card_weight(wshape, 300 + i), _card_weight((co,), 400 + i, 0.1)
        qc = (kq.quant_deconv(weight, bias, amax) if kind == "deconv"
              else kq.quant_conv(weight, bias, amax, 2 if kind == "down" else 1, "reflect"))
        exact = _check_exact(x, qc, pending)
        if kind == "conv3x3":
            exact["cases"] = _conv3x3_exact_cases(x, qc, shape, dtype)
        elif i == 0:
            exact["cases"] = _strided_exact_cases(kind, dtype)
        got = wrapper(x, qc, pending, with_stats=stats)
        again = wrapper(x, qc, pending, with_stats=stats)
        want = kq.conv_plain(x, qc, pending, stats)
        torch.cuda.synchronize()
        got, again, want = (got, again, want) if stats else ((got,), (again,), (want,))
        assert got[0].dtype == dtype, f"{kind} {shape}: y is {got[0].dtype}, not {dtype}"
        err = (got[0].float() - want[0].float()).abs().max().item()
        assert err == 0.0, f"{kind} {shape}: output differs from the plain version's by {err}"
        assert all(torch.equal(g, r) for g, r in zip(got[1:], want[1:])), f"{kind} {shape}: statistics differ"
        assert all(torch.equal(g, a) for g, a in zip(got, again)), f"{kind} {shape}: two calls differ"
        exact["bit_equal_repeat"] = True
        out_numel = got[0].numel()
        macs = b * c * co * 9 * ((h // 2) * (w // 2) if kind == "down" else h * w)
        nbytes = (esize * (numel + out_numel) + qc.w.numel() + (8 * b * co if stats else 0)
                  + (8 * b * c if pending else 0))
        b_ms, by = bound(nbytes, 2 * macs, INT8_OPS)
        wb = weight.bfloat16()
        bf_sets = [(t[0].bfloat16(),) for t in sets]
        cudnn = {"down": lambda t: F.conv2d(t, wb, None, 2, 1),
                 "conv3x3": lambda t: F.conv2d(t, wb, None, 1, 1),
                 "deconv": lambda t: F.conv_transpose2d(t, wb, None, 2, 1, 1)}[kind]
        rows.append(dict(
            shape=list(shape), co=co, per_forward=per_forward, prologue=pending is not None,
            **exact, max_abs_err=err, tol=0.0, stats=stats, stats_equal=stats or None,
            macs=macs, ms=device_ms(lambda t: wrapper(t, qc, pending, with_stats=stats), sets),
            plain_ms=device_ms(lambda t: kq.conv_plain(t, qc, pending, stats), sets, iters=5),
            bf16_cudnn_ms=device_ms(cudnn, bf_sets), library_ms=None,
            bound_ms=b_ms, bound_by=by,
        ))
    name = f"int8_{wname}" + ("" if dtype_name == "f32" else f"/{dtype_name}")
    return summarize(name, dtype_name, rows, replaces, "masterthesis_tpu_torch/csrc/int8_conv.cu",
                     None, name=name)


def _flips(out, ref) -> tuple[float, float]:
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), (diff > 1e-4).float().mean().item()


def _resblock_exact(shape, seed, dtype=torch.float32) -> dict:
    """Kernel 6 at ``shape`` against its plain version, and a second call
    against the first: both equal, or the script fails."""
    b, c = shape[:2]
    x = _randn(shape, dtype, seed)
    gamma, beta = _card_weight((b, c), seed + 1, 0.3), _card_weight((b, c), seed + 2, 0.3)
    q1 = kq.quant_conv(_card_weight((c, c, 3, 3), seed + 3), None, x.abs().amax(), 1, "reflect")
    q2 = kq.quant_conv(_card_weight((c, c, 3, 3), seed + 4), None, 4.0, 1, None)
    y = kq.resblock(x, q1, q2, gamma, beta)
    again = kq.resblock(x, q1, q2, gamma, beta)
    ref = kq.resblock_plain(x, q1, q2, gamma, beta)
    torch.cuda.synchronize()
    assert torch.equal(y, ref), f"resblock {shape}: differs from the plain version"
    assert torch.equal(y, again), f"resblock {shape}: two calls differ"
    return dict(shape=list(shape), cp=q1.cp, output_equal=True, bit_equal_repeat=True)


def check_int8_resblock(dtype_name: str = "f32") -> dict:
    """Kernel 6 at the forward's shape in ``dtype_name``, with random (1 +
    gamma, beta); also at DecoderConcat's 268 channels and at the ragged
    shape."""
    dtype = DTYPES[dtype_name]
    esize = torch.finfo(dtype).bits // 8
    rows = []
    for i, (shape, co, per_forward) in enumerate(RES_SHAPES):
        b, c, h, w = shape
        numel = math.prod(shape)
        sets = copies(lambda j: (_randn(shape, dtype, 500 + 10 * i + j),), esize * numel)
        x = sets[0][0]
        gamma, beta = _card_weight((b, c), 600, 0.3), _card_weight((b, c), 601, 0.3)
        w1, w2 = _card_weight((c, c, 3, 3), 602), _card_weight((c, c, 3, 3), 603)
        q1 = kq.quant_conv(w1, None, x.abs().amax(), 1, "reflect")
        exact1 = _check_exact(x, q1, None)
        # conv2's operands, fed the plain version's prologue affine
        h1, s1, sq1 = kq.conv_plain(x, q1, None, True)
        a1, b1 = kq.norm_affine_plain(s1, sq1, h * w, gamma, beta)
        mid = {"scale": a1, "shift": b1, "relu": True, "alpha": 0.0}
        q2 = kq.quant_conv(w2, None, kq.prologue_plain(h1, mid).abs().amax(), 1, "reflect")
        exact2 = _check_exact(h1, q2, mid)
        y = kq.resblock(x, q1, q2, gamma, beta)
        again = kq.resblock(x, q1, q2, gamma, beta)
        ref = kq.resblock_plain(x, q1, q2, gamma, beta)
        torch.cuda.synchronize()
        assert y.dtype == dtype, f"resblock {shape}: out is {y.dtype}, not {dtype}"
        err = (y.float() - ref.float()).abs().max().item()
        assert err == 0.0, f"resblock {shape}: output differs from the plain version's by {err}"
        assert torch.equal(y, again), f"resblock {shape}: two calls differ"
        cases = [_resblock_exact(CONV3X3_UNALIGNED[0], 640, dtype),
                 _resblock_exact(INT8_RAGGED[0], 650, dtype)]

        macs = 2 * b * h * w * c * co * 9
        nbytes = 2 * esize * numel + q1.w.numel() + q2.w.numel() + 8 * b * c
        b_ms, by = bound(nbytes, 2 * macs, INT8_OPS)
        w1b, w2b = w1.bfloat16(), w2.bfloat16()
        bf_sets = [(t[0].bfloat16(),) for t in sets]
        rows.append(dict(
            shape=list(shape), co=co, per_forward=per_forward,
            conv1=exact1, conv2=exact2, max_abs_err=err, tol=0.0, bit_equal_repeat=True,
            cases=cases, macs=macs,
            ms=device_ms(lambda t: kq.resblock(t, q1, q2, gamma, beta), sets),
            plain_ms=device_ms(lambda t: kq.resblock_plain(t, q1, q2, gamma, beta), sets, iters=5),
            bf16_cudnn_ms=device_ms(
                lambda t: F.conv2d(F.conv2d(t, w1b, None, 1, 1), w2b, None, 1, 1), bf_sets),
            library_ms=None, bound_ms=b_ms, bound_by=by,
            cuda_launches_per_call=7,
        ))
    name = "int8_resblock" + ("" if dtype_name == "f32" else f"/{dtype_name}")
    return summarize("int8_resblock", dtype_name, rows,
                     "masterthesis_tpu/ops/pallas/conv_int8.py:989",
                     "masterthesis_tpu_torch/csrc/int8_conv.cu", None, name=name)


def _head_launch(*args, **kwargs):
    """One call of kernel 8's wrapper, which must launch it exactly once."""
    before = khead.head.launches
    y = khead.head(*args, **kwargs)
    assert khead.head.launches == before + 1, "head: not one launch per call"
    return y


def check_head(dtype_name: str = "f32") -> dict:
    """Kernel 8 at the serving paths' shapes in ``dtype_name``, one launch
    per call: within 1e-5 of its plain version in f32, within
    ``khead.BF16_TOL`` (two bf16 steps of an output in [-1, 1], from sums in
    another order) in bf16; each shape timed beside its bound
    (``bound_share``: bound ms over ms). Then at HEAD_RAGGED, where outputs
    leave [-1, 1] (no tanh), within two bf16 steps of each output."""
    dtype = DTYPES[dtype_name]
    esize = torch.finfo(dtype).bits // 8
    tol = HEAD_TOL if dtype_name == "f32" else khead.BF16_TOL
    rows = []
    for i, (shape, co, per_forward, route) in enumerate(HEAD_SHAPES[dtype_name]):
        b, c, h, w = shape
        numel = math.prod(shape)
        sets = copies(lambda j: (_randn(shape, dtype, 700 + 10 * i + j),), esize * numel)
        pending = _card_pending(b, c, 800 + i, 0.0)
        weight = _card_weight((co, c), 801 + i, 0.1)
        y = _head_launch(sets[0][0], pending, weight)
        ref = khead.head_plain(sets[0][0], pending, weight)
        torch.cuda.synchronize()
        assert y.dtype == dtype, f"head {shape}: out is {y.dtype}, not {dtype}"
        diff = (y.float() - ref.float()).abs()
        err, share = diff.max().item(), (diff > 0).float().mean().item()
        del y, ref, diff
        assert err <= tol, f"head {shape}: error {err} > {tol}"
        macs = b * h * w * c * co
        b_ms, by = bound(esize * (numel + b * co * h * w) + 8 * b * c + 4 * co * c, 2 * macs)
        wb = weight.bfloat16()[:, :, None, None]
        bf_sets = [(t[0].bfloat16(),) for t in sets]
        ms = device_ms(lambda t: khead.head(t, pending, weight), sets)
        rows.append(dict(
            shape=list(shape), co=co, route=route, per_forward=per_forward, max_abs_err=err,
            tol=tol, share_differing=share, macs=macs, ms=ms,
            plain_ms=device_ms(lambda t: khead.head_plain(t, pending, weight), sets, iters=10),
            # context only: a 1x1 conv alone (no LN affine, relu or tanh) on bf16
            bf16_cudnn_ms=device_ms(lambda t: torch.tanh(F.conv2d(t, wb)), bf_sets),
            library_ms=None, bound_ms=b_ms, bound_by=by, bound_share=b_ms / ms,
        ))
        del sets, bf_sets
        torch.cuda.empty_cache()
    ragged = []
    for i, (shape, co) in enumerate(HEAD_RAGGED):
        b, c = shape[:2]
        x = _randn(shape, dtype, 760 + i)
        pending = _card_pending(b, c, 770 + i, 0.2)
        weight, bias = _card_weight((co, c), 780 + i, 0.2), _card_weight((co,), 790 + i, 0.1)
        y = _head_launch(x, pending, weight, bias, None)
        ref = khead.head_plain(x, pending, weight, bias, None).float()
        torch.cuda.synchronize()
        err = (y.float() - ref).abs().max().item()
        # f32: sums in another order; bf16: two bf16 steps of each output,
        # 2^-7 in [-1, 1] and 2^-6 |y| above it
        bad = (y.float() - ref).abs() > (HEAD_TOL if dtype_name == "f32" else
                                         khead.BF16_TOL * (1 + 2 * ref.abs()))
        assert not bad.any().item(), f"head {shape} ({dtype_name}): error {err}"
        ragged.append(dict(shape=list(shape), co=co, bias=True, alpha=0.2, act=None,
                           max_abs_err=err, max_abs_out=ref.abs().max().item()))
    log(dict(phase="head_ragged", dtype=dtype_name, cases=ragged))
    return summarize("head", dtype_name, rows, "masterthesis_tpu/ops/pallas/conv_int8.py:1429",
                     "masterthesis_tpu_torch/csrc/head.cu", None,
                     name="head" + ("" if dtype_name == "f32" else f"/{dtype_name}"))


# ------------------------------------------------------ training resblock --


def _resblock_set(shape, seed):
    b, c, h, w = shape
    return (_randn(shape, torch.bfloat16, seed), _card_weight((c, c, 3, 3), seed + 1, 0.03),
            _card_weight((c, c, 3, 3), seed + 2, 0.03), _card_weight((b, c), seed + 3, 0.3),
            _card_weight((b, c), seed + 4, 0.3), _randn(shape, torch.bfloat16, seed + 5))


def composed_block(x, w1, w2, gamma, beta):
    """The port's composed path for the same block, as AdaINResnetBlock runs
    it with ``--fused_resblock off``: reflect pad and cuDNN bf16 convs, the
    AdaIN kernel, torch relu and residual."""
    h = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w1.to(x.dtype))
    h = F.relu(norms.adain(h, gamma, beta))
    h = F.conv2d(F.pad(h, (1, 1, 1, 1), mode="reflect"), w2.to(x.dtype))
    return x + norms.adain(h, gamma, beta)


def _composed_fwd_bwd(x, w1, w2, gamma, beta, g):
    leaves = [t.detach().requires_grad_() for t in (x, w1, w2, gamma, beta)]
    return torch.autograd.grad(composed_block(*leaves), leaves, g)


def _rel_err(got, want) -> float:
    """Largest error over the tensors, each relative to its largest |value|."""
    return max((a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-12)
               for a, b in zip(got, want))


def check_resblock(kind: str) -> dict:
    """Kernel 9 (``kind`` "fwd") or 10 ("bwd") at the main step's shapes, bf16,
    with random (gamma, beta) as in an AdaIN block."""
    fwd = kind == "fwd"
    rows = []
    for i, (shape, per_step) in enumerate(RESBLOCK_FWD_SHAPES if fwd else RESBLOCK_BWD_SHAPES):
        b, c, h, w = shape
        numel = math.prod(shape)
        sets = [_resblock_set(shape, 900 + 10 * i + j)
                for j in range(max(2, math.ceil(3 * L2_BYTES / (numel * 2 * (2 if fwd else 4)))))]
        # the backward's inputs: each set with its forward's residuals
        sets = [s + tuple(krb.resblock_fwd(*s[:5])[1:]) for s in sets]
        x, w1, w2, gamma, beta, g, h1, h2, stats = sets[0]
        if fwd:
            got = krb.resblock_fwd(x, w1, w2, gamma, beta)
            ref = krb.resblock_fwd_plain(x, w1, w2, gamma, beta)
        else:
            got = krb.resblock_bwd(x, h1, h2, g, stats, w1, w2, gamma, beta)
            ref = krb.resblock_bwd_plain(x, h1, h2, g, stats, w1, w2, gamma, beta)
        again = (krb.resblock_fwd(x, w1, w2, gamma, beta) if fwd
                 else krb.resblock_bwd(x, h1, h2, g, stats, w1, w2, gamma, beta))
        torch.cuda.synchronize()
        err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
        rel = _rel_err(got, ref)
        assert rel <= RESBLOCK_TOL, f"resblock {kind} {shape}: relative error {rel} > {RESBLOCK_TOL}"
        repeats = all(torch.equal(a, r) for a, r in zip(got, again))
        assert repeats, f"resblock {kind} {shape}: two calls differ"
        conv_flops = 2 * b * h * w * 9 * c * c
        wbytes, sbytes = 9 * c * c * 4, b * c * 4
        if fwd:  # x, w1, w2, gamma, beta in; out, h1, h2, stats out
            flops, nbytes = 2 * conv_flops, 2 * numel * 4 + 2 * wbytes + 2 * sbytes + 4 * sbytes
            ms = device_ms(lambda *t: krb.resblock_fwd(*t[:5]), sets)
            plain_ms = device_ms(lambda *t: krb.resblock_fwd_plain(*t[:5]), sets, iters=3)
            library_ms = device_ms(lambda *t: composed_block(*t[:5]), sets)
            extra = {}
        else:  # x, h1, h2, g, stats, w1, w2, gamma, beta in; dx, dw1, dw2, dgamma, dbeta out
            flops = 4 * conv_flops
            nbytes = 2 * numel * 5 + 4 * sbytes + 4 * wbytes + 4 * sbytes
            args = lambda t: (t[0], t[6], t[7], t[5], t[8], t[1], t[2], t[3], t[4])  # noqa: E731
            ms = device_ms(lambda *t: krb.resblock_bwd(*args(t)), sets)
            plain_ms = device_ms(lambda *t: krb.resblock_bwd_plain(*args(t)), sets, iters=3)
            both = device_ms(lambda *t: _composed_fwd_bwd(*t[:6]), sets)
            extra = dict(library_fwd_bwd_ms=both)
            library_ms = both - device_ms(lambda *t: composed_block(*t[:5]), sets)
        b_ms, by = bound(nbytes, flops, BF16_FLOPS)
        rows.append(dict(
            shape=list(shape), per_step=per_step, max_abs_err=err, max_rel_err=rel,
            tol=dict(relative=RESBLOCK_TOL), flops=flops, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=b_ms, bound_by=by, bit_equal_repeat=repeats,
            cuda_launches_per_call=7 if fwd else 12, **extra,
        ))
        del sets
        torch.cuda.empty_cache()
    ragged = []
    for i, shape in enumerate(RESBLOCK_RAGGED_SHAPES):
        x, w1, w2, gamma, beta, g = _resblock_set(shape, 950 + i)
        _, h1, h2, stats = krb.resblock_fwd(x, w1, w2, gamma, beta)
        runs = [krb.resblock_fwd(x, w1, w2, gamma, beta) if fwd
                else krb.resblock_bwd(x, h1, h2, g, stats, w1, w2, gamma, beta) for _ in range(2)]
        ref = (krb.resblock_fwd_plain(x, w1, w2, gamma, beta) if fwd
               else krb.resblock_bwd_plain(x, h1, h2, g, stats, w1, w2, gamma, beta))
        torch.cuda.synchronize()
        rel = _rel_err(runs[0], ref)
        repeats = all(torch.equal(a, r) for a, r in zip(*runs))
        ragged.append(dict(shape=list(shape), max_rel_err=rel, bit_equal_repeat=repeats))
        assert rel <= RESBLOCK_TOL, f"resblock {kind} {shape}: relative error {rel} > {RESBLOCK_TOL}"
        assert repeats, f"resblock {kind} {shape}: two calls differ"
    log(dict(phase="resblock_ragged", kernel=f"resblock_{kind}", tol=dict(relative=RESBLOCK_TOL),
             shapes=ragged))
    name = f"resblock_{kind}"
    entry = summarize(name, "bf16", rows,
                     "masterthesis_tpu/ops/pallas/resblock_bf16.py:" + ("309" if fwd else "568"),
                     "masterthesis_tpu_torch/csrc/resblock_bf16.cu",
                     "the port's composed block (--fused_resblock off): cuDNN bf16 convs, "
                     "the AdaIN kernel, torch elementwise" + ("" if fwd else "; autograd"),
                     name=name, per="main step at batch 8 per side, 256px, dim 64, bf16",
                     count="per_step")
    entry["ms_per_call"] = {r["shape"][0]: r["ms"] for r in rows}
    return entry


def resblock_breakdown() -> list:
    """Device ms per launch of kernels 9 and 10 at the main step's (16, 256,
    64, 64) bf16, each beside its own bound (bytes: each input read once,
    each output written once; operations: the bf16 MACs), on two rotating
    sets of buffers that together exceed L2."""
    b, c, h, w = RESBLOCK_FWD_SHAPES[0][0]
    dt = torch.bfloat16
    run = krb._Launcher(dt, torch.device("cuda"))
    act, padded, wide = (b * hh * ww * c * 2 for hh, ww in ((h, w), (h + 2, w + 2),
                                                          (h + 4, w + 4)))
    stat, wbytes = b * c * 4, 9 * c * c * 2
    conv_flops = 2 * b * h * w * 9 * c * c
    dgrad_flops = 2 * b * (h + 2) * (w + 2) * 9 * c * c

    def buffers(seed):
        x, w1, w2, gamma, beta, g = _resblock_set((b, c, h, w), seed)
        e = lambda *shape: torch.empty(shape, device="cuda", dtype=dt)  # noqa: E731
        s = dict(x=x, g=g, gamma=gamma.float(), beta=beta.float(), t1=krb._taps(w1, dt),
                 t2=krb._taps_flipped(w2, dt), pad=e(b, h + 2, w + 2, c), wide=e(b, h + 4, w + 4, c),
                 dh=e(b, h + 4, w + 4, c), dp=e(b, h + 2, w + 2, c), h1=e(b, h, w, c),
                 gh=e(b, h, w, c), out=torch.empty_like(x),
                 dw=torch.empty((c, c, 3, 3), device="cuda"),
                 **{k: torch.empty((b, c), device="cuda") for k in ("m", "r", "s1", "s2")})
        for step in steps:  # every buffer holds finite values before the timing
            step[3](s)
        return s

    steps = [  # (kernel, launch, bound (bytes, flops), fn)
        (9, "pad (NCHW x in)", (act + padded, 0),
         lambda s: run("pad", s["x"], s["pad"], None, None, None, None, 0, b, h, w, c, 1, 0, 1)),
        (9, "conv (wgmma)", (padded + wbytes + act, conv_flops),
         lambda s: run("conv", s["pad"], s["t1"], s["h1"], b, h + 2, w + 2, c, c)),
        (9, "stats", (act + 2 * stat, 0),
         lambda s: run("stats", s["h1"], s["m"], s["r"], b, h * w, c, 1e-5)),
        (9, "pad (norm + relu)", (act + padded + 4 * stat, 0),
         lambda s: run("pad", s["h1"], s["pad"], s["m"], s["r"], s["gamma"], s["beta"], 1, b, h, w,
                       c, 1, 0, 0)),
        (9, "residual (NCHW out)", (3 * act + 4 * stat, 0),
         lambda s: run("residual", s["x"], s["h1"], s["m"], s["r"], s["gamma"], s["beta"],
                       s["out"], b, h * w, c)),
        (10, "g NCHW -> NHWC", (2 * act, 0),
         lambda s: run("nhwc", s["g"], s["gh"], b, c, h, w)),
        (10, "norm_bwd sums (g)", (2 * act + 4 * stat, 0),
         lambda s: run("norm_bwd", s["gh"], 0, 1, s["h1"], s["m"], s["r"], s["gamma"], s["beta"],
                       0, s["s1"], s["s2"], None, b, h, w, c)),
        (10, "norm_bwd apply (g)", (2 * act + wide + 6 * stat, 0),
         lambda s: run("norm_bwd", s["gh"], 0, 1, s["h1"], s["m"], s["r"], s["gamma"], s["beta"],
                       0, s["s1"], s["s2"], s["dh"], b, h, w, c)),
        (10, "pad (norm + relu, ringed)", (act + wide + 4 * stat, 0),
         lambda s: run("pad", s["h1"], s["wide"], s["m"], s["r"], s["gamma"], s["beta"], 1, b, h,
                       w, c, 1, 1, 0)),
        (10, "wgrad (wgmma, cluster)", (2 * wide + 9 * c * c * 4, conv_flops),
         lambda s: run("wgrad", s["wide"], s["dh"], s["dw"], b, h, w, c, c)),
        (10, "conv (dgrad, wgmma)", (wide + wbytes + padded, dgrad_flops),
         lambda s: run("conv", s["dh"], s["t2"], s["dp"], b, h + 4, w + 4, c, c)),
        (10, "norm_bwd sums (folded)", (padded + act + 4 * stat, 0),
         lambda s: run("norm_bwd", s["dp"], 1, 1, s["h1"], s["m"], s["r"], s["gamma"], s["beta"],
                       1, s["s1"], s["s2"], None, b, h, w, c)),
        (10, "norm_bwd apply (folded)", (padded + act + wide + 6 * stat, 0),
         lambda s: run("norm_bwd", s["dp"], 1, 1, s["h1"], s["m"], s["r"], s["gamma"], s["beta"],
                       1, s["s1"], s["s2"], s["dh"], b, h, w, c)),
        (10, "pad (NCHW x in, ringed)", (act + wide, 0),
         lambda s: run("pad", s["x"], s["wide"], None, None, None, None, 0, b, h, w, c, 1, 1, 1)),
        (10, "dx (NCHW out)", (act + padded + act, 0),
         lambda s: run("dx", s["g"], s["dp"], s["out"], b, h, w, c, 1)),
    ]
    sets = [buffers(970 + i) for i in range(2)]
    rows = []
    for kernel, name, (nbytes, flops), fn in steps:
        b_ms, by = bound(nbytes, flops, BF16_FLOPS)
        ms = device_ms(fn, [(s,) for s in sets])
        rows.append(dict(kernel=kernel, launch=name, ms=ms, bound_ms=b_ms, bound_by=by,
                         over_bound=ms / b_ms))
    per = {k: sum(r["ms"] * (2 if r["launch"].startswith(("conv", "stats", "wgrad")) else 1)
                  for r in rows if r["kernel"] == k) for k in (9, 10)}
    log(dict(phase="resblock_breakdown", shape=[b, c, h, w], dtype="bf16",
             wgrad_splits=krb.wgrad_splits(b, c, h, w), launches=rows,
             sum_per_call_ms={"resblock_fwd": per[9], "resblock_bwd": per[10]},
             note="conv, stats and wgrad run twice per call; the others once"))
    del sets
    torch.cuda.empty_cache()
    return rows


def _launch_ms(plans, iters: int = 20) -> list:
    """For each (fn, launches per call, sets) of ``plans``: the device ms of
    each CUDA launch of one ``fn`` call, by its place in the call, over
    ``iters`` calls rotating over ``sets``, and the kernels' names.
    torch.profiler's kernel records, all plans in one session; the records
    are assigned by their order, so a session that lost a record (the
    profiler drops one now and then) is run again, at most three times."""
    for fn, _, sets in plans:
        for s in sets[:2]:
            fn(*s)
    torch.cuda.synchronize()
    total = sum(n for _, n, _ in plans) * iters
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fn, _, sets in plans:
                for i in range(iters):
                    fn(*sets[i % len(sets)])
                torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                         key=lambda e: e.time_range.start)
        if len(kernels) == total:
            break
        log(dict(phase="profiler", recorded=len(kernels), expected=total, note="profiled again"))
    assert len(kernels) == total, f"{len(kernels)} launches recorded, expected {total}"
    out, first = [], 0
    for _, n, _ in plans:
        ks = kernels[first:first + n * iters]
        first += n * iters
        out.append(([sum(ks[c * n + p].time_range.elapsed_us() for c in range(iters)) / iters / 1e3
                     for p in range(n)], [ks[p].name[:80] for p in range(n)]))
    return out


def int8_breakdown() -> dict:
    """Device ms per launch of kernel 6 (``int8_resblock``) and kernel 4
    (``int8_conv3x3``, without and with statistics) at (8, 256, 64, 64) f32
    -> 256 and at DecoderConcat's (8, 268, 64, 64) -> 268, whose conv runs
    the 256-wide N tile and a 12-row tail tile as two launches; and of
    kernels 7 (``int8_downconv``) and 5 (``int8_deconv``), with their path's
    prologue and statistics, at the four shapes of the AdaINModel int8
    forward and at DecoderConcat's two deconvs (276 -> 138, 146 -> 73). Each
    launch beside its own bound (bytes: each input read once, each output
    written once, over 3.35 TB/s; operations: 2 x the int8 MACs over 1,979
    TOP/s), on rotating inputs that exceed L2."""
    cases = [_int8_breakdown_plans(CONV3X3_SHAPES[0][0], "reflect"),
             _int8_breakdown_plans(CONV3X3_UNALIGNED[0], None)]
    cases += [_strided_breakdown_plans(kind, i, shape, co, _path_pending(kind, i, *shape[:2]))
              for kind, shapes in (("down", DOWN_SHAPES), ("deconv", DECONV_SHAPES))
              for i, (shape, co, _) in enumerate(shapes)]
    # DecoderConcat concatenates z before each deconv: no prologue there
    cases += [_strided_breakdown_plans("deconv", 2 + i, shape, co, None)
              for i, (shape, co, _) in enumerate(DECONV_B_SHAPES)]
    timed = iter(_launch_ms([(fn, len(steps), case["sets"]) for case in cases
                             for fn, steps in case["plans"].values()]))
    out = {}
    for case in cases:
        res = {}
        for name, (fn, steps) in case["plans"].items():
            ms, names = next(timed)
            rows = []
            for (launch, (nbytes, ops)), t, kname in zip(steps, ms, names):
                b_ms, by = bound(nbytes, ops, INT8_OPS)
                rows.append(dict(launch=launch, kernel=kname, ms=t, bound_ms=b_ms, bound_by=by,
                                 over_bound=t / b_ms))
            res[name] = dict(launches=rows, sum_ms=sum(ms), call_ms=device_ms(fn, case["sets"]),
                             sum_bound_ms=sum(r["bound_ms"] for r in rows))
        shape = case["shape"]
        log(dict(phase="int8_breakdown", shape=list(shape), co=case["co"], cp=case["cp"],
                 dtype="f32", stat_tiles=case["tiles"], **res))
        out[(case["kind"], tuple(shape))] = res
    del cases
    torch.cuda.empty_cache()
    return out


def _strided_breakdown_plans(kind, i, shape, co, pending) -> dict:
    """Kernel 7 (``kind`` "down") or 5 ("deconv") at ``shape`` -> ``co``
    channels with the prologue ``pending`` and statistics: its launches in
    order, each with the (bytes, operations) it must move and do, and the
    rotating input sets."""
    b, c, h, w = shape
    numel = math.prod(shape)
    sets = copies(lambda j: (_randn(shape, torch.float32, 1000 + 10 * i + j),), 4 * numel)
    x = sets[0][0]
    amax = kq.prologue_plain(x, pending).abs().amax()
    down = kind == "down"
    weight = _card_weight((co, c, 3, 3) if down else (c, co, 3, 3), 1020 + i)
    bias = _card_weight((co,), 1030 + i, 0.1)
    qc = kq.quant_conv(weight, bias, amax, 2, "reflect") if down else kq.quant_deconv(weight, bias, amax)
    hp, wp = h + qc.pad[0] + qc.pad[1], w + qc.pad[2] + qc.pad[3]
    r, taps = qc.w.shape[:2]
    pad = b * hp * wp * qc.cp
    out_bytes = 4 * b * co * (h * w // 4 if down else 4 * h * w)
    macs = b * c * co * 9 * (h // 2) * (w // 2) if down else b * c * co * 9 * h * w
    tiles, _ = kq.conv_tiling(qc, hp, wp)
    convs = [(f"conv (N {n})", (pad + n * taps * qc.cp + out_bytes * n // r + 2 * b * tiles * n * 8,
                                2 * macs * n // r)) for n in kq.conv_launches(qc)]
    prologue = 8 * b * c if pending is not None else 0
    wrapper = kq.downconv if down else kq.deconv
    plans = {f"int8_{'downconv' if down else 'deconv'}": (
        lambda t: wrapper(t, qc, pending, with_stats=True), [
            (f"quant_pad (x NCHW{', affine + relu' if pending else ''})",
             (4 * numel + pad + prologue, 0)),
            *convs, ("stats", (2 * b * tiles * r * 8 + 2 * r * 4 + 2 * b * co * 4, 0))])}
    return dict(kind=kind, shape=shape, co=co, cp=qc.cp, tiles=tiles, sets=sets, plans=plans)


def _int8_breakdown_plans(shape, padding) -> dict:
    """Kernels 6 and 4 at ``shape`` -> as many channels: for each wrapper
    call its launches in order, each with the (bytes, operations) it must
    move and do, and the rotating input sets."""
    b, c, h, w = shape
    numel = math.prod(shape)
    sets = copies(lambda j: (_randn(shape, torch.float32, 980 + j),), 4 * numel)
    x = sets[0][0]
    gamma, beta = _card_weight((b, c), 990, 0.3), _card_weight((b, c), 991, 0.3)
    q1 = kq.quant_conv(_card_weight((c, c, 3, 3), 992), None, x.abs().amax(), 1, padding)
    q2 = kq.quant_conv(_card_weight((c, c, 3, 3), 993), None, 4.0, 1, padding)
    pending = _card_pending(b, c, 994, 0.0)
    act, pad = 4 * numel, b * (h + 2) * (w + 2) * q1.cp  # f32 activation, padded int8 operand
    stat = b * c * 4
    # per-image int64 partials of the sums and the squares, one row per M tile
    tiles, _ = kq.conv_tiling(q1, h + 2, w + 2)
    partials = 2 * b * tiles * c * 8
    # the conv's launches, as the library splits the N tiles
    widths = kq.conv_launches(q1)
    convs = [(f" (N {n})" if len(widths) > 1 else "",
              (pad + n * 9 * q1.cp + b * h * w * n * 4, 2 * b * h * w * n * c * 9))
             for n in widths]

    def conv_steps(k):
        return [(f"conv{k}{n}", work) for n, work in convs]

    qpad = (act + pad, 0)
    stats_affine = (partials + 2 * c * 4 + 2 * stat + 4 * stat, 0)  # + gamma, beta in; a, b out
    plans = {
        "int8_resblock": (lambda t: kq.resblock(t, q1, q2, gamma, beta), [
            ("quant_pad (x NCHW)", qpad), *conv_steps(1), ("stats1 + affine", stats_affine),
            ("quant_pad (h1, affine + relu)", (act + pad + 2 * stat, 0)), *conv_steps(2),
            ("stats2 + affine", stats_affine), ("residual (NCHW out)", (3 * act + 2 * stat, 0))]),
        "int8_conv3x3": (lambda t: kq.conv3x3(t, q1), [("quant_pad (x NCHW)", qpad),
                                                       *conv_steps("")]),
        "int8_conv3x3 + stats": (lambda t: kq.conv3x3(t, q1, pending, with_stats=True), [
            ("quant_pad (x NCHW, affine + relu)", (act + pad + 2 * stat, 0)), *conv_steps(""),
            ("stats", (partials + 2 * c * 4 + 2 * stat, 0))]),
    }
    return dict(kind="conv3x3", shape=shape, co=c, cp=q1.cp, tiles=tiles, sets=sets, plans=plans)


PLAIN = [
    (kmoments, "moments", kmoments.moments_plain), (kadain, "adain", kadain.adain_plain),
    (kq, "downconv", kq.conv_plain), (kq, "conv3x3", kq.conv_plain), (kq, "deconv", kq.conv_plain),
    (kq, "resblock", kq.resblock_plain), (khead, "head", khead.head_plain),
]


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version (for comparison only)."""
    saved = [getattr(module, name) for module, name, _ in PLAIN]
    for module, name, plain in PLAIN:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(PLAIN, saved):
            setattr(module, name, fn)


def counts():
    return kmoments.moments.launches, kadain.adain.launches


def int8_counts() -> dict:
    return {"int8_downconv": kq.downconv.launches, "int8_resblock": kq.resblock.launches,
            "int8_conv3x3": kq.conv3x3.launches, "int8_deconv": kq.deconv.launches,
            "head": khead.head.launches, "moments": kmoments.moments.launches}


def zero_counts() -> None:
    for module, name, _ in PLAIN:
        getattr(module, name).launches = 0


def request_inputs(args, seed):
    rng = np.random.default_rng(seed)
    size, k = args["crop_size"], args["num_domains"]
    b = args["batch_size"]
    host = dict(
        img=rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
        ref=rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
        z=rng.standard_normal((b, args["latent_dim"])).astype(np.float32),
        c=np.eye(k, dtype=np.float32)[rng.integers(0, k, b)],
    )
    return host, {k_: torch.from_numpy(v).cuda() for k_, v in host.items()}


def compute_dtype(dtype_name: str) -> str:
    return {"f32": "float32", "bf16": "bfloat16"}[dtype_name]


def check_image(out, shape, what):
    assert tuple(out.shape) == shape, f"{what}: shape {tuple(out.shape)} != {shape}"
    assert torch.isfinite(out).all(), f"{what}: non-finite output"
    lo, hi = out.min().item(), out.max().item()
    assert -1.0 <= lo and hi <= 1.0, f"{what}: output outside [-1, 1]: [{lo}, {hi}]"


def check_small_against_cpu(dtype_name: str, model_cls=AdaINModel, flags=None) -> None:
    args = default_test_args(compute_dtype=compute_dtype(dtype_name), **(flags or {}), **SMALL_ARGS)
    host, dev = request_inputs(SMALL_ARGS, seed=7)
    on_card, _, _ = model_cls(args).forward_random(dev["img"], dev["z"], dev["c"])
    on_cpu, _, _ = model_cls(args, device="cpu").forward_random(host["img"], host["z"], host["c"])
    err = (on_card.float().cpu() - on_cpu.float()).abs().max().item()
    log(dict(phase="card_vs_cpu", model=model_cls.__name__, flags=flags or {}, dtype=dtype_name,
             shape=list(on_cpu.shape), max_abs_err=err, tol=CPU_TOL[dtype_name]))
    assert err <= CPU_TOL[dtype_name], f"card vs CPU {dtype_name}: {err}"


def calibration_batches(args, seeds=(11, 12)):
    """Seeded B=8 calibration batches: (images, targets, styles) on the card."""
    batches = [request_inputs(args, seed)[1] for seed in seeds]
    return [b["img"] for b in batches], [b["c"] for b in batches], [b["z"] for b in batches]


def check_small_int8_against_cpu(model_cls=AdaINModel, flags=None) -> None:
    """One amax tree, calibrated on the CPU, on both devices."""
    args = default_test_args(**(flags or {}), **SMALL_ARGS)
    host, dev = request_inputs(SMALL_ARGS, seed=7)
    on_cpu = model_cls(args, device="cpu")
    quant = on_cpu.calibrate_int8([host["img"]], [host["c"]], [host["z"]])
    on_card = model_cls(args)
    on_card.load_int8(quant)
    out, _, _ = on_card.forward_random(dev["img"], dev["z"], dev["c"])
    ref, _, _ = on_cpu.forward_random(host["img"], host["z"], host["c"])
    err, share = _flips(out.cpu(), ref)
    log(dict(phase="card_vs_cpu", model=model_cls.__name__, flags=flags or {}, dtype="int8",
             shape=list(ref.shape), max_abs_err=err,
             share_differing=share, tol=dict(max=FLIP_MAX, share=FLIP_SHARE)))
    assert err <= FLIP_MAX and share <= FLIP_SHARE, f"int8 card vs CPU: {err}, {share}"


def int8_serve(card: str, model_cls=AdaINModel, flags=None, per_forward=INT8_PER_FORWARD,
               phase="int8_serve", reps=3) -> dict:
    """An int8 main path: calibrate, then serve the ``serve`` requests in
    turns with the float f32 model of the same weights. Returns the int8
    kernels' launches over the int8 forwards."""
    args = default_test_args(compute_dtype="float32", **(flags or {}), **ARGS)
    model_f, model_q = model_cls(args), model_cls(args)  # the same seeded weights
    _, dev = request_inputs(ARGS, seed=1)
    shape = (B, ARGS["crop_size"], ARGS["crop_size"], 3)
    t0 = time.perf_counter()
    quant = model_q.calibrate_int8(*calibration_batches(ARGS))
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0

    zero_counts()
    launched = dict.fromkeys(per_forward, 0)

    def checked(fn, *a, **kw):
        before = int8_counts()
        out = fn(*a, **kw)
        delta = {k: v - before[k] for k, v in int8_counts().items()}
        assert delta == per_forward, f"{phase}: int8 launches per forward {delta}"
        for k, v in delta.items():
            launched[k] += v
        return out

    def int8_request():
        return checked(model_q.forward_random, dev["img"], dev["z"], dev["c"])

    def float_request():
        return model_f.forward_random(dev["img"], dev["z"], dev["c"])

    int8_request()  # warm-up: quantizes the weights, cuDNN picks its algorithms
    float_request()
    secs = {"int8": [], "float": []}
    outs = {}
    for kind in ("float", "int8", "int8", "float"):
        for _ in range(reps):
            out, seconds, mem = int8_request() if kind == "int8" else float_request()
            secs[kind].append(seconds)
            outs[kind] = out
    gen = torch.Generator(device="cuda").manual_seed(2)
    ref_out, ref_s, _ = checked(model_q.forward_reference, dev["img"], dev["ref"], dev["c"],
                                generator=gen)
    with plain_kernels():
        plain_out, plain_s, _ = model_q.forward_random(dev["img"], dev["z"], dev["c"])

    for what, out in (("int8", outs["int8"]), ("float", outs["float"]), ("plain", plain_out)):
        check_image(out, shape, f"{phase} forward_random {what}")
    check_image(ref_out, shape, f"{phase} forward_reference")
    mse = (outs["int8"] - outs["float"]).square().mean().item()
    psnr = 10 * math.log10(4.0 / max(mse, 1e-12))
    assert psnr > PSNR_MIN_DB, f"{phase}: int8 vs float PSNR {psnr} dB"
    err, share = _flips(outs["int8"], plain_out)
    assert err <= HEAD_TOL, f"{phase}: int8 kernels vs plain: max {err}, share {share}"
    log(dict(
        phase=phase, model=model_cls.__name__, flags=flags or {}, card=card, batch=B,
        requests=len(secs["int8"]) + 2,
        img_per_s=B * len(secs["int8"]) / sum(secs["int8"]),
        img_per_s_float_f32=B * len(secs["float"]) / sum(secs["float"]),
        request_s=secs["int8"], request_s_float_f32=secs["float"],
        reference_request_s=ref_s, plain_request_s=plain_s, calibrate_s=calibrate_s,
        calibration_batches=2, amax_leaves={k: len(v) for k, v in quant.items()},
        memory_reserved_gb=mem, psnr_vs_float_db=psnr, psnr_min_db=PSNR_MIN_DB,
        max_abs_err_vs_plain=err, share_differing_vs_plain=share,
        tol=HEAD_TOL, launches=launched, per_forward=per_forward,
    ))
    return launched


def serve(dtype_name: str, card: str, model_cls=AdaINModel, flags=None,
          per_forward=(MOMENTS_PER_FORWARD, ADAIN_PER_FORWARD), phase="serve",
          reps=3) -> tuple[int, int]:
    """A float main path in one dtype; returns its (moments, adain) launch
    counts."""
    args = default_test_args(compute_dtype=compute_dtype(dtype_name), **(flags or {}), **ARGS)
    model = model_cls(args)
    _, dev = request_inputs(ARGS, seed=1)
    shape = (B, ARGS["crop_size"], ARGS["crop_size"], 3)

    def kernel_request():
        before = counts()
        out, seconds, mem = model.forward_random(dev["img"], dev["z"], dev["c"])
        after = counts()
        delta = (after[0] - before[0], after[1] - before[1])
        assert delta == per_forward, f"{phase}: launches per forward {delta}"
        return out, seconds, mem

    def plain_request():
        with plain_kernels():
            return model.forward_random(dev["img"], dev["z"], dev["c"])

    kmoments.moments.launches = 0
    kadain.adain.launches = 0
    kernel_request()  # warm-up: cuDNN picks its algorithms
    plain_request()
    secs = {"kernel": [], "plain": []}
    outs = {}
    for kind in ("plain", "kernel", "kernel", "plain"):
        for _ in range(reps):
            out, seconds, mem = kernel_request() if kind == "kernel" else plain_request()
            secs[kind].append(seconds)
            outs[kind] = out
    before = counts()
    gen = torch.Generator(device="cuda").manual_seed(2)
    ref_out, ref_s, _ = model.forward_reference(dev["img"], dev["ref"], dev["c"], generator=gen)
    launches = counts()  # the whole run: warm-up, the random requests, 1 reference
    assert (launches[0] - before[0], launches[1] - before[1]) == per_forward

    for kind, out in outs.items():
        check_image(out, shape, f"{phase} forward_random {dtype_name} {kind}")
    check_image(ref_out, shape, f"{phase} forward_reference {dtype_name}")
    err = (outs["kernel"].float() - outs["plain"].float()).abs().max().item()
    assert err <= MODEL_TOL[dtype_name], f"{phase}: kernels vs plain {dtype_name}: {err}"
    log(dict(
        phase=phase, model=model_cls.__name__, flags=flags or {}, dtype=dtype_name, card=card,
        batch=B, requests=len(secs["kernel"]) + 2,
        img_per_s=B * len(secs["kernel"]) / sum(secs["kernel"]),
        img_per_s_plain=B * len(secs["plain"]) / sum(secs["plain"]),
        request_s=secs["kernel"], request_s_plain=secs["plain"],
        reference_request_s=ref_s, memory_reserved_gb=mem,
        max_abs_err_vs_plain=err, tol=MODEL_TOL[dtype_name],
        launches=dict(moments=launches[0], adain=launches[1]),
        per_forward=dict(moments=per_forward[0], adain=per_forward[1]),
    ))
    del model
    torch.cuda.empty_cache()
    return launches


def base_serve(card: str) -> dict:
    """BaseModel's main paths: configs A and B, each served in f32 and bf16
    (checked against the plain versions on the card) and in int8 (in turns
    with the f32 float model), with the counts checked per forward. Returns
    the int8 launches of both configs, by kernel."""
    check_small_against_cpu("f32", BaseModel, BASE_CONFIGS["A"])
    check_small_int8_against_cpu(BaseModel, BASE_CONFIGS["A"])
    launched = {}
    for name, flags in BASE_CONFIGS.items():
        for dtype_name in DTYPES:
            serve(dtype_name, card, BaseModel, flags, BASE_FLOAT_PER_FORWARD,
                  f"base_serve/{name}", reps=2)
        got = int8_serve(card, BaseModel, flags, BASE_INT8_PER_FORWARD[name],
                         f"base_int8_serve/{name}", reps=2)
        launched = {k: launched.get(k, 0) + v for k, v in got.items()}
        torch.cuda.empty_cache()
    return launched


# bf16 compute under int8 (``int8_serve_bf16``): bench.py's two serving
# configurations (AdaINModel; BaseModel --concat --reparam), BaseModel A,
# whose decoder runs kernel 4, and AdaINModel with --dec_norm instance;
# request batch sizes (B = 8 and 64 for the flagship: at 8 the host's launch
# overhead bounds the request)
BF16_INT8_MODELS = {
    "AdaINModel": (AdaINModel, {}, INT8_PER_FORWARD, (B, 64)),
    "BaseModel_A": (BaseModel, BASE_CONFIGS["A"], BASE_INT8_PER_FORWARD["A"], (B,)),
    "BaseModel_B": (BaseModel, BASE_CONFIGS["B"], BASE_INT8_PER_FORWARD["B"], (B,)),
    # --dec_norm instance: no LayerNorm to defer, so the transposed convs'
    # instance norms take a moments launch each and the head stays float
    "AdaINModel_dec_instance": (AdaINModel, dict(dec_norm="instance"), {
        "int8_downconv": 2, "int8_resblock": 8, "int8_conv3x3": 0, "int8_deconv": 2, "head": 0,
        "moments": 3}, (B,)),
}


def _int8_serve_bf16(card, name, model_cls, flags, per_forward, sizes, reps=2) -> dict:
    """One model's int8 path at compute dtype bf16: calibrated on the seeded
    batches, its requests timed in turns with the float bf16 model of the
    same weights and with the int8 path at compute dtype f32 (float,
    int8 f32, int8 bf16, int8 bf16, int8 f32, float), at each batch size.
    Every bf16 int8 forward must launch ``per_forward``; its output is
    bf16, finite, in [-1, 1], above 25 dB from the float bf16 forward, and
    within ``khead.BF16_TOL`` of the same forward through the plain
    versions (kernels 4-7 are bit-equal to theirs; the head's sum order
    differs). Returns the int8 kernels' launches."""
    phase = f"int8_serve_bf16/{name}"
    common = dict(**(flags or {}), **ARGS)
    model_f = model_cls(default_test_args(compute_dtype="bfloat16", **common))
    model_q = model_cls(default_test_args(compute_dtype="bfloat16", **common))
    model_q32 = model_cls(default_test_args(compute_dtype="float32", **common))
    calib = calibration_batches(ARGS)
    t0 = time.perf_counter()
    quant = model_q.calibrate_int8(*calib)
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    model_q32.calibrate_int8(*calib)
    zero_counts()
    launched = dict.fromkeys(per_forward, 0)

    def checked(fn):
        before = int8_counts()
        out = fn()
        delta = {k: v - before[k] for k, v in int8_counts().items()}
        assert delta == per_forward, f"{phase}: int8 launches per forward {delta}"
        for k, v in delta.items():
            launched[k] += v
        return out

    for bs in sizes:
        _, dev = request_inputs(dict(ARGS, batch_size=bs), seed=1)
        x = (dev["img"], dev["z"], dev["c"])
        shape = (bs, ARGS["crop_size"], ARGS["crop_size"], 3)
        requests = {"int8": lambda: checked(lambda: model_q.forward_random(*x)),
                    "int8_f32": lambda: model_q32.forward_random(*x),
                    "float": lambda: model_f.forward_random(*x)}
        for request in requests.values():  # warm-up
            request()
        secs, outs = {k: [] for k in requests}, {}
        torch.cuda.reset_peak_memory_stats()
        for kind in ("float", "int8_f32", "int8", "int8", "int8_f32", "float"):
            for _ in range(reps):
                out, seconds, _ = requests[kind]()
                secs[kind].append(seconds)
                outs[kind] = out
        peak_gb = torch.cuda.max_memory_allocated() / 1024**3
        for kind, out in outs.items():
            check_image(out.float(), shape, f"{phase} B={bs} {kind}")
        assert outs["int8"].dtype == torch.bfloat16, f"{phase}: int8 output {outs['int8'].dtype}"

        def psnr(a, b):
            mse = (a.float() - b.float()).square().mean().item()
            return 10 * math.log10(4.0 / max(mse, 1e-12))

        psnr_float = psnr(outs["int8"], outs["float"])
        assert psnr_float > PSNR_MIN_DB, f"{phase}: int8 bf16 vs float bf16 {psnr_float} dB"
        extra = {}
        if bs == B:
            gen = torch.Generator(device="cuda").manual_seed(2)
            ref_out, _, _ = checked(lambda: model_q.forward_reference(
                dev["img"], dev["ref"], dev["c"], generator=gen))
            check_image(ref_out.float(), shape, f"{phase} forward_reference")
            with plain_kernels():
                plain_out, plain_s, _ = model_q.forward_random(*x)
            err, share = _flips(outs["int8"], plain_out)
            assert err <= khead.BF16_TOL, f"{phase}: kernels vs plain: max {err}, share {share}"
            extra = dict(max_abs_err_vs_plain=err, share_differing_vs_plain=share,
                         tol=khead.BF16_TOL, plain_request_s=plain_s)
        log(dict(
            phase=phase, card=card, batch=bs, requests_per_kind=2 * reps,
            img_per_s=bs * len(secs["int8"]) / sum(secs["int8"]),
            img_per_s_int8_f32=bs * len(secs["int8_f32"]) / sum(secs["int8_f32"]),
            img_per_s_float_bf16=bs * len(secs["float"]) / sum(secs["float"]),
            request_s=secs["int8"], request_s_int8_f32=secs["int8_f32"],
            request_s_float_bf16=secs["float"], calibrate_s=calibrate_s,
            amax_leaves={k: len(v) for k, v in quant.items()}, peak_allocated_gb=peak_gb,
            psnr_vs_float_bf16_db=psnr_float, psnr_vs_int8_f32_db=psnr(outs["int8"],
                                                                       outs["int8_f32"]),
            psnr_min_db=PSNR_MIN_DB, per_forward=per_forward, **extra,
        ))
    del model_f, model_q, model_q32
    torch.cuda.empty_cache()
    return launched


def int8_serve_bf16(card: str) -> dict:
    """``int8_serve_bf16``: each model of BF16_INT8_MODELS; returns the
    bf16 int8 kernels' launches, by kernel, over all of them."""
    launched = {}
    for name, (model_cls, flags, per_forward, sizes) in BF16_INT8_MODELS.items():
        got = _int8_serve_bf16(card, name, model_cls, flags, per_forward, sizes)
        launched = {k: launched.get(k, 0) + v for k, v in got.items()}
    return launched


# the sample CLI's shapes at 540 x 960 (the bottleneck 135 x 240: odd rows),
# one image, bf16: (kind, input shape, output channels, prologue)
CLI_KERNEL_CASES = [
    ("down", (1, 64, 540, 960), 128, 0.01), ("down", (1, 128, 270, 480), 256, 0.0),
    ("resblock", (1, 256, 135, 240), 256, None), ("conv3x3", (1, 256, 135, 240), 256, 0.0),
    ("deconv", (1, 256, 135, 240), 128, None), ("deconv", (1, 128, 270, 480), 64, 0.0),
    ("head", (1, 64, 540, 960), 3, 0.0),
]


def check_cli_shapes() -> None:
    """Kernels 4-8 at the sample CLI's 540 x 960 shapes in bf16 against
    their plain versions: y and statistics of kernels 4, 5 and 7 and the
    output of kernel 6 equal, the head within ``khead.BF16_TOL``."""
    rows = []
    for i, (kind, shape, co, alpha) in enumerate(CLI_KERNEL_CASES):
        b, c = shape[:2]
        x = _randn(shape, torch.bfloat16, 1500 + i)
        pending = None if alpha is None else _card_pending(b, c, 1510 + i, alpha)
        if kind == "head":
            weight = _card_weight((co, c), 1520 + i, 0.1)
            got, want = khead.head(x, pending, weight), khead.head_plain(x, pending, weight)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= khead.BF16_TOL, f"head {shape}: {err}"
            rows.append(dict(kind=kind, shape=list(shape), co=co, max_abs_err=err,
                             tol=khead.BF16_TOL))
            continue
        if kind == "resblock":
            gamma, beta = _card_weight((b, c), 1530, 0.3), _card_weight((b, c), 1531, 0.3)
            q1 = kq.quant_conv(_card_weight((c, c, 3, 3), 1532), None, x.abs().amax(), 1,
                               "reflect")
            q2 = kq.quant_conv(_card_weight((c, c, 3, 3), 1533), None, 4.0, 1, "reflect")
            got = (kq.resblock(x, q1, q2, gamma, beta),)
            want = (kq.resblock_plain(x, q1, q2, gamma, beta),)
        else:
            amax = kq.prologue_plain(x, pending).abs().amax()
            weight = _card_weight((c, co, 3, 3) if kind == "deconv" else (co, c, 3, 3), 1540 + i)
            bias = _card_weight((co,), 1550 + i, 0.1)
            qc = (kq.quant_deconv(weight, bias, amax) if kind == "deconv" else
                  kq.quant_conv(weight, bias, amax, 2 if kind == "down" else 1, "reflect"))
            wrapper = {"down": kq.downconv, "conv3x3": kq.conv3x3, "deconv": kq.deconv}[kind]
            got = wrapper(x, qc, pending, with_stats=True)
            want = kq.conv_plain(x, qc, pending, True)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.bfloat16, f"{kind} {shape}: y is {got[0].dtype}"
        assert all(torch.equal(g, w) for g, w in zip(got, want)), f"{kind} {shape}: differs"
        rows.append(dict(kind=kind, shape=list(shape), co=co, out=list(got[0].shape),
                         equal=True, tol=0.0))
    log(dict(phase="int8_bf16_540x960", cases=rows))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- training --


def train_batch(args, seed):
    """A seeded batch of B images per side, NHWC in [-1, 1], one-hot labels."""
    rng = np.random.default_rng(seed)
    size, k, b = args["crop_size"], args["num_domains"], args["batch_size"]
    y = np.eye(k, dtype=np.float32)
    host = dict(x1=rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
                x2=rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32),
                y1=y[rng.integers(0, k, b)], y2=y[rng.integers(0, k, b)])
    return host, {k_: torch.from_numpy(v).cuda() for k_, v in host.items()}


def fused_counts() -> dict:
    return {"resblock_fwd": krb.resblock_fwd.launches, "resblock_bwd": krb.resblock_bwd.launches}


def _floats(logs) -> dict:
    return {k: float(v) for k, v in logs.items()}


def _snapshot(model) -> dict:
    return {n: [p.detach().clone() for p in net.parameters()] for n, net in model.nets.items()}


def _changed(model, before) -> dict:
    """Per net: whether every parameter tensor moved."""
    return {n: all(not torch.equal(p, q) for p, q in zip(net.parameters(), before[n]))
            for n, net in model.nets.items()}


def _timed_step(model, batch, it):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = model.optimize_parameters(batch, it)
    torch.cuda.synchronize()
    return _floats(logs), time.perf_counter() - t0


def check_small_train_against_cpu(model_cls=AdaINModel, flags=None,
                                  per_step=FUSED_PER_STEP, random_draws=None,
                                  loss_floor=1e-6) -> None:
    """One f32 main step at the CPU tests' size on the card (kernels 9/10)
    against the same step on the CPU (their plain versions), from the same
    weights, batch and styles; without noise, or with ``random_draws``
    (default: with ``--use_dropout``) with every draw of the step (noise,
    eps, dropout masks, WGAN-GP's eps) made from the card model's generator
    on the card and handed to the CPU run. Losses within
    TRAIN_CPU_LOSS_TOL of max(|loss|, ``loss_floor``)."""
    flags = flags or {}
    if random_draws is None:
        random_draws = bool(flags.get("use_dropout"))
    what = f"f32 train step {model_cls.__name__} {flags}"
    host, dev = train_batch(SMALL_TRAIN_ARGS, seed=21)
    rng = np.random.default_rng(22)
    z = [torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32)) for _ in range(2)]
    card = model_cls(default_train_args(fused_resblock="auto", **flags, **SMALL_TRAIN_ARGS))
    cpu = model_cls(default_train_args(fused_resblock="on", **flags, **SMALL_TRAIN_ARGS),
                    device="cpu")
    draws = StepDraws(card.generator if random_draws else None, z_sr=z[0].cuda(), z_sr2=z[1].cuda())
    before = fused_counts()
    on_card = _floats(card.main_step(dev, draws))
    delta = {k: v - before[k] for k, v in fused_counts().items()}
    assert delta == per_step, f"{what}: launches {delta}"
    masks = [k for k in draws.given if ".drop" in k]
    if flags.get("use_dropout"):
        assert masks and all(draws.given[k].is_cuda for k in masks), "no masks drawn on the card"
    on_cpu = _floats(cpu.main_step(host, StepDraws(**{k: v.cpu() for k, v in draws.given.items()})))
    errs = {k: abs(on_card[k] - v) / max(abs(v), loss_floor) for k, v in on_cpu.items()}
    worst = max(errs, key=errs.get)
    loss_err = errs[worst]
    lr = on_cpu["lr"]
    diffs = torch.cat([(p.detach().cpu() - q.detach()).abs().flatten()
                       for n in cpu.nets for p, q in zip(card.nets[n].parameters(),
                                                         cpu.nets[n].parameters())])
    share = (diffs > 0.1 * lr).float().mean().item()
    log(dict(phase="card_vs_cpu", model=model_cls.__name__, flags=flags, dtype="f32 train step",
             draws_on_card=sorted(draws.given) if random_draws else ["z_sr", "z_sr2"],
             dropout_masks=len(masks), max_rel_loss_err=loss_err, worst_loss=worst,
             worst_loss_values=[on_card[worst], on_cpu[worst]], loss_floor=loss_floor,
             param_share_beyond_0_1_lr=share, max_param_diff_in_lr=diffs.max().item() / lr,
             tol=dict(loss=TRAIN_CPU_LOSS_TOL, share=TRAIN_CPU_FLIP_SHARE), launches=delta))
    assert loss_err <= TRAIN_CPU_LOSS_TOL, f"{what} card vs CPU: losses {loss_err}"
    assert share <= TRAIN_CPU_FLIP_SHARE, f"{what} card vs CPU: params {share}"


def _moments_by_dtype(calls: collections.Counter) -> dict:
    names = {dtype: name for name, dtype in DTYPES.items()}
    out = collections.Counter()
    for (_, dtype), n in calls.items():
        out[f"moments/{names[dtype]}"] += n
    return dict(out)


def _timed_main_steps(model, batch, its, per_step, moments_per_step, phase) -> tuple:
    """Timed main steps at iterations ``its``, each asserted to launch
    kernels 9/10 ``per_step`` times and the moments kernel as often as the
    warm-up step; returns (their logs, seconds)."""
    steps, secs = [], []
    for it in its:
        counts0 = {**fused_counts(), "moments": kmoments.moments.launches}
        logs, t = _timed_step(model, batch, it)
        delta = {k: v - counts0[k] for k, v in fused_counts().items()}
        assert delta == per_step, f"{phase}: kernel 9/10 launches per main step {delta}"
        moments = kmoments.moments.launches - counts0["moments"]
        assert moments == moments_per_step, \
            f"{phase}: {moments} moments launches in a main step, {moments_per_step} in the first"
        steps.append(logs)
        secs.append(t)
    return steps, secs


def _check_finite(phase, *logs) -> None:
    for step in logs:
        bad = [k for k, v in step.items() if not math.isfinite(v)]
        assert not bad, f"{phase}: non-finite losses {bad}"


def train(card: str, model_cls=AdaINModel, flags=None, per_step=FUSED_PER_STEP,
          phase="train") -> dict:
    """A training main path at the flagship config: a warm-up main step,
    three timed main steps, one timed d_iter cycle (main + 2 content steps);
    then the same first step composed (``--fused_resblock off``) from the same
    weights and draws, and three timed composed main steps; then the moments
    kernel at each shape of the main step (:func:`check_moments_path`).
    Returns the kernel 9/10 and moments launches over the timed run and,
    under ``per_main_step``, each kernel's launches (and the moments
    kernel's ms) per main step."""
    flags = flags or {}
    args = default_train_args(**flags, **TRAIN_ARGS)
    _, batch = train_batch(TRAIN_ARGS, seed=31)
    model = model_cls(args)
    model.generator.manual_seed(1)
    with recording_moments(collections.Counter()) as moments_calls:
        first, first_s = _timed_step(model, batch, 0)  # warm-up: cuDNN picks its algorithms
    moments_per_step = sum(moments_calls.values())

    krb.resblock_fwd.launches = krb.resblock_bwd.launches = kmoments.moments.launches = 0
    torch.cuda.reset_peak_memory_stats()
    before = _snapshot(model)
    steps, main_s = _timed_main_steps(model, batch, (3, 6, 9), per_step, moments_per_step, phase)
    changed = _changed(model, before)
    want = {n: n != "content_discriminator" for n in model.nets}
    assert changed == want, f"{phase}: main steps changed {changed}, expected {want}"
    before = _snapshot(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cycle = [model.optimize_parameters(batch, it) for it in (12, 13, 14)]
    torch.cuda.synchronize()
    cycle_s = time.perf_counter() - t0
    assert set(cycle[1]) == set(cycle[2]) == {"d_content_cls"}
    assert all(_changed(model, before).values()), f"{phase}: a d_iter cycle must move every net"
    launched = {**fused_counts(), "moments": kmoments.moments.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1024**3
    _check_finite(phase, first, *steps, *map(_floats, cycle))
    del model
    torch.cuda.empty_cache()

    off = model_cls(default_train_args(**flags, **{**TRAIN_ARGS, "fused_resblock": "off"}))
    off.generator.manual_seed(1)
    counts0 = fused_counts()
    composed, composed_first_s = _timed_step(off, batch, 0)
    composed_s = [_timed_step(off, batch, it)[1] for it in (3, 6, 9)]
    assert fused_counts() == counts0, f"{phase}: the composed step launched kernel 9 or 10"
    gap = {k: abs(first[k] - v) / max(abs(v), 1.0) for k, v in composed.items()}
    worst = max(gap, key=gap.get)
    del off
    torch.cuda.empty_cache()
    log(dict(
        phase=phase, model=model_cls.__name__, flags=flags, card=card,
        config={k: v for k, v in TRAIN_ARGS.items() if k != "seed"},
        images_per_side=B, main_step_s=main_s, main_it_per_s=len(main_s) / sum(main_s),
        cycle_s=cycle_s, schedule_img_per_s=3 * 2 * B / cycle_s, first_step_s=first_s,
        composed_first_step_s=composed_first_s, composed_step_s=composed_s,
        composed_it_per_s=len(composed_s) / sum(composed_s),
        peak_memory_allocated_gb=peak_gb, launches=launched,
        per_main_step=per_step, first_step_losses=first,
        fused_vs_composed=dict(worst=worst, rel_gap=gap[worst], tol=TRAIN_LOSS_TOL),
    ))
    assert gap[worst] <= TRAIN_LOSS_TOL, f"{phase}: fused vs composed {worst}: {gap[worst]}"
    launched["per_main_step"] = {**{k: dict(launches=n) for k, n in per_step.items()},
                                 **{f"moments/{k}": v for k, v in
                                    check_moments_path(phase, moments_calls).items()}}
    return launched


def base_train(card: str, per_call_ms: dict) -> dict:
    """BaseModel's training main paths, configs A and B, after their small
    f32 steps on the card against the CPU, and the small AdaINModel
    ``--use_dropout`` step with its draws made on the card. ``per_call_ms``:
    kernel -> {batch: ms per call at (batch, 256, 64, 64)}, from 7's timings.
    Returns the launches of each config's timed run and per main step."""
    for name, flags in BASE_CONFIGS.items():
        check_small_train_against_cpu(BaseModel, flags, SMALL_PER_STEP[name])
    check_small_train_against_cpu(AdaINModel, dict(use_dropout=True), SMALL_PER_STEP["dropout"])
    launched = {}
    for name, flags in BASE_CONFIGS.items():
        got = train(card, BaseModel, flags, BASE_PER_STEP[name], f"base_train/{name}")
        assert got["moments"] > 0, f"base_train/{name}: the moments kernel did not run"
        ms = {k: sum(per_call_ms[k][b] * n for b, n in calls.items())
              for k, calls in BASE_RESBLOCK_CALLS[name].items()}
        for k, t in ms.items():
            got["per_main_step"][k]["ms"] = t
        log(dict(phase=f"base_train/{name}", kernel_ms_per_main_step=ms,
                 calls_per_main_step=BASE_RESBLOCK_CALLS[name],
                 note="ms per call of the kernel timings (7) times the calls"))
        launched[name] = got
    return launched


def train_fused_gan(card: str) -> tuple[dict, float, dict]:
    """``train_variants/fused``: AdaINModel's training main path with
    bench.py's GAN step. A first main step without draws (no noise, z = mu:
    the deterministic step) as warm-up, recording the moments kernel's
    shapes; three timed main steps and a timed d_iter cycle with draws from
    the model's generator; then the reference GAN step from the same
    weights: its first step without draws must give the fused step's losses
    within 3 % (the two compute one update then), and three of its main
    steps are timed. Returns the per-main-step launches (kernels 9/10, and
    the moments kernel held at its shapes), the fused main step's seconds,
    and its main-step it/s and schedule img/s."""
    phase = "train_variants/fused"
    _, batch = train_batch(TRAIN_ARGS, seed=31)
    rng = np.random.default_rng(32)
    z = {k: torch.from_numpy(rng.standard_normal((B, TRAIN_ARGS["latent_dim"])).astype(
        np.float32)).cuda() for k in ("z_sr", "z_sr2")}
    model = AdaINModel(default_train_args(**FUSED_GAN_ARGS))
    model.generator.manual_seed(1)
    weights = {n: {k: v.clone() for k, v in net.state_dict().items()}
               for n, net in model.nets.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_moments(collections.Counter()) as moments_calls:
        first = _floats(model.main_step(batch, StepDraws(**z)))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    moments_per_step = sum(moments_calls.values())

    krb.resblock_fwd.launches = krb.resblock_bwd.launches = kmoments.moments.launches = 0
    torch.cuda.reset_peak_memory_stats()
    before = _snapshot(model)
    steps, main_s = _timed_main_steps(model, batch, (3, 6, 9), FUSED_GAN_PER_STEP,
                                      moments_per_step, phase)
    changed = _changed(model, before)
    want = {n: n != "content_discriminator" for n in model.nets}
    assert changed == want, f"{phase}: main steps changed {changed}, expected {want}"
    before = _snapshot(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cycle = [model.optimize_parameters(batch, it) for it in (12, 13, 14)]
    torch.cuda.synchronize()
    cycle_s = time.perf_counter() - t0
    assert set(cycle[1]) == set(cycle[2]) == {"d_content_cls"}
    assert all(_changed(model, before).values()), f"{phase}: a d_iter cycle must move every net"
    launched = {**fused_counts(), "moments": kmoments.moments.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1024**3
    _check_finite(phase, first, *steps, *map(_floats, cycle))
    del model
    torch.cuda.empty_cache()

    ref = AdaINModel(default_train_args(**TRAIN_ARGS))
    ref.load_params(weights)
    ref.generator.manual_seed(1)
    with recording_moments(collections.Counter()) as ref_calls:
        ref_first = _floats(ref.main_step(batch, StepDraws(**z)))
    torch.cuda.reset_peak_memory_stats()
    _, ref_s = _timed_main_steps(ref, batch, (3, 6, 9), FUSED_PER_STEP,
                                 sum(ref_calls.values()), f"{phase} reference")
    ref_peak_gb = torch.cuda.max_memory_allocated() / 1024**3
    del ref, weights
    torch.cuda.empty_cache()
    gap = {k: abs(first[k] - v) / max(abs(v), 1.0) for k, v in ref_first.items()}
    worst = max(gap, key=gap.get)
    log(dict(
        phase=phase, model="AdaINModel", card=card,
        config={k: v for k, v in FUSED_GAN_ARGS.items() if k != "seed"}, images_per_side=B,
        main_step_s=main_s, main_it_per_s=len(main_s) / sum(main_s), cycle_s=cycle_s,
        schedule_img_per_s=3 * 2 * B / cycle_s, first_step_s=first_s,
        peak_memory_allocated_gb=peak_gb, launches=launched, per_main_step=FUSED_GAN_PER_STEP,
        moments_per_main_step=moments_per_step,
        reference_moments_per_main_step=sum(ref_calls.values()), reference_step_s=ref_s, reference_it_per_s=len(ref_s) / sum(ref_s),
        reference_peak_memory_allocated_gb=ref_peak_gb, first_step_losses=first,
        fused_vs_reference=dict(worst=worst, rel_gap=gap[worst], tol=TRAIN_LOSS_TOL),
    ))
    assert gap[worst] <= TRAIN_LOSS_TOL, f"{phase}: fused vs reference {worst}: {gap[worst]}"
    per_step = {**{k: dict(launches=n) for k, n in FUSED_GAN_PER_STEP.items()},
                **{f"moments/{k}": v for k, v in check_moments_path(phase, moments_calls).items()}}
    rates = dict(main_it_per_s=len(main_s) / sum(main_s), schedule_img_per_s=3 * 2 * B / cycle_s)
    return per_step, sum(main_s) / len(main_s), rates


def train_variant(card: str, name: str, fused_s: float, timed: int = 2) -> dict:
    """``train_variants/<name>``: one training flag on the fused GAN step at
    the flagship config: a warm-up main step, ``timed`` timed main steps
    with their launches asserted, finite losses (the flag's own among them),
    every net but the content discriminator moved. Returns its launches per
    main step."""
    phase = f"train_variants/{name}"
    flags = VARIANT_FLAGS[name]
    per_step = REMAT_PER_STEP if name == "remat" else FUSED_GAN_PER_STEP
    _, batch = train_batch(TRAIN_ARGS, seed=31)
    model = AdaINModel(default_train_args(**{**FUSED_GAN_ARGS, **flags}))
    model.generator.manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    with recording_moments(collections.Counter()) as moments_calls:
        first, first_s = _timed_step(model, batch, 0)
    before = _snapshot(model)
    steps, secs = _timed_main_steps(model, batch, (3, 6, 9)[:timed], per_step,
                                    sum(moments_calls.values()), phase)
    changed = _changed(model, before)
    want = {n: n != "content_discriminator" for n in model.nets}
    assert changed == want, f"{phase}: main steps changed {changed}, expected {want}"
    _check_finite(phase, first, *steps)
    own = {"wgangp": {"d_gp"}, "vgg_l2": {"g_p", "g_p2"}}.get(name, set())
    assert own <= set(first), f"{phase}: no {own - set(first)} in the logs"
    peak_gb = torch.cuda.max_memory_allocated() / 1024**3
    del model
    torch.cuda.empty_cache()
    moments = _moments_by_dtype(moments_calls)
    log(dict(phase=phase, flags=flags, card=card, step_s=secs, first_step_s=first_s,
             s_per_step=sum(secs) / len(secs), fused_gan_s_per_step=fused_s,
             peak_memory_allocated_gb=peak_gb, per_main_step=per_step,
             moments_per_main_step=moments, first_step_losses=first))
    return {**{k: dict(launches=n) for k, n in per_step.items()},
            **{k: dict(launches=n) for k, n in moments.items()}}


def train_variants(card: str, per_call_ms: dict) -> tuple[dict, dict]:
    """The small steps of every training flag on the card against the CPU,
    then the fused GAN step and each flag at the flagship config. Returns
    each path's launches per main step, by phase, with kernel 9/10 ms per
    main step (``per_call_ms``, 7's per-call times, times the calls) for the
    fused step and ``--remat``; and the fused step's it/s and img/s."""
    for name, (model_cls, flags, per_step) in SMALL_VARIANTS.items():
        check_small_train_against_cpu(model_cls, flags, per_step, random_draws=True,
                                      loss_floor=VARIANT_LOSS_FLOOR)
    per_main_step = {}
    per_main_step["train_variants/fused"], fused_s, fused_rates = train_fused_gan(card)
    for name in VARIANT_FLAGS:
        per_main_step[f"train_variants/{name}"] = train_variant(card, name, fused_s)
    for name, calls in (("fused", FUSED_GAN_CALLS), ("remat", REMAT_CALLS)):
        ms = {k: sum(per_call_ms[k][b] * n for b, n in c.items()) for k, c in calls.items()}
        for k, t in ms.items():
            per_main_step[f"train_variants/{name}"][k]["ms"] = t
        log(dict(phase=f"train_variants/{name}", kernel_ms_per_main_step=ms,
                 calls_per_main_step=calls,
                 note="ms per call of the kernel timings (7) times the calls"))
    return per_main_step, fused_rates


# --------------------------------------------------------------- train CLI --

# train_cli: the train CLI (TrainArguments().parse, Trainer().run) at the
# flagship training config of train_variants/fused, on a seeded JPEG tree
CLI_DOMAINS = ("cloud", "fog", "rain", "sun")
CLI_PER_DOMAIN = 8
CLI_IMAGE = (540, 960)  # EvalTransform's size, a photograph's
# iterations 0..14, five d_iter cycles: 0-2 a warm-up, 3-5 recorded for host
# syncs and profiled, 6-8 and 12-14 timed clean, 9-11 with a checkpoint and
# an image grid at 9; StepTimer reports it/s per cycle (--print_freq 3)
CLI_ITERS, CLI_SAVE, CLI_PROFILED, CLI_CLEAN = 14, 9, (3, 4, 5), (2, 4)
CLI_ARGV = ["--model", "AdaINModel", "--dataset", "PairedDataset", "--load_size", "286",
            "--crop_size", "256", "--dim", "64", "--latent_dim", "8", "--num_domains", "4",
            "--batch_size", str(B), "--compute_dtype", "bfloat16", "--use_dis_content",
            "--d_iter", "3", "--gan_step", "fused", "--fused_resblock", "auto", "--seed", "0",
            "--print_freq", "3", "--save_freq", str(CLI_SAVE), "--display_freq", str(CLI_SAVE)]
# the resumed run's first iteration against the unbroken run's, relative, of
# max(|loss|, 1e-2); the later ones within RESUME_DRIFT_TOL: the content
# step's update on the card is not bit-reproducible (a repeat of iterations
# 10-11 from the same checkpoint, batches and draws shows the same drift;
# 1.3e-4 measured at iteration 11)
RESUME_LOSS_TOL, RESUME_DRIFT_TOL = 1e-5, 1e-3


def write_jpeg_tree(root: Path, seed: int = 0) -> int:
    """``root/train/<domain>/img{i}.jpg``: 4 domains x 8 seeded 540 x 960
    JPEGs (quality 90), smooth patterns (a gradient and six sinusoids per
    channel) with mild noise, about the size of a photograph each. Returns
    the bytes written."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = CLI_IMAGE
    yy, xx = _grid(h, w)
    total = 0
    for name in CLI_DOMAINS:
        d = root / "train" / name
        d.mkdir(parents=True)
        for i in range(CLI_PER_DOMAIN):
            img = _smooth_pattern(rng, yy, xx)
            img += rng.normal(0, 6, (h, w, 1)).astype(np.float32)
            path = d / f"img{i}.jpg"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=90)
            total += path.stat().st_size
    return total


def _grid(h: int, w: int):
    return np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                       np.linspace(0, 1, w, dtype=np.float32), indexing="ij")


def _smooth_pattern(rng, yy, xx) -> np.ndarray:
    """A gradient and six sinusoids per channel, (h, w, 3) f32 in about [0, 255]."""
    img = np.empty((*yy.shape, 3), np.float32)
    for c in range(3):
        acc = rng.uniform(60, 190) + rng.uniform(-60, 60) * yy
        for _ in range(6):
            fy, fx = rng.uniform(1, 24, 2)
            acc = acc + rng.uniform(5, 30) * np.sin(
                2 * np.pi * (fx * xx + fy * yy) + rng.uniform(0, 2 * np.pi))
        img[..., c] = acc
    return img


class CliTrainer(Trainer):
    keep = ()  # iterations whose device batches are kept

    """The train CLI's Trainer with its iterations recorded: each main
    step's kernel 9/10 and moments launches, every iteration's losses
    (device tensors, read after the run), host syncs inside the step over
    CLI_PROFILED (``torch.cuda.set_sync_debug_mode``), a torch.profiler
    window over that d_iter cycle (from its first step's start to its last
    step's end, the loop between them included) and each checkpoint save's
    seconds."""

    def create_model(self, args):
        model = super().create_model(args)
        self.records, self.syncs, self.saves, self.prof = {}, [], [], None
        self.window_s, self.batches = None, {}
        step, save = model.optimize_parameters, model.save
        self.step = step

        def recorded(batch, it, draws=None):
            profiled = it in CLI_PROFILED
            if it == CLI_PROFILED[0]:
                torch.cuda.synchronize()
                self.prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
                self._t0 = time.perf_counter()
            counts0 = {**fused_counts(), "moments": kmoments.moments.launches}
            if profiled:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        logs = step(batch, it, draws)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                self.syncs += [str(w.message).splitlines()[0] for w in caught
                               if "called a synchronizing" in str(w.message)]
            else:
                logs = step(batch, it, draws)
            if it == CLI_PROFILED[-1]:
                torch.cuda.synchronize()
                self.window_s = time.perf_counter() - self._t0
                self.prof.__exit__(None, None, None)
            delta = {k: v - counts0[k] for k, v in
                     {**fused_counts(), "moments": kmoments.moments.launches}.items()}
            self.records[it] = (delta, {k: v.detach().clone() for k, v in logs.items()
                                        if isinstance(v, torch.Tensor)})
            if it in self.keep:
                self.batches[it] = batch
            return logs

        def timed_save(it):
            t0 = time.perf_counter()
            save(it)
            self.saves.append((it, time.perf_counter() - t0))

        model.optimize_parameters, model.save = recorded, timed_save
        return model


def _device_busy_ms(prof) -> float:
    total = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            total += us / 1e3
    return total


def _losses(records, its) -> dict:
    return {it: {k: float(v) for k, v in records[it][1].items()} for it in its}


def _check_restored(model, model_path, opt_path) -> None:
    """Params, spectral u, Adam moments and counts, and step equal the
    checkpoint files bit for bit."""
    params, opt = ckpt.load_pytree(model_path), ckpt.load_pytree(opt_path)
    assert model.state.step == opt["step"], (model.state.step, opt["step"])
    for n, net in model.nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(v.cpu(), params["params"][n][k]), f"train_cli resume: {n}.{k}"
        s, saved = model.state.opt_state[n], opt["opt_state"][n]
        assert s.count == saved["count"], f"train_cli resume: {n} Adam count"
        for mine, theirs in zip(s.mu + s.nu, saved["mu"] + saved["nu"]):
            assert torch.equal(mine.cpu(), theirs), f"train_cli resume: {n} Adam moments"


def train_cli_route(card: str, root: Path, route: str, extra: list, fused: dict) -> dict:
    """``train_cli/<route>``: the CLI at the flagship config over the JPEG
    tree, then a fresh trainer resumed from the checkpoint at CLI_SAVE.
    Returns the launches per main step."""
    phase = f"train_cli/{route}"
    exps = root / "exps"
    argv = ["--dataroot", str(root / "data"), "--exp_dir", str(exps), "--name", route,
            "--n_iters", str(CLI_ITERS), "--max_iter", str(CLI_ITERS), *CLI_ARGV, *extra]
    args = TrainArguments().parse(argv)
    trainer = CliTrainer()
    krb.resblock_fwd.launches = krb.resblock_bwd.launches = kmoments.moments.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = trainer.run(args)
    run_s = time.perf_counter() - t0
    launched = {**fused_counts(), "moments": kmoments.moments.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1024**3
    mains = [it for it in trainer.records if it % 3 == 0]
    per_step = {**FUSED_GAN_PER_STEP, "moments": fused["moments/bf16"]["launches"]}
    for it in mains:
        assert trainer.records[it][0] == per_step, \
            f"{phase}: iteration {it} launched {trainer.records[it][0]}, expected {per_step}"
    assert sorted(trainer.records) == list(range(CLI_ITERS + 1))
    losses = _losses(trainer.records, range(CLI_ITERS + 1))
    _check_finite(phase, *losses.values())
    ck = Path(args.checkpoint_dir)
    want = {f"{k}_{i}.ckpt" for k in ("model", "opt") for i in (0, CLI_SAVE, CLI_ITERS + 1)}
    assert set(os.listdir(ck)) == want, f"{phase}: checkpoints {sorted(os.listdir(ck))}"
    grids = sorted(os.listdir(args.display_dir))
    assert grids == ["gen_0.jpg", f"gen_{CLI_SAVE}.jpg"], f"{phase}: grids {grids}"
    sizes = {f: (ck / f).stat().st_size for f in (f"model_{CLI_SAVE}.ckpt", f"opt_{CLI_SAVE}.ckpt")}
    busy = _device_busy_ms(trainer.prof)
    rates = trainer.throughput
    clean = [rates[i] for i in CLI_CLEAN]
    del model
    torch.cuda.empty_cache()

    # a fresh trainer resumed from the checkpoint at CLI_SAVE
    resume = [str(ck / f"model_{CLI_SAVE}.ckpt"), str(ck / f"opt_{CLI_SAVE}.ckpt")]
    rargs = TrainArguments().parse([
        *argv[:5], f"{route}_resumed", "--n_iters", str(CLI_SAVE + 3), "--max_iter",
        str(CLI_SAVE + 3), *CLI_ARGV, *extra, "--resume", resume[0], "--resume_opt", resume[1],
        "--last_iter", str(CLI_SAVE)])
    resumed = CliTrainer()
    resumed.keep = (CLI_SAVE + 1, CLI_SAVE + 2)
    loader = resumed.load_dataset(rargs)
    t0 = time.perf_counter()
    rmodel = resumed.create_model(rargs)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    _check_restored(rmodel, *resume)
    t0 = time.perf_counter()
    rmodel.load(*resume)
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t0
    resumed.train(rargs, rmodel, loader)
    its = list(range(CLI_SAVE + 1, CLI_SAVE + 4))
    assert sorted(resumed.records) == its
    got, want_l = _losses(resumed.records, its), {it: losses[it] for it in its}
    gaps = {(it, k): abs(got[it][k] - v) / max(abs(v), 1e-2)
            for it in its for k, v in want_l[it].items()}
    first = max((g, key) for key, g in gaps.items() if key[0] == its[0])
    later = max((g, key) for key, g in gaps.items() if key[0] != its[0])
    # the card's own spread: iterations 10-11 twice from the checkpoint
    repeats = []
    for _ in range(2):
        rmodel.load(*resume)
        for it in resumed.keep:
            logs = resumed.step(resumed.batches[it], it,
                                StepDraws(iteration_generator(rargs.seed, it, STEP, rmodel.device)))
        repeats.append({k: float(v) for k, v in logs.items() if isinstance(v, torch.Tensor)})
    spread = max(abs(repeats[0][k] - v) / max(abs(v), 1e-2) for k, v in repeats[1].items())
    del rmodel, resumed
    torch.cuda.empty_cache()
    log(dict(
        phase=phase, card=card, route=route, argv=argv, run_s=run_s,
        host_decode="native" if native.available() else "pil",
        native_build_error=None if native.available() else (native.build_error() or "")[-300:],
        it_per_s_per_cycle=rates, clean_cycles=list(CLI_CLEAN),
        trainer_it_per_s=sum(clean) / len(clean),
        schedule_img_per_s=sum(clean) / len(clean) * 2 * B,
        fused_step_main_it_per_s=fused["rates"]["main_it_per_s"],
        fused_step_schedule_img_per_s=fused["rates"]["schedule_img_per_s"],
        profiled_cycle=dict(its=list(CLI_PROFILED), window_s=trainer.window_s,
                            device_busy_ms=busy,
                            device_idle_share=1.0 - busy / (trainer.window_s * 1e3),
                            note="profiler on: the idle share is an upper bound"),
        host_syncs_in_steps=len(trainer.syncs), host_sync_kinds=sorted(set(trainer.syncs))[:8],
        launches=launched, per_main_step=per_step, main_steps=len(mains),
        peak_memory_allocated_gb=peak_gb, save_s=trainer.saves, checkpoint_bytes=sizes,
        resume=dict(load_s=load_s, reload_s=reload_s, restored="bit for bit",
                    spectral_u="none in this config (no --dis_sn)",
                    first_iteration=dict(it=its[0], worst=first[1][1], rel_gap=first[0],
                                         tol=RESUME_LOSS_TOL),
                    later=dict(worst=list(later[1]), rel_gap=later[0], tol=RESUME_DRIFT_TOL),
                    repeat_spread=dict(its=its[:2], rel=spread)),
        losses={it: losses[it] for it in (0, 3, CLI_ITERS - 2)},
    ))
    assert first[0] <= RESUME_LOSS_TOL, f"{phase}: resumed {first} {got} vs {want_l}"
    assert later[0] <= RESUME_DRIFT_TOL, f"{phase}: resumed {later} {got} vs {want_l}"
    return {k: dict(launches=n) for k, n in per_step.items() if k != "moments"} | {
        "moments/bf16": dict(launches=per_step["moments"])}


def loader_rates(root: Path, batches: int = 4) -> dict:
    """The loader alone, img/s over ``batches`` batches after the first
    (the trainer's dataset and DataLoader, one producer thread): native
    decode where it built, PIL's, and the host side of --device_preproc."""
    routes = {"pil": dict(native=False)}
    if native.available():
        routes["native"] = dict(native=True)
    routes["device_preproc_host"] = dict(native=native.available(), device_preproc=True)
    out = {}
    for name, kw in routes.items():
        args = default_train_args(dataroot=str(root / "data"), num_domains=4, load_size=286,
                                  crop_size=256, seed=0, device_preproc=kw.get("device_preproc"))
        ds = PairedDataset(args)
        ds.transforms.use_native = kw["native"]
        it = infinite(DataLoader(ds, batch_size=B, num_workers=4, drop_last=True))
        next(it)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        out[name] = 2 * B * batches / (time.perf_counter() - t0)
        it.close()
    return out


def device_preprocess_ms() -> dict:
    """preprocess_pair_batch on a uint8 batch on the card (B images per side
    at 286 px, cropped to 256), CUDA events, beside its bound: the crops
    read once as uint8, written once as f32."""
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (B, 286, 286, 3), dtype=np.uint8)).cuda()
             for k in ("x1", "x2")}
    g = torch.Generator(device="cuda").manual_seed(0)
    ms = device_ms(lambda b: preprocess_pair_batch(b, g, 286, 256), [(batch,)], iters=50)
    b_ms, by = bound(2 * B * 256 * 256 * 3 * (1 + 4), 2 * 2 * B * 256 * 256 * 3)
    return dict(ms_per_batch=ms, bound_ms=b_ms, bound_by=by)


def train_cli(card: str, fused_rates: dict, fused_per_step: dict) -> dict:
    """``train_cli``: the train CLI on the card, host transforms and
    --device_preproc, each with a resume; the loader alone; the device
    preprocess. Returns the launches per main step, by phase."""
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="train_cli_", dir=out_dir))
    try:
        t0 = time.perf_counter()
        nbytes = write_jpeg_tree(root / "data")
        log(dict(phase="train_cli/data", images=len(CLI_DOMAINS) * CLI_PER_DOMAIN,
                 size=list(CLI_IMAGE), bytes=nbytes, seconds=time.perf_counter() - t0))
        fused = {**fused_per_step, "rates": fused_rates}
        per_main_step = {}
        for route, extra in (("host", []), ("device_preproc", ["--device_preproc"])):
            per_main_step[f"train_cli/{route}"] = train_cli_route(card, root, route, extra, fused)
            shutil.rmtree(root / "exps", ignore_errors=True)
        log(dict(phase="train_cli/feed", card=card, loader_img_per_s=loader_rates(root),
                 device_preprocess=device_preprocess_ms(),
                 needed_img_per_s=fused_rates["schedule_img_per_s"],
                 note="loader: one producer thread, as the JAX package's"))
        return per_main_step
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the sample CLI (``sample_cli``): the flagship AdaINModel at full width from
# a Model.save checkpoint, 540 x 960 (EvalTransform's size), batch 4, bf16
SAMPLE_IMAGES, SAMPLE_BATCH, SAMPLE_FRAMES = 8, 4, 16
SAMPLE_ARGV = ["--model", "AdaINModel", "--dim", "64", "--latent_dim", "8", "--num_domains", "4",
               "--batch_size", str(SAMPLE_BATCH), "--sample_size", *map(str, CLI_IMAGE),
               "--compute_dtype", "bfloat16", "--seed", "0", "--num_workers", "1"]
SAMPLE_ROUTES = {"bf16": [], "bf16_int8": ["--int8"], "grid": ["--gen_grid"],
                 "video": ["--out_fmt", "video", "--vid_fname", "clip.avi"]}


class CliSampler(Sampler):
    """The sample CLI's Sampler with its work recorded: the launch counts
    set to 0 after calibration, and each queued translation (inputs and
    output, on the card)."""

    def calibrate(self, args, model, dataloader):
        quant = super().calibrate(args, model, dataloader)
        zero_counts()
        return quant

    def _enqueue(self, fn, *args):
        out = super()._enqueue(fn, *args)
        self.queued.append((args, out[0]))
        return out

    def run(self, args):
        self.queued = []
        zero_counts()
        return super().run(args)


def write_video(path: Path, frames: int, seed: int = 0) -> None:
    """``frames`` seeded 540 x 960 frames (smooth patterns), MJPG in an .avi."""
    import cv2

    h, w = CLI_IMAGE
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (w, h))
    assert writer.isOpened(), "cv2 has no MJPG video writer"
    for k in range(frames):
        img = np.stack([120 + 80 * np.sin(2 * np.pi * (3 * xx + 2 * yy + 0.05 * k + c))
                        for c in range(3)], axis=-1)
        img += rng.normal(0, 4, img.shape).astype(np.float32)
        writer.write(np.clip(img, 0, 255).astype(np.uint8))
    writer.release()


def _decoded_sizes(root: Path) -> dict:
    """{file under root: (w, h) of an image, (frames, w, h) of a video}."""
    import cv2
    from PIL import Image

    out = {}
    for path in sorted(root.rglob("*")):
        if path.suffix in (".jpg", ".png"):
            with Image.open(path) as im:
                out[str(path.relative_to(root))] = im.size
        elif path.suffix == ".avi":
            cap = cv2.VideoCapture(str(path))
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            ok, frame = cap.read()
            cap.release()
            out[str(path.relative_to(root))] = (n, *(frame.shape[1::-1] if ok else (0, 0)))
    return out


def _bare_rate(model, batch, style, c_trg, reps=4) -> float:
    """The bare forward_random at the CLI's shape and batch, img/s."""
    model.forward_random(batch, style, c_trg)
    secs = [model.forward_random(batch, style, c_trg)[1] for _ in range(reps)]
    return len(batch) * reps / sum(secs)


def _profiled_pass(sampler, args, model, loader) -> dict:
    """Device busy over one per-target pass over the batches (one target,
    the one-deep pipeline as the CLI runs it), and its window."""
    sampler.sample(args, model, loader, trgs=[0])  # warm
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.sample(args, model, loader, trgs=[0])
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    busy = _device_busy_ms(prof)
    return dict(device_busy_ms=busy, window_ms=window * 1e3,
                device_idle_share=1.0 - busy / (window * 1e3))


def sample_cli_route(card: str, root: Path, route: str, ckpt_path: str) -> dict:
    """``sample_cli/<route>``: ``TestArguments().parse`` and ``Sampler().run``
    on the card; the files checked; the first batch against the bare
    forward_random; the CLI's rate beside the bare forward's, the loader
    alone, the JPEG encode alone and the idle share over a profiled pass."""
    phase = f"sample_cli/{route}"
    video = route == "video"
    data = root / ("in.avi" if video else "imgs")
    out_dir = root / "out" / route
    argv = ["--dataroot", str(data), "--resume", ckpt_path, "--result_dir", str(out_dir),
            *SAMPLE_ARGV, *SAMPLE_ROUTES[route]]
    args = TestArguments().parse(argv)
    sampler = CliSampler()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = sampler.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1024**3
    h, w = CLI_IMAGE
    k = ARGS["num_domains"]
    batches = (SAMPLE_FRAMES - 1 if video else SAMPLE_IMAGES) // SAMPLE_BATCH
    forwards = batches * k
    int8 = route == "bf16_int8"
    files = _decoded_sizes(Path(args.display_dir))
    if route == "grid":
        want = {"grid.png": ((1 + k) * w, batches * h)}
    elif video:
        want = {f"clip_{d}.avi": (batches * SAMPLE_BATCH, w, h) for d in CLI_DOMAINS}
    else:
        want = {os.path.join(str(t), f"image{t}_{i}_{j}.jpg"): (w, h)
                for t in range(k) for i in range(batches) for j in range(SAMPLE_BATCH)}
    assert files == want, f"{phase}: files {sorted(files.items())[:4]}"
    per_forward = INT8_PER_FORWARD if int8 else None
    if int8:
        got = int8_counts()
        assert got == {n: v * forwards for n, v in per_forward.items()}, f"{phase}: {got}"
    elif route != "grid":
        got = dict(zip(("moments", "adain"), counts()))
        assert got == dict(moments=MOMENTS_PER_FORWARD * forwards,
                           adain=ADAIN_PER_FORWARD * forwards), f"{phase}: {got}"
    else:
        got = dict(zip(("moments", "adain"), counts()))
    extra = {}
    if route != "grid":
        assert len(sampler.queued) == forwards, f"{phase}: {len(sampler.queued)} forwards"
        for _, out in sampler.queued:
            assert out.dtype == torch.bfloat16 and torch.isfinite(out).all(), f"{phase}: output"
        (batch, style, c_trg), first = sampler.queued[0]
        bare, _, _ = model.forward_random(batch, style, c_trg)
        first_err = (first.float() - bare.float()).abs().max().item()
        assert first_err <= MODEL_TOL["bf16"], f"{phase}: first batch vs forward_random {first_err}"
        extra = dict(first_batch_vs_forward_random=first_err,
                     cli_translations_per_s=sampler.translated / sampler.loop_seconds,
                     bare_forward_img_per_s=_bare_rate(model, batch, style, c_trg),
                     loop_s=sampler.loop_seconds, translated=sampler.translated)
        if not video:
            loader = sampler.load_dataset(args)
            t1 = time.perf_counter()
            n = sum(len(b) for b in loader)
            loader_rate = n / (time.perf_counter() - t1)
            imgs = first.float().cpu().numpy()
            scratch = root / "encode"
            t1 = time.perf_counter()
            save_images(imgs, [str(scratch / f"{j}.jpg") for j in range(len(imgs))])
            encode_rate = len(imgs) / (time.perf_counter() - t1)
            shutil.rmtree(scratch)
            extra.update(loader_img_per_s=loader_rate, jpeg_encode_img_per_s=encode_rate,
                         profiled_pass=_profiled_pass(sampler, args, model, loader))
    log(dict(phase=phase, card=card, batch=SAMPLE_BATCH, size=list(CLI_IMAGE), run_s=run_s,
             forwards=forwards, launches=got, per_forward=per_forward,
             calibration_s=sampler.calibration_seconds if int8 else None,
             peak_allocated_gb=peak_gb, files=len(files), **extra))
    del model, sampler
    torch.cuda.empty_cache()
    return got


def sample_cli(card: str) -> dict:
    """``sample_cli``: a seeded flagship AdaINModel saved with
    ``Model.save``, then the CLI's four routes over 8 seeded 540 x 960
    JPEGs (and a 16-frame video), under ``chiprun_out/`` and removed after.
    Returns the int8 route's launches."""
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="sample_cli_", dir=out_dir))
    try:
        t0 = time.perf_counter()
        write_jpeg_tree(root / "tree")
        (root / "imgs").mkdir()
        for i, path in enumerate(sorted((root / "tree" / "train").rglob("*.jpg"))[:SAMPLE_IMAGES]):
            shutil.move(str(path), str(root / "imgs" / f"img{i}.jpg"))
        shutil.rmtree(root / "tree")
        write_video(root / "in.avi", SAMPLE_FRAMES)
        ckdir = root / "ckpt"
        trainer = AdaINModel(default_train_args(checkpoint_dir=str(ckdir), logdir=None,
                                                **TRAIN_ARGS))
        trainer.save(0)
        del trainer
        torch.cuda.empty_cache()
        log(dict(phase="sample_cli/data", images=SAMPLE_IMAGES, frames=SAMPLE_FRAMES,
                 size=list(CLI_IMAGE), seconds=time.perf_counter() - t0))
        launched = {}
        for route in SAMPLE_ROUTES:
            got = sample_cli_route(card, root, route, str(ckdir / "model_0.ckpt"))
            if route == "bf16_int8":
                launched = got
        return launched
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ----------------------------------------------------------- model surface --

# model_surface: the rest of the flag surface at ARGS (256 px, dim 64,
# latent 8, 4 domains, B=8, seed 0). The nearest and pixelshuffle up blocks'
# 3x3 convs run kernel 4 under int8 (the JAX Conv2d routes them through
# int8_conv3x3_ste): (NCHW input, Co) of each, by path and block
SURFACE_CONV3X3 = [
    ("AdaINModel nearest up0", (B, 256, 128, 128), 128),
    ("AdaINModel nearest up1", (B, 128, 256, 256), 64),
    ("AdaINModel pixelshuffle up0", (B, 256, 64, 64), 512),
    ("AdaINModel pixelshuffle up1", (B, 128, 128, 128), 256),
    ("BaseModel B nearest dec2", (B, 276, 128, 128), 138),
    ("BaseModel B nearest dec3", (B, 146, 256, 256), 73),
    ("BaseModel B pixelshuffle dec2", (B, 276, 64, 64), 552),
    ("BaseModel B pixelshuffle dec3", (B, 146, 128, 128), 292),
]
# int8 launches per AdaINModel forward with a nearest or pixelshuffle tail,
# as the JAX package routes them (tests/test_torch_surface_models.py counts
# its calls): the two up convs on kernel 4, no transposed conv and no head
# kernel (the 7x7 tanh head is float), moments for the stem's deferred
# instance norm and each up block's LayerNorm
SURFACE_INT8_PER_FORWARD = {"int8_downconv": 2, "int8_resblock": 8, "int8_conv3x3": 2,
                            "int8_deconv": 0, "head": 0, "moments": 3}
SURFACE_UP_TYPES = ("transpose", "nearest", "pixelshuffle")
SURFACE_BATCH_NORM = dict(enc_norm="batch", dec_norm="batch")
# the small steps against the CPU: AdaINModel's and BaseModel B's
# resblocks route as with the transposed tail
SURFACE_SMALL_STEPS = [
    (AdaINModel, dict(up_type="pixelshuffle", dec_norm="batch", init_type="orthogonal"),
     FUSED_PER_STEP),
    (BaseModel, dict(BASE_CONFIGS["B"], up_type="nearest"), SMALL_PER_STEP["B"]),
]


def check_surface_conv3x3(dtype_name: str) -> list:
    """Kernel 4 at each up conv's shape, zero padding, bias, no prologue or
    statistics, as the up blocks call it: operands and int32 sums, y, and a
    second call equal to the plain version's; ms per launch beside the
    bound and cuDNN's bf16 conv at the same shape."""
    dtype = DTYPES[dtype_name]
    esize = torch.finfo(dtype).bits // 8
    rows = []
    for i, (where, shape, co) in enumerate(SURFACE_CONV3X3):
        b, c, h, w = shape
        numel = math.prod(shape)
        sets = copies(lambda j: (_randn(shape, dtype, 500 + 10 * i + j),), esize * numel)
        x = sets[0][0]
        weight, bias = _card_weight((co, c, 3, 3), 600 + i), _card_weight((co,), 700 + i, 0.1)
        qc = kq.quant_conv(weight, bias, x.float().abs().amax(), 1, None)
        exact = _check_exact(x, qc, None)
        got, again = kq.conv3x3(x, qc), kq.conv3x3(x, qc)
        want = kq.conv_plain(x, qc, None, False)
        torch.cuda.synchronize()
        assert got.dtype == dtype, f"model_surface conv3x3 {shape}: y is {got.dtype}"
        err = (got.float() - want.float()).abs().max().item()
        assert err == 0.0, f"model_surface conv3x3 {shape} -> {co}: differs by {err}"
        assert torch.equal(got, again), f"model_surface conv3x3 {shape}: two calls differ"
        macs = b * c * co * 9 * h * w
        nbytes = esize * (numel + got.numel()) + qc.w.numel()
        b_ms, by = bound(nbytes, 2 * macs, INT8_OPS)
        wb = weight.bfloat16()
        ms = device_ms(lambda t: kq.conv3x3(t, qc), sets)
        rows.append(dict(
            path=where, shape=list(shape), co=co, cp=qc.cp, rows=qc.w.shape[0], **exact,
            max_abs_err=err, tol=0.0, bit_equal_repeat=True, macs=macs, ms=ms,
            plain_ms=device_ms(lambda t: kq.conv_plain(t, qc, None, False), sets, iters=3),
            bf16_cudnn_ms=device_ms(lambda t: F.conv2d(t, wb, None, 1, 1),
                                    [(t[0].bfloat16(),) for t in sets]),
            bound_ms=b_ms, bound_by=by, bound_share=b_ms / ms))
        del sets, x, got, again, want
    torch.cuda.empty_cache()
    log(dict(phase="model_surface/int8_conv3x3", dtype=dtype_name, shapes=rows))
    return rows


def surface_serve(card: str) -> dict:
    """AdaINModel at ARGS with each up type: the float bf16 model, int8 at
    compute dtype f32 and int8 at bf16, of the same weights, calibrated on
    the seeded batches and served in turns (every up type's float, int8 f32
    and int8 bf16 requests, twice over, in reverse the second time), the
    launch counts set to 0 just before and read just after. Every int8
    forward of a nearest or pixelshuffle tail launches
    SURFACE_INT8_PER_FORWARD (the transposed tail INT8_PER_FORWARD); every
    output is finite and in [-1, 1], int8 above 25 dB from the float bf16
    output, and within 1e-5 (f32) or 2^-7 (bf16) of the same forward through
    the plain versions; then each up type's int8 f32 forward once more
    under ``devtime.measure``: CUDA-event ms and its kernels' device ms.
    Returns kernel 4's launches by compute dtype."""
    phase = "model_surface/serve"
    calib = calibration_batches(ARGS)
    _, dev = request_inputs(ARGS, seed=1)
    x = (dev["img"], dev["z"], dev["c"])
    shape = (B, ARGS["crop_size"], ARGS["crop_size"], 3)
    models = {}
    for up in SURFACE_UP_TYPES:
        for kind, dtype in (("float_bf16", "bfloat16"), ("int8_f32", "float32"),
                            ("int8_bf16", "bfloat16")):
            m = AdaINModel(default_test_args(compute_dtype=dtype, up_type=up, **ARGS))
            if kind.startswith("int8"):
                m.calibrate_int8(*calib)
            models[up, kind] = m
    for m in models.values():  # warm-up: quantizes the weights, cuDNN picks its algorithms
        m.forward_random(*x)
    zero_counts()
    launched = {k: dict.fromkeys(SURFACE_INT8_PER_FORWARD, 0) for k in ("int8_f32", "int8_bf16")}
    secs = {key: [] for key in models}
    outs = {}
    order = [(up, kind) for up in SURFACE_UP_TYPES for kind in ("float_bf16", "int8_f32",
                                                                "int8_bf16")]
    for key in order + order[::-1]:
        up, kind = key
        for _ in range(2):
            before = int8_counts()
            out, seconds, _ = models[key].forward_random(*x)
            delta = {k: v - before[k] for k, v in int8_counts().items()}
            if kind.startswith("int8"):
                want = INT8_PER_FORWARD if up == "transpose" else SURFACE_INT8_PER_FORWARD
                assert delta == want, f"{phase} {key}: int8 launches per forward {delta}"
                if up != "transpose":
                    for k, v in delta.items():
                        launched[kind][k] += v
            secs[key].append(seconds)
            outs[key] = out
    summary = {}
    for up in SURFACE_UP_TYPES:
        row = {}
        for kind in ("float_bf16", "int8_f32", "int8_bf16"):
            out = outs[up, kind]
            check_image(out.float(), shape, f"{phase} {up} {kind}")
            row[f"img_per_s_{kind}"] = B * len(secs[up, kind]) / sum(secs[up, kind])
            row[f"request_s_{kind}"] = secs[up, kind]
        for kind, tol in (("int8_f32", HEAD_TOL), ("int8_bf16", khead.BF16_TOL)):
            mse = (outs[up, kind].float() - outs[up, "float_bf16"].float()).square().mean().item()
            psnr = 10 * math.log10(4.0 / max(mse, 1e-12))
            assert psnr > PSNR_MIN_DB, f"{phase} {up} {kind}: {psnr} dB from float bf16"
            with plain_kernels():
                plain_out, _, _ = models[up, kind].forward_random(*x)
            err, share = _flips(outs[up, kind], plain_out)
            assert err <= tol, f"{phase} {up} {kind}: kernels vs plain: max {err}"
            row[f"psnr_{kind}_vs_float_bf16_db"] = psnr
            row[f"max_abs_err_{kind}_vs_plain"] = err
            row[f"tol_{kind}_vs_plain"] = tol
        summary[up] = row
    # where the int8 f32 forward's device time goes, by kernel (utils/devtime.py)
    for up in SURFACE_UP_TYPES:
        per_call, kernels = devtime.measure({up: lambda: models[up, "int8_f32"].forward_random(*x)})
        top = sorted(kernels[up].items(), key=lambda kv: -kv[1])[:8]
        summary[up]["int8_f32_device"] = dict(
            event_ms=per_call[up], kernel_ms=sum(kernels[up].values()),
            top=[dict(kernel=k[:90], ms=v) for k, v in top])
    log(dict(phase=phase, model="AdaINModel", card=card, batch=B, requests_per_kind=4,
             psnr_min_db=PSNR_MIN_DB, per_forward=dict(
                 transpose=INT8_PER_FORWARD, nearest=SURFACE_INT8_PER_FORWARD,
                 pixelshuffle=SURFACE_INT8_PER_FORWARD),
             launches_nearest_and_pixelshuffle=launched, by_up_type=summary))
    del models, outs
    torch.cuda.empty_cache()
    return {k: v["int8_conv3x3"] for k, v in launched.items()}


def surface_batch_norm(card: str) -> None:
    """BaseModel A with ``--enc_norm batch --dec_norm batch``: its small
    forward on the card against the CPU in f32 and bf16, then float bf16 at
    ARGS (finite, in [-1, 1]; no kernel of the flagship's norms: batch norm
    is two plain reductions, as in the JAX package)."""
    for dtype_name in DTYPES:
        check_small_against_cpu(dtype_name, BaseModel, SURFACE_BATCH_NORM)
    model = BaseModel(default_test_args(compute_dtype="bfloat16", **SURFACE_BATCH_NORM, **ARGS))
    _, dev = request_inputs(ARGS, seed=1)
    model.forward_random(dev["img"], dev["z"], dev["c"])
    secs = []
    for _ in range(3):
        out, seconds, _ = model.forward_random(dev["img"], dev["z"], dev["c"])
        secs.append(seconds)
    check_image(out.float(), (B, ARGS["crop_size"], ARGS["crop_size"], 3),
                "model_surface/batch_norm BaseModel A bf16")
    log(dict(phase="model_surface/batch_norm", model="BaseModel", flags=SURFACE_BATCH_NORM,
             card=card, dtype="bf16", batch=B, request_s=secs,
             img_per_s=B * len(secs) / sum(secs)))
    del model
    torch.cuda.empty_cache()


def surface_train(card: str) -> None:
    """The fused main step at bench.py's training config with ``--up_type
    nearest`` beside the transposed tail, from the same seeded weights: a
    warm-up and two timed main steps each, in turns (transpose, nearest,
    nearest, transpose), each asserted to launch kernels 9/10 as
    FUSED_GAN_PER_STEP; losses finite. Prints it/s and peak memory."""
    phase = "model_surface/train"
    _, batch = train_batch(TRAIN_ARGS, seed=31)
    secs, peak, firsts = {}, {}, {}
    for up in ("transpose", "nearest"):
        model = AdaINModel(default_train_args(**FUSED_GAN_ARGS, up_type=up))
        model.generator.manual_seed(1)
        torch.cuda.reset_peak_memory_stats()
        with recording_moments(collections.Counter()) as moments_calls:
            first, _ = _timed_step(model, batch, 0)
        steps, s = _timed_main_steps(model, batch, (3, 6), FUSED_GAN_PER_STEP,
                                     sum(moments_calls.values()), f"{phase} {up}")
        _check_finite(f"{phase} {up}", first, *steps)
        secs[up], peak[up], firsts[up] = s, torch.cuda.max_memory_allocated() / 1024**3, first
        del model
        torch.cuda.empty_cache()
    log(dict(phase=phase, model="AdaINModel", card=card,
             config={k: v for k, v in FUSED_GAN_ARGS.items() if k != "seed"},
             per_main_step=FUSED_GAN_PER_STEP,
             **{f"main_it_per_s_{up}": len(s) / sum(s) for up, s in secs.items()},
             **{f"main_step_s_{up}": s for up, s in secs.items()},
             **{f"peak_memory_allocated_gb_{up}": g for up, g in peak.items()},
             first_step_losses_nearest=firsts["nearest"]))


def model_surface(card: str, t0: float) -> dict:
    """``model_surface``: kernel 4 at the up convs' shapes in f32 and bf16,
    AdaINModel served with each up type, BaseModel A with batch norm, the
    small steps against the CPU, the fused main step with a nearest tail.
    Returns, by kernel 4's entry name, its rows at the new shapes and its
    launches on AdaINModel's nearest and pixelshuffle paths."""
    rows = {"int8_conv3x3": check_surface_conv3x3("f32"),
            "int8_conv3x3/bf16": check_surface_conv3x3("bf16")}
    launched = surface_serve(card)
    surface_batch_norm(card)
    for model_cls, flags, per_step in SURFACE_SMALL_STEPS:
        check_small_train_against_cpu(model_cls, flags, per_step, random_draws=True,
                                      loss_floor=VARIANT_LOSS_FLOOR)
    surface_train(card)
    log(dict(phase="seconds", upto="model_surface", seconds=time.perf_counter() - t0))
    return {"int8_conv3x3": dict(shapes=rows["int8_conv3x3"],
                                 launches_adain_path=launched["int8_f32"]),
            "int8_conv3x3/bf16": dict(shapes=rows["int8_conv3x3/bf16"],
                                      launches_adain_path=launched["int8_bf16"])}


# ---------------------------------------------------------------- evaluate --

# evaluate: the evaluate CLI (``parse_args`` and ``Evaluator.run``, as its
# ``main`` does) over a seeded validation tree of 4 domains x 64 JPEGs at
# 360 x 640, which the flagship's load 286 / crop 256 resize; batch 8, bf16,
# 2 styles: per run 4 domains x 8 chunks x 2 styles forwards
EVAL_PER_DOMAIN, EVAL_IMAGE = 64, (360, 640)
EVAL_ARGV = ["--model", "AdaINModel", "--dim", "64", "--latent_dim", "8", "--num_domains", "4",
             "--load_size", "286", "--crop_size", "256", "--compute_dtype", "bfloat16",
             "--seed", "0", "--eval_batch", str(B), "--num_styles", "2"]
EVAL_RUNS = {"inception": [], "pixel": ["--fid_extractor", "pixel"],
             "int8_pixel": ["--int8", "--fid_extractor", "pixel"]}
EVAL_FORWARDS = len(CLI_DOMAINS) * (EVAL_PER_DOMAIN // B) * 2
# kernels against plain versions, both in bf16 (the AdaIN kernel's output
# one bf16 step from the plain version's, the int8 path's 2^-7): the FID
# accumulators (feature sums and sums of outer products) within EVAL_ACC_TOL
# of their largest magnitude, pixel FID and LPIPS diversity within
# EVAL_REL_TOL relative
EVAL_ACC_TOL, EVAL_REL_TOL = 1e-2, 2e-2
# the small evaluate on the card against the CPU (f32, TF32 off; the
# model's outputs within CPU_TOL): pixel FID and LPIPS diversity relative,
# the feature sums of their largest magnitude
SMALL_EVAL = dict(crop_size=32, load_size=36, dim=8, latent_dim=4, num_domains=2, seed=0)
SMALL_EVAL_TOL = 1e-3
IDENTITY_FID_MAX = 1e-3  # tests/test_evaluate.py's bar


def write_val_tree(root: Path, seed: int = 1) -> int:
    """``root/val/<domain>/img{i}.jpg``: 4 domains x 64 seeded 360 x 640
    JPEGs, ``write_jpeg_tree``'s pattern drawn at a quarter of the size and
    resized up, with mild noise and a tint per domain. Returns the bytes."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = EVAL_IMAGE
    yy, xx = _grid(h // 4, w // 4)
    total = 0
    for k, name in enumerate(CLI_DOMAINS):
        d = root / "val" / name
        d.mkdir(parents=True)
        tint = np.asarray([20.0, 0.0, -20.0], np.float32) * (k - 1.5)
        for i in range(EVAL_PER_DOMAIN):
            small = Image.fromarray(np.clip(_smooth_pattern(rng, yy, xx) + tint, 0, 255).astype(
                np.uint8))
            img = np.asarray(small.resize((w, h), Image.BICUBIC), np.float32)
            img = img + rng.normal(0, 6, (h, w, 1)).astype(np.float32)
            path = d / f"img{i}.jpg"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path, quality=90)
            total += path.stat().st_size
    return total


class CliEvaluator(Evaluator):
    """The evaluate CLI's Evaluator with its work recorded: the launch counts
    set to 0 as a run starts and after its calibration, the model kept; with
    ``score_fid=False`` (a run that is only compared) FID's host sqrtm is
    skipped and reads nan."""

    def __init__(self, score_fid: bool = True):
        super().__init__()
        self.score_fid = score_fid

    def load_model(self, args):
        self.model = super().load_model(args)
        return self.model

    def calibrate(self, args, model):
        quant = super().calibrate(args, model)
        zero_counts()
        return quant

    def score(self, fid, diversity):
        if self.score_fid:
            return super().score(fid, diversity)
        return {"fid": float("nan"), "lpips_diversity": float(np.mean(diversity))}

    def run(self, args):
        zero_counts()
        return super().run(args)


def _moments_of(fid) -> dict:
    """A domain's FID accumulators as means: each side's mean feature and
    mean outer product."""
    a = fid.accumulators()
    return {k: a[k] / a["n"] for k in ("train_total", "train_sigma", "test_total", "test_sigma")}


def _compare_runs(phase, ev, ev_plain, results, plain, pixel: bool) -> dict:
    """The kernel run against its plain-kernel repeat, per domain."""
    out = {}
    for d in results:
        got, want = _moments_of(ev.fids[d]), _moments_of(ev_plain.fids[d])
        acc = max(float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
                  for k in got)
        div = abs(results[d]["lpips_diversity"] - plain[d]["lpips_diversity"]) / abs(
            plain[d]["lpips_diversity"])
        fid = (abs(results[d]["fid"] - plain[d]["fid"]) / abs(plain[d]["fid"])) if pixel else None
        assert acc <= EVAL_ACC_TOL, f"{phase} {d}: accumulators {acc} > {EVAL_ACC_TOL}"
        assert div <= EVAL_REL_TOL, f"{phase} {d}: LPIPS diversity {div} > {EVAL_REL_TOL}"
        assert fid is None or fid <= EVAL_REL_TOL, f"{phase} {d}: pixel FID {fid}"
        out[d] = dict(accumulators_rel=acc, lpips_diversity_rel=div, pixel_fid_rel=fid)
    return out


def evaluate_run(card: str, root: Path, run: str, ckpt_path: str) -> dict:
    """``evaluate/<run>``: the CLI on the card, its launches per forward, its
    results against the same run through the plain versions, translations
    scored per second beside the bare forward. Returns the launches, the
    evaluator and its args."""
    phase = f"evaluate/{run}"
    flags = EVAL_RUNS[run]
    int8 = "--int8" in flags

    def argv(tag):
        return ["--dataroot", str(root / "data"), "--resume", ckpt_path,
                "--result_dir", str(root / "out" / tag), *EVAL_ARGV, *flags]

    args = parse_args(argv(run))
    ev = CliEvaluator()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = ev.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1024**3
    if int8:
        got = int8_counts()
        want = {n: v * EVAL_FORWARDS for n, v in INT8_PER_FORWARD.items()}
        got["adain"] = kadain.adain.launches
        want["adain"] = 0
    else:
        got = dict(zip(("moments", "adain"), counts()))
        want = dict(moments=MOMENTS_PER_FORWARD * EVAL_FORWARDS,
                    adain=ADAIN_PER_FORWARD * EVAL_FORWARDS)
    assert got == want, f"{phase}: launches {got} != {want}"
    assert ev.scored == EVAL_FORWARDS * B, f"{phase}: {ev.scored} translations scored"
    for d, r in results.items():
        assert np.isfinite(r["fid"]) and np.isfinite(r["lpips_diversity"]), f"{phase} {d}: {r}"
    launched = int8_counts() if int8 else counts()
    with plain_kernels():
        ev_plain = CliEvaluator(score_fid=run != "inception")
        plain = ev_plain.run(parse_args(argv(f"{run}_plain")))
    assert (int8_counts() if int8 else counts()) == launched, f"{phase}: the plain run launched"
    agree = _compare_runs(phase, ev, ev_plain, results, plain, pixel=run != "inception")
    _, dev = request_inputs(ARGS, seed=1)
    bare = _bare_rate(ev.model, dev["img"], dev["z"], dev["c"])
    sqrtm_s = sum(ev.fid_seconds.values())
    log(dict(phase=phase, card=card, batch=B, forwards=EVAL_FORWARDS, launches=got,
             per_forward=INT8_PER_FORWARD if int8 else dict(moments=MOMENTS_PER_FORWARD,
                                                            adain=ADAIN_PER_FORWARD),
             results=results, plain_results=plain, kernel_vs_plain=agree,
             tol=dict(accumulators=EVAL_ACC_TOL, relative=EVAL_REL_TOL),
             scored=ev.scored, loop_s=ev.loop_seconds, fid_compute_s=ev.fid_seconds,
             scored_translations_per_s=ev.scored / ev.loop_seconds,
             scored_per_s_without_fid_compute=ev.scored / (ev.loop_seconds - sqrtm_s),
             bare_forward_img_per_s=bare, run_s=run_s, peak_allocated_gb=peak_gb,
             calibration_s=ev.calibration_seconds if int8 else None))
    return got, ev, args


def _profiled_domain(ev, args) -> dict:
    """Device busy over one domain of a run (the one-deep pipeline as the CLI
    runs it, FID's host compute left out), and its window."""
    from masterthesis_tpu_torch.data.transforms import TrainTransform
    from masterthesis_tpu_torch.evaluate import mode_dir

    domains = sorted(os.listdir(mode_dir(args)))
    transform = TrainTransform(args.load_size, args.crop_size, train=False)
    lpips_fn, extractor = ev.metric_nets(args)
    g = ev.generator(args)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.evaluate_domain(args, ev.model, domains, 0, transform, lpips_fn, extractor, g)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    busy = _device_busy_ms(prof)
    return dict(device_busy_ms=busy, window_ms=window * 1e3,
                device_idle_share=1.0 - busy / (window * 1e3))


def _conv_macs(model, *inputs) -> int:
    """Multiply-adds of ``model``'s convs on ``inputs`` (output elements
    times each one's kernel volume)."""
    macs = []
    hooks = [m.register_forward_hook(lambda m, i, o: macs.append(o.numel() * m.weight[0].numel()))
             for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model(*inputs)
    for h in hooks:
        h.remove()
    return sum(macs)


def metric_rates(card: str) -> None:
    """InceptionV3 (2048-d, the 299 resize) img/s and LPIPS pairs/s alone, B=8
    f32 at 256 x 256 (CUDA events), each beside its bound: its convs'
    operations over the f32 peak. FID's host seconds per domain are the
    ``inception`` run's ``fid_compute_s``."""
    from masterthesis_tpu_torch.metrics.inception import InceptionV3
    from masterthesis_tpu_torch.metrics.lpips import LPIPS

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        extract = make_inception_extractor()
        dist = make_lpips_fn()
    sets = copies(lambda i: (_randn((B, 256, 256, 3), torch.float32, 70 + i, 0.3, 0.5),),
                  B * 256 * 256 * 3 * 4)
    inception_ms = device_ms(extract, sets, iters=10)
    pairs = [(a, b) for (a,), (b,) in zip(sets, sets[1:] + sets[:1])]
    lpips_ms = device_ms(dist, pairs, iters=10)
    inception_bound, _ = bound(0, 2 * _conv_macs(InceptionV3().cuda(), sets[0][0]))
    lpips_bound, _ = bound(0, 2 * _conv_macs(LPIPS().cuda(), *pairs[0]))
    del sets, pairs
    torch.cuda.empty_cache()
    log(dict(phase="evaluate/metric_nets", card=card, batch=B, size=[256, 256],
             inception_ms=inception_ms, inception_img_per_s=B / inception_ms * 1e3,
             inception_bound_ms=inception_bound, lpips_ms=lpips_ms,
             lpips_pairs_per_s=B / lpips_ms * 1e3, lpips_bound_ms=lpips_bound,
             bound_by="operations (f32 convs)", host_cpus=os.cpu_count()))


class _Codes:
    """The same seeded style codes on any device, as ``get_z_random``."""

    def __init__(self, n: int, latent: int, device):
        rng = np.random.default_rng(6)
        self.codes = iter([torch.from_numpy(rng.standard_normal((B, latent)).astype(
            np.float32)).to(device) for _ in range(n)])

    def __call__(self, n, generator=None):
        return next(self.codes)[:n]


def small_evaluate_against_cpu(root: Path) -> None:
    """The evaluate loop at 32 px (dim 8, 2 domains x 64 images, f32, pixel
    FID) on the card and on the CPU, the same seeded weights and codes."""
    from PIL import Image

    rng = np.random.default_rng(5)
    for d, base in (("cloud", 90), ("fog", 150)):
        (root / "val" / d).mkdir(parents=True)
        for i in range(EVAL_PER_DOMAIN):
            arr = np.clip(rng.normal(base, 40, (40, 40, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(root / "val" / d / f"img{i:02d}.jpg")
    args = default_test_args(**SMALL_EVAL, dataroot=str(root), mode="val", fid_extractor="pixel")
    runs = {}
    for device in ("cuda", "cpu"):
        model = AdaINModel(args, device=device)
        model.get_z_random = _Codes(2 * EVAL_PER_DOMAIN // B * 2, SMALL_EVAL["latent_dim"], device)
        ev = Evaluator(device=device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs[device] = (ev.evaluate(args, model), ev)
    (got, ev_card), (want, ev_cpu) = runs["cuda"], runs["cpu"]
    err = {}
    for d in want:
        for k in ("fid", "lpips_diversity"):
            err[f"{d}/{k}"] = abs(got[d][k] - want[d][k]) / abs(want[d][k])
        a, b = ev_card.fids[d].accumulators(), ev_cpu.fids[d].accumulators()
        for k in ("train_total", "test_total"):
            err[f"{d}/{k}"] = float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
    log(dict(phase="evaluate/card_vs_cpu", results=got, cpu_results=want, rel_err=err,
             tol=SMALL_EVAL_TOL))
    assert max(err.values()) <= SMALL_EVAL_TOL, f"evaluate card vs CPU: {err}"


class _CardIdentity:
    """A model whose translation is its input, on the card."""

    device = torch.device("cuda")

    def get_z_random(self, n, generator=None):
        return torch.zeros((n, 8), device="cuda")

    def forward_random(self, img, z, trg):
        return img, 0.0, 0.0


def identity_fid(root: Path) -> None:
    """Two domains of the same 64 files and the identity model: the
    translated side equals the target's reals, so FID must be ~0."""
    for d in ("cloud", "fog"):
        (root / "val" / d).mkdir(parents=True)
        for f in sorted((root.parent / "data" / "val" / "cloud").iterdir()):
            shutil.copy(f, root / "val" / d / f.name)
    args = default_test_args(**{**ARGS, "num_domains": 2}, load_size=286, dataroot=str(root),
                             mode="val", fid_extractor="pixel")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = evaluate_model(args, _CardIdentity(), num_styles=1)
    log(dict(phase="evaluate/identity", results=results, max_fid=IDENTITY_FID_MAX))
    for d, r in results.items():
        assert abs(r["fid"]) < IDENTITY_FID_MAX, f"identity FID {d}: {r['fid']}"


def evaluate_phase(card: str, t0: float) -> dict:
    """``evaluate``: a seeded flagship AdaINModel saved with ``Model.save``,
    the CLI's three runs over the validation tree (under ``chiprun_out/``,
    removed after), each against its plain-kernel repeat; the metric nets
    alone; the identity model; a small evaluate against the CPU. Returns,
    by kernel entry name, its launches per run."""
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="evaluate_", dir=out_dir))
    try:
        t1 = time.perf_counter()
        nbytes = write_val_tree(root / "data")
        ckdir = root / "ckpt"
        AdaINModel(default_train_args(checkpoint_dir=str(ckdir), logdir=None,
                                      **TRAIN_ARGS)).save(0)
        torch.cuda.empty_cache()
        log(dict(phase="evaluate/data", images=EVAL_PER_DOMAIN * len(CLI_DOMAINS),
                 size=list(EVAL_IMAGE), bytes=nbytes, seconds=time.perf_counter() - t1))
        launched = {}
        for run in EVAL_RUNS:
            got, ev, args = evaluate_run(card, root, run, str(ckdir / "model_0.ckpt"))
            if run == "pixel":
                log(dict(phase="evaluate/profiled_domain", card=card,
                         **_profiled_domain(ev, args)))
            for name, n in got.items():  # every route of this phase runs in bf16
                launched.setdefault(f"{name}/bf16", {})[run] = n
            del ev
            torch.cuda.empty_cache()
        metric_rates(card)
        identity_fid(root / "identity")
        small_evaluate_against_cpu(root / "small")
        log(dict(phase="seconds", upto="evaluate", seconds=time.perf_counter() - t0))
        return launched
    finally:
        shutil.rmtree(root, ignore_errors=True)


def profile_train(model_cls=AdaINModel, flags=None) -> None:
    """Device time by kernel over one main step (``--profile``)."""
    model = model_cls(default_train_args(**{**TRAIN_ARGS, **(flags or {})}))
    _, batch = train_batch(TRAIN_ARGS, seed=31)
    model.optimize_parameters(batch, 0)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds = _timed_step(model, batch, 3)
    what = "train main step"
    if model_cls is not AdaINModel or flags:
        what = f"{model_cls.__name__} {flags} {what}"
    _log_profile(prof, what, seconds, 25)
    del model
    torch.cuda.empty_cache()


def _log_profile(prof, what, seconds, top_n=15) -> None:
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows[e.key] = rows.get(e.key, 0.0) + us / 1e3
    total = sum(rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:top_n]
    # one stream, so kernel times do not overlap; the profiler's own host
    # overhead lengthens the wall time, so the idle share is an upper bound
    log(dict(phase="profile", dtype=what, request_s=seconds, device_ms_total=total,
             device_idle_share=1.0 - total / (seconds * 1e3),
             top_kernels_ms=[[k[:90], v] for k, v in top]))


def profile(dtype_name: str, int8: bool = False, model_cls=AdaINModel, flags=None) -> None:
    """Device time by kernel over one forward_random (``--profile``)."""
    args = default_test_args(compute_dtype=compute_dtype(dtype_name), **(flags or {}), **ARGS)
    model = model_cls(args)
    if int8:
        model.calibrate_int8(*calibration_batches(ARGS))
    _, dev = request_inputs(ARGS, seed=1)
    model.forward_random(dev["img"], dev["z"], dev["c"])
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, seconds, _ = model.forward_random(dev["img"], dev["z"], dev["c"])
    what = "int8" if int8 else dtype_name
    _log_profile(prof, what if model_cls is AdaINModel else f"{model_cls.__name__} {flags} {what}",
                 seconds)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(card)
    log(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
             device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
             cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
             matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
             cudnn_benchmark=torch.backends.cudnn.benchmark))

    t0 = time.perf_counter()
    logs = build.build()
    log(dict(phase="build", seconds=time.perf_counter() - t0, built=sorted(logs)))
    for name, text in logs.items():
        fn = ""  # ptxas names each kernel (mangled) before its spills and registers
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for", 1)[1].strip()
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                log(f"  {name}: {fn} | {line.strip()}")

    entries = []
    for dtype_name, dtype in DTYPES.items():
        entries.append(check_moments(dtype_name, dtype))
        entries.append(check_adain(dtype_name, dtype))
    int8_entries = [check_int8_conv("down"), check_int8_resblock(), check_int8_conv("conv3x3"),
                    check_int8_conv("deconv"), check_head()]
    bf16_entries = [check_int8_conv("down", "bf16"), check_int8_resblock("bf16"),
                    check_int8_conv("conv3x3", "bf16"), check_int8_conv("deconv", "bf16"),
                    check_head("bf16")]
    check_cli_shapes()
    int8_breakdown()
    torch.cuda.empty_cache()
    train_entries = [check_resblock("fwd"), check_resblock("bwd")]
    resblock_breakdown()
    for dtype_name in DTYPES:
        check_small_against_cpu(dtype_name)
    check_small_int8_against_cpu()
    check_small_train_against_cpu()
    for dtype_name in DTYPES:
        m, a = serve(dtype_name, card)
        for e in entries:
            if e["name"] == f"moments/{dtype_name}":
                e["launches"] = m
            elif e["name"] == f"adain/{dtype_name}":
                e["launches"] = a
    launched = int8_serve(card)
    base_launched = base_serve(card)  # kernel 4 runs on BaseModel's path only
    for e in int8_entries:
        e["launches"] = (base_launched if e["name"] == "int8_conv3x3" else launched)[e["name"]]
    entries += int8_entries
    launched = int8_serve_bf16(card)
    for e in bf16_entries:
        e["launches"] = launched[e["name"].split("/")[0]]
    entries += bf16_entries
    log(dict(phase="seconds", upto="int8_serve_bf16", seconds=time.perf_counter() - t0))
    sample_cli(card)
    log(dict(phase="seconds", upto="sample_cli", seconds=time.perf_counter() - t0))
    launched = train(card)
    for e in train_entries:
        e["launches"] = launched[e["name"]]
    entries += train_entries
    per_main_step = {"train": launched["per_main_step"]}
    log(dict(phase="seconds", upto="train", seconds=time.perf_counter() - t0))
    base_launched = base_train(card, {e["name"]: e["ms_per_call"] for e in train_entries})
    per_main_step.update({f"base_train/{k}": v["per_main_step"] for k, v in base_launched.items()})
    log(dict(phase="seconds", upto="base_train", seconds=time.perf_counter() - t0))
    variants, fused_rates = train_variants(card, {e["name"]: e["ms_per_call"]
                                                  for e in train_entries})
    per_main_step.update(variants)
    log(dict(phase="seconds", upto="train_variants", seconds=time.perf_counter() - t0))
    per_main_step.update(train_cli(card, fused_rates, variants["train_variants/fused"]))
    log(dict(phase="seconds", upto="train_cli", seconds=time.perf_counter() - t0))
    for name, surface in model_surface(card, t0).items():
        next(e for e in entries if e["name"] == name)["model_surface"] = surface
    # the evaluate CLI's launches per run (4 domains x 8 chunks x 2 styles forwards)
    for name, runs in evaluate_phase(card, t0).items():
        next(e for e in entries if e["name"] == name)["evaluate"] = dict(
            forwards_per_run=EVAL_FORWARDS, launches=runs)
    # each training phase's launches (moments also ms, bound ms and error)
    # per main step, beside the serving launches in "launches"
    for e in entries:
        if e["name"] in ("moments/f32", "moments/bf16", "resblock_fwd", "resblock_bwd"):
            e["per_main_step"] = {ph: v.get(e["name"], dict(launches=0))
                                  for ph, v in per_main_step.items()}
    if "--profile" in argv:
        for dtype_name in DTYPES:
            profile(dtype_name)
        profile("f32", int8=True)
        profile("f32", True, BaseModel, BASE_CONFIGS["A"])
        profile_train()
        profile_train(flags=dict(gan_step="fused"))
        for flags in BASE_CONFIGS.values():
            profile_train(BaseModel, flags)
    for e in entries:
        assert e["launches"], f"{e['name']} was not launched on the main path"
    log(dict(phase="seconds", upto="end", seconds=time.perf_counter() - t0))

    log(card)
    log({"kernels": entries})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
