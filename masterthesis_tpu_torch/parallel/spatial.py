"""The (data, spatial) sharded float forward of ``make_mesh_2d``.

The port of what ``spatial_sharding`` asks of XLA in the JAX package
(``masterthesis_tpu/parallel/mesh.py``): NHWC images with the batch split
over the mesh's "data" axis and the height over its "spatial" axis, each
rank holding contiguous rows. GSPMD partitions every conv and inserts the
halo exchanges; here :func:`forward_random` walks AdaINModel's content
encoder and decoder (the flagship forward, ``_forward_random_impl``) and
does both itself:

- Halo rows come from the neighbouring ranks before each conv
  (:func:`halo_rows`): 3 on each side for the 7x7 stem, 1 for each 3x3
  stride-1 resblock conv, 1 above for a 3x3 stride-2 down conv (a shard
  starts on an even row), 1 below for the k3/s2/p1/op1 transposed conv,
  none for the 1x1 head. Reflect padding applies at the image's true top
  and bottom only; the width is padded as on one device.
- Every norm reduces across the "spatial" group: the moments kernel
  (kernel 1) gives each rank's per-(sample, channel) sums, one all-reduce
  adds them, and instance norm and the tail's LayerNorm normalize with the
  whole image's statistics, as ``ops/norms.py`` does (plain torch); AdaIN
  applies them through kernel 3's stats-given entry
  (``ops/kernels/adain.adain_stats``).
- The style MLP runs on every rank of a data row (replicated).

The exchanges use ``all_gather`` and ``all_reduce`` only, which NCCL and
gloo both take for CUDA tensors. The pass serves: no gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from masterthesis_tpu_torch.models import networks
from masterthesis_tpu_torch.models.blocks import (
    AdaINResnetBlock,
    ConvBlock,
    ResnetBlock,
    UpsampleBlock,
)
from masterthesis_tpu_torch.ops import norms
from masterthesis_tpu_torch.ops.kernels import adain as kadain
from masterthesis_tpu_torch.ops.kernels import moments as kmoments
from masterthesis_tpu_torch.ops.norms import InstanceNorm, LayerNorm
from masterthesis_tpu_torch.parallel.mesh import Mesh, all_gather_rows, group_size


def _reflect_rows(x: torch.Tensor, n: int, top: bool) -> torch.Tensor:
    """The ``n`` rows that reflect padding puts above (``top``) or below x."""
    if n >= x.shape[2]:
        raise ValueError(f"a shard of {x.shape[2]} rows cannot reflect {n} rows at the image's "
                         "edge: use fewer spatial ranks or a taller image")
    rows = x[:, :, 1:n + 1] if top else x[:, :, -n - 1:-1]
    return rows.flip(2)


def halo_rows(x: torch.Tensor, top: int, bottom: int, group, edge: str = "reflect"):
    """NCHW ``x``, this rank's contiguous rows of an image split over
    ``group`` in rank order, with ``top`` rows of the rank above prepended
    and ``bottom`` rows of the rank below appended; at the image's true top
    and bottom, reflected rows (``edge`` "reflect") or zeros ("zeros"). One
    ``all_gather`` of each rank's edge rows."""
    if top == 0 and bottom == 0:
        return x
    n, rank = group_size(group), (0 if group is None else dist.get_rank(group))
    if x.shape[2] < max(top, bottom):
        raise ValueError(f"a shard of {x.shape[2]} rows cannot lend {max(top, bottom)} halo rows")
    # [this rank's last `top` rows | its first `bottom` rows]: what the ranks
    # below and above need of it
    edges = torch.cat([x[:, :, x.shape[2] - top:], x[:, :, :bottom]], dim=2).contiguous()
    gathered = all_gather_rows(edges[None], group) if n > 1 else edges[None]
    parts = []
    if top:
        if rank > 0:
            parts.append(gathered[rank - 1][:, :, :top])
        elif edge == "reflect":
            parts.append(_reflect_rows(x, top, True))
        else:
            parts.append(x.new_zeros((*x.shape[:2], top, x.shape[3])))
    parts.append(x)
    if bottom:
        if rank < n - 1:
            parts.append(gathered[rank + 1][:, :, top:])
        elif edge == "reflect":
            parts.append(_reflect_rows(x, bottom, False))
        else:
            parts.append(x.new_zeros((*x.shape[:2], bottom, x.shape[3])))
    return torch.cat(parts, dim=2)


def _sums(x: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) (sum, sumsq) of x over the whole image: kernel
    1 on this rank's rows, added over ``group`` in one all-reduce."""
    s1, s2 = kmoments.moments(x)
    if group_size(group) > 1:
        both = torch.stack([s1, s2])
        dist.all_reduce(both, group=group)
        s1, s2 = both[0], both[1]
    return s1, s2


def _image_rows(x: torch.Tensor, group) -> int:
    return x.shape[2] * group_size(group)


def instance_norm(x: torch.Tensor, group, eps: float = norms.EPS) -> torch.Tensor:
    """``norms.instance_norm`` over the whole image."""
    s1, s2 = _sums(x, group)
    n = _image_rows(x, group) * x.shape[3]
    mean = s1 / n
    var = (s2 / n - mean.square()).clamp_min(0.0)
    y = (x.float() - mean[:, :, None, None]) * torch.rsqrt(var + eps)[:, :, None, None]
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, norm: LayerNorm, group) -> torch.Tensor:
    """``norms.layer_norm`` (per sample over C, H, W) over the whole image."""
    s1, s2 = _sums(x, group)
    n = x.shape[1] * _image_rows(x, group) * x.shape[3]
    mean = (s1.sum(dim=1) / n)[:, None, None, None]
    var = (s2.sum(dim=1) / n)[:, None, None, None] - mean.square()
    y = (x.float() - mean) * torch.rsqrt(var.clamp_min(0.0) + norm.eps)
    if norm.scale is not None:
        y = y * norm.scale.float()[:, None, None] + norm.bias.float()[:, None, None]
    return y.to(x.dtype)


def adain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, group,
          eps: float = norms.EPS) -> torch.Tensor:
    """``norms.adain`` over the whole image: kernel 1's sums, all-reduced,
    then kernel 3's stats-given apply."""
    s1, s2 = _sums(x, group)
    n = _image_rows(x, group) * x.shape[3]
    mean = s1 / n
    rstd = torch.rsqrt((s2 / n - mean.square()).clamp_min(0.0) + eps)
    return kadain.adain_stats(x.contiguous(), mean.contiguous(), rstd.contiguous(),
                              gamma.float().contiguous(), beta.float().contiguous())


def conv(block: ConvBlock, x: torch.Tensor, group) -> torch.Tensor:
    """A reflect-padded ``ConvBlock`` (stride 1 or 2, no norm of its own
    beyond instance norm) on this rank's rows: the halo, then the conv
    unpadded in height."""
    c = block.conv
    if c.padding_type != "reflect" or c.sn is not None or c.int8:
        raise NotImplementedError("the spatial forward takes float reflect-padded convs")
    p, s = c.padding, c.stride
    if s == 2 and x.shape[2] % 2:
        raise ValueError(f"a stride-2 conv needs an even number of rows per shard, not "
                         f"{x.shape[2]}")
    h = halo_rows(x, p, p if s == 1 else 0, group)
    h = F.pad(h, (p, p, 0, 0), mode="reflect")
    bias = None if c.bias is None else c.bias.to(c.dtype)
    y = F.conv2d(h.to(c.dtype), c.weight.to(c.dtype), bias, s, 0)
    if isinstance(block.norm, InstanceNorm):
        y = instance_norm(y, group, block.norm.eps)
    elif block.norm is not None:
        raise NotImplementedError(f"the spatial forward has no {type(block.norm).__name__}")
    return block.act(y) if block.act is not None else y


def upsample(block: UpsampleBlock, x: torch.Tensor, group) -> torch.Tensor:
    """A transposed-conv ``UpsampleBlock``: k3/s2/p1/op1 with one row of the
    rank below (zeros under the image), or the 1x1 head; then its
    LayerNorm and activation."""
    c = block.conv
    if not block.transpose or c.int8:
        raise NotImplementedError("the spatial forward takes float transposed upsamples")
    bias = None if c.bias is None else c.bias.to(c.dtype)
    geometry = (c.kernel_size, c.stride, c.padding, c.output_padding)
    if geometry == (3, 2, 1, 1):
        h = halo_rows(x, 0, 1, group, edge="zeros")
        y = F.conv_transpose2d(h.to(c.dtype), c.weight.to(c.dtype), bias, 2, 1, (0, 1))
        y = y[:, :, :2 * x.shape[2]].contiguous()
    elif geometry == (1, 1, 0, 0):
        y = F.conv_transpose2d(x.to(c.dtype), c.weight.to(c.dtype), bias)
    else:
        raise NotImplementedError(f"the spatial forward has no transposed conv {geometry}")
    if isinstance(block.norm, LayerNorm):
        y = layer_norm(y, block.norm, group)
    elif block.norm is not None:
        raise NotImplementedError(f"the spatial forward has no {type(block.norm).__name__}")
    return block.act(y) if block.act is not None else y


def encode_content(encoder: networks.ContentEncoder, x: torch.Tensor, group) -> torch.Tensor:
    h = conv(encoder.stem, x, group)
    for i in range(encoder.num_downs):
        h = conv(getattr(encoder, f"down{i}"), h, group)
    for i in range(encoder.n_blocks):
        block = getattr(encoder, f"res{i}")
        if not isinstance(block, ResnetBlock):
            raise NotImplementedError(f"the spatial forward has no {type(block).__name__}")
        h = h + conv(block.conv2, conv(block.conv1, h, group), group)
    return h


def decode(decoder: networks.AdaINDecoder, x: torch.Tensor, z: torch.Tensor,
           c: torch.Tensor, group) -> torch.Tensor:
    if not isinstance(decoder, networks.AdaINDecoder) or not decoder.adain:
        raise NotImplementedError("the spatial forward decodes with AdaINDecoder's AdaIN blocks")
    style = decoder.linear(z, c)
    h = x
    for i in range(decoder.n_blocks):
        block: AdaINResnetBlock = getattr(decoder, f"dec1_{i}")
        p = block.adain.style_proj
        gb = F.linear(style.to(block.adain.dtype), p.weight.to(block.adain.dtype),
                      p.bias.to(block.adain.dtype))
        gamma, beta = gb.chunk(2, dim=-1)
        y = adain(conv(block.conv1, h, group), gamma, beta, group, block.adain.eps)
        y = block.act(y) if block.act is not None else y
        h = h + adain(conv(block.conv2, y, group), gamma, beta, group, block.adain.eps)
    tail = decoder.dec2
    for i in range(tail.num_ups):
        h = upsample(getattr(tail, f"up{i}"), h, group)
    return upsample(tail.head, h, group)


def check_rows(model, mesh: Mesh, height: int) -> int:
    """The rows of one shard of an image ``height`` rows tall: the spatial
    axis must divide it, and every down conv must start on an even row."""
    s = mesh.axis_size("spatial")
    downs = model.nets.content_encoder.num_downs
    if height % (s * 2 ** downs):
        raise ValueError(f"{height} rows do not split into {s} shards whose rows halve "
                         f"{downs} times")
    return height // s


def shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a global NHWC batch: its rows of the batch on
    "data", its rows of the height on "spatial"."""
    b = x.shape[0] // mesh.axis_size("data")
    h = x.shape[1] // mesh.axis_size("spatial")
    d, s = mesh.index("data"), mesh.index("spatial")
    return x[d * b:(d + 1) * b, s * h:(s + 1) * h].contiguous()


def gather(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global NHWC batch from every rank's block (:func:`shard`
    inverted), on every rank."""
    rows = all_gather_rows(y.permute(1, 0, 2, 3).contiguous(), mesh.group("spatial"))
    return all_gather_rows(rows.permute(1, 0, 2, 3).contiguous(), mesh.group("data"))


def forward_random(model, mesh: Mesh, img: torch.Tensor, z: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """``TranslationModel._forward_random_impl`` on this rank's block: NHWC
    ``img`` (its batch rows, its image rows), ``z`` (its batch rows,
    latent) and one-hot ``c``; returns its block of the NHWC translation.
    Every rank of the mesh calls it together."""
    group = mesh.group("spatial")
    check_rows(model, mesh, img.shape[1] * mesh.axis_size("spatial"))
    with torch.inference_mode():
        x = img.to(model.device, torch.float32).permute(0, 3, 1, 2).contiguous()
        z_c = encode_content(model.nets.content_encoder, x, group)
        out = decode(model.nets.decoder, z_c, z.to(model.device, torch.float32),
                     c.to(model.device, torch.float32), group)
        return out.permute(0, 2, 3, 1).contiguous()
