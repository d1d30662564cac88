"""Load the original's (PyTorch) network weights into the port's nets.

The original saves ``model_{it}.ckpt`` as ``{net_name: state_dict}``. This
module maps each network's state_dict onto the port's net of the same
configuration, by the graph maps of ``masterthesis_tpu/tools/port_reference.py``
(the reference's ``Sequential`` indices, which shift by one where a padding
layer precedes a conv). Both sides are torch, so the weights carry over as
they are: a conv stays OIHW, a transposed conv IOHW (unflipped), a Linear
(out, in); only the LayerNorm affine (C, 1, 1) becomes (C,). That is the JAX
package's mapping (HWIO, the transposed conv flipped) composed with
``tools/convert_jax.params_from_jax`` (which flips it back). A spectrally
normalized conv's ``weight_orig`` is its weight; its power-iteration vector
is the port's own.

As in the JAX package: a pixelshuffle upsample does not import (the
original's block is unusable as written: its conv does not widen, DESIGN.md
divergence 4), and the original's ``ResnetGenerator`` builds no residual
blocks, so only a net with ``n_blocks=0`` imports.

CLI (writes a checkpoint that ``Model.load``, ``--resume``, reads: a
``torch.save`` file, or a directory where DST ends in ``.orbax``; the nets
are built on the card unless ``--device cpu``)::

    python -m masterthesis_tpu_torch.tools.port_reference model_100.ckpt out.ckpt \\
        --model AdaINModel --dim 64 --latent_dim 8 --num_domains 4 [...]
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from masterthesis_tpu_torch.models.blocks import BatchNorm2d, UpsampleBlock
from masterthesis_tpu_torch.ops.norms import LayerNorm


def _t(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.float32)).clone()


def _conv_weight(sd: Dict, p: str):
    """A conv's weight at prefix ``p``, or spectral norm's ``weight_orig``."""
    if f"{p}.weight" in sd:
        return sd[f"{p}.weight"]
    return sd[f"{p}.weight_orig"]


def _conv(sd: Dict, p: str, q: str, bias: bool) -> Dict[str, torch.Tensor]:
    out = {f"{q}.weight": _t(_conv_weight(sd, p))}
    if bias:
        out[f"{q}.bias"] = _t(sd[f"{p}.bias"])
    return out


def _linear(sd: Dict, p: str, q: str) -> Dict[str, torch.Tensor]:
    return {f"{q}.weight": _t(sd[f"{p}.weight"]), f"{q}.bias": _t(sd[f"{p}.bias"])}


def _norm(sd: Dict, p: str, q: str, norm) -> Dict[str, torch.Tensor]:
    """A layer or batch norm's affine; the instance norm has none."""
    if isinstance(norm, (LayerNorm, BatchNorm2d)) and norm.scale is not None:
        return {f"{q}.scale": _t(sd[f"{p}.weight"]).reshape(-1),
                f"{q}.bias": _t(sd[f"{p}.bias"]).reshape(-1)}
    return {}


def conv_block(sd: Dict, p: str, block, q: str, pad: bool = True) -> Dict[str, torch.Tensor]:
    """ConvBlock: the original's ``block`` Sequential is [pad?, conv, norm?,
    act?]; ``pad`` says whether a padding layer comes first."""
    i = 1 if pad else 0
    out = _conv(sd, f"{p}.block.{i}", f"{q}.conv", block.conv.bias is not None)
    out.update(_norm(sd, f"{p}.block.{i + 1}", f"{q}.norm", block.norm))
    return out


def upsample_block(sd: Dict, p: str, block, q: str, pad: bool = False) -> Dict[str, torch.Tensor]:
    """UpsampleBlock: [conv-transpose, norm?, act?], or for ``nearest``
    [Upsample, ConvBlock, norm?, act?]."""
    if block.transpose:
        out = _conv(sd, f"{p}.block.0", f"{q}.conv", block.conv.bias is not None)
        norm_idx = 1
    elif "nearest" in block.up_type:
        out = conv_block(sd, f"{p}.block.1", block.conv, f"{q}.conv", pad=pad)
        norm_idx = 2
    else:
        raise NotImplementedError(
            "pixelshuffle import unsupported: the reference block is unusable as written "
            "(channel mismatch) and the port's fixed block has a different kernel shape")
    out.update(_norm(sd, f"{p}.block.{norm_idx}", f"{q}.norm", block.norm))
    return out


def resnet_block(sd: Dict, p: str, block, q: str) -> Dict[str, torch.Tensor]:
    """ResnetBlock: two padded ConvBlocks in ``model``."""
    return {**conv_block(sd, f"{p}.model.0", block.conv1, f"{q}.conv1"),
            **conv_block(sd, f"{p}.model.1", block.conv2, f"{q}.conv2")}


def down_resnet_block(sd: Dict, p: str, block, q: str) -> Dict[str, torch.Tensor]:
    """DownResnetBlock: ``conv`` is [norm?, act, ConvBlock, ConvBlock, pool],
    ``shortcut`` [pool, conv]."""
    base = 2 if block.pre_norm is not None else 1
    return {**conv_block(sd, f"{p}.conv.{base}", block.conv1, f"{q}.conv1"),
            **conv_block(sd, f"{p}.conv.{base + 1}", block.conv2, f"{q}.conv2"),
            **_conv(sd, f"{p}.shortcut.1", f"{q}.shortcut", True)}


def adain_resnet_block(sd: Dict, p: str, block, q: str) -> Dict[str, torch.Tensor]:
    """AdaINResnetBlock: the one shared norm's ``fc`` is the port's
    ``adain.style_proj``."""
    return {**conv_block(sd, f"{p}.conv1", block.conv1, f"{q}.conv1"),
            **conv_block(sd, f"{p}.conv2", block.conv2, f"{q}.conv2"),
            **_linear(sd, f"{p}.norm.fc", f"{q}.adain.style_proj")}


def dec_resnet_block(sd: Dict, p: str, block, q: str) -> Dict[str, torch.Tensor]:
    """DecResnetBlock: two ConvBlocks and the 1x1 mixes ``block1``/``block2``
    ([conv, relu, conv, relu])."""
    out = {**conv_block(sd, f"{p}.conv1", block.conv1, f"{q}.conv1"),
           **conv_block(sd, f"{p}.conv2", block.conv2, f"{q}.conv2")}
    for j in (1, 2):
        out.update(_conv(sd, f"{p}.block{j}.0", f"{q}.block{j}_a", True))
        out.update(_conv(sd, f"{p}.block{j}.2", f"{q}.block{j}_b", True))
    return out


def style_mlp(sd: Dict, p: str, q: str) -> Dict[str, torch.Tensor]:
    """The (z, c) -> style Sequential [Linear, ReLU, Linear, ReLU, Linear]."""
    return {**_linear(sd, f"{p}.0", f"{q}.fc0"), **_linear(sd, f"{p}.2", f"{q}.fc1"),
            **_linear(sd, f"{p}.4", f"{q}.fc2")}


def decoder_tail(sd: Dict, p: str, tail, q: str) -> Dict[str, torch.Tensor]:
    """The upsample tail: ``num_ups`` upsamples, then the head."""
    out = {}
    for i in range(tail.num_ups):
        out.update(upsample_block(sd, f"{p}.{i}", getattr(tail, f"up{i}"), f"{q}.up{i}"))
    head = f"{p}.{tail.num_ups}"
    if isinstance(tail.head, UpsampleBlock):
        out.update(upsample_block(sd, head, tail.head, f"{q}.head"))
    else:
        out.update(conv_block(sd, head, tail.head, f"{q}.head", pad=False))
    return out


# --------------------------------------------------------------- the nets --


def import_content_encoder(sd: Dict, net) -> Dict[str, torch.Tensor]:
    out = conv_block(sd, "model.0", net.stem, "stem")
    for i in range(net.num_downs):
        out.update(conv_block(sd, f"model.{1 + i}", getattr(net, f"down{i}"), f"down{i}"))
    for i in range(net.n_blocks):
        out.update(resnet_block(sd, f"model.{1 + net.num_downs + i}", getattr(net, f"res{i}"),
                                f"res{i}"))
    return out


def import_style_encoder(sd: Dict, net) -> Dict[str, torch.Tensor]:
    """The head conv sits after the pool."""
    out = conv_block(sd, "model.0", net.stem, "stem")
    for i in range(net.num_downs):
        out.update(conv_block(sd, f"model.{1 + i}", getattr(net, f"down{i}"), f"down{i}"))
    out.update(_conv(sd, f"model.{net.num_downs + 2}", "head", True))
    return out


def import_reparam_style_encoder(sd: Dict, net) -> Dict[str, torch.Tensor]:
    out = conv_block(sd, "model.0", net.stem, "stem")
    for i in range(1, net.n_blocks):
        out.update(down_resnet_block(sd, f"model.{i}", getattr(net, f"down{i}"), f"down{i}"))
    return {**out, **_linear(sd, "fc", "fc"), **_linear(sd, "fcVar", "fcVar")}


def import_decoder(sd: Dict, net) -> Dict[str, torch.Tensor]:
    out = style_mlp(sd, "linear", "linear")
    for i in range(net.n_blocks):
        out.update(dec_resnet_block(sd, f"dec1.{i}", getattr(net, f"dec1_{i}"), f"dec1_{i}"))
    return {**out, **decoder_tail(sd, "dec2", net.dec2, "dec2")}


def import_adain_decoder(sd: Dict, net) -> Dict[str, torch.Tensor]:
    out = style_mlp(sd, "linear", "linear") if net.adain else {}
    block = adain_resnet_block if net.adain else resnet_block
    for i in range(net.n_blocks):
        out.update(block(sd, f"dec1.{i}", getattr(net, f"dec1_{i}"), f"dec1_{i}"))
    return {**out, **decoder_tail(sd, "dec2", net.dec2, "dec2")}


def import_decoder_concat(sd: Dict, net) -> Dict[str, torch.Tensor]:
    out = resnet_block(sd, "dec_share", net.dec_share, "dec_share")
    for i in range(net.n_blocks):
        out.update(resnet_block(sd, f"dec1.{i}", getattr(net, f"dec1_{i}"), f"dec1_{i}"))
    out.update(upsample_block(sd, "dec2", net.dec2, "dec2"))
    out.update(upsample_block(sd, "dec3", net.dec3, "dec3"))
    if net.dec2.transpose:
        out.update(upsample_block(sd, "dec4", net.dec4, "dec4"))
    else:
        out.update(conv_block(sd, "dec4", net.dec4, "dec4", pad=False))
    return out


def import_discriminator(sd: Dict, net) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(net.n_layers):
        out.update(conv_block(sd, f"model.{i}", getattr(net, f"layer{i}"), f"layer{i}"))
    return {**out, **_conv(sd, "conv1", "patch_head", False), **_conv(sd, "conv2", "cls_head", False)}


def import_content_discriminator(sd: Dict, net) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(net.n_layers):
        out.update(conv_block(sd, f"model.{i}", getattr(net, f"layer{i}"), f"layer{i}"))
    out.update(conv_block(sd, f"model.{net.n_layers}", net.layer3, "layer3"))
    return {**out, **_conv(sd, f"model.{net.n_layers + 1}", "head", True)}


def import_multiscale_discriminator(sd: Dict, net) -> Dict[str, torch.Tensor]:
    """Without a padding type the conv is at Sequential index 0."""
    pad = net.layer0.conv.padding_type is not None
    out = {}
    for i in range(net.n_layers):
        out.update(conv_block(sd, f"model.{i}", getattr(net, f"layer{i}"), f"layer{i}", pad=pad))
    return {**out, **_conv(sd, "dis", "dis_head", True), **_conv(sd, "cls", "cls_head", True)}


def import_resnet_generator(sd: Dict, net) -> Dict[str, torch.Tensor]:
    """The original builds no residual blocks (its ``n_blocks`` is unused);
    its decoder Sequential holds the ups widest first, then the head."""
    if net.n_blocks != 0:
        raise ValueError("the original ResnetGenerator has no resnet blocks (its n_blocks is "
                         "unused); build the port's with n_blocks=0 to import")
    pad = net.stem.conv.padding_type is not None
    out = conv_block(sd, "encoder.0", net.stem, "stem", pad=pad)
    for i in range(net.num_downs):
        out.update(conv_block(sd, f"encoder.{1 + i}", getattr(net, f"down{i}"), f"down{i}",
                              pad=pad))
    for i in range(net.num_downs):
        out.update(upsample_block(sd, f"decoder.{net.num_downs - 1 - i}", getattr(net, f"up{i}"),
                                  f"up{i}"))
    return {**out, **conv_block(sd, f"decoder.{net.num_downs}", net.head, "head", pad=pad)}


_IMPORTERS = {
    "ContentEncoder": import_content_encoder,
    "StyleEncoder": import_style_encoder,
    "ReparameterizedStyleEncoder": import_reparam_style_encoder,
    "Decoder": import_decoder,
    "AdaINDecoder": import_adain_decoder,
    "DecoderConcat": import_decoder_concat,
    "Discriminator": import_discriminator,
    "ContentDiscriminator": import_content_discriminator,
    "MultiScaleDiscriminator": import_multiscale_discriminator,
    "ResnetGenerator": import_resnet_generator,
}


def import_net_params(net: nn.Module, state_dict: Dict) -> Dict[str, torch.Tensor]:
    """The original's state_dict of one network (tensors or arrays) -> the
    port net's parameters, by name. Raises unless it sets every parameter
    of ``net`` at its shape."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in state_dict.items()}
    kind = type(net).__name__
    if kind not in _IMPORTERS:
        raise KeyError(f"no reference importer for network type {kind}")
    out = _IMPORTERS[kind](sd, net)
    params = dict(net.named_parameters())
    if set(out) != set(params):
        raise KeyError(f"{kind}: missing={sorted(set(params) - set(out))} "
                       f"extra={sorted(set(out) - set(params))}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(params[k].shape):
            raise ValueError(f"{kind}.{k}: shape {tuple(v.shape)} != {tuple(params[k].shape)}")
    return out


def import_model_params(model, torch_ckpt: Dict[str, Dict]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The original's ``model_{it}.ckpt`` ({net_name: state_dict}) ->
    {net_name: parameters} for ``model``; a net on one side only is
    skipped with a message, as the original's load does."""
    out = {}
    for name in model.nets:
        if name not in torch_ckpt:
            print(f"Checkpoint for {name} net is not found.")
            continue
        out[name] = import_net_params(model.nets[name], torch_ckpt[name])
    return out


def main(argv=None):
    import argparse

    from masterthesis_tpu_torch import checkpoint as ckpt
    from masterthesis_tpu_torch import models as models_mod
    from masterthesis_tpu_torch.arguments import default_train_args
    from masterthesis_tpu_torch.utils import module_to_dict

    p = argparse.ArgumentParser("port an original PyTorch model_{it}.ckpt to the port")
    p.add_argument("src", help="the original's model_{it}.ckpt")
    p.add_argument("dst", help="output checkpoint path (.ckpt/.orbax); load with --resume")
    p.add_argument("--model", default="AdaINModel")
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--latent_dim", type=int, default=8)
    p.add_argument("--num_domains", type=int, default=4)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--up_type", default="transpose")
    p.add_argument("--concat", action="store_true")
    p.add_argument("--reparam", action="store_true")
    p.add_argument("--ms_dis", action="store_true")
    p.add_argument("--use_dis_content", action="store_true")
    p.add_argument("--mode", default="train", help="'train' ports the discriminators too")
    p.add_argument("--device", default=None, help="where the nets are built (default: the card)")
    cli = p.parse_args(argv)
    overrides = {k: v for k, v in vars(cli).items() if k not in ("src", "dst", "model", "device")}
    args = default_train_args(logdir=None, **overrides)
    model = module_to_dict(models_mod)[cli.model](args, device=cli.device)
    src = torch.load(cli.src, map_location="cpu", weights_only=True)
    imported = import_model_params(model, src)
    with torch.no_grad():
        for name, params in imported.items():
            for key, value in params.items():
                model.nets[name].get_parameter(key).copy_(value)
    ckpt.save_pytree({"params": {n: net.state_dict() for n, net in model.nets.items()}}, cli.dst)
    print(f"wrote {len(imported)} net(s) to {cli.dst}")


if __name__ == "__main__":
    main()
