"""Carry the JAX package's params over to the port's nets.

``params_from_jax(tree, model)`` maps a param tree of the JAX package, given
as nested dicts of numpy arrays (``{net: {module: {...: array}}}``, e.g.
``jax.tree_util.tree_map(np.asarray, state.params)``), to one state_dict per
net of the port's ``model``. The port's module names follow the Flax names,
so each port parameter finds its leaf by its own path. Per leaf:

- Conv2d ``kernel`` HWIO -> ``weight`` OIHW;
- ConvTranspose2d ``kernel`` HWIO -> ``weight`` IOHW, spatially flipped: the
  JAX package runs ``conv_transpose(transpose_kernel=False)``, torch's
  transposed conv correlates with the flipped kernel;
- Dense ``kernel`` (in, out) -> ``weight`` (out, in); ``blocks.Dense`` nests
  its leaves under ``Dense_0``, AdaIN's ``style_proj`` does not;
- LayerNorm ``scale``/``bias`` (C,) as they are; biases as they are.

It raises on a leaf it does not consume and on a port parameter it leaves
unset, so a model whose shape differs from the tree's cannot load silently.

``quant_from_jax(quant_cols, model)`` does the same for the JAX package's
int8 amax tree (``TranslationModel.quant_cols``: ``{net: {"down0": {"conv":
{"amax_in": scalar}}}}``), giving the port's tree for ``model.load_int8``
(``{net: {"down0.conv.amax_in": tensor}}``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from masterthesis_tpu_torch.models.blocks import Conv2d, ConvTranspose2d, Dense
from masterthesis_tpu_torch.models.quantize import LEAF, int8_convs
from masterthesis_tpu_torch.ops.norms import LayerNorm


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = np.asarray(v)
    return flat


def _conv(k):
    return np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW


def _conv_transpose(k):
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))  # flip, HWIO -> IOHW


def _same(a):
    return a


def _leaf(module: nn.Module, prefix: str, pname: str):
    """(JAX path, converter) of the port parameter ``pname`` of ``module``."""
    base = f"{prefix}/" if prefix else ""
    if isinstance(module, Conv2d):
        return base + ("kernel" if pname == "weight" else pname), (
            _conv if pname == "weight" else _same
        )
    if isinstance(module, ConvTranspose2d):
        return base + ("kernel" if pname == "weight" else pname), (
            _conv_transpose if pname == "weight" else _same
        )
    if isinstance(module, nn.Linear):
        if isinstance(module, Dense):
            base += "Dense_0/"
        return base + ("kernel" if pname == "weight" else pname), (
            np.transpose if pname == "weight" else _same
        )
    if isinstance(module, LayerNorm):
        return base + pname, _same
    raise TypeError(f"no JAX mapping for parameter {pname} of {type(module).__name__}")


def params_from_jax(tree: dict, model) -> dict[str, dict[str, torch.Tensor]]:
    """One state_dict per net of ``model`` from the JAX param ``tree``."""
    if set(tree) != set(model.nets):
        raise KeyError(f"JAX nets {sorted(tree)} != port nets {sorted(model.nets)}")
    out = {}
    for net_name, net in model.nets.items():
        leaves = _flatten(tree[net_name])
        consumed, sd = set(), {}
        for mod_name, module in net.named_modules():
            for pname, p in module.named_parameters(recurse=False):
                key = f"{mod_name}.{pname}" if mod_name else pname
                path, convert = _leaf(module, mod_name.replace(".", "/"), pname)
                if path not in leaves:
                    raise KeyError(f"{net_name}: no JAX leaf {path} for port parameter {key}")
                value = np.array(convert(leaves[path]), dtype=np.float32, order="C", copy=True)
                if value.shape != tuple(p.shape):
                    raise ValueError(
                        f"{net_name}.{key}: shape {tuple(p.shape)}, JAX leaf {path} "
                        f"converts to {value.shape}"
                    )
                sd[key] = torch.from_numpy(value)
                consumed.add(path)
        unused = sorted(set(leaves) - consumed)
        if unused:
            raise KeyError(f"{net_name}: JAX leaves with no port parameter: {unused}")
        out[net_name] = sd
    return out


def quant_from_jax(quant_cols: dict, model) -> dict[str, dict[str, torch.Tensor]]:
    """The port's amax tree from the JAX quant collections, per net."""
    out = {}
    for net_name, tree in quant_cols.items():
        if net_name not in model.nets:
            raise KeyError(f"JAX quant tree for {net_name}, which the port does not have")
        leaves = _flatten(tree)
        consumed, amax = set(), {}
        for path in int8_convs(model.nets[net_name]):
            leaf = f"{path.replace('.', '/')}/{LEAF}"
            if leaf not in leaves:
                raise KeyError(f"{net_name}: no JAX leaf {leaf} for the int8 conv {path}")
            value = np.asarray(leaves[leaf], dtype=np.float32)
            if value.shape != ():
                raise ValueError(f"{net_name}/{leaf}: amax must be a scalar, got {value.shape}")
            amax[f"{path}.{LEAF}"] = torch.tensor(float(value))
            consumed.add(leaf)
        unused = sorted(set(leaves) - consumed)
        if unused:
            raise KeyError(f"{net_name}: JAX amax leaves with no port conv: {unused}")
        out[net_name] = amax
    return out
