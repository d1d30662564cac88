"""Checkpoints: two files per save point, with a tolerant per-net restore.

The port of ``masterthesis_tpu/checkpoint.py``. The files keep the JAX
package's names and top-level layout: ``model_{it}.ckpt`` holds
``{"params": {net: state_dict}}`` (spectral norm's ``u`` is a buffer inside
its net's state_dict) and ``opt_{it}.ckpt`` holds ``{"opt_state": {net:
AdamState.state_dict()}, "step": int}``. They are written with
``torch.save`` (host tensors) and read with ``torch.load(weights_only=True)``:
this is what ``--ckpt_format msgpack`` means in the port. The JAX package's
``orbax`` directories are not ported, and a file the JAX package wrote (Flax
msgpack) does not load here.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

ORBAX_ERROR = ("--ckpt_format orbax is not ported to masterthesis_tpu_torch: its checkpoints "
               "are torch.save files (--ckpt_format msgpack)")


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_pytree(tree: Dict[str, Any], path: str) -> None:
    """Write ``tree`` (dicts and lists of tensors and numbers) to ``path``,
    through a temporary file, so that a cut run never leaves half a file."""
    if path.endswith(".orbax"):
        raise NotImplementedError(ORBAX_ERROR)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, path)


def load_pytree(path: str, device="cpu") -> Any:
    """Read a :func:`save_pytree` file, its tensors onto ``device``."""
    if path.endswith(".orbax"):
        raise NotImplementedError(ORBAX_ERROR)
    return torch.load(path, map_location=device, weights_only=True)


def restore_matching(template: Dict[str, Any], restored: Dict[str, Any],
                     label: str = "net") -> Dict[str, Any]:
    """Per-key tolerant restore: each entry of ``restored`` whose name is in
    ``template`` goes in through ``template[name].load_state_dict`` (a net,
    or an ``AdamState``); a name the template lacks is skipped with the JAX
    package's message."""
    for name in restored:
        if name in template:
            print(f"Loading checkpoint for : {name}")
            template[name].load_state_dict(restored[name])
        else:
            print(f"Checkpoint for {name} {label} is not found.")
    return template
