"""Checkpoints: two files per save point, with a tolerant per-net restore.

The port of ``masterthesis_tpu/checkpoint.py``. The files keep the JAX
package's names and top-level layout: ``model_{it}.ckpt`` holds
``{"params": {net: state_dict}}`` (spectral norm's ``u`` is a buffer inside
its net's state_dict) and ``opt_{it}.ckpt`` holds ``{"opt_state": {net:
AdamState.state_dict()}, "step": int}``. They are written with
``torch.save`` (host tensors) and read with ``torch.load(weights_only=True)``:
this is what ``--ckpt_format msgpack`` means in the port. The JAX package's
``orbax`` directories are not ported.

A file the JAX package wrote (Flax's msgpack, ``flax.serialization
.msgpack_serialize``) reads too: :func:`load_pytree` tells the two apart by
their first bytes (a ``torch.save`` file is a zip, ``PK``; a Flax file a
msgpack map) and decodes a Flax file with :func:`msgpack_restore`, a reader
of its own (neither Flax nor msgpack is needed), into nested dicts of torch
tensors in the JAX layout; ``tools/convert_jax.py`` carries them into the
port's nets (``Model.load``).
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np
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


def is_flax_file(path: str) -> bool:
    """Whether ``path`` is a file the JAX package wrote: a msgpack map (fixmap
    0x80-0x8f, map16 0xde, map32 0xdf) where a ``torch.save`` zip has ``PK``."""
    with open(path, "rb") as f:
        head = f.read(2)
    return len(head) > 0 and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def load_pytree(path: str, device="cpu") -> Any:
    """Read a :func:`save_pytree` file, or a file the JAX package wrote
    (:func:`msgpack_restore`), its tensors onto ``device``."""
    if path.endswith(".orbax"):
        raise NotImplementedError(ORBAX_ERROR)
    if is_flax_file(path):
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
        return _to_device(tree, device)
    return torch.load(path, map_location=device, weights_only=True)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


# ------------------------------------------------------------ Flax msgpack --

# Flax's ext types (flax/serialization.py _MsgpackExtType): an ndarray packed
# as the msgpack array (shape, dtype name, row-major bytes), and a numpy
# scalar packed the same way with shape (); complex numbers (2) never occur
# in a checkpoint of this system
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# Flax splits an array of more than 2^30 bytes into chunks of a flat array
_CHUNKED = "__msgpack_chunked_array__"


def _array(data) -> torch.Tensor:
    """A tensor from Flax's (shape, dtype name, bytes) encoding of an ndarray;
    bfloat16 through a 16-bit integer view of its bytes."""
    shape, name, buf = _Reader(data).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = torch.from_numpy(np.frombuffer(buf, np.int16).copy()).view(torch.bfloat16)
    else:
        flat = torch.from_numpy(np.frombuffer(buf, np.dtype(name)).copy())
    return flat.reshape([int(d) for d in shape])


class _Reader:
    """A msgpack decoder for what ``msgpack.packb`` writes: nil, booleans,
    integers, floats, strings, bytes, arrays, maps and Flax's ext types 1
    and 3. Anything else raises."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: the data ends inside a value")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code == _EXT_NDARRAY:
            return _array(data)
        if code == _EXT_NPSCALAR:
            return _array(data).reshape(())
        raise ValueError(f"msgpack: ext type {code} is not one of Flax's array types")

    def read(self):
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._list(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self._take(t & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self._unpack(numbers[t])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if t in sizes:
            n = self._unpack(sizes[t])
            if t <= 0xC6:
                return bytes(self._take(n))
            if t <= 0xC9:
                return self._ext(self._unpack(">b"), n)
            if t <= 0xDB:
                return str(self._take(n), "utf-8")
            return self._list(n) if t <= 0xDD else self._map(n)
        if 0xD4 <= t <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self._unpack(">b")
            return self._ext(code, 1 << (t - 0xD4))
        raise ValueError(f"msgpack: type byte {t:#04x} is not supported")

    def _list(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unchunk(tree):
    """Flax's chunked arrays back into one tensor each, in place."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [int(tree["shape"][str(i)]) for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def msgpack_restore(data) -> Any:
    """Decode the bytes of a Flax msgpack file (``flax.serialization
    .msgpack_serialize``): nested dicts and lists, arrays as CPU tensors of
    their dtype, numpy scalars as 0-d tensors, Flax's chunked arrays joined."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the first value")
    return _unchunk(tree)


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
