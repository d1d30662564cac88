"""Checkpoints: two per save point, with a tolerant per-net restore.

The port of ``masterthesis_tpu/checkpoint.py``. They keep the JAX package's
names and top-level layout: ``model_{it}`` holds ``{"params": {net:
state_dict}}`` (spectral norm's ``u`` is a buffer inside its net's
state_dict) and ``opt_{it}`` holds ``{"opt_state": {net:
AdamState.state_dict()}, "step": int}``. As in the JAX package, the path
picks the form (``--ckpt_format`` picks the path's ending, ``Model.save``):

- ``model_{it}.ckpt``, one ``torch.save`` file of host tensors, read with
  ``torch.load(weights_only=True)`` (``--ckpt_format msgpack``);
- ``model_{it}.orbax/``, a directory: a ``torch.distributed.checkpoint``
  store (``dcp.save`` with a ``FileSystemWriter``), PyTorch's form for
  directory and sharded state, as orbax's is the JAX package's
  (``--ckpt_format orbax``).

Both are written under a temporary name and renamed, so that a cut run
never leaves half a checkpoint.

What the JAX package wrote reads too (:func:`load_pytree` tells the forms
apart, :func:`checkpoint_format`): a Flax msgpack file
(``flax.serialization.msgpack_serialize``; a msgpack map where a
``torch.save`` zip has ``PK``), decoded by :func:`msgpack_restore`, a reader
of its own (neither Flax nor msgpack is needed), and an orbax directory
(``_METADATA`` and ``manifest.ocdbt``), read by ``checkpoint_orbax.read_store`` without JAX, orbax
or tensorstore. Both give nested dicts of torch tensors in the JAX layout,
which ``tools/convert_jax.py`` carries into the port's nets
(``Model.load``).
"""
from __future__ import annotations

import os
import shutil
import struct
import warnings
from typing import Any, Dict

import numpy as np
import torch

from masterthesis_tpu_torch import checkpoint_orbax

FORMATS = ("a torch.save file (.ckpt), a torch.distributed.checkpoint directory (.orbax), "
           "and what the JAX package writes: a Flax msgpack file or an orbax directory")


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_pytree(tree: Dict[str, Any], path: str) -> None:
    """Write ``tree`` (dicts and lists of tensors and numbers) to ``path``:
    a ``torch.save`` file, or where ``path`` ends in ``.orbax`` a
    ``torch.distributed.checkpoint`` directory (replacing one that is there,
    as the JAX package saves with ``force=True``). The directory is written
    by this process alone (``no_dist``): a data-parallel run saves from rank
    0 only (``Model.writes``)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    if path.endswith(".orbax"):
        from torch.distributed.checkpoint import FileSystemWriter, save

        shutil.rmtree(tmp, ignore_errors=True)
        with warnings.catch_warnings():  # "assuming ... a single process": it is one
            warnings.simplefilter("ignore", UserWarning)
            save(_to_host(tree), storage_writer=FileSystemWriter(tmp), no_dist=True)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        return
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, path)


def is_flax_file(path: str) -> bool:
    """Whether ``path`` is a file the JAX package wrote: a msgpack map (fixmap
    0x80-0x8f, map16 0xde, map32 0xdf) where a ``torch.save`` zip has ``PK``."""
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        head = f.read(2)
    return len(head) > 0 and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def checkpoint_format(path: str) -> str:
    """Which form ``path`` holds: "jax_orbax" (a directory orbax wrote: its
    ``_METADATA`` and ``manifest.ocdbt``), "dcp" (a ``torch.distributed.checkpoint`` directory: its
    ``.metadata``), "msgpack" (a Flax file) or "torch" (a ``torch.save``
    zip). Anything else raises, naming the forms taken."""
    if os.path.isdir(path):
        if checkpoint_orbax.is_jax_store(path):
            return "jax_orbax"
        if os.path.isfile(os.path.join(path, ".metadata")):
            return "dcp"
    elif os.path.isfile(path):
        if is_flax_file(path):
            return "msgpack"
        with open(path, "rb") as f:
            if f.read(2) == b"PK":
                return "torch"
    else:
        raise FileNotFoundError(f"checkpoint not found: {path}")
    raise ValueError(f"{path} is no checkpoint this package reads; it reads {FORMATS}")


def written_by_jax(path: str) -> bool:
    """Whether ``path`` holds a checkpoint of the JAX package (its trees
    are in the JAX layout)."""
    return checkpoint_format(path) in ("jax_orbax", "msgpack")


def load_pytree(path: str, device="cpu") -> Any:
    """Read a :func:`save_pytree` file or directory, or a checkpoint the JAX
    package wrote (:func:`msgpack_restore`, ``checkpoint_orbax.read_store``),
    its tensors onto ``device``."""
    kind = checkpoint_format(path)
    if kind == "torch":
        return torch.load(path, map_location=device, weights_only=True)
    if kind == "msgpack":
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
    elif kind == "jax_orbax":
        tree = checkpoint_orbax.read_store(path)
    else:
        tree = _load_dcp(path)
    return _to_device(tree, device)


def _load_dcp(path: str) -> dict:
    """A ``torch.distributed.checkpoint`` directory's whole tree, without a
    template: DCP's empty-state-dict planner builds it from the store's
    metadata (as ``format_utils.dcp_to_torch_save`` reads one), in this
    process alone."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.default_planner import _EmptyStateDictLoadPlanner
    from torch.distributed.checkpoint.state_dict_loader import _load_state_dict

    tree: dict = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        _load_state_dict(tree, storage_reader=FileSystemReader(path),
                         planner=_EmptyStateDictLoadPlanner(), no_dist=True)
    return tree


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
