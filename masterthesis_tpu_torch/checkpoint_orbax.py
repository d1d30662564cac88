"""Read the orbax checkpoints that the JAX package writes, without JAX.

``masterthesis_tpu/checkpoint.py`` saves a path ending in ``.orbax`` with
orbax's ``PyTreeCheckpointer`` (``--ckpt_format orbax``:
``model_{it}.orbax/`` and ``opt_{it}.orbax/``). Such a directory is a
tensorstore OCDBT key-value store of zarr v2 arrays, with the tree's layout
in ``_METADATA``. This module reads one with numpy and the system's
``libzstd.so.1`` (bound through ``ctypes``), and imports neither JAX, orbax
nor tensorstore, so that it runs where none of them is installed.

:func:`read_store` returns the tree that ``checkpoint.msgpack_restore``
gives for the same state saved as a Flax msgpack file: nested dicts with
string keys (a tuple's or a NamedTuple's entries under ``"0"``, ``"1"``, ...
or its field names), arrays as CPU tensors of their dtype (bfloat16 as
``torch.bfloat16``), 0-d arrays as 0-d tensors, and an empty subtree (an
empty dict or tuple, optax's ``EmptyState()``) as ``{}``. Orbax records
``None`` and ``EmptyState()`` alike, so a ``None`` leaf reads as ``{}`` too;
no state of this system holds one.

The layout read here (tensorstore's OCDBT format, version 0):

- ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf to its key path
  (``key_type`` 2 a dict key, 1 a sequence index) and value type; an array
  leaf is the zarr array named by its keys joined with ".".
- ``manifest.ocdbt`` and the B-tree nodes under ``d/`` (and, written by
  each process, ``ocdbt.process_<i>/``): a magic number (``0c db 3a 2a`` a
  manifest, ``0c db 20 de`` a node), the file's length (u64, little
  endian), a format version and a compression (varints; 1 is zstd), the
  body, and a CRC-32C, which is not checked here. A manifest holds the
  config, a table of data files and the versions, each with its root node
  (file, offset, length); the newest version is read. A node holds its
  height, its table of data files and its entries, keys prefix-compressed;
  a leaf's values lie inline or in a data file (file, offset, length); an
  interior node's children hold keys relative to the common prefix of
  their subtree.
- The zarr v2 keys: ``<name>/.zarray`` (JSON: ``shape``, ``chunks``,
  ``dtype`` such as ``"<f4"`` or ``"bfloat16"``, ``compressor`` zstd or
  none, ``fill_value``, ``order``) and one key per chunk, ``<name>/0.0``
  (``<name>/0`` for a 0-d array), each a zstd frame that need not state its
  content size. An array sharded over devices is several chunks, which are
  assembled by the chunk grid.
"""
from __future__ import annotations

import ctypes
import json
import os
from typing import Any, Optional

import numpy as np
import torch

ZSTD_LIBRARY = "libzstd.so.1"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_COMPRESSION_ZSTD = 1
# value types of orbax's tree metadata that hold an array in the store
ARRAY_TYPES = ("jax.Array", "np.ndarray")
# empty subtrees: no array keys, restored as {} (see the module docstring)
EMPTY_TYPES = ("Dict", "Tuple", "List", "None")


# ---------------------------------------------------------------- zstd --


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_zstd_lib: Optional[ctypes.CDLL] = None


def zstd() -> ctypes.CDLL:
    """The system's zstd library, bound at the first call. Raises OSError
    naming :data:`ZSTD_LIBRARY` where it cannot be loaded: there is no
    other decoder to fall back to."""
    global _zstd_lib
    if _zstd_lib is not None:
        return _zstd_lib
    try:
        lib = ctypes.CDLL(ZSTD_LIBRARY)
    except OSError as e:
        raise OSError(f"the orbax reader needs the zstd library {ZSTD_LIBRARY} "
                      f"(Debian/Ubuntu: libzstd1), which cannot be loaded: {e}") from e
    size_t, p = ctypes.c_size_t, ctypes.c_void_p
    for name, res, argtypes in (
        ("ZSTD_versionString", ctypes.c_char_p, []),
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
        ("ZSTD_compressBound", size_t, [size_t]),
        ("ZSTD_compress", size_t, [p, size_t, p, size_t, ctypes.c_int]),
        ("ZSTD_createDStream", p, []),
        ("ZSTD_freeDStream", size_t, [p]),
        ("ZSTD_initDStream", size_t, [p]),
        ("ZSTD_DStreamOutSize", size_t, []),
        ("ZSTD_decompressStream", size_t, [p, ctypes.POINTER(_OutBuffer),
                                           ctypes.POINTER(_InBuffer)]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, argtypes
    _zstd_lib = lib
    return lib


def zstd_version() -> str:
    return zstd().ZSTD_versionString().decode()


def _zstd_check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_compress(data: bytes, level: int = 1) -> bytes:
    """One zstd frame of ``data`` (for round-trip checks of the library)."""
    lib = zstd()
    out = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)))
    n = _zstd_check(lib, lib.ZSTD_compress(out, len(out), data, len(data), level), "compress")
    return out.raw[:n]


def zstd_decompress(data, size: Optional[int] = None) -> bytes:
    """Decode the zstd frames of ``data`` with the streaming API, which
    takes frames that do not state their content size. ``size``, where the
    caller knows it, is the exact decoded length (checked)."""
    lib = zstd()
    src = ctypes.create_string_buffer(bytes(data), len(data))
    cap = size if size is not None else max(4 * len(data), lib.ZSTD_DStreamOutSize())
    buf = ctypes.create_string_buffer(max(cap, 1))
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        _zstd_check(lib, lib.ZSTD_initDStream(stream), "init")
        inb = _InBuffer(ctypes.addressof(src), len(data), 0)
        outb = _OutBuffer(ctypes.addressof(buf), cap, 0)
        while True:
            seen = (inb.pos, outb.pos)
            ret = _zstd_check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outb),
                                                             ctypes.byref(inb)), "decompress")
            if ret == 0 and inb.pos == inb.size:
                break
            if outb.pos == outb.size:
                if size is not None:
                    raise ValueError(f"zstd decompress: more than the {size} bytes expected")
                cap *= 2
                grown = ctypes.create_string_buffer(cap)
                ctypes.memmove(grown, buf, outb.pos)
                buf = grown
                outb = _OutBuffer(ctypes.addressof(buf), cap, outb.pos)
            elif (inb.pos, outb.pos) == seen:
                raise ValueError("zstd decompress: the data ends inside a frame")
    finally:
        lib.ZSTD_freeDStream(stream)
    if size is not None and outb.pos != size:
        raise ValueError(f"zstd decompress: {outb.pos} bytes where {size} were expected")
    return ctypes.string_at(buf, outb.pos)


# ---------------------------------------------------------------- OCDBT --


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def byte(self) -> int:
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return out

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("ocdbt: the data ends inside a record")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _body(blob: bytes, magic: int, what: str) -> _Cursor:
    """The body of one manifest or node (header and checksum removed,
    decompressed)."""
    if len(blob) < 16 or int.from_bytes(blob[:4], "big") != magic:
        raise ValueError(f"ocdbt: {what} does not start with the magic number {magic:08x}")
    length = int.from_bytes(blob[4:12], "little")
    if length != len(blob):
        raise ValueError(f"ocdbt: {what} states {length} bytes and has {len(blob)}")
    c = _Cursor(blob[:-4])
    c.pos = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what} has format version {version}; 0 is read")
    rest = blob[c.pos:-4]
    if compression == _COMPRESSION_ZSTD:
        rest = zstd_decompress(rest)
    elif compression != 0:
        raise ValueError(f"ocdbt: {what} has compression {compression}; 0 and zstd are read")
    return _Cursor(rest)


def _file_table(c: _Cursor) -> list:
    """A data-file table: each file's path from the store's root (the
    paths prefix-compressed; a path is its base path then its relative
    path)."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)  # the base path's length within each path
    out, prev = [], b""
    for i in range(n):
        prev = prev[:prefix[i]] + c.take(suffix[i])
        out.append(prev.decode())
    return out


def _keys(c: _Cursor, n: int, interior: bool):
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The keys and values of the newest version of an OCDBT store (a
    directory): :meth:`get` returns a key's bytes."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            c = _body(f.read(), MANIFEST_MAGIC, f"{root}/manifest.ocdbt")
        c.take(16)  # uuid
        if c.varint() != 0:
            raise ValueError(f"ocdbt: {root} has a numbered manifest; a single one is read")
        c.varint(), c.varint(), c.byte()  # inline and node limits, version tree arity
        if c.varint() == _COMPRESSION_ZSTD:
            c.take(4)  # the level, an int32
        files = _file_table(c)
        n = c.varint()
        if n == 0:
            raise ValueError(f"ocdbt: {root} holds no version")
        gens = c.varints(n)
        heights = [c.byte() for _ in range(n)]
        fids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        newest = max(range(n), key=gens.__getitem__)
        self._refs: dict[bytes, Any] = {}
        if c.varints(n)[newest]:  # its key count: 0 is an empty tree
            self._walk(files[fids[newest]], offsets[newest], lengths[newest], heights[newest], b"")

    def _read(self, path: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"ocdbt: {path} ends before byte {offset + length}")
        return data

    def _walk(self, path: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        c = _body(self._read(path, offset, length), NODE_MAGIC, f"{path}@{offset}")
        if c.byte() != height:
            raise ValueError(f"ocdbt: node {path}@{offset} is not at height {height}")
        files = _file_table(c)
        n = c.varint()
        keys, common = _keys(c, n, height > 0)
        if height > 0:
            fids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
            for i in range(n):
                self._walk(files[fids[i]], offsets[i], lengths[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        lengths = c.varints(n)
        kinds = c.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"ocdbt: node {path}@{offset} has a value of unknown kind")
        fids, offsets = c.varints(len(indirect)), c.varints(len(indirect))
        where = dict(zip(indirect, zip(fids, offsets)))
        for i in range(n):
            if i in where:
                fid, off = where[i]
                self._refs[prefix + keys[i]] = (files[fid], off, lengths[i])
            else:
                self._refs[prefix + keys[i]] = c.take(lengths[i])

    def keys(self) -> list:
        return sorted(k.decode() for k in self._refs)

    def get(self, key: str) -> Optional[bytes]:
        ref = self._refs.get(key.encode())
        if ref is None or isinstance(ref, bytes):
            return ref
        return self._read(*ref)


# ---------------------------------------------------------------- zarr --


def _dtype(name: str):
    """(numpy dtype of the stored bytes, torch dtype to view them as, or
    None)."""
    if name == "bfloat16":
        return np.dtype("<i2"), torch.bfloat16
    return np.dtype(name), None


def read_array(store, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store``, assembled from its chunks."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"orbax store: no array {name!r}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"orbax store: {name} is not a plain zarr v2 array")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"orbax store: {name} is compressed with {compressor.get('id')!r}; "
                         "zstd and none are read")
    dtype, view = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if meta.get("order", "C") != "C":
        raise ValueError(f"orbax store: {name} is stored in Fortran order; C order is read")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    if view is not None and fill not in (None, 0):
        raise ValueError(f"orbax store: {name}: a bfloat16 fill value {fill!r} is not read")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid) if shape else [()]:
        key = f"{name}/{sep.join(str(i) for i in idx) if idx else '0'}"
        data = store.get(key)
        if data is None:  # never written: the fill value (zero if it is null)
            continue
        if compressor is not None:
            data = zstd_decompress(data, chunk_bytes)
        block = np.frombuffer(data, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    t = torch.from_numpy(out)
    return t.view(view) if view is not None else t


# ---------------------------------------------------------------- trees --


def is_jax_store(path: str) -> bool:
    """Whether ``path`` is a directory that orbax's ``PyTreeCheckpointer``
    wrote: its ``_METADATA`` and ``manifest.ocdbt``."""
    return all(os.path.isfile(os.path.join(path, f)) for f in ("_METADATA", "manifest.ocdbt"))


def read_store(path: str) -> dict:
    """The tree of the orbax checkpoint at ``path``, as
    ``checkpoint.msgpack_restore`` gives the same state (module docstring)."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    tree_meta = meta.get("tree_metadata")
    if not isinstance(tree_meta, dict):
        raise ValueError(f"{path}/_METADATA has no tree_metadata: not a PyTreeCheckpointer store "
                         "this reader knows")
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
        raise ValueError(f"{path} is not an OCDBT store of zarr v2 arrays (orbax's default), "
                         "which is what the reader takes")
    store = OcdbtStore(path)
    tree: dict = {}
    for entry in tree_meta.values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value.get("value_type")
        if kind in ARRAY_TYPES:
            leaf = read_array(store, ".".join(keys))
        elif kind in EMPTY_TYPES and value.get("skip_deserialize"):
            leaf = {}
        else:
            raise ValueError(f"{path}: leaf {'/'.join(keys)} has value type {kind!r}, which "
                             "the reader does not take")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree
