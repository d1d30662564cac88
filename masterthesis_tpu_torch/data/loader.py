"""Batching, a background-prefetch loader and the device feed.

The port of ``masterthesis_tpu/data/loader.py``: ``collate``, the
thread-prefetch ``DataLoader`` and ``infinite``. The loader is the JAX
package's and not ``torch.utils.data.DataLoader``: its worker processes
would each copy the dataset's numpy generator, and the batches would no
longer be the JAX package's (one generator, drawn in order). As there, one
producer thread decodes ahead of the consumer whatever ``num_workers`` says
(0: no thread). The JAX package's ``shard_batch`` places a batch on its
mesh; here :func:`to_device` copies a rank's batch onto its device and
:func:`shard_batch` takes a rank's rows of a global batch.
``shard_index``/``num_shards`` stride the index space per process as in the
JAX package: the data-parallel trainer's loaders.

``DataLoader.fast_forward(n)`` makes the next pass start ``n`` batches
later, across epochs, drawing what those batches would have drawn (the
shuffle orders, and each skipped item's ``dataset.skip``) without loading
them: a resumed run reads the batches the unbroken run would have read.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch


def collate(items) -> Any:
    """Stack a list of samples (dicts / tuples / arrays) into batch arrays."""
    first = items[0]
    if isinstance(first, dict):
        return {k: collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(collate(list(col)) for col in zip(*items))
    if isinstance(first, str):
        return list(items)
    return np.stack([np.asarray(it) for it in items], axis=0)


class DataLoader:
    """Sequential-index batch loader with optional background prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        """``shard_index``/``num_shards`` stride the index space per process:
        each feeds its own disjoint slice in a shared shuffle order (the same
        ``seed`` in every process)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.shard_index = shard_index
        self.num_shards = max(1, num_shards)
        self._rng = np.random.default_rng(seed)
        self._skip = 0

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def fast_forward(self, n_batches: int) -> None:
        """Start the next passes ``n_batches`` batches later (see the module
        docstring)."""
        self._skip = int(n_batches)

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_index :: self.num_shards]
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            if self._skip > 0:
                self._skip -= 1
                for i in idx:
                    self.dataset.skip(int(i))
                continue
            yield idx

    def _make_batch(self, idx):
        return collate([self.dataset[int(i)] for i in idx])

    def __iter__(self) -> Iterator[Any]:
        if self.num_workers <= 0:
            for idx in self._index_batches():
                yield self._make_batch(idx)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for idx in self._index_batches():
                    if not put(self._make_batch(idx)):
                        return
            except Exception as e:  # the consumer raises it
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=60)


def infinite(loader) -> Iterator[Any]:
    """Epoch-looping iterator."""
    while True:
        for batch in loader:
            yield batch


def to_device(batch, device) -> Any:
    """Copy a host batch onto ``device``: arrays become tensors there,
    strings and lists of strings stay as they are."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        if all(isinstance(v, str) for v in batch):
            return batch
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, str):
        return batch
    return torch.as_tensor(np.asarray(batch)).to(device, non_blocking=True)


def shard_batch(batch, mesh) -> Any:
    """This rank's rows of a global batch (arrays or tensors split on dim 0
    over ``mesh``'s "data" axis, which must divide them; strings and
    scalars pass): the twin of the JAX package's ``shard_batch``, which
    places the batch on the mesh sharded on the same axis."""
    n = mesh.axis_size("data")
    if n == 1:
        return batch
    i = mesh.index("data")

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if isinstance(x, str) or getattr(x, "ndim", 0) == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over {n} ranks")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return rows(batch)
