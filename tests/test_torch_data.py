"""The port's data tier against the JAX package's, on the same files and seeds.

The behaviours of ``tests/test_data.py`` on the port's datasets, loader and
transforms; then the port's ``PairedDataset`` items and ``DataLoader``
batches (shuffled, and strided per host) bit-equal to the JAX package's,
through PIL's route, the native route, and the uint8 route of
``--device_preproc``: one numpy generator per dataset, drawn in the JAX
order (domains, then each image's crop and flip, x1's before x2's), gives
the same items. Also ``DataLoader.fast_forward``, which the trainer resumes
with: it lands where the unbroken stream is, across epochs.
"""
import numpy as np
import pytest

from masterthesis_tpu import data as jdata
from masterthesis_tpu.utils import AttributeDict as JaxAttributeDict
from masterthesis_tpu_torch import native
from masterthesis_tpu_torch.arguments import AttributeDict
from masterthesis_tpu_torch.data import (
    DataLoader,
    ImageFolder,
    ImageList,
    PairedDataset,
    PairedImageDataset,
    SingleDataset,
    collate,
    infinite,
    to_device,
)
from masterthesis_tpu_torch.data.transforms import EvalTransform, TrainTransform

from conftest import make_image_tree


def _args(root, cls=AttributeDict, **kw):
    d = cls(
        dataroot=str(root), mode="train", num_domains=4, load_size=36, crop_size=32,
        no_flip=False, select_domains=None, seed=0,
    )
    d.update(kw)
    return d


def test_image_list_recursive(tmp_path):
    make_image_tree(tmp_path, per_domain=2)
    ds = ImageList(str(tmp_path))
    assert len(ds) == 8
    img = ds[0]
    assert img.ndim == 3 and img.shape[-1] == 3
    assert 0.0 <= img.min() and img.max() <= 1.0


def test_image_folder_labels(tmp_path):
    make_image_tree(tmp_path, per_domain=2, mode="train")
    ds = ImageFolder(AttributeDict(dataroot=str(tmp_path / "train")))
    assert sorted({ds[i][1] for i in range(len(ds))}) == [0, 1, 2, 3]


def test_single_dataset_semantics(tmp_path):
    make_image_tree(tmp_path, per_domain=3)
    ds = SingleDataset(_args(tmp_path))
    assert len(ds) == 3
    item = ds[0]
    assert item["x"].shape == (32, 32, 3)
    assert item["y"].shape == (4,) and item["y"].sum() == 1.0
    assert -1.0 <= item["x"].min() and item["x"].max() <= 1.0


def test_single_dataset_select_domains(tmp_path):
    make_image_tree(tmp_path, per_domain=2)
    ds = SingleDataset(_args(tmp_path, select_domains=["cloud", "sun"], num_domains=2))
    assert ds.target_names == ["cloud", "sun"]
    assert ds[0]["y"].shape == (2,)
    with pytest.raises(ValueError, match="num_domains"):
        SingleDataset(_args(tmp_path, num_domains=3))


def test_paired_dataset_distinct_domains(tmp_path):
    make_image_tree(tmp_path, per_domain=3)
    ds = PairedDataset(_args(tmp_path))
    for i in range(6):
        item = ds[i]
        assert item["x1"].shape == item["x2"].shape == (32, 32, 3)
        assert int(np.argmax(item["y1"])) != int(np.argmax(item["y2"]))


def test_paired_image_dataset_int_labels(tmp_path):
    make_image_tree(tmp_path, per_domain=2)
    item = PairedImageDataset(_args(tmp_path))[0]
    assert item["y1"].dtype == np.int64
    assert int(item["y1"]) != int(item["y2"])


def test_dataloader_collate_and_prefetch(tmp_path):
    make_image_tree(tmp_path, per_domain=4)
    ds = PairedDataset(_args(tmp_path))
    for workers in (0, 2):
        batches = list(DataLoader(ds, batch_size=2, num_workers=workers, drop_last=True))
        assert len(batches) == 2
        assert batches[0]["x1"].shape == (2, 32, 32, 3)
        assert batches[0]["y1"].shape == (2, 4)


def test_transforms_geometry():
    from PIL import Image

    img = Image.fromarray(np.zeros((50, 70, 3), np.uint8))
    out = TrainTransform(load_size=36, crop_size=32, train=True)(img, np.random.default_rng(0))
    assert out.shape == (32, 32, 3)
    out = EvalTransform(size=(54, 96))(img)
    assert out.shape == (54, 96, 3)
    assert out.min() >= -1.0 and out.max() <= 1.0


def test_collate_nested():
    items = [{"a": np.zeros((2,)), "b": (np.ones(()), "p1")},
             {"a": np.ones((2,)), "b": (np.zeros(()), "p2")}]
    c = collate(items)
    assert c["a"].shape == (2, 2)
    assert c["b"][0].shape == (2,)
    assert c["b"][1] == ["p1", "p2"]


class _IdxDs:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        return np.array([i])


def test_dataloader_host_sharding():
    """Per-host striding: shards are disjoint and cover the index space."""
    shards = []
    for s in range(3):
        dl = DataLoader(_IdxDs(), batch_size=2, shard_index=s, num_shards=3)
        shards.append(set(np.concatenate([b.ravel() for b in dl]).tolist()))
        assert len(dl) == 2
    assert shards[0] | shards[1] | shards[2] == set(range(12))
    assert not (shards[0] & shards[1])


def test_to_device_copies_arrays_and_keeps_strings():
    import torch

    batch = {"x": np.ones((2, 3), np.float32), "p": ["a", "b"], "y": np.int64(3)}
    out = to_device(batch, "cpu")
    assert isinstance(out["x"], torch.Tensor) and out["x"].dtype == torch.float32
    assert out["p"] == ["a", "b"] and int(out["y"]) == 3


# --- bit-equal to the JAX package ---------------------------------------------

ROUTES = ["pil", "native", "uint8"]


def _pair(tmp_path, route, **kw):
    """(port dataset, JAX dataset) on one tree, seed and route."""
    flags = dict(device_preproc=route == "uint8", **kw)
    ours = PairedDataset(_args(tmp_path / "data", **flags))
    theirs = jdata.PairedDataset(_args(tmp_path / "data", JaxAttributeDict, **flags))
    if route == "pil":
        ours.transforms.use_native = theirs.transforms.use_native = False
    elif not native.available():  # the port's own build; JAX builds its own
        pytest.skip(f"the port's native library did not build: {native.build_error()}")
    return ours, theirs


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("route", ROUTES)
def test_paired_items_bit_equal_to_jax(tmp_path, route):
    make_image_tree(tmp_path / "data", per_domain=3, size=50)
    ours, theirs = _pair(tmp_path, route)
    for i in range(8):
        _equal(ours[i], theirs[i])
    assert ours[0]["x1"].dtype == (np.uint8 if route == "uint8" else np.float32)


@pytest.mark.parametrize("route", ROUTES)
def test_loader_batches_bit_equal_to_jax(tmp_path, route):
    """Shuffled, strided over 2 hosts, prefetched by the thread: two epochs."""
    make_image_tree(tmp_path / "data", per_domain=5, size=50)
    ours, theirs = _pair(tmp_path, route)
    kw = dict(batch_size=2, shuffle=True, num_workers=1, drop_last=True, seed=3,
              shard_index=1, num_shards=2)
    mine, jax_ = DataLoader(ours, **kw), jdata.DataLoader(theirs, **kw)
    assert len(mine) == len(jax_) == 1
    for _ in range(2):
        got, want = list(mine), list(jax_)
        assert len(got) == len(want) == 1
        for a, b in zip(got, want):
            _equal(a, b)


@pytest.mark.parametrize("route", ["pil", "uint8"])
def test_fast_forward_lands_on_the_unbroken_stream(tmp_path, route):
    """Skipping 3 batches (past an epoch of 2) draws what loading them
    draws: the next batches equal the unbroken stream's 4th and 5th."""
    make_image_tree(tmp_path / "data", per_domain=4, size=50)
    flags = dict(device_preproc=route == "uint8")
    kw = dict(batch_size=2, shuffle=True, num_workers=1, drop_last=True, seed=5)
    unbroken = infinite(DataLoader(PairedDataset(_args(tmp_path / "data", **flags)), **kw))
    want = [next(unbroken) for _ in range(5)][3:]
    loader = DataLoader(PairedDataset(_args(tmp_path / "data", **flags)), **kw)
    loader.fast_forward(3)
    resumed = infinite(loader)
    for w in want:
        _equal(next(resumed), w)
