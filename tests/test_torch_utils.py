"""The port's ``utils`` against the JAX package's: the same grids, images,
files, masks and strings from the same arrays (numpy, and torch tensors for
the port), the same console lines, and the reflection helpers on the port's
models; plus the port's own timing helpers (``StepTimer``, ``trace``) on
the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

from masterthesis_tpu import utils as jutils
from masterthesis_tpu.utils import images as jimages
from masterthesis_tpu_torch import utils
from masterthesis_tpu_torch.utils import images, profiling

RNG = np.random.default_rng(0)
BATCH = RNG.uniform(-1.2, 1.2, (5, 4, 6, 3)).astype(np.float32)


@pytest.mark.parametrize("nrow", [1, 2, 3, 5, 8])
def test_grids_equal_jax(nrow):
    for x in (BATCH, torch.from_numpy(BATCH)):
        assert np.array_equal(images.make_grid(x, nrow), jimages.make_grid(BATCH, nrow))
        assert np.array_equal(images.tensor_to_image(x, nrow), jimages.tensor_to_image(BATCH, nrow))
    one = BATCH[:1, :, :, :1]
    assert np.array_equal(images.tensor_to_image(one), jimages.tensor_to_image(one))
    with pytest.raises(ValueError):
        images.make_grid(BATCH[0, 0])


def test_saved_files_equal_jax(tmp_path):
    images.save_image(torch.from_numpy(BATCH), str(tmp_path / "a" / "grid.jpg"), nrow=3)
    jimages.save_image(BATCH, str(tmp_path / "b" / "grid.jpg"), nrow=3)
    assert (tmp_path / "a" / "grid.jpg").read_bytes() == (tmp_path / "b" / "grid.jpg").read_bytes()
    names = [str(tmp_path / "c" / f"{i}.png") for i in range(2)]
    images.save_images(BATCH[:2], names)
    jimages.save_images(BATCH[:2], [n.replace("/c/", "/d/") for n in names])
    for n in names:
        assert open(n, "rb").read() == open(n.replace("/c/", "/d/"), "rb").read()


def test_masks_resize_and_strings_equal_jax():
    mask = RNG.uniform(0, 1, (2, 3, 3, 1)).astype(np.float32)
    assert np.array_equal(images.tensor_to_mask(mask), jimages.tensor_to_mask(mask))
    img = RNG.integers(0, 256, (10, 12, 3), dtype=np.uint8)
    assert np.array_equal(images.resize_image(img, (7, 5)), jimages.resize_image(img, (7, 5)))
    assert images.param_to_str(a=1, b="x") == jimages.param_to_str(a=1, b="x")


def test_console_helpers_equal_jax(capsys):
    for mod in (utils, jutils):
        m = mod.AverageMeter("loss", ":.3f")
        m.update(1.0)
        m.update(3.0, n=3)
        print(m, m.avg, m.count)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == "loss 3.000 (2.500) 2.5 4"
    for mod in (utils, jutils):
        with mod.TimerBlock("title") as block:
            block.log("hello")
    lines = [line.split("] ")[-1] if "]" in line else line
             for line in capsys.readouterr().out.splitlines()]
    half = len(lines) // 2
    assert lines[:half] == lines[half:] and "Operation finished" in lines[half - 2]


def test_attribute_dict_is_the_arguments_one():
    from masterthesis_tpu_torch.arguments import AttributeDict

    assert utils.AttributeDict is AttributeDict
    d = utils.AttributeDict(a=1)
    d.b = 2
    assert d["b"] == 2 and d.a == 1 and d.missing is None
    del d.b
    assert "b" not in d


def test_reflection_helpers():
    import masterthesis_tpu.models as jmodels
    import masterthesis_tpu_torch.data as data_mod
    import masterthesis_tpu_torch.models as models_mod

    d = utils.module_to_dict(models_mod)
    assert d["AdaINModel"] is models_mod.AdaINModel and "BaseModel" in d
    assert utils.get_modules(models_mod, filter="Model") == jutils.get_modules(jmodels, filter="Model")
    datasets = utils.module_to_dict(data_mod)
    assert {"PairedDataset", "SingleDataset", "DataLoader"} <= set(datasets)
    assert "SingleDataset" in utils.get_modules(data_mod, superclass=data_mod.SingleDataset)


def test_step_timer_and_memory_on_the_cpu(tmp_path):
    timer = profiling.StepTimer(sync_every=2, device="cpu")
    assert timer.lap() is None
    rate = timer.lap()
    assert rate is not None and rate > 0
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("mt.block"):
            torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with open(tmp_path / "prof" / "trace.json") as f:
        assert [e["name"] for e in json.load(f)["traceEvents"]] == ["mt.block"]
