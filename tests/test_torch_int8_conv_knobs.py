"""The compiled knobs of ``scripts/int8_conv_knobs.py`` are text
substitutions into ``masterthesis_tpu_torch/csrc/int8_conv.cu``: each must
still apply to the committed source as often as it says, which needs no
card. Timing them needs one (the script's own docstring)."""
import importlib.util
from pathlib import Path

import pytest

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "int8_conv_knobs.py"


@pytest.fixture(scope="module")
def knobs():
    spec = importlib.util.spec_from_file_location("int8_conv_knobs", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_variant_applies(knobs):
    sources = knobs.variant_sources()
    assert set(sources) == set(knobs.VARIANTS)
    base = sources["base"]
    for name, text in sources.items():
        assert (text == base) == (name == "base"), name


@pytest.mark.parametrize("name,old,new", [
    # the grid order's alternative: every M tile of N tile 0 first
    ("grid_m_fastest", "const int mt = blockIdx.x / p.ntiles, nt = blockIdx.x % p.ntiles;",
     "const int mt = blockIdx.x % (gridDim.x / p.ntiles), nt = blockIdx.x / (gridDim.x / p.ntiles);"),
    # thread stores in either dtype: the library's TMA rule no longer reached
    ("thread_stores", "mt_int8_y_by_tma(stride, phases, Wo, y_bf16) && aligned(y)};", "false};"),
])
def test_knob_changes_what_it_says(knobs, name, old, new):
    base, text = knobs.variant_sources()["base"], knobs.variant_sources()[name]
    assert old in base and old not in text
    assert text == base.replace(old, new)
