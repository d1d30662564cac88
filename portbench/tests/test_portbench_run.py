"""A run without a card, a run in a checkout that holds only the benchmark,
and the import guard. CPU only."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402

CELL = "adain_256.serve_int8_b64"
ARGS = ["--workload", CELL, "--seed", "4294967301", "--seconds", "1", "--trace", "0"]


def _run(cwd: Path, env_extra=None):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _printed_result(out: str) -> bool:
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except ValueError:
        return False


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    assert not torch.cuda.is_available(), "this test is for a machine without a card"
    p = _run(ROOT)
    assert p.returncode == 2, p.stderr
    assert not _printed_result(p.stdout)
    assert "CUDA device" in p.stderr


def test_in_a_checkout_of_the_benchmark_alone_the_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for path in common.benchmark()["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path, ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not _printed_result(p.stdout)


GUARD = """
import sys
sys.path.insert(0, {root!r})
{imports}
bad = [m for m in sys.modules if m.split('.')[0] in {names!r}]
print(repr(bad))
"""


def _loaded(imports: str, names) -> list:
    code = GUARD.format(root=str(ROOT), imports=imports, names=tuple(names))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return eval(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_not_the_jax_package():
    """The whole CPU path of a run at a small size: the port, the traffic kinds,
    the tracer and the reference; compared by whole top-level names (the
    port's name begins with the JAX package's)."""
    imports = (
        "from portbench import run, common\n"
        "cell = common.resolve({cell!r})\n"
        "cell.config = dict(cell.config, flags=dict(cell.config['flags'], crop_size=32, dim=8,"
        " latent_dim=4))\n"
        "cell.traffic = dict(cell.traffic, batch=2, pool=2, calibration_batch=2,"
        " warmup_requests=1, checked_requests=2, check_block=2, trace_seconds=0.2)\n"
        "r = run.run_cell({cell!r}, 5, 0.2, True, device='cpu', cell=cell)\n"
        "import portbench.kinds, portbench.reference.train, portbench.readings\n"
    ).format(cell=CELL)
    assert _loaded(imports, common.FORBIDDEN) == []
    assert "masterthesis_tpu_torch" not in common.FORBIDDEN
    assert common.forbidden_modules(["masterthesis_tpu_torch.models", "jaxtyping"]) == []
    assert common.forbidden_modules(["jax.numpy", "masterthesis_tpu.ops"]) == [
        "jax.numpy", "masterthesis_tpu.ops"]


def test_the_reference_loads_nothing_of_the_program():
    imports = ("import portbench.reference.nets, portbench.reference.train\n"
               "from portbench import common\n"
               "for p in sorted(common.HERE.joinpath('reference').glob('*.*.py')):\n"
               "    common.load_module(p, 'ref_' + p.stem.replace('.', '_'))\n")
    assert _loaded(imports, (*common.FORBIDDEN, common.PORT)) == []


def test_the_guard_refuses_a_loaded_jax_module(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "flax", object())
    try:
        run.guard("after the window")
    except run.Refused as e:
        assert e.code == 3 and "flax" in str(e)
    else:
        raise AssertionError("the guard let flax through")
