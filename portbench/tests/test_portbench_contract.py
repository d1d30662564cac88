"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its file. CPU only; run with ``python -m pytest portbench/tests``."""
from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import common  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert TEXT.match(text), text
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[group]]
        assert len(got) == len(set(got)), group


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_budget_fits_the_full_check():
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e_names
    for name in CELLS:
        cell = common.resolve(name)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer


def test_listed_cells_report_the_metric_moved():
    e2e = {m["name"]: m.get("workloads", CELLS) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert w in CELLS and w in e2e[m["moves"]], (m["name"], w)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_file_resolves_by_name(name):
    cell = common.resolve(name)
    assert cell.traffic["kind"] and (ROOT / "portbench" / "kinds" /
                                     f"{cell.traffic['kind']}.py").exists()
    assert cell.limits, "the cell's correctness limits"
    for m in cell.per_layer:
        assert callable(common.metric_reader(m["name"]))
    config = next(c for c in BENCH["configs"] if c["name"] == cell.config_name)
    assert config["file"].startswith("portbench/") and config["reduced"] == cell.config["reduced"]
    assert config["source"] in cell.config["source"]


def test_kernel_files_name_a_function_its_launches_and_a_work_count():
    from portbench import work

    kernels = common.kernel_files()
    assert {k["kernel"] for k in kernels.values()} == {1, 3, 4, 5, 6, 7, 8, 9, 10}
    for spec in kernels.values():
        assert callable(getattr(work, spec["work"]))
        source = (ROOT / spec["source"]).read_text()
        mod = __import__(spec["module"], fromlist=[spec["function"]])
        assert callable(getattr(mod, spec["function"]))
        assert spec["launches"]
        for pattern in spec["launches"]:
            re.compile(pattern)
            # each names a __global__ function of the kernel's own source
            name = re.search(r"[A-Za-z_0-9]+_kernel", pattern).group(0)
            assert re.search(rf"__global__[^;{{]*\b{name}\(", source), (spec["function"], name)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_names_the_kernels_it_drives(name):
    cell = common.resolve(name)
    assert cell.kernels and set(cell.kernels) <= set(common.kernel_files())


def test_added_files_are_found_without_editing_any(tmp_path):
    """A new cell, traffic mix and per-layer metric, added as new files in a
    copy, resolve by name; the copy's existing files are left as they were."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    traffic = json.loads((ROOT / "portbench/traffic/serve_int8_b64.json").read_text())
    traffic.update(batch=8, pool=32)
    (tmp_path / "portbench/traffic/serve_int8_b8.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/cells/adain_256.serve_int8_b8.json").write_text(
        json.dumps({"limits": {"worst_image_rmse": 0.1}, "kernels": ["int8_resblock"]}))
    (tmp_path / "portbench/metrics/requests_per_s.serve.py").write_text(
        "def read(s):\n    r = s.spans.get('request', [])\n"
        "    return len(r) / s.window_s if r and s.window_s else None\n")
    bench["workloads"].append({"name": "adain_256.serve_int8_b8", "config": "adain_256",
                               "traffic": "serve_int8_b8", "chips": 1, "why": "host-paced"})
    for m in bench["end_to_end"]:
        if "serve_img_per_s" == m["name"] or "serve_p95_ms" == m["name"] or "workloads" not in m:
            m.setdefault("workloads", CELLS)
            m["workloads"].append("adain_256.serve_int8_b8")
    bench["per_layer"].append({"name": "requests_per_s.serve", "unit": "1/s", "better": "higher",
                               "source": "program_span", "layer": "entry", "moves":
                               "serve_img_per_s", "workloads": ["adain_256.serve_int8_b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = common.resolve("adain_256.serve_int8_b8", root=tmp_path)
    assert cell.traffic["batch"] == 8 and cell.limits == {"worst_image_rmse": 0.1}
    assert cell.kernels == ["int8_resblock"]
    assert [m["name"] for m in cell.per_layer] == ["requests_per_s.serve"]
    read = common.metric_reader("requests_per_s.serve", tmp_path / "portbench")
    from portbench.trace import Summary

    assert read(Summary(window_s=2.0, spans={"request": [{}] * 10})) == 5.0
    assert read(Summary()) is None
    for p, data in before.items():
        assert p.read_bytes() == data, p


@pytest.mark.parametrize("by", ["config", "mix"])
def test_a_reference_added_as_a_file_drives_a_run_without_editing_any(tmp_path, by):
    """A plain reference added as a new file, named by a new configuration
    (``configs/<config>.json``: ``reference`` -> ``reference/<name>.serve.py``)
    or by a new mix (``traffic/<mix>.json``: ``reference_role`` ->
    ``reference/adain.<role>.py``), is found by name and drives a whole
    small run on the CPU; the copy's existing files are left as they were."""
    import time

    from portbench import run as pbrun

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    config, traffic, ref = "adain_256", "serve_bf16_b64", "adain.serve_counted"
    if by == "config":
        config, ref = "adain_counted_256", "adain_counted.serve"
        data = json.loads((ROOT / "portbench/configs/adain_256.json").read_text())
        data.update(reference="adain_counted")
        (tmp_path / f"portbench/configs/{config}.json").write_text(json.dumps(data))
        bench["configs"].append({"name": config, "source": "https://example.org",
                                 "file": f"portbench/configs/{config}.json",
                                 "reduced": [], "why": "a reference of its own"})
    else:
        traffic = "serve_bf16_b64_counted"
        data = json.loads((ROOT / "portbench/traffic/serve_bf16_b64.json").read_text())
        data.update(reference_role="serve_counted")
        (tmp_path / f"portbench/traffic/{traffic}.json").write_text(json.dumps(data))
    (tmp_path / f"portbench/reference/{ref}.py").write_text(
        "from portbench.reference import nets\n"
        "calls = []\n"
        "def forward_random(weights, img, z, c, A):\n"
        "    calls.append(img.shape[0])\n"
        "    return nets.forward_random(weights, nets.adain_decoder, img, z, c, A)\n")
    name = f"{config}.{traffic}"
    (tmp_path / f"portbench/cells/{name}.json").write_text(
        json.dumps({"limits": {"worst_image_rmse": 0.03}, "kernels": ["adain"]}))
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": 1, "why": "a reference of its own"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = common.resolve(name, root=tmp_path)
    module = common.reference(cell, "serve", tmp_path / "portbench")
    assert Path(module.__file__) == tmp_path / f"portbench/reference/{ref}.py"
    cell.config = dict(cell.config, flags=dict(cell.config["flags"], crop_size=32, dim=8,
                                               latent_dim=4))
    cell.traffic = dict(cell.traffic, batch=2, pool=2, calibration_batch=2, warmup_requests=1,
                        checked_requests=2, check_block=2)
    r = pbrun.run_cell(name, 11, 0.2, False, device="cpu", root=tmp_path, cell=cell,
                       t0=time.perf_counter())
    assert r["correct"], r["compared"]
    # the check ran the new file's forward over the checked requests' images
    loaded = sys.modules["portbench_reference_" + ref.replace(".", "_")]
    assert sum(loaded.calls) >= 2 * 2
    for p, data in before.items():
        assert p.read_bytes() == data, p
