"""The comparison that decides ``correct``, at a size a CPU test run holds:
a sound run passes each cell's limits, the control (the reference in the
precision below the configuration's, in the program's place) fails one of
them, and a whole run with the timed path broken underneath comes out
``correct: false`` for each fault the cell can have. CPU only; the limits
are the cells' own (``portbench/cells/<cell>.json``), set from readings at
the cells' sizes on the card."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import common, readings  # noqa: E402
from portbench import run as pbrun  # noqa: E402

SERVE = ["adain_256.serve_int8_b64", "base_a_256.serve_int8_b64", "adain_256.serve_bf16_b64"]
TRAIN = ["adain_256.train_fused_b8"]
SEED = 3_000_000_019


def small(name: str):
    """The cell at a size a CPU test holds: 64 px, narrow nets, small batches
    (training: one stride-2 layer of the content discriminator and four of
    the patch discriminators, whose maps 64 px would shrink below their
    kernels; the fused resblock "on", so that its autograd Function runs on
    the CPU as "auto" runs it on the card)."""
    cell = common.resolve(name)
    if cell.traffic["kind"] == "serve_closed":
        cell.config = dict(cell.config, flags=dict(cell.config["flags"], crop_size=64, dim=16,
                                                   latent_dim=4))
        cell.traffic = dict(cell.traffic, batch=4, pool=4, calibration_batch=4,
                            warmup_requests=1, checked_requests=3, check_block=4,
                            trace_seconds=0.2)
    else:
        cell.config = dict(cell.config, flags=dict(cell.config["flags"], crop_size=64, dim=32))
        cell.traffic = dict(cell.traffic, pool=3, warmup_iterations=1, trace_seconds=0.2,
                            flags=dict(cell.traffic["flags"], batch_size=4,
                                       dis_content_layers=1, dis_content_final_kernel=2,
                                       dis_n_layers=4, fused_resblock="on"))
    return cell


def run_small(name: str, fault=None) -> dict:
    return pbrun.run_cell(name, SEED, 0.3, False, device="cpu", cell=small(name), fault=fault,
                          t0=time.perf_counter())


def failed_numbers(compared: dict) -> list:
    return [k for k, c in compared.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_sound_run_is_correct(name):
    r = run_small(name)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("name", SERVE)
def test_the_serving_control_fails(name):
    cell = small(name)
    got = readings.serve_reading(cell, SEED, torch.device("cpu"), control=True)
    assert got["worst_image_rmse"] > cell.limits["worst_image_rmse"], got


def test_the_training_control_fails():
    cell = small(TRAIN[0])
    got = readings.train_reading(cell, SEED, torch.device("cpu"), control=True)
    compared = {k: {"value": got[k], "limit": v} for k, v in cell.limits.items()}
    assert failed_numbers(compared), compared


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("fault", ["altered_image", "dropped_half"])
def test_a_broken_serving_path_is_not_correct(name, fault):
    r = run_small(name, readings.FAULTS[fault])
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch", "resblock_dw_double"])
def test_a_broken_training_step_is_not_correct(fault):
    r = run_small(TRAIN[0], readings.FAULTS[fault])
    assert not r["correct"], r["compared"]


def test_a_kernel_10_fault_is_taken_out_after_the_run():
    from masterthesis_tpu_torch.ops.kernels import resblock_train as krb

    sound = krb.resblock_bwd
    r = run_small(TRAIN[0], readings.FAULTS["resblock_dw_double"])
    assert r["compared"]["grad_gap"]["value"] > r["compared"]["grad_gap"]["limit"]
    assert krb.resblock_bwd is sound
