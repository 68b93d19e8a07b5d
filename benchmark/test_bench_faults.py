"""Whole runs at a tiny size on the CPU, the harness's look for a card
skipped: a sound run comes out `correct`; a run with its timed path broken
underneath, and the control (the reference in the precision below the
configuration's, in the program's place), come out not correct against the
cells' own limits.

Faults (`benchmark/faults.py`), each of the kinds a cell can have: half
of the batch left out, an answer altered where it is produced, a training
step that returns its state unchanged. (No cell runs on more than one
card, so none can leave out an exchange between cards.)

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, faults, run

MANIFEST = run.load_json(run.ROOT / "BENCHMARK.json")
CPU = torch.device("cpu")
TINY = {
    "segpp-volume-n160": {"traffic": {
        "slices": 4, "size": 64, "calibration_slices": 4, "volumes": 2,
        "kept": 2, "warmup_requests": 1}},
    # float32 on the CPU: the program's bfloat16 path there is the plain
    # version's, whose rounding at 64^2 says nothing of the card's
    "infer-s640-b64": {"config": {"variant": "n", "dtype": "float32"},
                       "traffic": {"batch": 2, "height": 48, "width": 64,
                                   "imgsz": 64, "batches": 2, "kept": 2,
                                   "warmup_requests": 1}},
    "decoder-train-n160-b128": {"traffic": {
        "batch": 4, "size": 64, "distinct": 3, "calibration_images": 4}},
}
FAULTS = [("segpp-volume-n160", "half_batch"),
          ("segpp-volume-n160", "altered_answer"),
          ("infer-s640-b64", "half_batch"),
          ("infer-s640-b64", "altered_answer"),
          ("decoder-train-n160-b128", "half_batch"),
          ("decoder-train-n160-b128", "unchanged")]
CONTROL_TINY = {
    "segpp-volume-n160": TINY["segpp-volume-n160"],
    "infer-s640-b64": {"config": {"variant": "n"},
                       "traffic": TINY["infer-s640-b64"]["traffic"]},
    "decoder-train-n160-b128": TINY["decoder-train-n160-b128"],
}


def tiny_run(cell: str, seed: int = 7) -> dict:
    return run.run_cell(cell, seed, 0.2, False, CPU, time.time(), MANIFEST,
                        TINY[cell])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    res = tiny_run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    driver = run.cell_files(cell, MANIFEST)["traffic"]["driver"]
    with faults.planted(fault, driver):
        res = tiny_run(cell)
    assert not res["correct"], res["checks"]
    if fault == "altered_answer":
        assert res["checks"]["dets_differ"]["value"] >= 1
    if fault == "unchanged":
        assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", sorted(CONTROL_TINY))
def test_control_is_not_correct(cell):
    """The control at a tiny size fails one of the cell's limits (on the
    card at the cell's own size: `python3 -m benchmark.control`)."""
    limits = run.cell_files(cell, MANIFEST)["limits"]
    got = control.readings(cell, 5, False, True, CPU,
                           CONTROL_TINY[cell])["control"]
    assert any(v > limits[k] for k, v in got.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct_on_the_card(cell, cuda):
    """The same at the cell's own size, on the card."""
    limits = run.cell_files(cell, MANIFEST)["limits"]
    got = control.readings(cell, 5, False, True, cuda)["control"]
    assert any(v > limits[k] for k, v in got.items()), got


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
