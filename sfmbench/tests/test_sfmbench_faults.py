"""The check that decides ``correct``, shown to fail.

Each test drives the rest of a run on the CPU at a small size (the cell's
configuration with fewer cameras and points; the look for a card skipped)
with the timed path broken underneath, and sees ``correct`` come out false;
a sound run beside them comes out true.  The control, the reference in
the program's place one precision below the configuration's, is held at
the same size in ``test_ba_control_fails`` and
``test_mapper_control_fails``.

    python -m pytest sfmbench/tests -q
"""

import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import core  # noqa: E402
import faults  # noqa: E402

SEED = 3000000017


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_config(cams=20, pts=3000, window=5):
    cfg = core.load_json(HERE / "configs" / "ring-200.json")
    cfg["scene"].update(num_cams=cams, num_pts=pts, window=window)
    return cfg


def run(cell, **kw):
    res = core.run_cell(cell, SEED, 0.0, False, time.perf_counter(),
                        device=torch.device("cpu"), config=small_config(),
                        **kw)
    res.pop("_records")
    return res


# ------------------------------------------------------------------ BA cell

BA = "ring-200.ba"


def test_ba_sound_run_is_correct():
    assert run(BA)["correct"]


def test_ba_control_fails():
    """The reference in the program's place in float32 with its products
    in TF32: the limits are tighter than that precision allows."""
    res = run(BA, control=True)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", ["step_unchanged", "half_batch",
                                   "point_altered"])
def test_ba_fault_fails(fault):
    undo = faults.plant(fault)
    try:
        assert not run(BA)["correct"]
    finally:
        undo()


# -------------------------------------------------------------- mapper cell

MAPPER = "ring-200.mapper"


def test_mapper_sound_run_is_correct():
    assert run(MAPPER)["correct"]


def test_mapper_control_fails():
    """The reference in the final bundle-adjustment round's place in
    float32 with its products in TF32."""
    res = run(MAPPER, control=True)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("fault", ["pose_altered", "step_unchanged",
                                   "half_batch", "ba_stage_frozen"])
def test_mapper_fault_fails(fault):
    undo = faults.plant(fault)
    try:
        assert not run(MAPPER)["correct"]
    finally:
        undo()
