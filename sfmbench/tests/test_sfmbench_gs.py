"""The 3DGS cell ``gs-100k.train`` at a tiny size on the CPU: a sound run
reads ``correct`` true; its control (the reference in float32 with
TF32-rounded products in the program's place) and six planted faults
(``gs_faults.py``: the probe's gradient summed unnormalised, SH capped at
degree 0, the pairs cut at the JAX package's 16-tile / 512-slot budgets,
the means' learning rate left undecayed, the growth threshold doubled,
the split children left on their parents) read it false.

The configuration keeps its shapes and is cut in scale: 3,000
ground-truth gaussians and 300 SfM points, 8 views at 80 x 64 with a long focal length (the sparse points'
first gaussians cover more than 4 x 4 tiles, which the JAX package's
budget cuts), 400 set-up steps (the unit's 100 steps end in the refine at
step 500, the strategy's first), SH degree raised every 100 steps.

    python -m pytest sfmbench/tests/test_sfmbench_gs.py -q
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
import gs_faults  # noqa: E402,F401  (adds the 3DGS faults)

CELL, SEED = "gs-100k.train", 3000000017


@pytest.fixture(scope="module", autouse=True)
def lean():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(n)


def small_config():
    cfg = core.load_json(HERE / "configs" / "gs-100k.json")
    cfg["scene"].update(num_gaussians=3000, num_points=300, num_views=8,
                        width=80, height=64, focal=200.0)
    cfg["setup_steps"] = 400
    cfg["program"]["gsconfig"] = {"sh_degree_interval": 100}
    cfg["trainer"]["sh_degree_interval"] = 100
    return cfg


def run(**kw):
    res = core.run_cell(CELL, SEED, 0.0, False, time.perf_counter(),
                        device=torch.device("cpu"), config=small_config(),
                        **kw)
    res.pop("_records")
    return res


def test_gs_sound_run_is_correct():
    res = run()
    assert res["correct"] and res["attempted"] == 1
    assert res["compared"]["pairs_cut"]["value"] == 0
    assert res["compared"]["refine_mismatch"]["value"] == 0


def test_gs_control_fails():
    assert not run(control=True)["correct"]


@pytest.mark.parametrize("fault", ["unnormalised_probe", "sh_degree_zero",
                                   "pairs_cut", "means_lr_undecayed",
                                   "grow_threshold_doubled",
                                   "split_children_unmoved"])
def test_gs_fault_fails(fault):
    repair = faults.plant(fault)
    try:
        res = run()
    finally:
        repair()
    assert not res["correct"], res["compared"]
