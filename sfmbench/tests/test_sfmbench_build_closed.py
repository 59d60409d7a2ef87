"""``build_closed_share``, the share of the LM steps' system builds that
took the closed form, on the CPU: the BA cell traced at 20 cameras, the
metric read from planted ``lm.step`` roots, and nothing read from a
program without the registry.

    python -m pytest sfmbench/tests/test_sfmbench_build_closed.py -q
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
from instantsfm_tpu_torch.utils import debug  # noqa: E402

SEED = 3000000041
CELL = "ring-200.ba"
METRIC = "build_closed_share"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def reader():
    bench = core.load_json(HERE.parent / "BENCHMARK.json")
    return core.resolve_cell(bench, CELL)["readers"][METRIC]


def test_ba_cell_builds_every_step_in_closed_form(monkeypatch):
    """A traced run of the BA cell at 20 cameras (PCG named, as the cell's
    200 cameras pick it): every step of the window took the closed form,
    its plain version on the CPU."""
    resolve = core.resolve_cell

    def resolve_cell(bench, name):
        out = resolve(bench, name)
        out["traffic"].get("lm", {}).update(solver="pcg")
        return out

    monkeypatch.setattr(core, "resolve_cell", resolve_cell)
    cfg = core.load_json(HERE / "configs" / "ring-200.json")
    cfg["scene"].update(num_cams=20, num_pts=3000, window=5)
    res = core.run_cell(CELL, SEED, 0.0, True, time.perf_counter(),
                        device=torch.device("cpu"), config=cfg)
    res.pop("_records")
    assert res["correct"]
    assert res["metrics"][METRIC]["value"] == 100.0
    traffic = core.load_json(HERE / "traffic" / "ba.json")
    steps, profiled = traffic["steps"], traffic["profiled_units"]
    window = debug.REGISTRY.roots("lm.step")[
        -(1 + profiled) * steps:-profiled * steps]
    assert sum(r["counters"]["lm_build_closed"] for r in window) == steps
    assert not any(r["counters"].get("lm_build_autodiff") for r in window)


def test_build_closed_share_reads_the_steps_counters(monkeypatch):
    """The share from the run counters summed into each ``lm.step`` root;
    None where the roots carry neither counter (a program without them)."""
    reg = debug.Registry(ring_size=64)
    monkeypatch.setattr(debug, "REGISTRY", reg)
    read = reader().read
    run = dict(units=[{}], trace=dict(units=[{}]), traffic=dict(steps=2))

    def steps(*paths):
        for path in paths:
            with reg.span("lm.step"):
                if path:
                    debug.stat_add(path, 1)

    steps("lm_build_closed", "lm_build_closed", None, None)
    assert read(run) == 100.0
    steps("lm_build_closed", "lm_build_autodiff", None, None)
    assert read(run) == 50.0
    steps(None, None, None, None)
    assert read(run) is None
    debug.drain_stats()


def test_build_closed_share_finds_nothing_without_the_registry(monkeypatch):
    monkeypatch.delattr(debug, "REGISTRY")
    run = dict(units=[{"work": 20}], trace=dict(units=[{}]),
               traffic=dict(steps=20))
    assert reader().read(run) is None
