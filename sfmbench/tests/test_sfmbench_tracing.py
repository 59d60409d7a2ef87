"""The per-layer metrics that read the program's tracing registry, on the
CPU: both cells traced at 20 cameras, and the choice of the window's
roots on a planted ring.

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
import program_roots  # noqa: E402
from instantsfm_tpu_torch.utils import debug  # noqa: E402

SEED = 3000000029
NEW = {"ring-200.ba": ("host_reads_per_lm_step", "pcg_iter_host_us",
                       "read_wait_ms_per_lm_step"),
       "ring-200.mapper": ("host_reads.mapper", "ra_read_wait_s")}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def traced(cell, monkeypatch, **lm):
    """A traced run of ``cell`` at 20 cameras, with ``lm`` set in its
    traffic's LM settings."""
    resolve = core.resolve_cell

    def resolve_cell(bench, name):
        out = resolve(bench, name)
        out["traffic"].get("lm", {}).update(lm)
        return out

    monkeypatch.setattr(core, "resolve_cell", resolve_cell)
    cfg = core.load_json(HERE / "configs" / "ring-200.json")
    cfg["scene"].update(num_cams=20, num_pts=3000, window=5)
    res = core.run_cell(cell, SEED, 0.0, True, time.perf_counter(),
                        device=torch.device("cpu"), config=cfg)
    return res, res.pop("_records")


def test_ba_cell_reports_the_registry_metrics_of_its_window(monkeypatch):
    # at 20 cameras the LM would pick its dense Schur solve; the cell's 200
    # cameras pick PCG, which the test names
    res, rec = traced("ring-200.ba", monkeypatch, solver="pcg")
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(m.get(k) is not None for k in NEW["ring-200.ba"]), m
    steps = core.load_json(HERE / "traffic" / "ba.json")["steps"]
    profiled = core.load_json(HERE / "traffic" / "ba.json")["profiled_units"]
    assert rec["units"] == 1
    roots = debug.REGISTRY.roots("lm.step")
    window, after = roots[-(1 + profiled) * steps:-profiled * steps], \
        roots[-profiled * steps:]
    # the waits are the window's own, not the profiled units'
    assert m["read_wait_ms_per_lm_step"] == \
        1e3 * program_roots.reads(window)[1]
    assert m["read_wait_ms_per_lm_step"] != \
        1e3 * program_roots.reads(after[:steps])[1]
    iters = sum(r["spans"]["pcg.iter"][0] for r in window)
    # pcg_iters_per_lm_step still reads the solver's counter, which the
    # registry's spans agree with
    assert m["pcg_iters_per_lm_step"] == iters / steps
    tries = sum(r["reads"]["lm.accept"][0] for r in window)
    reads = sum(n for r in window for n, _ in r["reads"].values())
    assert m["host_reads_per_lm_step"] == reads / steps
    assert iters < reads <= iters + 2 * tries
    assert m["pcg_iter_host_us"] > 0


def test_mapper_cell_reports_the_registry_metrics_of_its_window(monkeypatch):
    res, rec = traced("ring-200.mapper", monkeypatch)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert all(m.get(k) is not None for k in NEW["ring-200.mapper"]), m
    window = debug.REGISTRY.roots("mapper")[-2]
    assert m["ra_read_wait_s"] == program_roots.reads([window], "ra.")[1]
    assert m["host_reads.mapper"] == sum(n for n, _ in
                                         window["reads"].values())
    # ra_host_reads still reads the ra_syncs counter: the ra.* reads less
    # the two passes' result reads
    ra = program_roots.reads([window], "ra.")[0]
    assert m["ra_host_reads"] == ra - window["reads"]["ra.result"][0] == \
        ra - 2


def test_window_roots_takes_the_window_and_not_the_profiled_units(
        monkeypatch):
    reg = debug.Registry(ring_size=64)
    monkeypatch.setattr(debug, "REGISTRY", reg)
    for i in range(5 * 3):          # a warm-up unit, 2 window, 2 profiled
        with reg.span("unit.step"):
            reg.read("x", torch.tensor(i))
        with reg.span("other"):
            pass
    run = dict(units=[{}, {}], trace=dict(units=[{}, {}]))
    roots = program_roots.window_roots(run, "unit.step", k=3)
    assert len(roots) == 6 and all(
        a is b for a, b in zip(roots, reg.roots("unit.step")[3:9]))
    assert program_roots.reads(roots) == (1, pytest.approx(
        sum(r["reads"]["x"][1] for r in roots) / 6))
    assert program_roots.window_roots(run, "unit.step", k=4) is None
    assert program_roots.window_roots(run, "absent") is None


def test_readers_find_nothing_in_a_program_without_the_registry(monkeypatch):
    monkeypatch.delattr(debug, "REGISTRY")
    run = dict(units=[{"work": 20}], trace=dict(units=[{}]),
               traffic=dict(steps=20))
    bench = core.load_json(HERE.parent / "BENCHMARK.json")
    for cell, names in NEW.items():
        readers = core.resolve_cell(bench, cell)["readers"]
        for name in names:
            assert readers[name].read(run) is None
