"""``solve_kernel_share``, the share of the LM steps' damped solves that
took the solve kernels, on the CPU: the metric read from planted
``lm.step`` roots (100, 0, a mix, None where no step solved on the PCG
path), nothing read from a program without the registry, and its entry in
``BENCHMARK.json``.

    python -m pytest sfmbench/tests/test_sfmbench_solve_kernel.py -q
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import core  # noqa: E402
from instantsfm_tpu_torch.utils import debug  # noqa: E402

CELL = "ring-200.ba"
METRIC = "solve_kernel_share"


def reader():
    bench = core.load_json(HERE.parent / "BENCHMARK.json")
    return core.resolve_cell(bench, CELL)["readers"][METRIC]


KERNEL, TORCH = "lm_solve_kernel", "lm_solve_torch"


@pytest.mark.parametrize("tries,want", [
    ([(KERNEL,), (KERNEL, KERNEL)], 100.0),
    ([(TORCH,), (TORCH,)], 0.0),
    ([(KERNEL, KERNEL), (TORCH,)], 200 / 3),
    ([(), ()], None),
])
def test_solve_kernel_share_reads_the_steps_counters(tries, want,
                                                     monkeypatch):
    """The share from the run counters summed into the window's ``lm.step``
    roots, a count a damped try (a try on the dense path counts neither);
    None where the roots carry neither counter, as in a program without
    them.  The window is the first two of the four steps planted (one
    window unit and one profiled unit of two steps)."""
    reg = debug.Registry(ring_size=64)
    monkeypatch.setattr(debug, "REGISTRY", reg)
    run = dict(units=[{}], trace=dict(units=[{}]), traffic=dict(steps=2))
    for step in [*tries, (TORCH,), (TORCH,)]:
        with reg.span("lm.step"):
            for path in step:
                debug.stat_add(path, 1)
    got = reader().read(run)
    assert got is None if want is None else got == pytest.approx(want)
    debug.drain_stats()


def test_solve_kernel_share_finds_nothing_without_the_registry(monkeypatch):
    monkeypatch.delattr(debug, "REGISTRY")
    run = dict(units=[{"work": 20}], trace=dict(units=[{}]),
               traffic=dict(steps=20))
    assert reader().read(run) is None


def test_solve_kernel_share_is_a_per_layer_metric_of_the_ba_cell():
    bench = core.load_json(HERE.parent / "BENCHMARK.json")
    entry, = [m for m in bench["per_layer"] if m["name"] == METRIC]
    assert entry == {"name": METRIC, "unit": "%", "better": "higher",
                     "source": "program_counter", "layer": "LM loop and PCG",
                     "moves": "ba_lm_iters_per_s", "workloads": [CELL]}
    assert bench["per_layer"][-1] is entry
    assert METRIC in core.resolve_cell(bench, CELL)["readers"]
