"""``pcg_graph_share`` on planted registries: the share of the window's
damped solves that ran on the program's CUDA graphs, and None where no
solve did (the CPU's eager loop, or a program without the graph path).

    python -m pytest sfmbench/tests -q
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import core  # noqa: E402
from instantsfm_tpu_torch.utils import debug  # noqa: E402

READER = core.load_module(HERE / "metrics" / "pcg_graph_share.py",
                          "sfmbench_metric_pcg_graph_share")


def planted(monkeypatch, graphs):
    """A warm-up unit, one window unit and one profiled unit of 2 steps;
    each step two solves, the first ``graphs`` of them on the graph path
    (window and profiled units alike)."""
    reg = debug.Registry(ring_size=64)
    monkeypatch.setattr(debug, "REGISTRY", reg)
    for _ in range(3 * 2):
        with reg.span("lm.step"):
            for i in range(2):
                with reg.span("lm.solve"):
                    if i < graphs:
                        with reg.span("pcg.graph"):
                            pass
                    else:
                        with reg.span("pcg.iter"):
                            pass
    return dict(units=[{}], trace=dict(units=[{}]), traffic=dict(steps=2))


@pytest.mark.parametrize("graphs,share", [(2, 100.0), (1, 50.0), (0, None)])
def test_pcg_graph_share_reads_the_window(monkeypatch, graphs, share):
    assert READER.read(planted(monkeypatch, graphs)) == share


def test_pcg_graph_share_finds_nothing_without_the_window(monkeypatch):
    run = planted(monkeypatch, 2)
    run["units"] = [{}, {}, {}]     # more units than the ring holds steps of
    assert READER.read(run) is None
