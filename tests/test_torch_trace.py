"""The port's tracing registry (``instantsfm_tpu_torch/utils/debug.py``):
spans, host reads and root records on their own, then at their call sites
in rotation averaging and the LM step, and a check that the mapper path
and the LM engine read the device only through ``debug.read``."""

import ast
import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from instantsfm_tpu_torch.pipeline import rotation_averaging as tra
from instantsfm_tpu_torch.scene import types as ttypes
from instantsfm_tpu_torch.solve import block_lm as tbl
from instantsfm_tpu_torch.solve import robust as trobust
from instantsfm_tpu_torch.utils import debug
from tests.synthetic import make_scene
from tests.test_rotation_averaging import L1_OPTS, RA_OPTS, _make_graph
from tests.test_torch_block_lm import _ba_torch

PORT = Path(__file__).resolve().parents[1] / "instantsfm_tpu_torch"
TRACED = ["pipeline/mapper.py", "pipeline/relpose.py",
          "pipeline/rotation_averaging.py", "pipeline/vgc.py",
          "pipeline/tracks.py", "pipeline/positioning.py", "pipeline/ba.py",
          "pipeline/filters.py", "solve/block_lm.py", "solve/pcg.py",
          "solve/blocked.py", "math/fivepoint.py", "parallel/sharded.py",
          "utils/loops.py"]


def _last_root(name):
    return debug.REGISTRY.roots(name)[-1]


# ----------------------------------------------------------------- registry

def test_nested_spans_keep_count_total_and_self():
    reg = debug.Registry()
    with reg.span("outer"):
        for _ in range(3):
            with reg.span("inner"):
                time.sleep(0.002)
        time.sleep(0.002)
    rec = reg.ring[-1]
    n_out, total_out, self_out = rec["spans"]["outer"]
    n_in, total_in, self_in = rec["spans"]["inner"]
    assert (n_out, n_in) == (1, 3)
    assert self_in == total_in >= 0.006
    assert self_out == pytest.approx(total_out - total_in, abs=1e-12)
    assert self_out >= 0.002
    assert rec["name"] == "outer" and rec["seconds"] == total_out
    assert reg.totals["inner"] == [3, total_in, self_in]


def test_reads_return_host_values_and_are_counted_with_their_wait():
    reg = debug.Registry()
    with reg.span("root"):
        flag = reg.read("a.flag", torch.tensor(True))
        arr = reg.read("a.arr", torch.arange(3))
        pair = reg.read("a.pair", (torch.ones(2), torch.zeros((1, 2))))
        again = reg.read("a.flag", torch.tensor(1.5))
    assert flag is True and again == 1.5
    np.testing.assert_array_equal(arr, [0, 1, 2])
    assert isinstance(pair, tuple) and pair[1].shape == (1, 2)
    rec = reg.ring[-1]
    assert {k: v[0] for k, v in rec["reads"].items()} == \
        {"a.flag": 2, "a.arr": 1, "a.pair": 1}
    waits = sum(w for _, w in rec["reads"].values())
    # the reads are the root's children: its self time excludes their wait
    _, total, own = rec["spans"]["root"]
    assert own == pytest.approx(total - waits, abs=1e-12)
    assert rec["reads"]["a.arr"] == rec["spans"]["read:a.arr"][:2]
    assert reg.read_count() == 4


def test_root_records_sit_in_a_bounded_ring():
    reg = debug.Registry(ring_size=4)
    for i in range(10):
        with reg.span("even" if i % 2 == 0 else "odd"):
            pass
    assert reg.roots_closed == 10 and len(reg.ring) == 4
    assert [r["name"] for r in reg.ring] == ["even", "odd", "even", "odd"]
    assert len(reg.roots("odd")) == 2
    assert reg.totals["even"][0] == 5


def test_traced_runs_the_function_in_its_span():
    @debug.traced("test.traced")
    def f(x, y=1):
        """f's own docstring."""
        with debug.span("test.inner"):
            return x + y

    closed = debug.REGISTRY.roots_closed
    assert f(2, y=3) == 5 and f.__doc__ == "f's own docstring."
    assert debug.REGISTRY.roots_closed == closed + 1
    rec = _last_root("test.traced")
    assert rec["spans"]["test.traced"][0] == rec["spans"]["test.inner"][0] == 1


def test_drain_stats_leaves_the_ring_alone():
    with debug.span("test.drain"):
        debug.stat_add("test_counter", 1)
    closed = debug.REGISTRY.roots_closed
    assert debug.drain_stats()["test_counter"] == [1]
    assert debug.REGISTRY.roots_closed == closed
    assert _last_root("test.drain")["spans"]["test.drain"][0] == 1


def test_profiler_scopes_only_while_a_profiler_runs(monkeypatch):
    opened = []
    real = debug.record_function
    monkeypatch.setattr(debug, "record_function",
                        lambda name: opened.append(name) or real(name))
    with debug.span("test.quiet"):
        debug.read("test.quiet", torch.tensor(False))
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with debug.span("test.loud"):
            debug.read("test.loud", torch.ones(2))
    assert opened == ["test.loud", "read:test.loud"]
    names = {e.name for e in prof.events()}
    assert {"test.loud", "read:test.loud"} <= names


def test_spans_on_other_threads_keep_nothing():
    reg = debug.Registry()

    def work():
        with reg.span("worker"):
            reg.read("worker.x", torch.tensor(1))

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert reg.roots_closed == 0 and not reg.totals and not reg._stack


# ---------------------------------------------------------- the call sites

def test_rotation_averaging_reads_are_its_syncs_and_its_result():
    vg, images, _ = _make_graph(np.random.default_rng(0), n=15,
                                extra_edges=30)
    port = lambda o: getattr(ttypes, type(o).__name__)(**{
        f.name: getattr(o, f.name)
        for f in dataclasses.fields(getattr(ttypes, type(o).__name__))})
    vg, images = port(vg), port(images)
    debug.drain_stats()
    with debug.span("test.ra"):
        assert tra.estimate_rotations(vg, images, RA_OPTS, L1_OPTS,
                                      device="cpu")
    syncs = debug.drain_stats()["ra_syncs"][0]
    rec = _last_root("test.ra")
    ra = {site: n for site, (n, _) in rec["reads"].items()
          if site.startswith("ra.")}
    assert ra == {**{f"ra.{k}": n for k, n in syncs.items()}, "ra.result": 1}
    assert syncs["cg"] >= 1 and syncs["l1"] >= 1
    spans = rec["spans"]
    assert spans["ra.irls"][0] == syncs["irls"]
    assert spans["ra.l1"][0] == syncs["l1"]
    assert spans["ra.admm"][0] == syncs["admm"]
    assert spans["ra.mst"][0] == 1


def test_lm_step_reads_agree_with_pcg_iterations_and_tries():
    problem, params, obs = _ba_torch(make_scene(num_cams=8, num_pts=100,
                                                noise=0.5),
                                     q_noise=0.02, t_noise=0.1, p_noise=0.1)
    cfg = tbl.LMConfig(solver="pcg", pcg_iters=60)
    z = torch.zeros((), dtype=torch.float64)
    state = tbl.LMState(params, torch.tensor(1e-4, dtype=torch.float64),
                        torch.tensor(float("inf"), dtype=torch.float64), z, z)
    debug.drain_stats()
    closed = debug.REGISTRY.roots_closed
    tbl.lm_step(problem, trobust.huber(1.0), cfg, state, obs, device="cpu")
    stats = debug.drain_stats()
    iters, tries = stats["pcg_iters"], stats["lm_tries"][0]
    assert debug.REGISTRY.roots_closed == closed + 1
    rec = _last_root("lm.step")
    assert len(iters) == tries and sum(iters) > 0
    # one exit test an iteration, and one more where the test ended a solve
    assert rec["reads"]["pcg.exit"][0] == \
        sum(iters) + sum(i < cfg.pcg_iters for i in iters)
    assert rec["reads"]["lm.accept"][0] == tries
    assert set(rec["reads"]) == {"pcg.exit", "lm.accept"}
    spans = rec["spans"]
    assert spans["pcg.iter"][0] == sum(iters)
    assert spans["lm.solve"][0] == spans["lm.loss"][0] == tries
    assert spans["lm.build"][0] == spans["lm.step"][0] == 1


# ------------------------------------------------------- no bare reads left

_BARE = {"item", "tolist", "cpu"}


def _bare_reads(tree):
    """Calls of ``.item()``, ``.tolist()``, ``.cpu()`` or ``torch.equal``
    outside the arguments of a ``read(...)`` call: (line, text) each."""
    found = []

    def is_read(call):
        f = call.func
        return (isinstance(f, ast.Name) and f.id == "read") or \
            (isinstance(f, ast.Attribute) and f.attr == "read")

    def visit(node, inside):
        if isinstance(node, ast.Call):
            f = node.func
            if not inside and isinstance(f, ast.Attribute) and (
                    f.attr in _BARE or (f.attr == "equal" and isinstance(
                        f.value, ast.Name) and f.value.id == "torch")):
                found.append((node.lineno, ast.unparse(node)))
            inside = inside or is_read(node)
        for child in ast.iter_child_nodes(node):
            visit(child, inside)

    visit(tree, False)
    return found


def test_bare_read_finder_sees_what_it_looks_for():
    tree = ast.parse("a.cpu().numpy()\nb.item()\ntorch.equal(x, y)\n"
                     "c.tolist()\nread('s', d.cpu())\ndebug.read('s', e)\n")
    assert [line for line, _ in _bare_reads(tree)] == [1, 2, 3, 4]


@pytest.mark.parametrize("module", TRACED)
def test_no_bare_device_read_on_the_traced_path(module):
    tree = ast.parse((PORT / module).read_text())
    assert _bare_reads(tree) == []
