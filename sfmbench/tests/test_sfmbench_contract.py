"""The benchmark's definition on the CPU: names, files, imports and exits.

    python -m pytest sfmbench/tests -q
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]          # sfmbench/
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import core  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "instantsfm_tpu"}


def test_keys_and_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "sfmbench/run.py"]
    assert BENCH["paths"] == ["sfmbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(BENCH["workloads"])
    # a full check with 24 cells must fit its time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_names_and_units_use_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("sfmbench/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_its_files_by_name(cell):
    resolved = core.resolve_cell(BENCH, cell)
    e2e = {m["name"] for m in resolved["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert resolved["per_layer"], "every cell reports a per-layer metric"
    assert resolved["traffic"]["rate"]["metric"] in e2e
    for m in resolved["per_layer"]:
        assert callable(resolved["readers"][m["name"]].read)
        assert m["moves"] in e2e
    assert resolved["limits"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "yardstick").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "instantsfm_tpu_torch" not in _imports(path)


def test_yardstick_loads_without_the_program():
    code = ("import sys; sys.path.insert(0, 'sfmbench');"
            "import yardstick.ring, yardstick.model, yardstick.roofline,"
            " yardstick.ba_reference, yardstick.trace, yardstick.readers;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    tops = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"instantsfm_tpu_torch"})


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "sfmbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "3000000000",
         "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_run_with_only_the_benchmark_files_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "sfmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
