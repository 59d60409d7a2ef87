"""Packaging of the port's CUDA sources, on the CPU.

A wheel built offline from the project's metadata carries both
``instantsfm_tpu_torch/csrc/*.cu`` and the port's console scripts, and
``utils/build.py`` builds into ``<package>/build`` where it can write there
and into the user cache directory where it cannot (a read-only installed
package), and processes that build at once each find a whole library.
``nvcc`` is replaced by a stub that writes its output file: no compile.
No module of the package imports JAX, the JAX package or the measuring
code beside it."""

import ast
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "instantsfm_tpu_torch"


def test_wheel_carries_the_cuda_sources(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for f in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / f, src / f)
    shutil.copytree(PKG, src / PKG.name,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                    "--no-build-isolation", "--no-index", "-q", "-w",
                    str(tmp_path / "dist"), str(src)], check=True,
                   capture_output=True)
    wheel, = (tmp_path / "dist").glob("*.whl")
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
        entry = z.read(next(n for n in names
                            if n.endswith("entry_points.txt"))).decode()
    cu = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert cu == ["ba_build.cu", "composite_tiles.cu", "schur_wchain.cu"]
    assert all(f"instantsfm_tpu_torch/csrc/{f}" in names for f in cu)
    for name, target in (("ins-torch-sfm", "instantsfm_tpu_torch.cli.sfm"),
                         ("ins-torch-feat", "instantsfm_tpu_torch.cli.feat"),
                         ("ins-torch-gs", "instantsfm_tpu_torch.cli.gs"),
                         ("ins-sfm", "instantsfm_tpu.cli.sfm")):
        assert f"{name} = {target}:main" in entry


def test_program_imports_no_jax_and_no_measuring_code():
    """Every module of the port, parsed: it imports neither JAX nor the JAX
    package (the port uses JAX only in tests), nor the benchmark
    (``sfmbench``, its ``yardstick``), ``chip_smoke``, a root ``bench*``
    script or ``tools``."""
    banned = {"jax", "instantsfm_tpu", "sfmbench", "yardstick", "chip_smoke",
              "tools"} | {p.stem for p in REPO.glob("bench*.py")}
    found = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.relative_to(REPO)}:{node.lineno} {name}"
                      for name in names if name.split(".")[0] in banned]
    assert "bench_torch" in banned and not found, found


def _copied_build_module(root: Path):
    """``utils/build.py`` of a copy of the package under ``root``, loaded
    from there (its package directory is the copy)."""
    pkg = root / PKG.name
    shutil.copytree(PKG, pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    spec = importlib.util.spec_from_file_location(
        "copied_build", pkg / "utils" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return pkg, mod


def _stub_nvcc(tmp_path, monkeypatch, mod):
    """``nvcc`` replaced by a script that writes the file after ``-o``."""
    stub = tmp_path / "nvcc"
    stub.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w')"
                    ".write('stub')\n")
    stub.chmod(0o755)
    monkeypatch.setattr(mod, "_nvcc", lambda: str(stub))


@pytest.mark.parametrize("layout", ["build_dir_read_only",
                                    "package_read_only", "writable"])
def test_build_dir_falls_back_to_user_cache(layout, tmp_path, monkeypatch):
    pkg, mod = _copied_build_module(tmp_path / "site")
    cache = tmp_path / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    _stub_nvcc(tmp_path, monkeypatch, mod)
    if layout == "build_dir_read_only":
        (pkg / "build").mkdir()
    ro = {"build_dir_read_only": pkg / "build",
          "package_read_only": pkg}.get(layout)
    if ro is not None:
        ro.chmod(0o555)
    try:
        where = Path(mod.build_dir())
        mod.build_all(["schur_wchain"])
        built = list(where.glob("libschur_wchain-*.so"))
        # a second build finds the library and starts no nvcc
        monkeypatch.setattr(mod, "_nvcc", lambda: pytest.fail("rebuilt"))
        mod.build_all(["schur_wchain"])
    finally:
        if ro is not None:
            ro.chmod(0o755)
    want = (pkg / "build" if layout == "writable"
            else cache / "instantsfm_tpu_torch" / "build")
    assert where == want
    assert len(built) == 1 and built[0].read_text() == "stub"
    local = list((pkg / "build").glob("*")) if (pkg / "build").exists() \
        else []
    assert (local == built) == (layout == "writable")


RACE_SCRIPT = """
import importlib.util, hashlib, json, os, sys, time
spec = importlib.util.spec_from_file_location("copied_build", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
while not os.path.exists(sys.argv[2]):
    time.sleep(0.001)
time.sleep(0.04 * int(sys.argv[3]))
mod.build_all(["schur_wchain", "composite_tiles"])
print(json.dumps({n: hashlib.sha256(mod._target(n).read_bytes()).hexdigest()
                  for n in ("schur_wchain", "composite_tiles")}))
"""


def test_processes_building_at_once_find_whole_libraries(tmp_path):
    """Four processes reach ``build_all`` on a fresh package 40 ms apart,
    as the ranks of a multi-process run do, while the first is still
    compiling: each compiles into a file of its own and moves it into
    place, so whatever each then finds under the library's name is a whole
    library, and no partial file is left.  The stub ``nvcc`` writes its
    output in 32 pieces 5 ms apart, so a build written in place would be
    found half done."""
    pkg, _ = _copied_build_module(tmp_path / "site")
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir()
    stub = stub_dir / "nvcc"
    stub.write_text(f"#!{sys.executable}\nimport sys, time\n"
                    "with open(sys.argv[sys.argv.index('-o') + 1], 'wb') as f:\n"
                    "    for _ in range(32):\n"
                    "        f.write(b'x' * 4096)\n"
                    "        f.flush()\n"
                    "        time.sleep(0.005)\n")
    stub.chmod(0o755)
    go = tmp_path / "go"
    env = dict(os.environ, PATH=f"{stub_dir}{os.pathsep}{os.environ['PATH']}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RACE_SCRIPT, str(pkg / "utils" / "build.py"),
         str(go), str(i)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(4)]
    go.touch()
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    whole = hashlib.sha256(b"x" * 4096 * 32).hexdigest()
    for out, _ in outs:
        assert set(json.loads(out).values()) == {whole}
    built = sorted(p.name for p in (pkg / "build").iterdir())
    assert len(built) == 2 and all(n.endswith(".so") for n in built), built
