"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``instantsfm_tpu_torch/build/`` (listed in .gitignore) as
``lib<name>-<hash of the source>.so``, so an edited source is never served
from a stale library.  Where that directory cannot be written (an installed
package in a read-only site-packages), the libraries go to the user's cache,
``$XDG_CACHE_HOME`` or ``~/.cache``, under ``instantsfm_tpu_torch/build``.
Target: Hopper, ``sm_90a``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import stat
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# per library: {"seconds": build wall time (0.0 when already built),
#               "log": nvcc/ptxas output}
BUILD_INFO: dict = {}
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _writable(path: Path) -> bool:
    """Whether files can be made in the directory ``path``.  A directory
    without its owner's write bit counts as read-only even for root, whom
    ``os.access`` lets write anywhere."""
    return (os.access(path, os.W_OK | os.X_OK)
            and bool(path.stat().st_mode & stat.S_IWUSR))


def build_dir() -> Path:
    """``<package>/build`` where it (or, before it exists, the package
    directory) is writable; else the user's cache directory."""
    local = PKG_DIR / "build"
    if _writable(local if local.is_dir() else PKG_DIR):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "instantsfm_tpu_torch" / "build"


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build_all(names) -> None:
    """Compile every named source that is not built yet, one ``nvcc``
    process per source, all started together."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LOADED[name] = lib
    return lib
