"""Benchmark of the InstantSfM PyTorch/CUDA port on the card.

    python3 sfmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (see ``core.py``) on one card and
prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the check compared, with
its limit, which are also the last lines on standard error.

Exits 2 without a CUDA card (or with fewer than the cell asks for), 3 when
the cell cannot be resolved or the program is missing, 4 when a module of
JAX or of the JAX package was loaded; none of these prints a result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".sfmbench_cache"


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so only a cell's first run there builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fixed_caches()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import torch

    import core

    try:
        bench = core.load_json(ROOT / "BENCHMARK.json")
        cell = core.resolve_cell(bench, args.workload)
    except (OSError, KeyError, core.HarnessError) as exc:
        core.log(f"cannot resolve {args.workload!r}: {exc!r}")
        return 3
    chips = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"{args.workload} needs {chips} CUDA card(s); "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                 " available")
        return 2
    try:
        import instantsfm_tpu_torch  # noqa: F401
    except ImportError as exc:
        core.log(f"the program is missing: {exc!r}")
        return 3

    result = core.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_PROCESS, bench=bench)
    bad = core.forbidden_modules()
    if bad:
        core.log(f"modules of JAX or of the JAX package were loaded: {bad}")
        return 4
    extra = result.pop("_records")
    core.log(f"unit seconds: {extra['unit_seconds']}")
    if any(extra["unit_spans"]):
        core.log(f"unit spans: {json.dumps(extra['unit_spans'])}")
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
