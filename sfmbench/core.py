"""The harness: a cell of ``BENCHMARK.json`` resolved by name and run.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by its name:

- ``configs/<config>.json``: the configuration's sizes;
- ``traffic/<mix>.json``: the unit of work the window repeats (``unit``
  names a module in ``units/``), its parameters, and the end-to-end rate
  it yields;
- ``limits/<cell>.json``: each number that decides ``correct``, with its
  limit;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns its value or None where it finds nothing to read.

A run: set-up (inputs from the seed, the program's own set-up, one warm-up
unit), the window (whole units back to back until ``seconds`` have passed;
the last unit started runs to its end and counts), with ``trace`` a few
more units under ``torch.profiler``, then the check of every answer
against the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "instantsfm_tpu")


class HarnessError(RuntimeError):
    """A cell that cannot be run as asked (exit code 3)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise HarnessError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve_cell(bench: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, traffic, limits, its
    end-to-end metrics and the readers of its per-layer metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[cell["config"]]
    root = HERE.parent
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name]) and m["moves"] in names]
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return dict(
        cell=cell, config=load_json(root / conf["file"]), traffic=traffic,
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=layer,
        unit=load_module(HERE / "units" / f"{traffic['unit']}.py",
                         f"sfmbench_unit_{traffic['unit']}"),
        readers={m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py",
                                        f"sfmbench_metric_{m['name']}")
                 for m in layer})


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[sfmbench] {msg}", file=sys.stderr, flush=True)


def set_precision(torch, control: bool) -> None:
    """Float32 as the configurations state it: no TF32 in cuBLAS or cuDNN.
    The control runs with TF32 on, the nearest precision below."""
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control


def run_window(unit, seconds: float, sync) -> list:
    """Whole units until ``seconds`` have passed since the first began:
    their records and the seconds from the first's start to the last's
    end."""
    records = []
    t_start = time.perf_counter()
    while not records or time.perf_counter() - t_start < seconds:
        t0 = time.perf_counter()
        rec = unit.run()
        sync()
        rec["seconds"] = time.perf_counter() - t0
        records.append(rec)
    return records, time.perf_counter() - t_start


def profile_units(unit, n: int, sync):
    from torch.profiler import ProfilerActivity, profile

    records = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            t0 = time.perf_counter()
            rec = unit.run()
            sync()
            rec["seconds"] = time.perf_counter() - t0
            records.append(rec)
    return prof, records


def judge(rows: list, limits: dict):
    """(worst value of each number over the answers, answers that failed)."""
    worst = {k: max((r[k] for r in rows), default=float("inf"))
             for k in limits}
    failed = sum(any(not r[k] <= lim for k, lim in limits.items())
                 for r in rows)
    return worst, failed


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_process: float, device=None, config=None,
             control: bool = False, bench: dict = None) -> dict:
    """One run of the cell; returns the result line's object.  ``device``
    and ``config`` let the tests run it on the CPU at a small size."""
    import torch

    sys.path.insert(0, str(HERE))
    bench = bench or load_json(HERE.parent / "BENCHMARK.json")
    cell = resolve_cell(bench, name)
    if config is not None:
        cell["config"] = config
    if device is None:
        device = torch.device("cuda")
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    set_precision(torch, control)
    traffic = cell["traffic"]

    with tempfile.TemporaryDirectory(prefix="sfmbench_") as workdir:
        unit = cell["unit"].Unit(cell["config"], traffic, seed, device,
                                 workdir, log, control=control)
        unit.setup()
        sync()
        t_window = time.perf_counter()
        setup_s = t_window - t_process
        records, window_s = run_window(unit, seconds, sync)
        work = sum(r["work"] for r in records)
        log(f"window: {len(records)} units, {work} {cell['unit'].WORK} in "
            f"{window_s:.3f} s; set-up {setup_s:.3f} s")
        prof = prof_records = None
        if trace:
            prof, prof_records = profile_units(
                unit, int(traffic["profiled_units"]), sync)
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        set_precision(torch, False)
        unit.release()
        metrics = {}
        if trace:
            from yardstick.trace import reduce_trace
            t0 = time.perf_counter()
            reduced = reduce_trace(prof)
            del prof
            reduced["units"] = prof_records
            log(f"trace reduced in {time.perf_counter() - t0:.2f} s: busy "
                f"{reduced['busy_s']:.4f} s of {reduced['window_s']:.4f} s")
            run = dict(units=records, window_s=window_s, trace=reduced,
                       sizes=getattr(unit, "sizes", {}), config=cell["config"],
                       traffic=traffic, device_name=(
                           torch.cuda.get_device_name(device) if cuda
                           else "cpu"))
            for m in cell["per_layer"]:
                value = cell["readers"][m["name"]].read(run)
                if value is not None:
                    metrics[m["name"]] = dict(value=float(value),
                                              unit=m["unit"])
        else:
            rate = traffic["rate"]
            for m in cell["end_to_end"]:
                if m["name"] == "setup_s":
                    metrics["setup_s"] = dict(value=setup_s, unit="s")
                elif m["name"] == rate["metric"]:
                    metrics[m["name"]] = dict(value=work / window_s,
                                              unit=m["unit"])
        t0 = time.perf_counter()
        rows = unit.check(cell["limits"])
        log(f"check of {len(rows)} answers in {time.perf_counter() - t0:.2f} s")

    limits = cell["limits"]
    worst, failed = judge(rows, limits)
    result = dict(correct=bool(rows) and failed == 0, attempted=len(rows),
                  failed=failed, metrics=metrics)
    result["device"] = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        count=1, memory_peak_bytes=int(memory_peak))
    if trace:
        result["device"].update(busy_s=reduced["busy_s"],
                                window_s=reduced["window_s"])
        result["breakdown"] = dict(
            device_ops=[[k[:200], v] for k, v in reduced["ops"]],
            idle_gaps=[[k[:200], v] for k, v in reduced["idle"]])
    finite = lambda v: v if math.isfinite(v) else 1e300
    result["compared"] = {k: dict(value=finite(worst[k]), limit=lim)
                          for k, lim in limits.items()}
    result["_records"] = dict(
        units=len(records), unit_seconds=[r["seconds"] for r in records],
        unit_spans=[r["spans"] for r in records], rows=rows)
    return result
