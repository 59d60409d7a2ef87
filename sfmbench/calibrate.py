"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 sfmbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--seconds 1]

Runs the cell on the card once for each seed in one process (a short
window at the cell's own size; the set-up builds and warms once for all),
then its control for each control seed: the same run with TF32 allowed in
cuBLAS and cuDNN, the nearest precision below the float32 the
configurations state, where the cell's unit puts the reference in the
program's place in that precision or runs the program under it.  With
``--fault`` every run has that fault of ``faults.py`` planted.  Prints
one JSON line a run: the seed, whether it was the control, ``correct`` and
the worst value of each number compared.  The benchmark's own runs never
run this.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import HERE, ROOT, fixed_caches  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", default="",
                    help="plant this fault of faults.py under every run")
    args = ap.parse_args(argv)
    fixed_caches()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import torch

    import core
    import faults
    if args.fault:
        faults.plant(args.fault)
    if not torch.cuda.is_available():
        core.log("calibration needs a CUDA card")
        return 2
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        res = core.run_cell(args.workload, seed, args.seconds, False, t0,
                            control=control)
        rows = res.pop("_records")["rows"]
        print(json.dumps(dict(
            seed=seed, control=control, fault=args.fault,
            correct=res["correct"],
            attempted=res["attempted"],
            seconds=time.perf_counter() - t0,
            worst={k: v["value"] for k, v in res["compared"].items()},
            rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
