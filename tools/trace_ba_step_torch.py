"""Device-time breakdown of the port's BA LM step on the card.

The counterpart of ``tools/trace_ba_step.py``: ``bench_torch.py``'s scene
and step (``BENCH_BA_CAMS/PTS/OBS_PER_PT``), 3 warm steps, then ``steps``
steps of active convergence from the perturbed start under
``torch.profiler``.  Prints device self-time by kernel name divided by the
steps, largest first, the device-busy time a step and its idle share of the
wall time, and writes the trace to ``ba_step_trace_torch.json`` in
``chip_smoke.OUT_DIR``.

    python3 tools/trace_ba_step_torch.py [steps (5)]

Prints ONE JSON line last.  Needs a CUDA card.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.utils import bench, debug
from instantsfm_tpu_torch.utils.device import full_f32

from chip_smoke import OUT_DIR


def trace(steps, device, out_dir=OUT_DIR):
    """The breakdown record of ``steps`` BA LM steps on ``device``."""
    step, fresh_state, _, params, obs = bench_torch.setup(
        int(os.environ.get("BENCH_BA_CAMS", "200")),
        int(os.environ.get("BENCH_BA_PTS", "50000")),
        int(os.environ.get("BENCH_BA_OBS_PER_PT", "8")), device=device)
    bench_torch.run_steps(step, fresh_state(), bench_torch.N_WARM)
    state = [fresh_state()]

    def one():
        state[0] = step(state[0])

    debug.drain_stats()
    launches0 = k1.schur_wchain.launches
    rec, prof = bench.device_breakdown(one, steps)
    stats = debug.drain_stats()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "ba_step_trace_torch.json"))
    rec.update(metric="ba_step_device_breakdown", rows=int(obs.valid.shape[0]),
               point_slots=int(params.pts.shape[0]),
               pcg_iters_per_step=sum(stats["pcg_iters"]) / steps,
               k1_launches_per_step=(k1.schur_wchain.launches
                                     - launches0) / steps)
    return rec


def main():
    device = bench.require_card()
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    with full_f32():
        rec = trace(steps, device)
    bench.print_breakdown(rec)
    rec["device"] = bench.device_record()
    print(f"card: {rec['device']['nvidia_smi']}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
