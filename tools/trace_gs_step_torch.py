"""Device-time breakdown of the port's 3DGS training step on the card.

The counterpart of ``tools/trace_gs_step.py``: ``bench_gs_torch.py``'s pool
(100k gaussians), view (800x608, SH 3) and full step, 3 warm steps, then
``steps`` steps under ``torch.profiler``.  Prints device self-time by
kernel name divided by the steps, largest first, with the device-busy time
a step and its idle share, and writes the trace to
``gs_step_trace_torch.json`` in ``chip_smoke.OUT_DIR``.

Then each part of the benchmark's ``gs_step_cost`` with its device time
a step beside its own bound (``parts``): a kernel goes to the part whose
``gs.<part>`` scope launched it, or, in the backward, to the part whose
forward op made its autograd node (``bench.time_by_scope``; K2 and K3 by
name).  ``unassigned`` lists the kernels no part took (the untiling of the
image, gradient accumulation), largest first.

    python3 tools/trace_gs_step_torch.py [steps (5)]

Prints ONE JSON line last.  Needs a CUDA card.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_gs_torch
from instantsfm_tpu_torch.gs import composite as k23
from instantsfm_tpu_torch.utils import bench
from instantsfm_tpu_torch.utils.device import full_f32

from chip_smoke import OUT_DIR
# the benchmark's count (``bench_gs_torch`` puts ``sfmbench`` on the path)
from yardstick.gs_roofline import GS_PARTS, bound_s, gs_step_cost
from yardstick.roofline import chip_spec


def trace(steps, device, out_dir=OUT_DIR):
    step = bench_gs_torch.setup(device=device)
    for _ in range(bench_gs_torch.N_WARM):
        loss = step()
    float(loss)
    f0, b0 = k23.composite_fwd.launches, k23.composite_bwd.launches
    rec, prof = bench.device_breakdown(step, steps)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "gs_step_trace_torch.json"))
    rec.update(metric="gs_step_device_breakdown",
               k2_launches_per_step=(k23.composite_fwd.launches - f0) / steps,
               k3_launches_per_step=(k23.composite_bwd.launches - b0) / steps)
    device_ms, rest = bench.time_by_scope(prof, steps,
                                          bench_gs_torch.PART_SCOPES,
                                          bench_gs_torch.PART_KERNELS)
    work = step.work()
    cost = gs_step_cost(**work)
    bounds = bench_gs_torch.part_bounds_ms(cost)
    rec.update(step_work=work, bound_ms=bound_s(
        cost.hbm_bytes, cost.flops, cost.sfu, chip_spec()) * 1e3)
    rec["parts"] = {
        part: dict(device_ms=device_ms.get(part, 0.0), bound_ms=bounds[part],
                   bound_over_device=(bounds[part] / device_ms[part]
                                      if device_ms.get(part) else None))
        for part in GS_PARTS}
    rec["unassigned"] = [dict(name=name[:100], ms_per_step=ms)
                         for name, ms in rest]
    return rec


def print_parts(rec):
    print(f"{'part':<18} {'device ms':>10} {'bound ms':>10} {'bound/dev':>10}")
    for part, p in rec["parts"].items():
        share = p["bound_over_device"]
        print(f"{part:<18} {p['device_ms']:>10.4f} {p['bound_ms']:>10.4f} "
              f"{'-' if share is None else f'{share:.4f}':>10}")
    print(f"unassigned: {sum(u['ms_per_step'] for u in rec['unassigned']):.4f}"
          f" ms a step in {len(rec['unassigned'])} kernels")


def main():
    device = bench.require_card()
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    with full_f32():
        rec = trace(steps, device)
    bench.print_breakdown(rec)
    print_parts(rec)
    rec["device"] = bench.device_record()
    print(f"card: {rec['device']['nvidia_smi']}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
