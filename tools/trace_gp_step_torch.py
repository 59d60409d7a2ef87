"""Device-time breakdown of the port's global-positioning LM step on the card.

The counterpart of ``tools/trace_gp_step.py``: a synthetic GP problem at the
2,000-image mapper's shape (camera centres, PC = 3, points and one scale an
observation; ``GP_CAMS`` 2000, ``GP_TRACKS`` 350000, ``GP_OBS_PER_TRACK``
23, ``GP_PCG`` 100 as the mapper's GP), seeded numpy, in the port's bucketed
layout; ``huber(0.1)``; one warm step, then ``steps`` steps under
``torch.profiler``.  Prints device self-time by kernel name divided by the
steps, largest first, with the device-busy time a step and its idle share,
and writes the trace to ``gp_step_trace_torch.json`` in
``chip_smoke.OUT_DIR``.

    python3 tools/trace_gp_step_torch.py [steps (3)]

Prints ONE JSON line last.  Needs a CUDA card.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from instantsfm_tpu_torch.solve import block_lm, robust
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.solve.blocked import bucketize_problem
from instantsfm_tpu_torch.solve.problems import make_gp_problem
from instantsfm_tpu_torch.utils import bench, debug
from instantsfm_tpu_torch.utils.device import full_f32

from chip_smoke import OUT_DIR


def gp_setup(C, T, per, pcg, device, seed=0):
    """(step(state) -> state, start LMState, rows) of the synthetic GP
    problem: each track seen by ``per`` random cameras along unit
    directions, centres and points uniform in +-1, scales 1 and free."""
    rng = np.random.default_rng(seed)
    O = T * per
    pt_idx = np.repeat(np.arange(T, dtype=np.int32), per)
    cam_idx = rng.integers(0, C, O).astype(np.int32)
    t_obs = rng.standard_normal((O, 3)).astype(np.float32)
    t_obs /= np.linalg.norm(t_obs, axis=-1, keepdims=True)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    params = block_lm.Params(
        cam={"c": f32(rng.uniform(-1, 1, (C, 3)))},
        pts=f32(rng.uniform(-1, 1, (T, 3))), scales=f32(np.ones((O, 1))),
        scales_free=torch.ones(O, dtype=torch.bool, device=device))
    obs = block_lm.Observations(
        torch.as_tensor(cam_idx, device=device),
        torch.as_tensor(pt_idx, device=device),
        {"tx": f32(t_obs[:, 0]), "ty": f32(t_obs[:, 1]),
         "tz": f32(t_obs[:, 2]), "w": f32(np.ones(O))},
        torch.ones(O, dtype=torch.bool, device=device))
    params, obs, buckets, _ = bucketize_problem(params, obs)
    problem, kernel = make_gp_problem(), robust.huber(0.1)
    cfg = block_lm.LMConfig(pcg_iters=pcg, radius_init=1e3, radius_max=1e8)

    def step(state):
        return block_lm.lm_step(problem, kernel, cfg, state, obs,
                                buckets=buckets, device=device)

    s = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    start = block_lm.LMState(params, s(1e-3), s(float("inf")), s(0.0), s(0.0))
    return step, start, int(obs.valid.shape[0])


def trace(steps, device, C=2000, T=350_000, per=23, pcg=100,
          out_dir=OUT_DIR):
    t0 = time.perf_counter()
    step, state, rows = gp_setup(C, T, per, pcg, device)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = [step(state)]
    float(state[0].cost)
    first_s = time.perf_counter() - t0

    def one():
        state[0] = step(state[0])

    debug.drain_stats()
    launches0 = k1.schur_wchain.launches
    rec, prof = bench.device_breakdown(one, steps)
    stats = debug.drain_stats()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "gp_step_trace_torch.json"))
    rec.update(metric="gp_step_device_breakdown", cams=C, tracks=T,
               obs_per_track=per, rows=rows, setup_s=setup_s,
               first_step_s=first_s,
               pcg_iters_per_step=sum(stats["pcg_iters"]) / steps,
               k1_launches_per_step=(k1.schur_wchain.launches
                                     - launches0) / steps)
    return rec


def main():
    device = bench.require_card()
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    env = os.environ.get
    with full_f32():
        rec = trace(steps, device, int(env("GP_CAMS", "2000")),
                    int(env("GP_TRACKS", "350000")),
                    int(env("GP_OBS_PER_TRACK", "23")),
                    int(env("GP_PCG", "100")))
    bench.print_breakdown(rec)
    rec["device"] = bench.device_record()
    print(f"card: {rec['device']['nvidia_smi']}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
