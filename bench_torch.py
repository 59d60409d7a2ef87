"""Benchmark of the port: BA LM iterations a second on the card.

The PyTorch/CUDA counterpart of ``bench.py``.  The scene is ``bench.py``'s
synthetic ETH3D-indoor shape (200 SIMPLE_RADIAL cameras on a ring, 50k
points, 8 observations a point, 0.5 px noise, float32), drawn from numpy
with the same draws in the same order.  The step is the port's bucketed
layout, then ``block_lm.lm_step`` with ``LMConfig(pcg_iters=25,
pcg_tol=1e-4, max_rejects=2)`` and ``huber(1.0)``: the system build, the
Schur complement, PCG through K1 (``csrc/schur_wchain.cu``) on every
iteration, the retraction and the cost, driven from the host as the mapper
drives it.

Timing: 3 warm steps, then ``BENCH_REPEATS`` (5) repeats of 20 steps from
the perturbed start, each ending in ``torch.cuda.synchronize()``;
``ba_iters_per_sec`` is 20 over the median repeat.  ``roofline_frac`` is
the analytic bound of the step (the benchmark's frozen count,
``sfmbench/yardstick/roofline.py::lm_step_cost``, at the PCG iterations
the steps ran, camera sums by ``index_add_`` and K1, not one-hot products)
over the median step, against the H100's published peaks; ``bound`` names
the binding term.  K1 launches and host reads a step
(``host_syncs_per_step``: the reads of ``utils/debug.read`` in the timed
steps) are counted.

Knobs: ``BENCH_BA_CAMS``, ``BENCH_BA_PTS``, ``BENCH_BA_OBS_PER_PT`` (e.g.
500 / 1000000 for the T&T shape) and ``BENCH_REPEATS``.

    python3 bench_torch.py

Prints ONE JSON line last; needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.scene import cameras as cm
from instantsfm_tpu_torch.solve import block_lm, robust
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.solve.blocked import bucketize_problem
from instantsfm_tpu_torch.solve.problems import make_ba_problem
from instantsfm_tpu_torch.utils import bench, debug
from instantsfm_tpu_torch.utils.device import full_f32

# the benchmark's frozen count of the work, after this repo's own modules
# on the path: ``sfmbench`` has a ``tests`` of its own
SFMBENCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sfmbench")
if SFMBENCH not in sys.path:
    sys.path.append(SFMBENCH)
from yardstick.roofline import (LMStepCost, chip_spec,  # noqa: E402
                                lm_step_cost)

CFG = block_lm.LMConfig(pcg_iters=25, pcg_tol=1e-4, max_rejects=2)
N_WARM, N = 3, 20


class Roofline(NamedTuple):
    flops: float
    hbm_bytes: float
    t_light: float         # seconds: max(compute-bound, memory-bound) time
    mfu: float             # measured FLOP/s over the float32 peak
    membw_util: float      # measured bytes/s over the memory rate
    roofline_frac: float   # t_light / t_measured (1.0 == speed of light)
    bound: str             # "memory" | "compute", the binding term
    chip: str


def analyze_analytic(cost: LMStepCost, t_step: float, spec=None) -> Roofline:
    """Roofline of one step of ``cost`` measured at ``t_step`` seconds on
    ``spec`` (default: the card in use): the larger of FLOPs over the
    float32 peak and bytes over the memory rate, over the step.  As in the
    JAX package, a share past 1.02 means the count over-counts and is
    reported as NaN, and a share under 0.25 is marked as a step that
    launches and latency bound."""
    spec = spec or chip_spec()
    t_c = cost.flops / spec.peak_flops_f32
    t_m = cost.hbm_bytes / spec.peak_bw
    t_light = max(t_c, t_m)
    frac = t_light / t_step if t_step > 0 else 0.0
    bound = "compute" if t_c >= t_m else "memory"
    if frac > 1.02:
        bound = "unreliable (analytic model over-counts)"
        frac = float("nan")
    elif frac < 0.25:
        bound += " (model lower-bound; step is launch/latency dominated)"
    return Roofline(
        flops=cost.flops, hbm_bytes=cost.hbm_bytes, t_light=t_light,
        mfu=cost.flops / t_step / spec.peak_flops_f32,
        membw_util=cost.hbm_bytes / t_step / spec.peak_bw,
        roofline_frac=min(frac, 1.0), bound=bound, chip=spec.name)


def ba_arrays(num_cams=200, num_pts=50_000, obs_per_pt=8, seed=0):
    """``bench.py::make_ba``'s scene as float64 numpy arrays, drawn in its
    order: cameras on a ring of radius 8 looking at the origin, points in
    +-2, each observed by ``obs_per_pt`` random cameras, 0.5 px noise; the
    start perturbs translations by 0.15 and points by 0.3.  ``valid`` marks
    the observations in front of their camera (z > 0.2)."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(0, 2 * np.pi, num_cams)
    centers = np.stack([8 * np.cos(angles), 8 * np.sin(angles),
                        rng.uniform(0, 2, num_cams)], -1)
    Rm, ts = [], []
    for c in centers:       # bench.py's arithmetic, camera by camera
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        Rm.append(np.stack([x, np.cross(z, x), z], 0))
        ts.append(-Rm[-1] @ c)
    Rm, ts = np.array(Rm), np.array(ts)
    qs = lie.matrix_to_quat(torch.as_tensor(Rm)).numpy()
    pts = rng.uniform(-2, 2, (num_pts, 3))

    obs_pt = np.repeat(np.arange(num_pts), obs_per_pt)
    obs_cam = rng.integers(0, num_cams, num_pts * obs_per_pt)
    R = lie.quat_to_matrix(torch.as_tensor(qs)).numpy()
    xyz = np.einsum("oij,oj->oi", R[obs_cam], pts[obs_pt]) + ts[obs_cam]
    valid = xyz[:, 2] > 0.2
    uv = xyz[:, :2] / np.maximum(xyz[:, 2:], 0.2)
    r2 = np.sum(uv * uv, -1, keepdims=True)
    xy = uv * (1 + 0.01 * r2) * 500.0 + np.array([320.0, 240.0])
    xy += 0.5 * rng.standard_normal(xy.shape)
    t0 = ts + 0.15 * rng.standard_normal(ts.shape)
    p0 = pts + 0.3 * rng.standard_normal(pts.shape)
    intr = np.tile(cm.pad_params([500.0, 320.0, 240.0, 0.01]), (num_cams, 1))
    return dict(q=qs, t=t0, intr=intr, pts=p0, obs_cam=obs_cam,
                obs_pt=obs_pt, x=xy[:, 0], y=xy[:, 1], valid=valid)


def make_ba(num_cams=200, num_pts=50_000, obs_per_pt=8, seed=0,
            dtype=torch.float32, device="cuda"):
    """(problem, Params, Observations) of ``ba_arrays`` on ``device``."""
    a = ba_arrays(num_cams, num_pts, obs_per_pt, seed)
    t = lambda v, dt=dtype: torch.as_tensor(v, device=device).to(dt)
    O = len(a["obs_cam"])
    params = block_lm.Params(
        cam={"q": t(a["q"]), "t": t(a["t"]), "intr": t(a["intr"])},
        pts=t(a["pts"]),
        scales=torch.zeros((O, 1), dtype=dtype, device=device),
        scales_free=torch.zeros(O, dtype=torch.bool, device=device))
    obs = block_lm.Observations(
        cam_idx=t(a["obs_cam"], torch.int32),
        pt_idx=t(a["obs_pt"], torch.int32),
        data={"x": t(a["x"]), "y": t(a["y"])}, valid=t(a["valid"], torch.bool))
    return make_ba_problem(cm.SIMPLE_RADIAL), params, obs


def setup(num_cams=200, num_pts=50_000, obs_per_pt=8, seed=0,
          dtype=torch.float32, device="cuda"):
    """The scene in the port's bucketed layout and a step function of it:
    (step(state) -> state, fresh_state() -> LMState, problem, Params,
    Observations)."""
    problem, params, obs = make_ba(num_cams, num_pts, obs_per_pt, seed,
                                   dtype, device)
    params, obs, buckets, _ = bucketize_problem(params, obs)
    kernel = robust.huber(1.0)

    def step(state):
        return block_lm.lm_step(problem, kernel, CFG, state, obs,
                                buckets=buckets, device=device)

    def fresh_state():
        s = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return block_lm.LMState(params, s(1e-4), s(float("inf")), s(0.0),
                                s(0.0))

    return step, fresh_state, problem, params, obs


def run_steps(step, state, n):
    for _ in range(n):
        state = step(state)
    return state


def measure(num_cams, num_pts, obs_per_pt, repeats, device):
    """The timed protocol on the card; returns the JSON record."""
    step, fresh_state, problem, params, obs = setup(
        num_cams, num_pts, obs_per_pt, device=device)
    t0 = time.perf_counter()
    run_steps(step, fresh_state(), N_WARM)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    debug.drain_stats()
    reads0 = debug.REGISTRY.read_count()
    launches0, plain0 = k1.schur_wchain.launches, k1.schur_wchain.plain_calls
    times = []
    for _ in range(repeats):
        state = fresh_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_steps(step, state, N)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steps = repeats * N
    stats = debug.drain_stats()
    reads = debug.REGISTRY.read_count() - reads0
    launches = k1.schur_wchain.launches - launches0
    plain = k1.schur_wchain.plain_calls - plain0
    cost = float(state.cost)

    dt = float(np.median(times))
    pcg_per_step = sum(stats["pcg_iters"]) / steps
    rl = analyze_analytic(lm_step_cost(
        O=int(obs.valid.shape[0]), C=num_cams, T=int(params.pts.shape[0]),
        PC=problem.cam_dim, res_dim=problem.res_dim, cg_iters=pcg_per_step,
        onehot_cam_reduce=False), dt / N)
    return {
        "metric": "ba_iters_per_sec",
        "value": N / dt,
        "unit": f"iter/s, median of {repeats} repeats of {N} steps "
                f"({num_cams} cams, {num_pts} pts, {num_pts * obs_per_pt} "
                f"obs, SIMPLE_RADIAL, float32, PCG <= {CFG.pcg_iters})",
        "spread_iters_per_sec": [N / t for t in times],
        "ms_per_step": 1e3 * dt / N,
        "warm_s": warm_s,
        "roofline_frac": rl.roofline_frac,
        "bound": rl.bound,
        "t_light_ms": rl.t_light * 1e3,
        "gflops_per_iter": rl.flops / 1e9,
        "hbm_gb_per_iter": rl.hbm_bytes / 1e9,
        "mfu_f32": rl.mfu,
        "membw_util": rl.membw_util,
        "chip": rl.chip,
        "traffic_model": "analytic lower bound (yardstick/roofline.py::"
                         "lm_step_cost, onehot_cam_reduce=False, cg_iters = "
                         "the PCG iterations a step ran)",
        "pcg_iters_per_step": pcg_per_step,
        "damped_solves_per_step": sum(stats["lm_tries"]) / steps,
        "k1_launches_per_step": launches / steps,
        "k1_plain_calls": plain,
        "host_syncs_per_step": reads / steps,
        "rows": int(obs.valid.shape[0]),
        "point_slots": int(params.pts.shape[0]),
        "cost_after": cost,
        "device": bench.device_record(),
    }


def main():
    device = bench.require_card()
    num_cams = int(os.environ.get("BENCH_BA_CAMS", "200"))
    num_pts = int(os.environ.get("BENCH_BA_PTS", "50000"))
    obs_per_pt = int(os.environ.get("BENCH_BA_OBS_PER_PT", "8"))
    repeats = int(os.environ.get("BENCH_REPEATS", "5"))
    with full_f32():
        rec = measure(num_cams, num_pts, obs_per_pt, repeats, device)
    print(f"card: {rec['device']['nvidia_smi']}", file=sys.stderr)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
