"""3DGS training-step benchmark of the port on the card.

The PyTorch/CUDA counterpart of ``bench_gs.py``: a 100k-gaussian pool
(points uniform in +-2 around z = 6, seeded numpy, ``init_splats`` at SH
degree 3), one 800x608 view a step, and the full step: projection, SH,
the tile sort, K2 and K3 (``csrc/composite_tiles.cu``), the L1 + SSIM loss
against a seeded random target, and Adam on every parameter group.  3 warm
steps, then 20 timed through a host readback of the last loss, each step
also between CUDA events.

The roofline keys carry ``bench_gs.py``'s names (``roofline_frac``,
``mfu``, ``membw_util``, ``bound``, ``chip``, ``gflops_per_iter``,
``hbm_gb_per_iter``), but the count is analytic, not XLA's cost model:
the benchmark's frozen ``gs_step_cost`` (``sfmbench/yardstick/gs_roofline.py``)
on the step's own data-dependent counts (tile intersections, the
compositing's entered chunks and live pairs, read after the timed steps by
``step.work()``), and ``roofline_frac`` is its bound over the median step.
``roofline_parts`` gives each part's own bound in ms; ``bound`` names the
binding resource (bytes, operations or sfu).

    python3 bench_gs_torch.py

Prints ONE JSON line last; needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from instantsfm_tpu_torch.gs import composite as k23
from instantsfm_tpu_torch.gs import rasterize, splats as splats_mod, ssim
from instantsfm_tpu_torch.utils import bench
from instantsfm_tpu_torch.utils.device import full_f32

# the benchmark's frozen count of the work, after this repo's own modules
# on the path: ``sfmbench`` has a ``tests`` of its own
SFMBENCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sfmbench")
if SFMBENCH not in sys.path:
    sys.path.append(SFMBENCH)
from yardstick.gs_roofline import (GSStepCost, bound_s,  # noqa: E402
                                   gs_step_cost)
from yardstick.roofline import chip_spec  # noqa: E402

G, W, H = 100_000, 800, 608
SH_DEGREE = 3
N_WARM, N = 3, 20
# the step's profiler scopes -> (forward, backward) part of the count, and
# the compositing kernels by name (bench.time_by_scope)
PART_SCOPES = {"gs.projection": ("projection_fwd", "projection_bwd"),
               "gs.sh": ("sh_fwd", "sh_bwd"),
               "gs.tile_sort": ("tile_sort", "tile_sort"),
               "gs.gather": ("gather", "gather_transpose"),
               "gs.composite": ("k2", "k3"),
               "gs.loss": ("loss_fwd", "loss_bwd"),
               "Optimizer.step#": ("adam", "adam")}
PART_KERNELS = {"composite_fwd_kernel": "k2", "composite_bwd_kernel": "k3"}


def step_work(means, quats, scales, opac, sh, viewmat, K, width, height,
              tiles_per_gauss=None, tile_capacity=None):
    """The counts ``gs_step_cost`` takes for the step's view of
    these gaussians: the tile intersections, those in the tiles' windows,
    and the compositing's entered chunks and live pairs (a forward render,
    K2 on a card).  The budgets default to the step's: none, every pair
    kept."""
    with torch.no_grad():
        p = rasterize.project_view(means, quats, scales, opac, sh, viewmat,
                                   K, width, height, SH_DEGREE)
        counts = rasterize.tile_windows(p.means2d, p.radii, p.valid,
                                        p.depths, width, height,
                                        tiles_per_gauss, tile_capacity).counts
        attrs, nchunks, ntx = rasterize.tile_attrs(
            p, width, height, tiles_per_gauss, tile_capacity)
        pairs = k23.pair_counts(attrs, k23.composite_fwd(attrs, nchunks,
                                                         ntx)[1], ntx)
    return dict(G=means.shape[0], sh_degree=SH_DEGREE, width=width,
                height=height, intersections=int(counts.sum()),
                kept=int(counts.clamp(max=attrs.shape[1]).sum()),
                chunks_entered=pairs["chunks_entered"],
                live_pairs=pairs["live_pairs"])


def setup(num_gaussians=G, width=W, height=H, seed=0, device="cuda"):
    """``bench_gs.py``'s pool, view and target on ``device``; returns
    step() -> the step's loss (a 0-dim tensor, not read back), with its
    parameters as ``step.params`` (field -> leaf tensor) and the inputs of
    its render as ``step.inputs()``.  ``step.work()`` is ``step_work`` on
    those inputs: the next step's counts.  The step's parts run under
    ``record_function`` scopes named ``gs.<part>`` (``rasterize.py`` adds
    its own spans), which ``tools/trace_gs_step_torch.py`` reads."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (num_gaussians, 3)) + np.array([0, 0, 6.0])
    cols = rng.uniform(0, 1, (num_gaussians, 3))
    splats = splats_mod.init_splats(pts, cols, capacity=num_gaussians,
                                    sh_degree=SH_DEGREE, device=device)
    params = {k: v.clone().requires_grad_(True)
              for k, v in splats_mod.float_params(splats).items()}
    opt = splats_mod.make_optimizer(params, scene_scale=4.0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    viewmat = f32(np.eye(4))
    K = f32([[600.0, 0, width / 2], [0, 600.0, height / 2], [0, 0, 1]])
    target = f32(rng.uniform(0, 1, (height, width, 3)))
    alive = splats.alive
    count = [0]

    def inputs():
        sp = splats_mod.with_float_params(splats, params)
        with record_function("gs.projection"):
            opac = torch.sigmoid(sp.opacities) * alive
            scales = torch.exp(sp.scales)
        with record_function("gs.sh"):
            sh = torch.cat([sp.sh0, sp.shN], dim=1)
        return sp.means, sp.quats, scales, opac, sh, viewmat, K

    def step():
        opt.zero_grad(set_to_none=True)
        out = rasterize.rasterize(
            *inputs(), width=width, height=height, sh_degree=SH_DEGREE)
        with record_function("gs.loss"):
            l1 = torch.mean(torch.abs(out.rgb - target))
            loss = 0.8 * l1 + 0.2 * (1 - ssim.ssim(out.rgb, target))
        loss.backward()
        splats_mod.set_lr(opt, count[0])
        opt.step()
        count[0] += 1
        return loss.detach()

    step.params, step.inputs = params, inputs
    step.work = lambda: step_work(*inputs(), width, height)
    return step


class GSRoofline(NamedTuple):
    flops: float
    sfu: float
    hbm_bytes: float
    t_light: float        # seconds: the largest of the three times
    mfu: float            # measured FLOP/s over the float32 peak
    membw_util: float     # measured bytes/s over the memory rate
    roofline_frac: float  # t_light / t_measured (1.0 == speed of light)
    bound: str            # "bytes" | "operations" | "sfu"
    chip: str
    parts_ms: dict        # part -> its own bound, ms


def part_bounds_ms(cost: GSStepCost, spec=None) -> dict:
    """Each part's own bound in ms on ``spec`` (default: the card in
    use)."""
    spec = spec or chip_spec()
    return {k: bound_s(p.hbm_bytes, p.flops, p.sfu, spec) * 1e3
            for k, p in cost.parts.items()}


def analyze_gs(cost: GSStepCost, t_step: float, spec=None) -> GSRoofline:
    """Roofline of one 3DGS step of ``cost`` measured at ``t_step``
    seconds on ``spec`` (default: the card in use).  The share is not
    clamped: above 1.0 the count is wrong."""
    spec = spec or chip_spec()
    times = {"bytes": cost.hbm_bytes / spec.peak_bw,
             "operations": cost.flops / spec.peak_flops_f32,
             "sfu": cost.sfu / spec.peak_sfu}
    bound = max(times, key=times.get)
    t_light = times[bound]
    return GSRoofline(
        flops=cost.flops, sfu=cost.sfu, hbm_bytes=cost.hbm_bytes,
        t_light=t_light, mfu=cost.flops / t_step / spec.peak_flops_f32,
        membw_util=cost.hbm_bytes / t_step / spec.peak_bw,
        roofline_frac=t_light / t_step, bound=bound, chip=spec.name,
        parts_ms=part_bounds_ms(cost, spec))


def roofline_record(work, t_step, spec=None):
    """``bench_gs.py``'s roofline keys for a step of ``work`` (``step.work()``)
    measured at ``t_step`` seconds on ``spec`` (default: the card in use),
    with each part's own bound in ms and the counts."""
    rl = analyze_gs(gs_step_cost(**work), t_step, spec)
    return {"roofline_frac": rl.roofline_frac, "mfu": rl.mfu,
            "membw_util": rl.membw_util, "bound": rl.bound, "chip": rl.chip,
            "gflops_per_iter": rl.flops / 1e9,
            "hbm_gb_per_iter": rl.hbm_bytes / 1e9,
            "bound_ms": rl.t_light * 1e3, "roofline_parts": rl.parts_ms,
            "step_work": work}


def measure(device):
    step = setup(device=device)
    t0 = time.perf_counter()
    for _ in range(N_WARM):
        loss = step()
    float(loss)
    warm_s = time.perf_counter() - t0
    f0, b0 = k23.composite_fwd.launches, k23.composite_bwd.launches
    events = [torch.cuda.Event(enable_timing=True) for _ in range(N + 1)]
    t0 = time.perf_counter()
    for i in range(N):
        events[i].record()
        loss = step()
    events[N].record()
    final = float(loss)     # the readback waits for every step
    dt = time.perf_counter() - t0
    k2, k3 = k23.composite_fwd.launches - f0, k23.composite_bwd.launches - b0
    median_ms = statistics.median(
        events[i].elapsed_time(events[i + 1]) for i in range(N))
    return {
        "metric": "gs_train_iters_per_sec",
        "value": N / dt,
        "unit": f"iter/s ({G // 1000}k gaussians, {W}x{H}, SH3, full step "
                "with Adam; 20 steps timed through a host readback)",
        "ms_per_step": 1e3 * dt / N,
        "median_step_ms": median_ms,
        "warm_s": warm_s,
        "loss_after": final,
        "k2_launches_per_step": k2 / N,
        "k3_launches_per_step": k3 / N,
        **roofline_record(step.work(), median_ms / 1e3),
        "device": bench.device_record(),
    }


def main():
    device = bench.require_card()
    with full_f32():
        rec = measure(device)
    print(f"card: {rec['device']['nvidia_smi']}", file=sys.stderr)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
