"""3DGS training-step benchmark of the port on the card.

The PyTorch/CUDA counterpart of ``bench_gs.py``: a 100k-gaussian pool
(points uniform in +-2 around z = 6, seeded numpy, ``init_splats`` at SH
degree 3), one 800x608 view a step, and the full step: projection, SH,
the tile sort, K2 and K3 (``csrc/composite_tiles.cu``), the L1 + SSIM loss
against a seeded random target, and Adam on every parameter group.  3 warm
steps, then 20 timed through a host readback of the last loss.

``roofline_frac`` is null: JAX's number comes from XLA's compiled cost
model, and no analytic count of this step exists in either package.

    python3 bench_gs_torch.py

Prints ONE JSON line last; needs a CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from instantsfm_tpu_torch.gs import composite as k23
from instantsfm_tpu_torch.gs import rasterize, splats as splats_mod, ssim
from instantsfm_tpu_torch.utils import bench
from instantsfm_tpu_torch.utils.device import full_f32

G, W, H = 100_000, 800, 608
N_WARM, N = 3, 20


def setup(num_gaussians=G, width=W, height=H, seed=0, device="cuda"):
    """``bench_gs.py``'s pool, view and target on ``device``; returns
    step() -> the step's loss (a 0-dim tensor, not read back)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (num_gaussians, 3)) + np.array([0, 0, 6.0])
    cols = rng.uniform(0, 1, (num_gaussians, 3))
    splats = splats_mod.init_splats(pts, cols, capacity=num_gaussians,
                                    sh_degree=3, device=device)
    params = {k: v.clone().requires_grad_(True)
              for k, v in splats_mod.float_params(splats).items()}
    opt = splats_mod.make_optimizer(params, scene_scale=4.0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    viewmat = f32(np.eye(4))
    K = f32([[600.0, 0, width / 2], [0, 600.0, height / 2], [0, 0, 1]])
    target = f32(rng.uniform(0, 1, (height, width, 3)))
    alive = splats.alive
    count = [0]

    def step():
        opt.zero_grad(set_to_none=True)
        sp = splats_mod.with_float_params(splats, params)
        opac = torch.sigmoid(sp.opacities) * alive
        out = rasterize.rasterize(
            sp.means, sp.quats, torch.exp(sp.scales), opac,
            torch.cat([sp.sh0, sp.shN], dim=1), viewmat, K, width=width,
            height=height, sh_degree=3, tile_capacity=512)
        l1 = torch.mean(torch.abs(out.rgb - target))
        loss = 0.8 * l1 + 0.2 * (1 - ssim.ssim(out.rgb, target))
        loss.backward()
        splats_mod.set_lr(opt, count[0])
        opt.step()
        count[0] += 1
        return loss.detach()

    return step


def measure(device):
    step = setup(device=device)
    t0 = time.perf_counter()
    for _ in range(N_WARM):
        loss = step()
    float(loss)
    warm_s = time.perf_counter() - t0
    f0, b0 = k23.composite_fwd.launches, k23.composite_bwd.launches
    t0 = time.perf_counter()
    for _ in range(N):
        loss = step()
    final = float(loss)     # the readback waits for every step
    dt = time.perf_counter() - t0
    return {
        "metric": "gs_train_iters_per_sec",
        "value": N / dt,
        "unit": f"iter/s ({G // 1000}k gaussians, {W}x{H}, SH3, full step "
                "with Adam; 20 steps timed through a host readback)",
        "ms_per_step": 1e3 * dt / N,
        "warm_s": warm_s,
        "loss_after": final,
        "k2_launches_per_step": (k23.composite_fwd.launches - f0) / N,
        "k3_launches_per_step": (k23.composite_bwd.launches - b0) / N,
        "roofline_frac": None,
        "roofline_note": "not counted: bench_gs.py's number comes from XLA's "
                         "compiled cost model, and no analytic count of "
                         "this step exists in either package",
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
