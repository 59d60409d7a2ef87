"""Splat parameters: initialization and the per-group Adam optimizer.

Counterpart of ``instantsfm_tpu/gs/splats.py``: means from SfM points,
scales from the 3-NN mean distance, SH DC colour from the point colours,
and a fixed-capacity pool with an ``alive`` mask, so densification never
reallocates.  ``init_splats`` draws from numpy with the same seed as the
JAX package, so both start from the same parameters.  The optimizer is one
``torch.optim.Adam`` with one parameter group per field (optax's
multi-transform in JAX).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from instantsfm_tpu_torch.gs import sh as sh_mod
from instantsfm_tpu_torch.utils.device import resolve_device

FLOAT_FIELDS = ("means", "scales", "quats", "opacities", "sh0", "shN")
FIELDS = FLOAT_FIELDS + ("alive",)


@dataclasses.dataclass
class Splats:
    means: torch.Tensor      # [N, 3]
    scales: torch.Tensor     # [N, 3] log-scale
    quats: torch.Tensor      # [N, 4] xyzw
    opacities: torch.Tensor  # [N] logit
    sh0: torch.Tensor        # [N, 1, 3]
    shN: torch.Tensor        # [N, K-1, 3]
    alive: torch.Tensor      # [N] bool: capacity slots in use


def knn_mean_dist(points: np.ndarray, k: int = 3, sample_cap: int = 65536,
                  chunk: int = 2048, device="cuda") -> np.ndarray:
    """Mean distance to the k nearest neighbours (the reference's
    ``misc.knn``), from chunked float32 distance matrices on ``device``."""
    dev = resolve_device(device)
    n = len(points)
    ref = points
    if n > sample_cap:
        ref = points[np.random.default_rng(0).choice(n, sample_cap, False)]
    ref_t = torch.as_tensor(np.asarray(ref, np.float32), device=dev)
    ref_sq = torch.sum(ref_t * ref_t, dim=-1)
    out = np.empty(n, np.float32)
    for lo in range(0, n, chunk):
        q = torch.as_tensor(np.asarray(points[lo:lo + chunk], np.float32),
                            device=dev)
        d2 = torch.sum(q * q, -1)[:, None] + ref_sq[None, :] - 2 * q @ ref_t.T
        nk = min(k + 1, d2.shape[1])
        d2_top = -torch.topk(-d2, nk, dim=1).values[:, 1:]       # drop self
        out[lo:lo + chunk] = torch.sqrt(torch.clamp(d2_top, min=0)) \
            .mean(-1).cpu().numpy()
    return out


def init_splats(points: np.ndarray, colors: np.ndarray, capacity: int,
                sh_degree: int = 3, init_opacity: float = 0.1,
                init_scale_mult: float = 1.0, seed: int = 0,
                device="cuda") -> Splats:
    """points [P,3], colors [P,3] in [0,1]; capacity >= P slots."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    P = len(points)
    assert capacity >= P
    K = (sh_degree + 1) ** 2

    dist = np.maximum(knn_mean_dist(points, device=dev), 1e-7) * init_scale_mult
    means = np.zeros((capacity, 3), np.float32)
    means[:P] = points
    means[P:] = rng.uniform(-1, 1, (capacity - P, 3))
    scales = np.full((capacity, 3), -5.0, np.float32)
    scales[:P] = np.log(dist)[:, None]
    quats = np.zeros((capacity, 4), np.float32)
    quats[:, 3] = 1.0
    quats[:P] = rng.standard_normal((P, 4))
    quats[:P] /= np.linalg.norm(quats[:P], axis=-1, keepdims=True)
    opac = np.full(capacity, float(np.log(init_opacity / (1 - init_opacity))),
                   np.float32)
    sh0 = np.zeros((capacity, 1, 3), np.float32)
    sh0[:P, 0] = sh_mod.rgb_to_sh(colors)
    shN = np.zeros((capacity, K - 1, 3), np.float32)
    alive = np.zeros(capacity, bool)
    alive[:P] = True
    t = lambda a: torch.as_tensor(a, device=dev)
    return Splats(means=t(means), scales=t(scales), quats=t(quats),
                  opacities=t(opac), sh0=t(sh0), shN=t(shN), alive=t(alive))


def make_optimizer(params: dict, scene_scale: float, means_lr: float = 1.6e-4,
                   scales_lr: float = 5e-3, quats_lr: float = 1e-3,
                   opacities_lr: float = 5e-2, sh0_lr: float = 2.5e-3,
                   shN_lr: float = 2.5e-3 / 20, max_steps: int = 30000,
                   batch_scale: float = 1.0) -> torch.optim.Adam:
    """Adam over ``params`` (field -> leaf tensor) with one group per field
    and the reference's learning rates (``gsplat_trainer.py:230-262``).
    The means lr decays exponentially to 1% over ``max_steps``, as optax's
    ``exponential_decay(lr, max_steps, 0.01)``: ``set_lr`` sets it before
    each update."""
    bs = batch_scale
    lrs = {"means": means_lr * scene_scale * bs, "scales": scales_lr * bs,
           "quats": quats_lr * bs, "opacities": opacities_lr * bs,
           "sh0": sh0_lr * bs, "shN": shN_lr * bs}
    groups = [{"params": [params[f]], "lr": lrs[f], "name": f}
              for f in FLOAT_FIELDS]
    groups[0].update(lr0=lrs["means"], decay_steps=max_steps)
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-15)


def set_lr(optimizer: torch.optim.Adam, k: int) -> None:
    """Learning rates of update ``k`` (0, 1, ...): lr0 · 0.01^(k / steps)
    for the groups with a decay schedule."""
    for g in optimizer.param_groups:
        if "decay_steps" in g:
            g["lr"] = g["lr0"] * 0.01 ** (k / g["decay_steps"])


def float_params(splats: Splats) -> dict:
    return {f: getattr(splats, f) for f in FLOAT_FIELDS}


def with_float_params(splats: Splats, params: dict) -> Splats:
    return dataclasses.replace(splats, **params)
