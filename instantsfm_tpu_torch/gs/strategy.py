"""Densification with a fixed capacity (gsplat's DefaultStrategy).

Counterpart of the DefaultStrategy half of ``instantsfm_tpu/gs/strategy.py``:
splats live in a fixed pool with an ``alive`` mask; duplication and
splitting write into dead slots (with their Adam moments zeroed) and
pruning clears the mask.  The parameter tensors are the optimizer's, so
``refine`` and ``reset_opacity`` update them in place.  The MCMC strategy
(``mcmc_relocate``, ``mcmc_noise``) is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from instantsfm_tpu_torch.gs.splats import FIELDS, Splats
from instantsfm_tpu_torch.math import lie


class StrategyConfig(NamedTuple):
    # gsplat DefaultStrategy defaults
    grow_grad2d: float = 0.0002
    grow_scale3d: float = 0.01
    prune_opa: float = 0.005
    prune_scale3d: float = 0.1
    refine_start_iter: int = 500
    refine_stop_iter: int = 15000
    refine_every: int = 100
    reset_every: int = 3000
    revised_opacity: bool = False


class StrategyState(NamedTuple):
    grad2d_sum: torch.Tensor  # [N]
    count: torch.Tensor       # [N]


def init_state(capacity: int, device="cpu") -> StrategyState:
    z = lambda: torch.zeros(capacity, dtype=torch.float32, device=device)
    return StrategyState(z(), z())


def accumulate(state: StrategyState, probe_grad, radii, valid) -> StrategyState:
    """probe_grad: d loss / d means2d [N, 2] (the screen-space probe)."""
    seen = valid & (radii > 0)
    g = torch.linalg.norm(probe_grad, dim=-1)
    return StrategyState(
        state.grad2d_sum + torch.where(seen, g, torch.zeros_like(g)),
        state.count + seen)


def zero_moments(optimizer, mask) -> None:
    """Zero the Adam moments of the slots in ``mask`` in every group."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st:
                st["exp_avg"][mask] = 0
                st["exp_avg_sq"][mask] = 0


@torch.no_grad()
def refine(splats: Splats, optimizer, state: StrategyState, scene_scale,
           cfg: StrategyConfig = StrategyConfig(), prune_too_big: bool = False,
           generator=None, noise=None):
    """One grow + prune pass (gsplat DefaultStrategy._grow_gs/_prune_gs).

    Split children are drawn inside their parent with ``noise`` [N, 3]
    standard normals, drawn from ``generator`` when not given.  Updates
    ``splats`` and the optimizer's moments in place; returns
    (splats, fresh strategy state, number grown, number pruned)."""
    N = splats.alive.shape[0]
    dev = splats.alive.device
    avg_grad = state.grad2d_sum / torch.clamp(state.count, min=1.0)
    scale_max = torch.exp(splats.scales).amax(dim=-1)
    is_small = scale_max <= cfg.grow_scale3d * scene_scale
    hot = splats.alive & (avg_grad > cfg.grow_grad2d) & (state.count > 0)
    is_dupli = hot & is_small
    is_split = hot & ~is_small

    # growers take dead slots in rank order
    grow = is_dupli | is_split
    grow_rank = torch.cumsum(grow.to(torch.int64), 0) - 1
    dead_order = torch.argsort(splats.alive.to(torch.uint8), stable=True)
    num_dead = int((~splats.alive).sum())
    use = grow & (grow_rank < num_dead)
    src = use.nonzero()[:, 0]
    dst = dead_order[grow_rank[src]]

    # children: splits sample inside the gaussian and shrink 1.6x
    if noise is None:
        noise = torch.randn((N, 3), generator=generator, device=dev,
                            dtype=splats.means.dtype)
    noise = noise.to(device=dev, dtype=splats.means.dtype)
    R = lie.quat_to_matrix(lie.quat_normalize(splats.quats))
    jitter = torch.einsum("nij,nj->ni", R, noise * torch.exp(splats.scales))
    split_col = is_split[:, None]
    child_means = torch.where(split_col, splats.means + jitter, splats.means)
    child_scales = torch.where(split_col, splats.scales - math.log(1.6),
                               splats.scales)
    for f in FIELDS:
        a = getattr(splats, f)
        if f == "means":
            a[dst] = child_means[src]
        elif f == "scales":
            a[dst] = child_scales[src]
        elif f == "alive":
            a[dst] = True
        else:
            a[dst] = a[src]
    # originals of splits shrink too
    splats.scales[is_split] -= math.log(1.6)

    # prune
    opac = torch.sigmoid(splats.opacities)
    too_faint = opac < cfg.prune_opa
    # gsplat prunes oversized gaussians only after the first opacity reset
    too_big = (scale_max > cfg.prune_scale3d * scene_scale) & prune_too_big
    prune = splats.alive & (too_faint | too_big)
    splats.alive &= ~prune

    # zero the Adam moments of every slot touched (new or pruned)
    touched = prune.clone()
    touched[dst] = True
    zero_moments(optimizer, touched)
    return (splats, init_state(N, dev), int(use.sum()), int(prune.sum()))


@torch.no_grad()
def reset_opacity(splats: Splats, optimizer, value: float = 0.01) -> Splats:
    """Clamp opacities to at most ``value`` (gsplat reset_opa).  As in the
    JAX package, the Adam moments of every group are zeroed, not only the
    opacities'."""
    new_logit = math.log(value / (1 - value))
    splats.opacities.clamp_(max=new_logit)
    zero_moments(optimizer, slice(None))
    return splats
