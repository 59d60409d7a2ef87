"""Densification with a fixed capacity (gsplat's DefaultStrategy and a
simplified MCMCStrategy).

Counterpart of ``instantsfm_tpu/gs/strategy.py``: splats live in a fixed
pool with an ``alive`` mask; duplication and splitting write into dead
slots (with their Adam moments zeroed) and pruning clears the mask.  The
MCMC half relocates low-opacity gaussians onto high-opacity ones and adds
SGLD-style position noise.  The parameter tensors are the optimizer's, so
``refine``, ``reset_opacity``, ``mcmc_relocate`` and ``mcmc_noise`` update
them in place.  Random draws come from an explicit ``torch.Generator``, or
are given (tests feed JAX's draws).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from instantsfm_tpu_torch.gs.splats import FIELDS, Splats
from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.utils.debug import read, stat_add


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


def accumulate(state: StrategyState, probe_grad, radii, valid, width: int,
               height: int) -> StrategyState:
    """probe_grad: d loss / d means2d [N, 2] (the screen-space probe) of a
    ``width`` x ``height`` view.  As gsplat's DefaultStrategy, the gradient
    is taken in normalised device units, x times width / 2 and y times
    height / 2, before its norm is summed; the JAX package sums the pixel
    gradient's norm, which ``grow_grad2d`` = 2e-4 then almost never
    passes at a real image size."""
    seen = valid & (radii > 0)
    g = torch.linalg.norm(
        probe_grad * probe_grad.new_tensor([width / 2.0, height / 2.0]),
        dim=-1)
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
           generator=None, noise=None, record=None):
    """One grow + prune pass (gsplat DefaultStrategy._grow_gs/_prune_gs).

    Split children are drawn inside their parent with ``noise`` [N, 3]
    standard normals, drawn from ``generator`` when not given.  Updates
    ``splats`` and the optimizer's moments in place; returns
    (splats, fresh strategy state, number grown, number pruned).  Two
    host reads (``gs.refine``): the counts that size the growth, and the
    pruned and alive counts after; the counters ``gs_grown``,
    ``gs_grow_dropped`` (growers that found no dead slot), ``gs_pruned``
    and ``gs_alive``.  A ``record`` dict receives the pass's decisions
    [N] bool: ``dupli``, ``split``, ``grown`` (the growers that got a
    slot) and ``prune``, and the alive counts ``alive_before`` and
    ``alive_after``."""
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
    dead = ~splats.alive
    n_grow, num_dead = (int(v) for v in read(
        "gs.refine", torch.stack([grow.sum(), dead.sum()])))
    alive_before = N - num_dead
    use = grow & (grow_rank < num_dead)
    # the growers that got a slot, in row order, sized by the read
    src = torch.argsort((~use).to(torch.uint8), stable=True)[
        :min(n_grow, num_dead)]
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
    # originals of splits shrink too; a grower that found no dead slot
    # stays as it was
    splats.scales[is_split & use] -= math.log(1.6)

    # prune
    opac = torch.sigmoid(splats.opacities)
    too_faint = opac < cfg.prune_opa
    # gsplat prunes oversized gaussians only after the first opacity
    # reset, by their scales after the growth (a split's halves)
    too_big = (torch.exp(splats.scales).amax(dim=-1)
               > cfg.prune_scale3d * scene_scale) & prune_too_big
    prune = splats.alive & (too_faint | too_big)
    splats.alive &= ~prune

    # zero the Adam moments of every slot touched (new or pruned)
    touched = prune.clone()
    touched[dst] = True
    zero_moments(optimizer, touched)
    n_prune, alive = (int(v) for v in read(
        "gs.refine", torch.stack([prune.sum(), splats.alive.sum()])))
    n_use = len(src)
    stat_add("gs_grown", n_use)
    stat_add("gs_grow_dropped", n_grow - n_use)
    stat_add("gs_pruned", n_prune)
    stat_add("gs_alive", alive)
    if record is not None:
        record.update(dupli=is_dupli, split=is_split, grown=use, prune=prune,
                      alive_before=alive_before, alive_after=alive)
    return (splats, init_state(N, dev), n_use, n_prune)


@torch.no_grad()
def reset_opacity(splats: Splats, optimizer, value: float = 0.01) -> Splats:
    """Clamp opacities to at most ``value`` (gsplat reset_opa).  As in the
    JAX package, the Adam moments of every group are zeroed, not only the
    opacities'."""
    new_logit = math.log(value / (1 - value))
    splats.opacities.clamp_(max=new_logit)
    zero_moments(optimizer, slice(None))
    return splats


class MCMCConfig(NamedTuple):
    cap_max: int = 1_000_000
    noise_lr: float = 5e5
    refine_every: int = 100
    refine_start_iter: int = 500
    refine_stop_iter: int = 25000
    min_opacity: float = 0.005


def choice(probs, n: int, generator=None, uniforms=None):
    """``n`` indices drawn with replacement by ``probs`` [N] (not
    normalised), by inverse CDF as ``jax.random.choice(p=...)`` draws them:
    the first index whose cumulative sum reaches total * (1 - u).  With
    all-zero ``probs`` every draw is index 0, as in JAX."""
    if uniforms is None:
        uniforms = torch.rand(n, generator=generator, device=probs.device,
                              dtype=probs.dtype)
    cum = torch.cumsum(probs, 0)
    return torch.searchsorted(cum, cum[-1] * (1 - uniforms)).clamp_(
        max=len(probs) - 1)


@torch.no_grad()
def mcmc_relocate(splats: Splats, optimizer, min_opacity: float = 0.005,
                  generator=None, src=None):
    """Simplified MCMCStrategy relocation: alive gaussians whose opacity
    fell below ``min_opacity`` ("dead") take every field of a gaussian
    drawn with probability proportional to its opacity among the others
    (``src`` [N] indices, drawn from ``generator`` when not given); the
    dead rows' Adam moments are zeroed.  Returns the number of dead rows."""
    N = splats.alive.shape[0]
    opac = torch.sigmoid(splats.opacities)
    dead = splats.alive & (opac < min_opacity)
    probs = torch.where(splats.alive & ~dead, opac, torch.zeros_like(opac))
    probs = probs / torch.clamp(probs.sum(), min=1e-12)
    if src is None:
        src = choice(probs, N, generator)
    src = src.to(device=dead.device, dtype=torch.int64)
    for f in FIELDS:
        if f != "alive":
            a = getattr(splats, f)
            col = dead.reshape((-1,) + (1,) * (a.dim() - 1))
            a.copy_(torch.where(col, torch.index_select(a, 0, src), a))
    zero_moments(optimizer, dead)
    return int(dead.sum())


@torch.no_grad()
def mcmc_noise(splats: Splats, lr_means: float, noise_lr: float = 5e5,
               generator=None, noise=None) -> Splats:
    """Per-step SGLD-style position noise, shaped by each gaussian's
    covariance and damped for opaque ones; alive rows only.  ``noise``
    [N, 3] standard normals, drawn from ``generator`` when not given."""
    opac = torch.sigmoid(splats.opacities)
    sigmoid_term = 1.0 / (1.0 + torch.exp(100.0 * (opac - 0.995)))
    if noise is None:
        noise = torch.randn(splats.means.shape, generator=generator,
                            device=splats.means.device,
                            dtype=splats.means.dtype)
    noise = noise.to(device=splats.means.device, dtype=splats.means.dtype)
    R = lie.quat_to_matrix(lie.quat_normalize(splats.quats))
    shaped = torch.einsum("nij,nj->ni", R, noise * torch.exp(splats.scales))
    step = shaped * (sigmoid_term * noise_lr * lr_means)[:, None]
    splats.means.add_(torch.where(splats.alive[:, None], step,
                                  torch.zeros_like(step)))
    return splats
