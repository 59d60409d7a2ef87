"""Faults planted in the 3DGS cell's timed path, beside ``faults.py``'s;
importing this module adds them to ``faults.FAULTS``.

    python3 sfmbench/gs_faults.py --workload gs-100k.train --fault <name> \
        --seeds 11,12 [--control-seeds 21]

runs ``calibrate.py`` with these faults known.
"""

from __future__ import annotations

import sys

import torch

import faults


def unnormalised_probe():
    """The strategy sums the probe's pixel gradient, as the JAX package
    does, not gsplat's normalised one."""
    from instantsfm_tpu_torch.gs import strategy

    return faults._swap(strategy, "accumulate", lambda real: (
        lambda state, g, radii, valid, width, height:
        real(state, g, radii, valid, 2, 2)))


def sh_degree_zero():
    """Every render evaluates the SH colour at degree 0 only."""
    from instantsfm_tpu_torch.gs import rasterize

    def make(real):
        def render(*a, **kw):
            kw["sh_degree"] = 0
            return real(*a, **kw)
        return render
    return faults._swap(rasterize, "rasterize", make)


def pairs_cut():
    """Every render cuts the pairs at the JAX package's fixed budgets: 16
    tiles a gaussian, 512 gaussians a tile."""
    from instantsfm_tpu_torch.gs import rasterize

    def make(real):
        def render(*a, **kw):
            kw.update(tiles_per_gauss=16, tile_capacity=512)
            return real(*a, **kw)
        return render
    return faults._swap(rasterize, "rasterize", make)


def means_lr_undecayed():
    """Adam steps the means at their first learning rate: the exponential
    decay of the trainer's schedule left out."""
    from instantsfm_tpu_torch.gs import splats

    def make(real):
        def set_lr(optimizer, k):
            for g in optimizer.param_groups:
                if "decay_steps" in g:
                    g["lr"] = g["lr0"]
        return set_lr
    return faults._swap(splats, "set_lr", make)


def grow_threshold_doubled():
    """The refine grows gaussians whose mean screen-space gradient passes
    twice the DefaultStrategy's ``grow_grad2d``."""
    from instantsfm_tpu_torch.gs import strategy

    def make(real):
        def refine(splats, optimizer, state, scene_scale,
                   cfg=strategy.StrategyConfig(), *a, **kw):
            cfg = cfg._replace(grow_grad2d=2 * cfg.grow_grad2d)
            return real(splats, optimizer, state, scene_scale, cfg, *a, **kw)
        return refine
    return faults._swap(strategy, "refine", make)


def split_children_unmoved():
    """The refine writes each split's child on its parent's centre: the
    draws that place it inside the parent are left out."""
    from instantsfm_tpu_torch.gs import strategy

    def make(real):
        def refine(splats, *a, **kw):
            kw["noise"] = torch.zeros((splats.alive.shape[0], 3),
                                      device=splats.alive.device,
                                      dtype=splats.means.dtype)
            return real(splats, *a, **kw)
        return refine
    return faults._swap(strategy, "refine", make)


faults.FAULTS.update({f.__name__: f for f in (
    unnormalised_probe, sh_degree_zero, pairs_cut, means_lr_undecayed,
    grow_threshold_doubled, split_children_unmoved)})


if __name__ == "__main__":
    import calibrate
    sys.exit(calibrate.main())
