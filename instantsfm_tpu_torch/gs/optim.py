"""Selective Adam: update only the gaussians seen in a step.

Counterpart of ``instantsfm_tpu/gs/optim.py`` (``selective``, the analog of
gsplat's ``SelectiveAdam``): rows of a per-gaussian parameter that no view
of the step saw keep their parameters and both Adam moments, while the step
count advances for every row, as optax's ``count`` does.  torch's Adam
updates whole tensors, so ``selective_step`` runs the optimizer's own step
and then puts the unseen rows of each parameter and of its ``exp_avg`` and
``exp_avg_sq`` back.  The optimizer and its state stay the same objects, so
``strategy.zero_moments`` reaches the same entries as without it.
"""

from __future__ import annotations

import torch

MOMENTS = ("exp_avg", "exp_avg_sq")


@torch.no_grad()
def selective_step(optimizer: torch.optim.Optimizer, visible: torch.Tensor):
    """``optimizer.step()`` on the rows where ``visible`` [N] is True.  A
    parameter is per-gaussian when its leading dimension is N (all of the
    splats' fields); any other parameter steps whole."""
    n = visible.shape[0]
    kept = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.dim() == 0 or p.shape[0] != n:
                continue
            st = optimizer.state.get(p, {})
            # moments the step creates start at zero, as optax's init does
            old = [p.clone()] + [st[k].clone() if k in st else None
                                 for k in MOMENTS]
            kept.append((p, old))
    optimizer.step()
    for p, (old_p, *old_m) in kept:
        m = visible.reshape((n,) + (1,) * (p.dim() - 1))
        p.copy_(torch.where(m, p, old_p))
        st = optimizer.state[p]
        for k, old in zip(MOMENTS, old_m):
            st[k].copy_(torch.where(m, st[k], 0.0 if old is None else old))
