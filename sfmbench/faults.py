"""Faults planted in the timed path, to show that the check fails them.

``plant(name)`` breaks the program underneath a run and returns the
function that repairs it.  The tests drive runs on the CPU with each
fault; ``calibrate.py --fault`` reads one on the card at a cell's size.
"""

from __future__ import annotations

import torch


def _swap(module, attr, make):
    real = getattr(module, attr)
    setattr(module, attr, make(real))
    return lambda: setattr(module, attr, real)


def step_unchanged():
    """Every LM step returns the state it was given."""
    from instantsfm_tpu_torch.solve import block_lm
    return _swap(block_lm, "lm_step", lambda real: (lambda *a, **k: a[3]))


def half_batch():
    """Every LM step sees every other observation row: half of the batch
    left out, the cost taken over the rest."""
    from instantsfm_tpu_torch.solve import block_lm

    def make(real):
        def step(problem, kernel, cfg, state, obs, **kw):
            keep = torch.arange(obs.valid.shape[0],
                                device=obs.valid.device) % 2 == 0
            return real(problem, kernel, cfg, state,
                        obs._replace(valid=obs.valid & keep), **kw)
        return step
    return _swap(block_lm, "lm_step", make)


def point_altered():
    """Every LM step's result has its first point moved by 0.01 in x."""
    from instantsfm_tpu_torch.solve import block_lm

    def make(real):
        def step(*a, **kw):
            state = real(*a, **kw)
            pts = state.params.pts.clone()
            pts[0, 0] += 0.01
            return state._replace(params=state.params._replace(pts=pts))
        return step
    return _swap(block_lm, "lm_step", make)


def pose_altered():
    """The written model's fourth image has its rotation's quaternion
    components swapped."""
    from instantsfm_tpu_torch.pipeline import writer

    def make(real):
        def write(out, cameras, images, tracks, *a, **kw):
            images.qvec[3] = images.qvec[3][[1, 0, 2, 3]]
            return real(out, cameras, images, tracks, *a, **kw)
        return write
    return _swap(writer, "write_reconstruction", make)


def ba_stage_frozen():
    """The mapper's bundle adjustment takes no step: its LM loop's steps
    return their state, global positioning untouched."""
    from instantsfm_tpu_torch.pipeline import ba

    def make(real):
        def optimize(*a, **kw):
            kw["step_fn"] = lambda state, obs: state
            return real(*a, **kw)
        return optimize
    return _swap(ba, "optimize", make)


FAULTS = {f.__name__: f for f in (step_unchanged, half_batch, point_altered,
                                  pose_altered, ba_stage_frozen)}


def plant(name: str):
    return FAULTS[name]()
