"""Concrete BlockProblem definitions: bundle adjustment and global positioning.

Counterpart of ``instantsfm_tpu/solve/problems.py``:

* Bundle adjustment: per-observation reprojection residual
  ``project(R(q) X + t) - xy`` with per-camera-model projection; principal
  point frozen; pose in the 6-dof tangent.  The problem declares which
  residual it is (``reproj``), so the engine builds its system in closed
  form (``solve/ba_closed.py``) where that covers the camera model.
* Global positioning: residual ``(t_obs - s * (X - c)) * w``; unknowns are
  camera centers, points and per-observation scales.

The residuals take ONE observation (the engine vmaps them) and mutate
nothing, so ``torch.func.jacfwd`` differentiates them.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.scene import cameras as cam_models
from instantsfm_tpu_torch.solve.block_lm import BlockProblem


@lru_cache(maxsize=None)
def make_ba_problem(model_id: int, optimize_poses: bool = True) -> BlockProblem:
    """Camera block = [6 pose tangent (optional)] ++ [optimizable intrinsics].

    cam dict: {'q': [C,4], 't': [C,3], 'intr': [C,12] full padded params}.
    """
    info = cam_models.get_camera_model_info(model_id)
    opt = list(info["optimize"])
    pose_dims = 6 if optimize_poses else 0
    PC = pose_dims + len(opt)

    def residual_fn(dc, cam_ref, dp, pt_ref, ds, sc_ref, obs):
        # first-order pose action X + w x X + dt: same value and Jacobian at
        # delta = 0 as the exact exp map (retract_cam does the exact update)
        xyz = lie.quat_rotate(cam_ref["q"], pt_ref + dp) + cam_ref["t"]
        if optimize_poses:
            xyz = xyz + torch.linalg.cross(dc[:3], xyz, dim=-1) + dc[3:6]
        idx = torch.tensor(opt, device=dc.device)
        params = cam_ref["intr"].index_add(0, idx, dc[pose_dims:])
        proj = cam_models.img_from_cam(model_id, params, xyz)
        return proj - torch.stack([obs["x"], obs["y"]])

    def retract_cam(cam, delta):
        if optimize_poses:
            q, t = lie.se3_retract(cam["q"], cam["t"], delta[:, :6])
        else:
            q, t = cam["q"], cam["t"]
        idx = torch.tensor(opt, device=delta.device)
        intr = cam["intr"].index_add(1, idx, delta[:, pose_dims:])
        return {"q": q, "t": t, "intr": intr}

    return BlockProblem(residual_fn=residual_fn, retract_cam=retract_cam,
                        cam_dim=PC, res_dim=2, has_points=True,
                        has_scales=False,
                        reproj=(int(model_id), bool(optimize_poses)))


@lru_cache(maxsize=None)
def make_gp_problem() -> BlockProblem:
    """Global positioning: cam dict {'c': [C,3]} camera centers.

    obs data: {'tx','ty','tz': [O] rotated bearing components,
    'w': [O] calibrated factor}."""

    def residual_fn(dc, cam_ref, dp, pt_ref, ds, sc_ref, obs):
        c = cam_ref["c"] + dc
        p = pt_ref + dp
        s = sc_ref + ds
        t = torch.stack([obs["tx"], obs["ty"], obs["tz"]])
        return (t - s * (p - c)) * obs["w"]

    def retract_cam(cam, delta):
        return {"c": cam["c"] + delta}

    return BlockProblem(residual_fn=residual_fn, retract_cam=retract_cam,
                        cam_dim=3, res_dim=3, has_points=True, has_scales=True)
