"""Pair inlier scoring (reference ``processors/image_pair_inliers.py``).

Counterpart of ``instantsfm_tpu/pipeline/pair_inliers.py``.  Used by the
alternative poselib-style relpose path: given an already-estimated pair
model (E from the stored relative pose, or F/H matrices), score matches by
Sampson / transfer error with cheirality and epipole tests, and set the
pair's inlier set.  The per-match errors and depths run in torch on
``device`` in float64 (the port's ``math/epipolar.py``), one transfer each
way a pair; the 3x3 algebra, the votes and the masks are host numpy, as in
JAX.  Pairs are processed host-side since each dispatches on its config.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.math import epipolar, lie
from instantsfm_tpu_torch.scene.types import (CONFIG_CALIBRATED,
                                              CONFIG_PANORAMIC, CONFIG_PLANAR,
                                              CONFIG_PLANAR_OR_PANORAMIC,
                                              CONFIG_UNCALIBRATED, Cameras,
                                              Images, ViewGraph)
from instantsfm_tpu_torch.utils.device import resolve_device

_EPS = 1e-6


def _on(dev, *arrays):
    return [torch.as_tensor(np.asarray(a, np.float64), device=dev)
            for a in arrays]


def _rotation(qvec):
    """The 3x3 rotation of an xyzw quaternion, on the host."""
    return lie.quat_to_matrix(torch.as_tensor(qvec, dtype=torch.float64)
                              ).numpy()


def _E_from_motion(R, tvec):
    tx = np.array([[0, -tvec[2], tvec[1]],
                   [tvec[2], 0, -tvec[0]],
                   [-tvec[1], tvec[0], 0]])
    return tx @ R


def _score_homography(H, pts1, pts2, thr_sq, dev):
    err = epipolar.homography_error(*_on(dev, H, pts1, pts2)).cpu().numpy()
    inl = err < thr_sq
    score = err[inl].sum() + (~inl).sum() * thr_sq
    return inl, score


def _score_fundamental(F, pts1, pts2, thr_sq, dev):
    epipole = np.cross(F[0], F[1])
    if not np.any(np.abs(epipole) > _EPS):
        epipole = np.cross(F[1], F[2])
    err = epipolar.sampson_error(*_on(dev, F, pts1, pts2)).cpu().numpy()
    pre = err < thr_sq
    # orientation signum consistency vote (reference get_orientation_signum)
    signum1 = F[0, 0] * pts2[:, 0] + F[1, 0] * pts2[:, 1] + F[2, 0]
    signum2 = epipole[1] - epipole[2] * pts1[:, 1]
    signums = (signum1 * signum2)[pre]
    positive = (signums > 0).sum()
    negative = len(signums) - positive
    if positive == negative:
        return np.zeros(len(pts1), bool), 0.0
    cheir = (signums > 0) == (positive > negative)
    inl = np.zeros(len(pts1), bool)
    inl[np.nonzero(pre)[0][cheir]] = True
    score = err[inl].sum() + (~cheir).sum() * thr_sq + (~pre).sum() * thr_sq
    return inl, score


def _score_essential(qvec, tvec, b1, b2, focal1, focal2, thr, dev):
    R = _rotation(qvec)
    E = _E_from_motion(R, tvec)
    epipole12 = tvec if tvec[2] >= 0 else -tvec
    e21 = R @ -tvec
    epipole21 = e21 if e21[2] >= 0 else -e21

    thr = thr * 0.5 * (1.0 / focal1 + 1.0 / focal2)
    thr_sq = thr * thr
    # reference evaluates sampson on the homogeneous bearings (z-normalized)
    E_d, R_d, t_d, b1_d, b2_d = _on(dev, E, R, tvec, b1, b2)
    err, lam1, lam2, sc = torch.stack([
        epipolar.sampson_error(
            E_d, b1_d[:, :2] / b1_d[:, 2:].clamp(min=_EPS),
            b2_d[:, :2] / b2_d[:, 2:].clamp(min=_EPS)),
        *epipolar.cheirality_depths(R_d, t_d, b1_d, b2_d)]).cpu().numpy()
    cheir = (lam1 > 1e-2 * sc) & (lam2 > 1e-2 * sc) \
        & (lam1 < 100.0 * sc) & (lam2 < 100.0 * sc)

    thres_epipole = np.cos(np.deg2rad(3)) + 1e-6
    thres_angle = 1 + 1e-6
    diff_angle = np.einsum("nd,nd->n", b1, b2 @ R)  # b1ᵀ R⁻¹ b2 = b1·(Rᵀb2)
    ok_angle = diff_angle <= thres_angle
    ok_epi = (b1 @ epipole21 <= thres_epipole) & (b2 @ epipole12 <= thres_epipole)

    inl = (err < thr_sq) & cheir & ok_angle & ok_epi
    score = err[inl].sum() + (~inl).sum() * thr_sq
    return inl, score


def image_pair_inliers_count(view_graph: ViewGraph, cameras: Cameras,
                             images: Images, opts: dict,
                             device="cuda") -> None:
    """Rescore every valid pair's matches against its stored model and
    write ``view_graph.inlier_mask`` (thresholds ``max_epipolar_error_{E,F,H}``
    of ``opts``)."""
    dev = resolve_device(device)
    for e in np.nonzero(view_graph.valid)[0]:
        m = view_graph.pair_matches(e)
        if len(m) == 0:
            continue
        i, j = view_graph.pair_i[e], view_graph.pair_j[e]
        f1 = images.kp_index(np.full(len(m), i), m[:, 0])
        f2 = images.kp_index(np.full(len(m), j), m[:, 1])
        cfg = view_graph.config[e]
        sl = slice(view_graph.match_offset[e], view_graph.match_offset[e + 1])
        if cfg in (CONFIG_PLANAR, CONFIG_PANORAMIC, CONFIG_PLANAR_OR_PANORAMIC):
            inl, _ = _score_homography(
                view_graph.H_mat[e], images.kp_xy[f1], images.kp_xy[f2],
                float(opts["max_epipolar_error_H"]) ** 2, dev)
        elif cfg == CONFIG_UNCALIBRATED:
            inl, _ = _score_fundamental(
                view_graph.F_mat[e], images.kp_xy[f1], images.kp_xy[f2],
                float(opts["max_epipolar_error_F"]) ** 2, dev)
        elif cfg == CONFIG_CALIBRATED:
            inl, _ = _score_essential(
                view_graph.qvec[e], view_graph.tvec[e],
                images.kp_bearing[f1], images.kp_bearing[f2],
                cameras.focal(images.cam_idx[i]),
                cameras.focal(images.cam_idx[j]),
                float(opts["max_epipolar_error_E"]), dev)
        else:
            continue
        view_graph.inlier_mask[sl] = inl
