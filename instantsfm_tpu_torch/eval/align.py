"""Similarity alignment + pose-error metrics for evaluation.

Counterpart of ``instantsfm_tpu/eval/align.py``: umeyama similarity
alignment, absolute translation errors (ATE), relative angular errors with
the unregistered-image penalty, recall curves and AUC.  Everything is host
numpy as in JAX but the relative poses of ``relative_pose_errors_deg``,
whose quaternion algebra runs in torch on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.utils.device import resolve_device


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Similarity transform (s, R, t) minimizing ||dst - (s R src + t)||²."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (sc ** 2).sum() / len(src)
    s = (D * np.diag(S)).sum() / var if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def absolute_translation_errors(centers_est, centers_gt, with_scale=True):
    """ATE after similarity alignment (reference absolute-error path)."""
    s, R, t = umeyama(centers_est, centers_gt, with_scale)
    aligned = (s * (R @ centers_est.T)).T + t
    return np.linalg.norm(aligned - centers_gt, axis=-1)


def rotation_angles_deg(R_est, R_gt):
    """Geodesic angle per camera between estimated and GT rotations (after
    removing the global gauge via the best-fit rotation)."""
    # world-frame gauge acts on the right of world->cam rotations:
    # R_gt ≈ R_est G; chordal mean of R_estᵀ R_gt gives G.
    M = np.einsum("nji,njk->ik", R_est, R_gt)  # sum R_estᵀ R_gt
    U, _, Vt = np.linalg.svd(M)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    G = U @ S @ Vt
    R_al = np.einsum("nij,jk->nik", R_est, G)
    tr = np.einsum("nij,nij->n", R_al, R_gt)
    cos = np.clip((tr - 1) / 2, -1.0, 1.0)
    return np.rad2deg(np.arccos(cos))


def relative_pose_errors_deg(q_est, t_est, q_gt, t_gt, registered,
                             max_pairs: int = 500000, seed: int = 0,
                             min_proj_center_dist: float = 0.0,
                             device="cuda"):
    """Relative pose errors over ORDERED GT image pairs with the reference's
    exact semantics (``evaluation/utils.py:597-680``):

    * per registered pair (i, j), i != j:
      dt = angle(t_rel_est, t_rel_gt) of ``other_from_this`` (signed cosine —
      a flipped direction is a 180-degree error), set to 0 when
      ``||t_rel_gt|| < min_proj_center_dist`` (near-coincident centers make
      the direction unstable; the reference passes the GT position accuracy);
      dR = geodesic angle between the relative rotations;
    * an unregistered image contributes (dt=inf, dR=180) for EVERY ordered
      pair it appears in — so the combined error max(dt, dR) is +inf, a
      super-linear AUC penalty (reference docstring, utils.py:604-615);
    * returns max(dt, dR) per ordered pair — N(N-1) entries (or a seeded
      sample of ``max_pairs`` of them for very large N; the sample is the
      JAX package's, so both score the same pairs).

    q: world->cam xyzw; t: world->cam.  The relative poses and rotation
    angles are computed in torch on ``device`` in the inputs' dtype."""
    dev = resolve_device(device)
    n = len(q_est)
    grid = np.mgrid[0:n, 0:n].reshape(2, -1)
    keep = grid[0] != grid[1]
    ii, jj = grid[0][keep], grid[1][keep]           # ordered pairs
    if len(ii) > max_pairs:
        sel = np.random.default_rng(seed).choice(len(ii), max_pairs, False)
        ii, jj = ii[sel], jj[sel]
    i_d = torch.as_tensor(ii, device=dev)
    j_d = torch.as_tensor(jj, device=dev)

    def rel(q, t):
        """other_from_this: R = R_j R_i^T, t = t_j - R t_i."""
        q = torch.as_tensor(np.asarray(q), device=dev)
        t = torch.as_tensor(np.asarray(t), device=dev)
        q_rel = lie.quat_mul(q[j_d], lie.quat_conj(q[i_d]))
        return q_rel, t[j_d] - lie.quat_rotate(q_rel, t[i_d])

    qr_e, tr_e = rel(q_est, t_est)
    qr_g, tr_g = rel(q_gt, t_gt)
    rot_err = np.rad2deg(
        lie.rotation_geodesic_angle(qr_e, qr_g).cpu().numpy())
    tr_e, tr_g = tr_e.cpu().numpy(), tr_g.cpu().numpy()
    ne = np.linalg.norm(tr_e, axis=-1)
    ng = np.linalg.norm(tr_g, axis=-1)
    # signed cosine (utils.py:583-585): direction flips score as ~180 deg
    cos = np.einsum("nd,nd->n", tr_e, tr_g) / np.maximum(ne * ng, 1e-12)
    tr_err = np.rad2deg(np.arccos(np.clip(cos, -1.0, 1.0)))
    # near-coincident GT centers: rotation-only error (utils.py:659-668)
    tr_err = np.where(ng < max(min_proj_center_dist, 1e-12), 0.0, tr_err)

    err = np.maximum(rot_err, tr_err)
    bad = ~registered[ii] | ~registered[jj]
    return np.where(bad, np.inf, err)   # max(inf, 180) per the reference


def auc(errors: np.ndarray, thresholds, min_error: float = 0.0) -> list:
    """Pose AUC at thresholds, returned as recall-fractions in [0, 1]
    (reference ``evaluation/utils.py:719-750``, minus its final x100/1.1
    display scaling — apply ``REFERENCE_AUC_SCALE`` to compare against
    reference-reported numbers).

    ``min_error`` clamps the recall curve below the GT accuracy: errors
    smaller than the GT's own position accuracy are indistinguishable from
    perfect, so recall is held flat there (utils.py:731-737)."""
    errors = np.sort(np.asarray(errors, np.float64))
    num = len(errors)
    if num == 0:
        raise ValueError("no errors to evaluate")
    recall = (np.arange(num) + 1) / num
    if min_error > 0:
        min_index = np.searchsorted(errors, min_error, side="right")
        min_score = min_index / num
        recall = np.r_[min_score, min_score, recall[min_index:]]
        errors = np.r_[0.0, min_error, errors[min_index:]]
    else:
        recall = np.r_[0.0, recall]
        errors = np.r_[0.0, errors]
    out = []
    for th in thresholds:
        last = np.searchsorted(errors, th, side="right")
        r = np.r_[recall[:last], recall[last - 1]]
        e = np.r_[errors[:last], th]
        out.append(float(np.trapezoid(r, x=e) / th))
    return out


# the reference reports compute_auc(...) * 100 / 1.1 (utils.py:750) —
# a display-scale quirk kept out of the fraction-valued ``auc`` above
REFERENCE_AUC_SCALE = 100.0 / 1.1
