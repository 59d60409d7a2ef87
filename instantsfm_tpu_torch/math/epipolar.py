"""Batched two-view geometry on torch tensors: 8-point E/F, 4-point H,
Sampson scoring, essential-matrix decomposition with cheirality.

Counterpart of ``instantsfm_tpu/math/epipolar.py``.  Every function takes
leading batch dimensions (pairs, hypotheses) and masked match arrays
``[..., M, 2]``, so the RANSAC stages run one call per chunk of pairs.

Matrix convention: x2ᵀ E x1 = 0 with E = [t]× R and  x2 = R x1 + t
(cam1 -> cam2).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12
# cuSOLVER's batched symmetric eigensolver refuses 32,768 or more matrices
# in one call (CUSOLVER_STATUS_INVALID_VALUE; torch 2.11, CUDA 12.8, H100),
# which view-graph calibration reaches from 16,384 image pairs; in float32
# it can also fail to converge on the double eigenvalue of EᵀE (an
# essential matrix), so svd3x3 solves its 3x3 eigenproblems in float64
EIGH_BATCH = 16384


def _norm(x, dim=-1, keepdim=False):
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def svd3x3(M):
    """Batched SVD of (..., 3, 3) via eigh of MᵀM (no sign guarantees beyond
    U S Vᵀ = M with S >= 0 descending).  Returns (U, s, V)."""
    MtM = M.transpose(-1, -2) @ M
    # torch.linalg.eigh raises on a matrix that is not finite, where JAX's
    # returns NaN: such a matrix is solved as zero and its factors are NaN
    bad = ~torch.isfinite(MtM).all(dim=-1).all(dim=-1)
    flat = torch.where(bad[..., None, None], 0.0, MtM).reshape(-1, 3, 3)
    parts = [torch.linalg.eigh(c) for c in
             flat.to(torch.float64).split(EIGH_BATCH)]
    s2 = torch.cat([p[0] for p in parts]).reshape(MtM.shape[:-1])
    V = torch.cat([p[1] for p in parts]).reshape(MtM.shape)   # ascending
    s2, V = s2.to(M.dtype), V.to(M.dtype)
    s2 = torch.where(bad[..., None], torch.nan, s2)
    V = torch.where(bad[..., None, None], torch.nan, V)
    s2 = s2.flip(-1)
    V = V.flip(-1)
    s = torch.sqrt(s2.clamp_min(0.0))
    U = (M @ V) / s[..., None, :].clamp_min(_EPS)
    # a (near-)zero singular value leaves its U column degenerate: rebuild it
    # from orthogonality (needed for rank-2 E/F where t = u3)
    tiny = s[..., 2] < 1e-6 * s[..., 0].clamp_min(_EPS)
    u2_cross = _cross(U[..., :, 0], U[..., :, 1])
    U = torch.cat([U[..., :, :2],
                   torch.where(tiny[..., None], u2_cross, U[..., :, 2])[..., None]],
                  dim=-1)
    return U, s, V


def hartley_normalize(pts, mask):
    """Normalize 2D points to zero mean / sqrt(2) RMS over masked entries.

    pts [..., M, 2], mask [..., M].  Returns (pts_n, T [..., 3, 3]) with
    x_n = T x (homogeneous)."""
    m = mask[..., None].to(pts.dtype)
    cnt = torch.sum(m, dim=-2, keepdim=True).clamp_min(1.0)          # [...,1,1]
    mean = torch.sum(pts * m, dim=-2, keepdim=True) / cnt            # [...,1,2]
    d = _norm((pts - mean) * m, dim=-1)
    rms = torch.sqrt(torch.sum(d * d, dim=-1)[..., None, None] / cnt[..., :1])
    scale = math.sqrt(2.0) / rms.clamp_min(_EPS)                     # [...,1,1]
    pts_n = (pts - mean) * scale
    s = scale[..., 0, 0]
    mean = mean[..., 0, :]
    z, o = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([s, z, -s * mean[..., 0],
                     z, s, -s * mean[..., 1],
                     z, z, o], dim=-1)
    return pts_n, T.reshape(T.shape[:-1] + (3, 3))


def _nullvec9(A_rows, row_mask):
    """Smallest right singular vector of masked rows [..., S, 9] via 6
    inverse iterations on AᵀA + ridge."""
    w = row_mask[..., None].to(A_rows.dtype)
    AtA = torch.einsum("...si,...sj->...ij", A_rows * w, A_rows)
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    # the ridge must sit above the dtype's representable precision of AtA
    ridge = 100.0 * torch.finfo(A_rows.dtype).eps
    M = AtA + ridge * tr * torch.eye(9, dtype=A_rows.dtype,
                                     device=A_rows.device)
    v = torch.ones(A_rows.shape[:-2] + (9,), dtype=A_rows.dtype,
                   device=A_rows.device) / 3.0
    for _ in range(6):
        v = torch.linalg.solve(M, v[..., None])[..., 0]
        v = v / _norm(v, dim=-1, keepdim=True).clamp_min(_EPS)
    return v


def _epipolar_rows(x1, x2):
    """DLT rows for x2ᵀ F x1 = 0: kron(x2, x1) with homogeneous coords.
    x1, x2: [..., 2] -> rows [..., 9]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2,
                        v2 * u1, v2 * v1, v2,
                        u1, v1, one], dim=-1)


def eight_point(x1, x2, sample_mask, enforce_essential=False):
    """Estimate F (or E) from masked correspondences via normalized 8-point.

    x1, x2: [..., M, 2]; sample_mask: [..., M] bool (>= 8 true entries
    expected).  Returns [..., 3, 3], Frobenius-normalized.  With
    ``enforce_essential`` the result is projected to the essential manifold
    diag(1,1,0); otherwise to rank 2."""
    x1n, T1 = hartley_normalize(x1, sample_mask)
    x2n, T2 = hartley_normalize(x2, sample_mask)
    f = _nullvec9(_epipolar_rows(x1n, x2n), sample_mask)
    F = f.reshape(f.shape[:-1] + (3, 3))
    if enforce_essential:
        # the essential structure diag(s,s,0) only holds in the original
        # (calibrated) coordinates: denormalize first, then project
        F = T2.transpose(-1, -2) @ F @ T1
        U, s, V = svd3x3(F)
        s_avg = (s[..., 0] + s[..., 1]) / 2
        s_new = torch.stack([s_avg, s_avg, torch.zeros_like(s_avg)], dim=-1)
        F = (U * s_new[..., None, :]) @ V.transpose(-1, -2)
    else:
        U, s, V = svd3x3(F)
        s_new = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
        F = (U * s_new[..., None, :]) @ V.transpose(-1, -2)
        F = T2.transpose(-1, -2) @ F @ T1
    norm = _norm(F.reshape(F.shape[:-2] + (9,)), dim=-1)
    return F / norm[..., None, None].clamp_min(_EPS)


def sampson_error(F, x1, x2):
    """Squared Sampson distance per correspondence (homogeneous z=1).

    F [..., 3, 3]; x1, x2 [..., M, 2] (batch dims broadcast).  Returns
    [..., M]."""
    f = lambda i, j: F[..., i, j, None]
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    a0 = f(0, 0) * u1 + f(0, 1) * v1 + f(0, 2)
    a1 = f(1, 0) * u1 + f(1, 1) * v1 + f(1, 2)
    a2 = f(2, 0) * u1 + f(2, 1) * v1 + f(2, 2)
    b0 = f(0, 0) * u2 + f(1, 0) * v2 + f(2, 0)
    b1 = f(0, 1) * u2 + f(1, 1) * v2 + f(2, 1)
    C = u2 * a0 + v2 * a1 + a2
    denom = a0 ** 2 + a1 ** 2 + b0 ** 2 + b1 ** 2
    return C * C / denom.clamp_min(_EPS)


def homography_dlt(x1, x2, sample_mask):
    """4+-point homography via DLT on masked correspondences: [..., 3, 3],
    x2 ~ H x1."""
    x1n, T1 = hartley_normalize(x1, sample_mask)
    x2n, T2 = hartley_normalize(x2, sample_mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([z, z, z, u1, v1, o, -v2 * u1, -v2 * v1, -v2], dim=-1)
    rows = torch.cat([r1, r2], dim=-2)
    rmask = torch.cat([sample_mask, sample_mask], dim=-1)
    h = _nullvec9(rows, rmask)
    H = h.reshape(h.shape[:-1] + (3, 3))
    H = torch.linalg.solve(T2, H @ T1)
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < _EPS, torch.ones_like(h22), h22)


def homography_error(H, x1, x2):
    """Squared one-sided transfer error |proj(H x1) - x2|^2 per
    correspondence: H [..., 3, 3], x1, x2 [..., M, 2] -> [..., M]."""
    h = lambda i, j: H[..., i, j, None]
    u1, v1 = x1[..., 0], x1[..., 1]
    p0 = h(0, 0) * u1 + h(0, 1) * v1 + h(0, 2)
    p1 = h(1, 0) * u1 + h(1, 1) * v1 + h(1, 2)
    p2 = h(2, 0) * u1 + h(2, 1) * v1 + h(2, 2) + _EPS
    return (p0 / p2 - x2[..., 0]) ** 2 + (p1 / p2 - x2[..., 1]) ** 2


def decompose_essential(E):
    """E -> (R1, R2, t): the four candidate poses are (R1,t), (R1,-t),
    (R2,t), (R2,-t)."""
    U, s, V = svd3x3(E)
    # Gram-Schmidt + cross product give an exactly orthonormal right-handed
    # U (det +1); V is orthonormal from eigh: negate the whole matrix if it
    # is improper (single-column flips would change the candidate set)
    u1 = U[..., :, 0]
    u1 = u1 / _norm(u1, dim=-1, keepdim=True).clamp_min(_EPS)
    u2 = U[..., :, 1]
    u2 = u2 - torch.sum(u1 * u2, dim=-1, keepdim=True) * u1
    u2 = u2 / _norm(u2, dim=-1, keepdim=True).clamp_min(_EPS)
    u3 = _cross(u1, u2)
    U = torch.stack([u1, u2, u3], dim=-1)
    V = V * torch.sign(torch.linalg.det(V))[..., None, None]
    W = torch.tensor([[0., -1., 0.], [1., 0., 0.], [0., 0., 1.]],
                     dtype=E.dtype, device=E.device)
    Vt = V.transpose(-1, -2)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return R1, R2, t


def cheirality_depths(Rm, t, x1, x2):
    """Two-ray depths lambda1, lambda2 of the midpoint triangulation, scaled
    by (1 - a^2).  x1, x2: unit bearings [..., M, 3] in their own camera
    frames; pose x2 = R x1 + t with Rm [..., 3, 3], t [..., 3]."""
    Rx1 = torch.einsum("...ij,...mj->...mi", Rm, x1)
    a = -torch.sum(Rx1 * x2, dim=-1)
    b1 = -torch.sum(Rx1 * t[..., None, :], dim=-1)
    b2 = torch.sum(x2 * t[..., None, :], dim=-1)
    lam1 = b1 - a * b2
    lam2 = -a * b1 + b2
    scale = 1.0 - a * a
    return lam1, lam2, scale


def cheirality_mask(Rm, t, x1b, x2b, mask, min_depth=0.0, max_depth=100.0):
    """Matches of ``mask`` that pass the cheirality test for (Rm, t)."""
    lam1, lam2, sc = cheirality_depths(Rm, t, x1b, x2b)
    return ((lam1 > min_depth * sc) & (lam2 > min_depth * sc)
            & (lam1 < max_depth * sc) & (lam2 < max_depth * sc) & mask)


def recover_pose(E, x1b, x2b, mask, min_depth=0.0, max_depth=100.0):
    """Choose the (R, t) with the most matches passing cheirality, like
    cv2.recoverPose.

    E [..., 3, 3]; x1b, x2b: [..., M, 3] unit bearings; mask: [..., M]
    inliers to vote with.  Returns R [..., 3, 3], t [..., 3], pass_mask
    [..., M] (inliers passing cheirality for the winning pose); ties go to
    the first candidate."""
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2], dim=-3)          # [..., 4, 3, 3]
    cands_t = torch.stack([t, -t, t, -t], dim=-2)            # [..., 4, 3]
    oks = cheirality_mask(cands_R, cands_t, x1b[..., None, :, :],
                          x2b[..., None, :, :], mask[..., None, :],
                          min_depth, max_depth)              # [..., 4, M]
    best = torch.argmax(torch.sum(oks, dim=-1), dim=-1)      # [...]
    Rbest = torch.take_along_dim(cands_R, best[..., None, None, None],
                                 dim=-3)[..., 0, :, :]
    tbest = torch.take_along_dim(cands_t, best[..., None, None],
                                 dim=-2)[..., 0, :]
    pass_mask = torch.take_along_dim(oks, best[..., None, None],
                                     dim=-2)[..., 0, :]
    return Rbest, tbest, pass_mask
