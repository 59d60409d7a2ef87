"""Parity of the port's two-view geometry (``instantsfm_tpu_torch/math/
epipolar.py`` and ``math/fivepoint.py``) against the JAX package on the same
correspondences, both in float64.

Tolerances:
* ``svd3x3`` singular values, Sampson and transfer errors, cheirality
  depths, homographies: 1e-10 relative (float64 sums in other orders),
  but the smallest singular value within 1e-7 of the largest (it is the
  square root of an eigenvalue of MᵀM, known to eps * s_max²);
* 8-point E/F and the E of ``recover_pose``'s input: up to sign within
  1e-8 relative (eigenvector signs differ between torch's and XLA's eigh);
* ``recover_pose``: the chosen (R, t) within 1e-8 and the same pass mask,
  for E and for -E (the choice must not depend on eigenvector signs);
* ``five_point``: the slot validity masks are equal.  With the Gauss-Newton
  polish every candidate E agrees up to sign within 1e-8 relative except
  near-double roots of the degree-10 polynomial, whose roots move by the
  square root of float noise in its coefficients: at least 99.5% of valid
  slots within 1e-8, all within 1e-5, and the slot of the true E within
  1e-8.  Unpolished (as RANSAC scores them), the same near-double roots
  move further: at least 99% of slots within 1e-8, the true E's slot within
  1e-5 (measured on 2,000 problems: 66 of 10,372 slots above 1e-8, the true
  slot at most 1.4e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from instantsfm_tpu.math import epipolar as jep
from instantsfm_tpu.math import fivepoint as jfp
from instantsfm_tpu_torch.math import epipolar as tep
from instantsfm_tpu_torch.math import fivepoint as tfp


def _two_view(n_problems, n_pts, seed, noise=0.0):
    """Random calibrated two-view problems: (x1, x2 [B, n, 2] normalized
    coords, b1, b2 [B, n, 3] unit bearings, E_true [B, 3, 3] unit
    Frobenius, R [B, 3, 3], t [B, 3] unit), points in front of both."""
    rng = np.random.default_rng(seed)
    Rs = R.from_rotvec(0.3 * rng.standard_normal((n_problems, 3))).as_matrix()
    ts = rng.standard_normal((n_problems, 3))
    ts /= np.linalg.norm(ts, axis=1, keepdims=True)
    X = rng.uniform(-1, 1, (n_problems, n_pts, 3)) + np.array([0, 0, 4.0])
    X2 = np.einsum("bij,bnj->bni", Rs, X) + ts[:, None]
    x1 = X[..., :2] / X[..., 2:] + noise * rng.standard_normal(X[..., :2].shape)
    x2 = X2[..., :2] / X2[..., 2:] + noise * rng.standard_normal(X[..., :2].shape)
    b1 = np.concatenate([x1, np.ones(x1.shape[:-1] + (1,))], -1)
    b2 = np.concatenate([x2, np.ones(x2.shape[:-1] + (1,))], -1)
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    b2 /= np.linalg.norm(b2, axis=-1, keepdims=True)
    tx = np.zeros((n_problems, 3, 3))
    tx[:, 0, 1], tx[:, 0, 2] = -ts[:, 2], ts[:, 1]
    tx[:, 1, 0], tx[:, 1, 2] = ts[:, 2], -ts[:, 0]
    tx[:, 2, 0], tx[:, 2, 1] = -ts[:, 1], ts[:, 0]
    E = tx @ Rs
    E /= np.linalg.norm(E.reshape(n_problems, 9), axis=1)[:, None, None]
    return x1, x2, b1, b2, E, Rs, ts


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _up_to_sign(a, b):
    """Per-matrix max |a - s b| with s = +-1, over [..., 3, 3]."""
    a = a.reshape(a.shape[:-2] + (9,))
    b = b.reshape(b.shape[:-2] + (9,))
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


def _svd3x3_holds(M):
    Uj, sj, Vj = (np.asarray(a) for a in jep.svd3x3(_j(M)))
    Ut, st, Vt = (a.numpy() for a in tep.svd3x3(_t(M)))
    assert st.shape == sj.shape and Ut.shape == Vt.shape == M.shape
    assert _rel(st[..., :2], sj[..., :2]) < 1e-10
    # the smallest singular value comes from the eigenvalue of MᵀM, known
    # to eps * s_max², so to sqrt(eps) * s_max (rank-2 rows: s3 = 0)
    assert np.max(np.abs(st[..., 2] - sj[..., 2]) / sj[..., 0]) < 1e-7
    # each factorization reproduces M (signs of U/V columns are free) as
    # well as JAX's does: U = M V / s carries the same sqrt(eps) error
    for U, s, V in ((Ut, st, Vt), (Uj, sj, Vj)):
        rec = np.einsum("...ij,...j,...kj->...ik", U, s, V)
        assert np.max(np.abs(rec - M)) < 1e-7


def test_svd3x3_matches_jax():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((64, 3, 3))
    M[:8, :, 2] = M[:8, :, 0] + M[:8, :, 1]           # rank 2
    _svd3x3_holds(M)


def test_svd3x3_of_non_finite_matrix_is_nan_like_jax():
    """A matrix with NaN or inf in the batch: JAX's eigh gives it NaN
    factors, and so does the port, where ``torch.linalg.eigh`` would raise
    for the whole batch; the other matrices are factored as before."""
    rng = np.random.default_rng(2)
    M = rng.standard_normal((16, 3, 3))
    M[3, 1, 1] = np.nan
    M[7, 0, 2] = np.inf
    Uj, sj, Vj = (np.asarray(a) for a in jep.svd3x3(_j(M)))
    Ut, st, Vt = (a.numpy() for a in tep.svd3x3(_t(M)))
    for j, t in ((Uj, Ut), (sj, st), (Vj, Vt)):
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(st[[3, 7]]).all()
    ok = np.ones(16, bool)
    ok[[3, 7]] = False
    _svd3x3_holds(M[ok])
    np.testing.assert_allclose(st[ok], tep.svd3x3(_t(M[ok]))[1].numpy())


def test_svd3x3_splits_large_batches():
    """Past ``EIGH_BATCH`` matrices (cuSOLVER refuses 32,768 in one batched
    call) the eigensolves run in chunks: the same factorization, over two
    leading dimensions."""
    rng = np.random.default_rng(1)
    M = rng.standard_normal((2, tep.EIGH_BATCH // 2 + 37, 3, 3))
    M[:, :8, :, 2] = M[:, :8, :, 0] + M[:, :8, :, 1]
    _svd3x3_holds(M)


@pytest.mark.parametrize("essential", [True, False])
def test_eight_point_matches_jax(essential):
    x1, x2, *_ = _two_view(32, 40, seed=1, noise=1e-3)
    rng = np.random.default_rng(2)
    mask = rng.uniform(size=x1.shape[:2]) < 0.8
    Fj = np.asarray(jax_eight_point(x1, x2, mask, essential))
    Ft = tep.eight_point(_t(x1), _t(x2), _t(mask), essential).numpy()
    assert np.max(_up_to_sign(Ft, Fj)) < 1e-8


def jax_eight_point(x1, x2, mask, essential):
    import jax
    return jax.vmap(jep.eight_point, in_axes=(0, 0, 0, None))(
        _j(x1), _j(x2), _j(mask), essential)


def test_sampson_and_homography_match_jax():
    x1, x2, *_ = _two_view(8, 50, seed=3, noise=1e-2)
    rng = np.random.default_rng(4)
    F = rng.standard_normal((8, 3, 3))
    sj = np.asarray(jep.sampson_error(_j(F), _j(x1), _j(x2)))
    st = tep.sampson_error(_t(F), _t(x1), _t(x2)).numpy()
    assert _rel(st, sj) < 1e-10
    mask = np.ones(x1.shape[:2], bool)
    import jax
    Hj = np.asarray(jax.vmap(jep.homography_dlt)(_j(x1), _j(x2), _j(mask)))
    Ht = tep.homography_dlt(_t(x1), _t(x2), _t(mask)).numpy()
    assert _rel(Ht, Hj) < 1e-10
    hj = np.asarray(jep.homography_error(_j(Hj), _j(x1), _j(x2)))
    ht = tep.homography_error(_t(Hj), _t(x1), _t(x2)).numpy()
    assert _rel(ht, hj) < 1e-10


@pytest.mark.parametrize("flip", [1.0, -1.0])
def test_recover_pose_matches_jax(flip):
    """Same (R, t) and pass mask from E and from -E: the choice does not
    depend on the eigenvector signs of the SVD."""
    import jax
    x1, x2, b1, b2, E, Rs, ts = _two_view(32, 60, seed=5, noise=1e-4)
    rng = np.random.default_rng(6)
    mask = rng.uniform(size=x1.shape[:2]) < 0.9
    Rj, tj, pj = (np.asarray(a) for a in jax.vmap(jep.recover_pose)(
        _j(E), _j(b1), _j(b2), _j(mask)))
    Rt, tt, pt = (a.numpy() for a in tep.recover_pose(
        _t(flip * E), _t(b1), _t(b2), _t(mask)))
    assert np.max(np.abs(Rt - Rj)) < 1e-8
    assert np.max(np.abs(tt - tj)) < 1e-8
    assert np.array_equal(pt, pj)
    # and it is the true pose
    assert np.max(np.abs(Rt - Rs)) < 1e-3
    assert np.max(np.abs(tt - ts)) < 1e-3
    lj = [np.asarray(a) for a in jax.vmap(jep.cheirality_depths)(
        _j(Rs), _j(ts), _j(b1), _j(b2))]
    lt = [a.numpy() for a in tep.cheirality_depths(_t(Rs), _t(ts), _t(b1),
                                                   _t(b2))]
    for a, b in zip(lt, lj):
        assert _rel(a, b) < 1e-10


@pytest.mark.parametrize("polish", [True, False])
def test_five_point_matches_jax(polish):
    x1, x2, _, _, E_true, _, _ = _two_view(400, 5, seed=7)
    Ej, okj = (np.asarray(a) for a in jfp.five_point(_j(x1), _j(x2),
                                                      polish=polish))
    Et, okt = (a.numpy() for a in tfp.five_point(_t(x1), _t(x2),
                                                  polish=polish))
    assert Et.shape == (400, tfp.NUM_ROOT_SLOTS, 3, 3)
    assert np.array_equal(okt, okj)
    d = _up_to_sign(Et, Ej)[okj]
    if polish:
        assert np.mean(d < 1e-8) >= 0.995 and np.max(d) < 1e-5
    else:
        assert np.mean(d < 1e-8) >= 0.99
    # the slot holding the true E
    dt = np.where(okj, _up_to_sign(Ej, E_true[:, None]), np.inf)
    found = dt.min(1) < 1e-6
    assert found.mean() > 0.95
    slot = dt.argmin(1)
    d_true = _up_to_sign(Et, Ej)[np.arange(len(slot)), slot][found]
    assert np.max(d_true) < (1e-8 if polish else 1e-5)
