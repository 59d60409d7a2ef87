"""Parity of the port's relative-pose RANSAC (``instantsfm_tpu_torch/
pipeline/relpose.py``) against the JAX package, both in float64, with the
port fed the uniforms JAX draws (``jax_uniforms``: the JAX stage's key
schedule, one split a chunk and three a chunk for E, F and H).

Tolerances: inlier masks are equal.  Models and poses agree within 1e-8
(E, F up to sign; H is normalized by its last entry), except where the
RANSAC winner is a 5-point candidate at a near-double root of the degree-10
polynomial: such a root moves by the square root of float noise in the
polynomial's coefficients, and the two LO rounds keep it when they find no
more inliers.  At the whole-stage test's size (91 pairs of 14 images) one
pair is such a case, at 2.5e-6 in E and 1.7e-6 in q: the stage test holds
every pair within 1e-5 and all but 2% of them within 1e-8.
"""

import os

import jax
import numpy as np
import pytest
import torch

from instantsfm_tpu.config import Config as JConfig
from instantsfm_tpu.io.colmap_db import read_colmap_database as jread_db
from instantsfm_tpu.pipeline import preprocess as jpre
from instantsfm_tpu.pipeline import relpose as jrp
from instantsfm_tpu.pipeline import vgc as jvgc
from instantsfm_tpu.scene.types import CONFIG_PLANAR, CONFIG_UNCALIBRATED
from instantsfm_tpu_torch.config import Config
from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
from instantsfm_tpu_torch.pipeline import preprocess as tpre
from instantsfm_tpu_torch.pipeline import relpose as trp
from instantsfm_tpu_torch.pipeline import vgc as tvgc
from tests.synthetic import make_scene
from tests.test_e2e import _write_synthetic_db


def jax_uniforms(seed=0):
    """``uniforms(chunk, model, shape)`` drawing what the JAX stage draws:
    chunk k's key is PRNGKey(seed) split once per earlier chunk, then split
    three ways for E, F and H."""
    keys = [jax.random.PRNGKey(seed)]

    def draw(k, model, shape):
        while len(keys) <= k:
            keys.append(jax.random.split(keys[-1], 1)[0])
        ke, kf, kh = jax.random.split(keys[k], 3)
        key = {"E": ke, "F": kf, "H": kh}[model]
        return np.array(jax.random.uniform(key, shape))
    return draw


def write_e2e_db(dirpath):
    """``tests/test_e2e.py``'s scene (14 images, 220 points) as a COLMAP
    database; returns its path and the scene (ground truth)."""
    scene = make_scene(num_cams=14, num_pts=220, params=[500.0, 320, 240, 0.0],
                       seed=3, vis_prob=0.85)
    dbpath = os.path.join(dirpath, "database.db")
    _write_synthetic_db(scene, dbpath, np.random.default_rng(0))
    return dbpath, scene


def _up_to_sign(a, b):
    a = a.reshape(a.shape[:-2] + (-1,)) if a.ndim > 2 else a
    b = b.reshape(b.shape[:-2] + (-1,)) if b.ndim > 2 else b
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


def _matches(P, M, seed, pixels=False, planar=False, outliers=0.15):
    """P two-view problems of M matches (the last M // 8 padded), with a
    share of random outliers: (x1, x2 [P, M, 2], valid [P, M])."""
    from scipy.spatial.transform import Rotation as R
    rng = np.random.default_rng(seed)
    Rs = R.from_rotvec(0.2 * rng.standard_normal((P, 3))).as_matrix()
    ts = rng.standard_normal((P, 3))
    X = rng.uniform(-1, 1, (P, M, 3)) + np.array([0, 0, 5.0])
    if planar:
        X[..., 2] = 5.0
    X2 = np.einsum("pij,pmj->pmi", Rs, X) + ts[:, None]
    x1 = X[..., :2] / X[..., 2:]
    x2 = X2[..., :2] / X2[..., 2:]
    scale, noise = (500.0, 0.3) if pixels else (1.0, 3e-4)
    x1 = x1 * scale + noise * rng.standard_normal(x1.shape)
    x2 = x2 * scale + noise * rng.standard_normal(x2.shape)
    out = rng.uniform(size=(P, M)) < outliers
    x2[out] = rng.uniform(-0.3, 0.3, (out.sum(), 2)) * scale
    valid = np.ones((P, M), bool)
    valid[:, M - M // 8:] = False
    x1[~valid] = 0.0
    x2[~valid] = 0.0
    return x1, x2, valid


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("model", ["E5", "E8", "F", "H"])
def test_ransac_core_matches_jax(model):
    P, M, key = 16, 256, jax.random.PRNGKey(7)
    pixels = model in ("F", "H")
    x1, x2, valid = _matches(P, M, seed=3, pixels=pixels,
                             planar=model == "H")
    thr = (3.0 ** 2) if pixels else (1e-3 ** 2)
    jargs = (jax.numpy.asarray(x1), jax.numpy.asarray(x2),
             jax.numpy.asarray(valid), key)
    targs = (_t(x1), _t(x2), _t(valid))
    if model == "E5":
        H = 48
        mj, inj = jrp._ransac_essential_5pt(*jargs, H, thr)
        u = jax.random.uniform(key, (P, H, 5))
        mt, int_ = trp._ransac_essential_5pt(*targs, _t(u), torch.tensor(thr))
    elif model == "H":
        H = 256
        mj, inj = jrp._ransac_homography(*jargs, H, thr)
        u = jax.random.uniform(key, (P, H, 4))
        mt, int_ = trp._ransac_homography(*targs, _t(u), torch.tensor(thr))
    else:
        H = 256
        mj, inj = jrp._ransac_fundamental_like(*jargs, H, thr,
                                               essential=model == "E8")
        u = jax.random.uniform(key, (P, H, 8))
        mt, int_ = trp._ransac_fundamental_like(*targs, _t(u),
                                                torch.tensor(thr),
                                                essential=model == "E8")
    mj, inj = np.asarray(mj), np.asarray(inj)
    mt, int_ = mt.numpy(), int_.numpy()
    assert np.array_equal(int_, inj)
    assert inj.sum(-1).mean() > 0.4 * M
    d = (np.abs(mt - mj).reshape(P, 9).max(-1) / np.abs(mj).reshape(P, 9).max(-1)
         if model == "H" else _up_to_sign(mt, mj))
    assert np.max(d) < 1e-8


def _stage_inputs(pkg, dbpath, configs):
    """Read the database and run preprocess + view-graph calibration +
    undistortion with one package; ``configs`` overrides some pairs'
    two-view configuration."""
    if pkg == "jax":
        vg, cams, imgs, _ = jread_db(dbpath)
        vg.config[configs[0]] = configs[1]
        jpre.update_image_pairs_config(vg, cams, imgs)
        jpre.decompose_relpose(vg, cams, imgs)
        jvgc.solve_view_graph_calibration(
            vg, cams, imgs, JConfig().VIEW_GRAPH_CALIBRATOR_OPTIONS)
        jrp.undistort_images(cams, imgs)
    else:
        vg, cams, imgs, _ = read_colmap_database(dbpath)
        vg.config[configs[0]] = configs[1]
        tpre.update_image_pairs_config(vg, cams, imgs)
        tpre.decompose_relpose(vg, cams, imgs)
        tvgc.solve_view_graph_calibration(
            vg, cams, imgs, Config().VIEW_GRAPH_CALIBRATOR_OPTIONS,
            device="cpu")
        trp.undistort_images(cams, imgs, device="cpu")
    return vg, cams, imgs


def test_estimate_relative_pose_matches_jax(tmp_path, monkeypatch):
    """The whole stage on the 14-image database, a few pairs set
    UNCALIBRATED and PLANAR so the F and H paths run, chunks of 32 pairs so
    the key schedule crosses chunks; JAX on one device."""
    monkeypatch.setenv("ISFM_RELPOSE_ONE_DEVICE", "1")
    dbpath, _ = write_e2e_db(str(tmp_path))
    rows = np.arange(0, 91, 7)
    cfg = np.where(np.arange(len(rows)) % 2, CONFIG_UNCALIBRATED, CONFIG_PLANAR)
    vj, cj, ij = _stage_inputs("jax", dbpath, (rows, cfg))
    vt, ct, it = _stage_inputs("torch", dbpath, (rows, cfg))
    assert np.max(np.abs(it.kp_bearing - ij.kp_bearing)) < 1e-12
    assert np.array_equal(vt.valid, vj.valid)

    jrp.estimate_relative_pose(vj, cj, ij, chunk_pairs=32)
    trp.estimate_relative_pose(vt, ct, it, chunk_pairs=32, device="cpu",
                               uniforms=jax_uniforms(0))
    assert np.array_equal(vt.valid, vj.valid)
    assert np.array_equal(vt.inlier_mask, vj.inlier_mask)
    est = np.nonzero(vj.valid)[0]
    assert len(est) > 80
    dE = _up_to_sign(vt.E_mat[est], vj.E_mat[est])
    dq = _up_to_sign(vt.qvec[est][:, None], vj.qvec[est][:, None])
    dt = np.abs(vt.tvec[est] - vj.tvec[est]).max(-1)
    for d in (dE, dq, dt):
        assert np.max(d) < 1e-5
        assert np.mean(d < 1e-8) >= 0.98
    uncal = rows[cfg == CONFIG_UNCALIBRATED]
    planar = rows[cfg == CONFIG_PLANAR]
    assert np.max(_up_to_sign(vt.F_mat[uncal], vj.F_mat[uncal])) < 1e-8
    hj, ht = vj.H_mat[planar], vt.H_mat[planar]
    assert np.abs(hj).max() > 0
    assert np.max(np.abs(ht - hj)) < 1e-8 * np.abs(hj).max()
