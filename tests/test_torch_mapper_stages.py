"""Stage-by-stage parity of the port's mapper (``instantsfm_tpu_torch/
pipeline/``, ``io/colmap_db.py``, the model writer) against the JAX package,
both in float64 on the CPU.

A module fixture runs the JAX stages once on ``tests/test_e2e.py``'s scene
(14 images, 220 points, written as a COLMAP database) and keeps the state
before and after each stage; each test hands a stage's input state to the
port and holds its output against JAX's.  JAX runs on one device
(``ISFM_NO_SHARD``, ``ISFM_RELPOSE_ONE_DEVICE``), the path the port has.

Tolerances: database reads, preprocessing, track establishment, filter masks
and the model files are exact (equal arrays, equal bytes); view-graph
calibration focals within 1e-6 relative (the Fetzer coefficients are
differences of products of SVD terms, and float noise in them moves the
LM's stopping point by about 1e-8 relative); rotation averaging quaternions
within 1e-9 (up to sign); global positioning centers and points within 1e-6
of the scene extent; ``normalize_reconstruction`` within 1e-12.
"""

import copy
import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from instantsfm_tpu import native as jnative
from instantsfm_tpu.config import Config as JConfig
from instantsfm_tpu.io.colmap_db import read_colmap_database as jread_db
from instantsfm_tpu.pipeline import filters as jfilters
from instantsfm_tpu.pipeline import positioning as jgp
from instantsfm_tpu.pipeline import preprocess as jpre
from instantsfm_tpu.pipeline import relpose as jrp
from instantsfm_tpu.pipeline import rotation_averaging as jra
from instantsfm_tpu.pipeline import track_filters as jtf
from instantsfm_tpu.pipeline import tracks as jtracks
from instantsfm_tpu.pipeline import vgc as jvgc
from instantsfm_tpu.pipeline import writer as jwriter
from instantsfm_tpu_torch.config import Config
from instantsfm_tpu_torch.io.colmap_db import (ColmapDatabase,
                                               read_colmap_database)
from instantsfm_tpu_torch.pipeline import filters as tfilters
from instantsfm_tpu_torch.pipeline import positioning as tgp
from instantsfm_tpu_torch.pipeline import preprocess as tpre
from instantsfm_tpu_torch.pipeline import relpose as trp
from instantsfm_tpu_torch.pipeline import rotation_averaging as tra
from instantsfm_tpu_torch.pipeline import track_filters as ttf
from instantsfm_tpu_torch.pipeline import tracks as ttracks
from instantsfm_tpu_torch.pipeline import vgc as tvgc
from instantsfm_tpu_torch.pipeline import writer as twriter
from instantsfm_tpu_torch.scene import types as ttypes
from instantsfm_tpu_torch.utils import debug as tdebug
from tests.test_torch_relpose import write_e2e_db

JCFG = JConfig("colmap")
TCFG = Config("colmap")
ONE_DEVICE = {"ISFM_NO_SHARD": "1", "ISFM_RELPOSE_ONE_DEVICE": "1"}


def _snap(*objs):
    return copy.deepcopy(objs)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX stages on the 14-image database; a dict of state snapshots
    (view_graph, cameras, images[, tracks]) keyed by the stage after which
    each was taken, plus the database path and the scene."""
    saved = {k: os.environ.get(k) for k in ONE_DEVICE}
    os.environ.update(ONE_DEVICE)
    try:
        dbpath, scene = write_e2e_db(str(tmp_path_factory.mktemp("stages")))
        inl = JCFG.INLIER_THRESHOLD_OPTIONS
        vg, cams, imgs, _ = jread_db(dbpath)
        s = {"db": dbpath, "scene": scene, "read": _snap(vg, cams, imgs)}
        jpre.update_image_pairs_config(vg, cams, imgs)
        jpre.decompose_relpose(vg, cams, imgs)
        s["preprocess"] = _snap(vg, cams, imgs)
        jvgc.solve_view_graph_calibration(vg, cams, imgs,
                                          JCFG.VIEW_GRAPH_CALIBRATOR_OPTIONS)
        jrp.undistort_images(cams, imgs)
        jrp.estimate_relative_pose(vg, cams, imgs)
        s["relpose"] = _snap(vg, cams, imgs)
        jfilters.filter_inlier_num(vg, inl["min_inlier_num"])
        jfilters.filter_inlier_ratio(vg, inl["min_inlier_ratio"])
        assert vg.keep_largest_connected_component(imgs)
        s["relpose_filtered"] = _snap(vg, cams, imgs)
        assert jra.estimate_rotations(vg, imgs, JCFG.ROTATION_ESTIMATOR_OPTIONS,
                                      JCFG.L1_SOLVER_OPTIONS)
        s["rotation_averaging"] = _snap(vg, cams, imgs)
        tracks = jtracks.establish_tracks(vg, imgs,
                                          JCFG.TRACK_ESTABLISHMENT_OPTIONS)
        s["tracks"] = _snap(vg, cams, imgs, tracks)
        tracks = jgp.global_positioning(cams, imgs, tracks,
                                        JCFG.GLOBAL_POSITIONER_OPTIONS)
        s["global_positioning"] = _snap(vg, cams, imgs, tracks)
        yield s
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def to_port(obj):
    """A JAX-package scene object as the port's type (fields copied)."""
    cls = getattr(ttypes, type(obj).__name__)
    return cls(**{f.name: copy.deepcopy(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})


def _port_state(state):
    return [to_port(o) for o in state]


def _assert_same_fields(a, b, rtol=0.0):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if y is None or isinstance(y, list):
            assert x == y, f.name
        elif rtol:
            np.testing.assert_allclose(x, y, rtol=rtol, err_msg=f.name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_read_colmap_database_matches_jax(jax_run, tmp_path):
    """The port's reader gives the JAX reader's arrays; a database written
    by the port's ``ColmapDatabase`` reads back the same in both."""
    vj, cj, ij = jax_run["read"]
    vt, ct, it, name = read_colmap_database(jax_run["db"])
    assert name == "colmap"
    for a, b in ((vt, vj), (ct, cj), (it, ij)):
        _assert_same_fields(a, b)

    path = str(tmp_path / "port.db")
    with ColmapDatabase.connect(path) as db:
        db.create_tables()
        cam_ids = [db.add_camera(int(cj.model_ids[c]), int(cj.widths[c]),
                                 int(cj.heights[c]), cj.params[c, :4],
                                 prior_focal=bool(cj.has_prior_focal[c]))
                   for c in range(cj.num_cameras)]
        img_ids = [db.add_image(ij.names[i], cam_ids[ij.cam_idx[i]])
                   for i in range(ij.num_images)]
        for i in range(ij.num_images):
            db.add_keypoints(img_ids[i], ij.keypoints(i))
        for e in range(vj.num_pairs):
            a, b = img_ids[vj.pair_i[e]], img_ids[vj.pair_j[e]]
            db.add_matches(a, b, vj.pair_matches(e))
            db.add_two_view_geometry(a, b, vj.pair_matches(e),
                                     config=int(vj.config[e]))
        db.set_feature_name("colmap")
    for reader in (jread_db, read_colmap_database):
        v2, c2, i2, n2 = reader(path)
        assert n2 == "colmap"
        for a, b in ((v2, vj), (c2, cj), (i2, ij)):
            _assert_same_fields(a, b)


def test_preprocess_matches_jax(jax_run):
    vg, cams, imgs = _port_state(jax_run["read"])
    tpre.update_image_pairs_config(vg, cams, imgs)
    n_pure = tpre.decompose_relpose(vg, cams, imgs)
    assert isinstance(n_pure, int)
    for a, b in zip((vg, cams, imgs), jax_run["preprocess"]):
        _assert_same_fields(a, b)


def _vgc_scene(seed=0, n_img=8, n_cam=4, noise=1e-3):
    """A view graph whose fundamental matrices come from true poses and
    focals (400-700 px, one per camera) with 1e-3 relative noise on each
    entry, with the
    cameras' focals 5-10% off: JAX-package objects."""
    from scipy.spatial.transform import Rotation as R

    from instantsfm_tpu.scene import types as jtypes
    rng = np.random.default_rng(seed)
    f_true = np.array([400.0, 500.0, 600.0, 700.0])[:n_cam]
    pp = np.array([320.0, 240.0])
    pi, pj = np.triu_indices(n_img, 1)
    E = len(pi)
    cam_idx = (np.arange(n_img) % n_cam).astype(np.int32)
    F = np.empty((E, 3, 3))
    for e in range(E):
        Rr = R.from_rotvec(0.3 * rng.standard_normal(3)).as_matrix()
        t = rng.standard_normal(3)
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        Ki, Kj = (np.linalg.inv(np.array([[f_true[c], 0, pp[0]],
                                          [0, f_true[c], pp[1]], [0, 0, 1]]))
                  for c in (cam_idx[pi[e]], cam_idx[pj[e]]))
        g = Kj.T @ tx @ Rr @ Ki
        F[e] = g / np.linalg.norm(g) * (1 + noise * rng.standard_normal((3, 3)))
    params = np.zeros((n_cam, 12))
    params[:, 0] = f_true * np.array([1.1, 0.9, 1.05, 0.95])[:n_cam]
    params[:, 1:3] = pp
    cams = jtypes.Cameras(np.full(n_cam, 2, np.int32), np.full(n_cam, 640),
                          np.full(n_cam, 480), params, np.ones(n_cam, bool),
                          np.zeros(n_cam, bool))
    z = np.zeros((E, 3, 3))
    vg = jtypes.ViewGraph(
        pi.astype(np.int32), pj.astype(np.int32), np.ones(E, bool),
        np.full(E, jtypes.CONFIG_UNCALIBRATED, np.int8), z.copy(), F, z.copy(),
        np.tile([0.0, 0, 0, 1], (E, 1)), np.zeros((E, 3)),
        np.zeros((0, 2), np.int32), np.zeros(E + 1, np.int64),
        np.zeros(0, bool))
    imgs = jtypes.Images(cam_idx, [f"{i}.png" for i in range(n_img)],
                         np.tile([0.0, 0, 0, 1], (n_img, 1)),
                         np.zeros((n_img, 3)), np.ones(n_img, bool),
                         np.zeros(n_img, np.int32), np.zeros((0, 2)),
                         np.zeros(n_img + 1, np.int64))
    return vg, cams, imgs, f_true


@pytest.mark.parametrize("thres_two_view_error", [2.0, 2e-3])
def test_vgc_matches_jax(jax_run, thres_two_view_error):
    """View-graph calibration of four focals from 28 noisy fundamental
    matrices, and the stage on the 14-image database (whose two-view
    geometries hold F = I): the same focals and the same rejected pairs."""
    vj, cj, ij, f_true = _vgc_scene()
    opts = dict(JCFG.VIEW_GRAPH_CALIBRATOR_OPTIONS,
                thres_two_view_error=thres_two_view_error)
    vt, ct, it = _port_state((vj, cj, ij))
    jvgc.solve_view_graph_calibration(vj, cj, ij, opts)
    tdebug.drain_stats()
    tvgc.solve_view_graph_calibration(vt, ct, it, opts, device="cpu")
    assert "vgc_syncs" in tdebug.drain_stats()
    assert cj.has_refined_focal.all()
    assert np.max(np.abs(cj.params[:, 0] / f_true - 1)) < 2e-3
    np.testing.assert_allclose(ct.params, cj.params, rtol=1e-6)
    assert np.array_equal(ct.has_refined_focal, cj.has_refined_focal)
    assert np.array_equal(vt.valid, vj.valid)
    if thres_two_view_error < 1:
        assert 0 < vj.valid.sum() < vj.num_pairs

    vj, cj, ij = copy.deepcopy(jax_run["preprocess"])
    vt, ct, it = _port_state((vj, cj, ij))
    jvgc.solve_view_graph_calibration(vj, cj, ij, opts)
    tvgc.solve_view_graph_calibration(vt, ct, it, opts, device="cpu")
    np.testing.assert_allclose(ct.params, cj.params, rtol=1e-9)
    assert np.array_equal(vt.valid, vj.valid)


def test_filters_match_jax(jax_run):
    inl = TCFG.INLIER_THRESHOLD_OPTIONS
    vj, cj, ij = copy.deepcopy(jax_run["relpose"])
    vt, ct, it = _port_state((vj, cj, ij))
    for thr in (inl["min_inlier_num"], 120):
        assert tfilters.filter_inlier_num(vt, thr) == \
            jfilters.filter_inlier_num(vj, thr)
    for thr in (inl["min_inlier_ratio"], 0.9):
        assert tfilters.filter_inlier_ratio(vt, thr) == \
            jfilters.filter_inlier_ratio(vj, thr)
    assert np.array_equal(vt.valid, vj.valid)
    # components: the filters above split the graph
    assert vt.keep_largest_connected_component(it) == \
        vj.keep_largest_connected_component(ij)
    assert np.array_equal(it.registered, ij.registered)
    assert np.array_equal(vt.valid, vj.valid)
    assert vt.mark_connected_components(it) == \
        vj.mark_connected_components(ij)
    assert np.array_equal(it.cluster_id, ij.cluster_id)
    # the rotation filter, on the rotations after averaging, at a threshold
    # that drops some pairs
    vj, cj, ij = copy.deepcopy(jax_run["rotation_averaging"])
    vt, ct, it = _port_state((vj, cj, ij))
    nj = jfilters.filter_rotations(vj, ij, 0.05)
    assert tfilters.filter_rotations(vt, it, 0.05) == nj > 0
    assert np.array_equal(vt.valid, vj.valid)


def test_rotation_averaging_matches_jax(jax_run):
    vg, cams, imgs = _port_state(jax_run["relpose_filtered"])
    tdebug.drain_stats()
    assert tra.estimate_rotations(vg, imgs, TCFG.ROTATION_ESTIMATOR_OPTIONS,
                                  TCFG.L1_SOLVER_OPTIONS, device="cpu")
    syncs = tdebug.drain_stats()["ra_syncs"][0]
    assert syncs["l1"] >= 1 and syncs["irls"] >= 1
    qj = jax_run["rotation_averaging"][2].qvec
    d = np.minimum(np.abs(imgs.qvec - qj).max(1), np.abs(imgs.qvec + qj).max(1))
    assert np.max(d) < 1e-9


def test_establish_tracks_matches_jax(jax_run):
    """Tracks equal element for element and in the same order, which needs
    the JAX package's native union-find (the scipy fallback labels
    components otherwise)."""
    assert jnative.get_lib() is not None, "JAX native union-find not built"
    vj, cj, ij = jax_run["rotation_averaging"]
    vt, ct, it = _port_state((vj, cj, ij))
    opts = TCFG.TRACK_ESTABLISHMENT_OPTIONS
    tj, tj_full = jtracks.establish_tracks(vj, ij, opts, return_full=True)
    tt, tt_full = ttracks.establish_tracks(vt, it, opts, return_full=True,
                                           device="cpu")
    assert tj.num_tracks > 100
    for a, b in ((tt, tj), (tt_full, tj_full)):
        _assert_same_fields(a, b)
    _assert_same_fields(tt, jax_run["tracks"][3])


def test_component_max_labels_is_union_find():
    """The device labelling gives every node its component's largest id,
    as the native union-find does, on a random forest of chains."""
    rng = np.random.default_rng(0)
    n = 5000
    e1 = rng.integers(0, n, 3000)
    e2 = rng.integers(0, n, 3000)
    lab = ttracks.component_max_labels(e1, e2, n, device="cpu")
    ref = jnative.connected_components(e1, e2, n)
    assert ref is not None
    np.testing.assert_array_equal(lab, ref)


@pytest.mark.parametrize("init", ["random", "tree"])
def test_global_positioning_matches_jax(jax_run, init):
    vj, cj, ij, trj = copy.deepcopy(jax_run["tracks"])
    vt, ct, it, trt = _port_state((vj, cj, ij, trj))
    opts = dict(JCFG.GLOBAL_POSITIONER_OPTIONS, init=init)
    saved = {k: os.environ.get(k) for k in ONE_DEVICE}
    os.environ.update(ONE_DEVICE)
    try:
        trj = jgp.global_positioning(cj, ij, trj, opts, view_graph=vj)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
    trt = tgp.global_positioning(ct, it, trt, opts, view_graph=vt,
                                 device="cpu")
    if init == "random":
        np.testing.assert_array_equal(
            ij.tvec, jax_run["global_positioning"][2].tvec)
    assert np.array_equal(it.registered, ij.registered)
    cj_ = ij.centers()[ij.registered]
    extent = np.linalg.norm(cj_.max(0) - cj_.min(0))
    assert np.max(np.abs(it.centers()[it.registered] - cj_)) < 1e-6 * extent
    _assert_same_fields(
        dataclasses.replace(trt, xyz=trj.xyz), trj)
    assert np.max(np.abs(trt.xyz - trj.xyz)) < 1e-6 * extent


@pytest.mark.parametrize("name, arg", [
    ("filter_tracks_by_angle", 1.0),
    ("filter_tracks_by_angle", 0.05),
    ("filter_tracks_by_reprojection_normalized", 1e-2),
    ("filter_tracks_by_reprojection_normalized", 1e-3),
    ("filter_tracks_by_reprojection", 0.3),
    ("filter_tracks_triangulation_angle", 1.0),
    ("filter_tracks_triangulation_angle", 20.0),
])
def test_track_filter_matches_jax(jax_run, name, arg):
    vj, cj, ij, trj = copy.deepcopy(jax_run["global_positioning"])
    vt, ct, it, trt = _port_state((vj, cj, ij, trj))
    out_j = getattr(jtf, name)(cj, ij, trj, arg)
    out_t = getattr(ttf, name)(ct, it, trt, arg)
    _assert_same_fields(out_t, out_j)
    assert 0 < out_j.num_observations <= trj.num_observations


@pytest.mark.parametrize("depths", [None, True])
def test_normalize_reconstruction_matches_jax(jax_run, depths):
    vj, cj, ij, trj = copy.deepcopy(jax_run["global_positioning"])
    if depths:
        rng = np.random.default_rng(1)
        ij.kp_depth = rng.uniform(0.0, 8.0, len(ij.kp_xy)).astype(np.float32)
    vt, ct, it, trt = _port_state((vj, cj, ij, trj))
    jtf.normalize_reconstruction(ij, trj, depths=depths)
    ttf.normalize_reconstruction(it, trt, depths=depths)
    np.testing.assert_allclose(it.tvec, ij.tvec, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(trt.xyz, trj.xyz, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("export_txt", [False, True])
def test_writer_matches_jax(jax_run, tmp_path, export_txt):
    """The same state written by both packages: the same files, byte for
    byte, for the binary (SoA) and the text model."""
    vj, cj, ij, trj = copy.deepcopy(jax_run["global_positioning"])
    trj.color[:] = np.arange(trj.num_tracks * 3).reshape(-1, 3) % 251
    ij.cluster_id[:] = 0
    vt, ct, it, trt = _port_state((vj, cj, ij, trj))
    jwriter.write_reconstruction(str(tmp_path / "j"), cj, ij, trj,
                                 export_txt=export_txt)
    twriter.write_reconstruction(str(tmp_path / "t"), ct, it, trt,
                                 export_txt=export_txt)
    names = (["cameras.txt", "images.txt", "points3D.txt"] if export_txt
             else ["cameras.bin", "images.bin", "points3D.bin"])
    for n in names:
        a, b = tmp_path / "t" / "0" / n, tmp_path / "j" / "0" / n
        assert os.path.getsize(b) > 0
        assert filecmp.cmp(a, b, shallow=False), n
