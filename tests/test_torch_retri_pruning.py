"""Retriangulation and pruning in the port against the JAX package on the
CPU (JAX in x64, the port in float64), each case on inputs made from a
numpy seed:

* ``complete_tracks`` and ``prune_weakly_connected_images`` on
  ``tests/test_retri_pruning.py``'s two cases: equal tracks (element for
  element) and equal ``cluster_id``;
* the whole mapper with both stages on (``skip_retriangulation`` and
  ``skip_pruning`` False) on ``tests/test_e2e_extras.py``'s 12-image scene,
  the port fed the RANSAC uniforms JAX draws
  (``tests/test_torch_relpose.py::jax_uniforms``): the same registered
  images, equal ``cluster_id``, equal track counts and observations, poses
  within 1e-8 (quaternions up to sign; centers relative to the scene
  extent), points within 1e-8 of the extent; and the port must meet
  ``test_e2e_extras.py``'s bars against the ground truth.  Both runs take
  about 25 s on the CPU; they run once, in a module fixture.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from instantsfm_tpu.config import Config as JConfig
from instantsfm_tpu.eval.align import (absolute_translation_errors,
                                       rotation_angles_deg)
from instantsfm_tpu.io.colmap_db import read_colmap_database as jread_db
from instantsfm_tpu.math import lie as jlie
from instantsfm_tpu.pipeline import pruning as jpruning
from instantsfm_tpu.pipeline import retriangulation as jretri
from instantsfm_tpu.pipeline.mapper import solve_global_mapper as jmapper
from instantsfm_tpu.scene.types import Images, Tracks
from instantsfm_tpu_torch.config import Config
from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
from instantsfm_tpu_torch.pipeline import pruning, retriangulation
from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper
from instantsfm_tpu_torch.utils import debug
from tests.synthetic import make_scene
from tests.test_e2e import _write_synthetic_db
from tests.test_retri_pruning import TRI_OPTS, _scene_to_types
from tests.test_torch_mapper_stages import to_port
from tests.test_torch_relpose import jax_uniforms

ONE_DEVICE = {"ISFM_NO_SHARD": "1", "ISFM_RELPOSE_ONE_DEVICE": "1"}
STAGES = ["preprocessing", "view_graph_calibration",
          "relative_pose_estimation", "rotation_averaging",
          "track_establishment", "global_positioning", "bundle_adjustment",
          "retriangulation", "pruning"]


def _quiet(*a, **k):
    pass


def _tracks_equal(a, b):
    for name in ("obs_image", "obs_feature", "obs_offset", "track_id"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    np.testing.assert_array_equal(a.xyz, b.xyz)


def test_complete_tracks_matches_jax(rng):
    """40% of the observations dropped: both packages restore every one
    (ground-truth poses and points) and rebuild the same CSR; and after
    perturbing the points by 2 px-scale noise, both keep the same ones."""
    scene = make_scene(num_cams=8, num_pts=60, params=[500.0, 320, 240, 0.0])
    cameras, images, tracks_full = _scene_to_types(scene)
    keep = rng.uniform(size=tracks_full.num_observations) > 0.4
    tracks = tracks_full.filter_observations(keep)
    for noise in (0.0, 0.02):
        moved = tracks.filter_observations(
            np.ones(tracks.num_observations, bool))
        moved.xyz = tracks.xyz + noise * rng.standard_normal(tracks.xyz.shape)
        want, n_want = jretri.complete_tracks(cameras, images, moved,
                                              tracks_full, TRI_OPTS)
        got, n_got = retriangulation.complete_tracks(
            to_port(cameras), to_port(images), to_port(moved),
            to_port(tracks_full), TRI_OPTS, device="cpu")
        assert n_got == n_want
        _tracks_equal(got, want)
        if noise == 0.0:
            assert got.num_observations == tracks_full.num_observations
        else:
            assert 0 < got.num_observations < tracks_full.num_observations


def test_pruning_matches_jax(rng):
    """``test_retri_pruning.py``'s two weakly joined camera groups, and the
    same with the groups bridged by 300 tracks seen from both (one cluster)."""
    n_cams = 12
    for bridge in (0, 300):
        obs_image, obs_track = [], []
        n_pts = 400 + bridge
        for t in range(n_pts):
            if t < 400:
                cams = (0 if t < 200 else 6) + rng.choice(6, 4, replace=False)
            else:
                cams = np.array([rng.integers(0, 6), rng.integers(6, 12),
                                 rng.integers(0, 6), rng.integers(6, 12)])
                cams = np.unique(cams)
            obs_image.append(cams)
            obs_track.append(np.full(len(cams), t))
        obs_image = np.concatenate(obs_image).astype(np.int32)
        obs_track = np.concatenate(obs_track)
        offset = np.zeros(n_pts + 1, np.int64)
        np.cumsum(np.bincount(obs_track, minlength=n_pts), out=offset[1:])
        images = Images(cam_idx=np.zeros(n_cams, np.int32),
                        names=[str(i) for i in range(n_cams)],
                        qvec=np.tile([0., 0, 0, 1], (n_cams, 1)),
                        tvec=np.zeros((n_cams, 3)),
                        registered=np.ones(n_cams, bool),
                        cluster_id=np.full(n_cams, -1, np.int32),
                        kp_xy=np.zeros((0, 2)),
                        kp_offset=np.zeros(n_cams + 1, np.int64))
        tracks = Tracks(xyz=np.zeros((n_pts, 3)),
                        color=np.zeros((n_pts, 3), np.uint8),
                        obs_image=obs_image,
                        obs_feature=np.zeros(len(obs_image), np.int32),
                        obs_offset=offset,
                        track_id=np.arange(n_pts, dtype=np.int64))
        port_images = to_port(images)
        n_port = pruning.prune_weakly_connected_images(
            port_images, to_port(tracks), log=_quiet)
        n_jax = jpruning.prune_weakly_connected_images(images, tracks,
                                                       log=_quiet)
        assert n_port == n_jax == (2 if bridge == 0 else 1)
        np.testing.assert_array_equal(port_images.cluster_id,
                                      images.cluster_id)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``test_e2e_extras.py``'s scene through both mappers with both stages
    on: (cameras, images, tracks, timings) each, the scene, and the port's
    run counters."""
    root = tmp_path_factory.mktemp("retri")
    scene = make_scene(num_cams=12, num_pts=180, params=[500.0, 320, 240, 0.0],
                       seed=5, vis_prob=0.85)
    dbpath = os.path.join(root, "database.db")
    _write_synthetic_db(scene, dbpath, np.random.default_rng(0))
    saved = {k: os.environ.get(k) for k in ONE_DEVICE}
    os.environ.update(ONE_DEVICE)
    try:
        vg, cams, imgs, name = jread_db(dbpath)
        cfg = JConfig(name)
        cfg.OPTIONS.update(skip_retriangulation=False, skip_pruning=False)
        jax_out = jmapper(vg, cams, imgs, cfg, dtype=jnp.float64, log=_quiet)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
    vg, cams, imgs, name = read_colmap_database(dbpath)
    cfg = Config(name)
    cfg.OPTIONS.update(skip_retriangulation=False, skip_pruning=False)
    hooked = []
    debug.drain_stats()
    port_out = solve_global_mapper(
        vg, cams, imgs, cfg, log=_quiet, device="cpu",
        stage_hook=lambda stage, *a: hooked.append(stage),
        ransac_uniforms=jax_uniforms(0))
    return dict(scene=scene, jax=jax_out, port=port_out, hooked=hooked,
                stats=debug.drain_stats())


def test_mapper_with_retriangulation_and_pruning_matches_jax(runs):
    cj, ij, tj, timings_j = runs["jax"]
    ct, it, tt, timings_t = runs["port"]
    assert list(timings_t) == STAGES == list(timings_j)
    assert runs["hooked"][-2:] == ["retriangulation", "pruning"]
    assert runs["stats"]["retri_changed_share"]
    np.testing.assert_array_equal(it.registered, ij.registered)
    np.testing.assert_array_equal(it.cluster_id, ij.cluster_id)
    assert tt.num_tracks == tj.num_tracks
    np.testing.assert_array_equal(tt.obs_image, tj.obs_image)
    np.testing.assert_array_equal(tt.obs_feature, tj.obs_feature)
    dq = np.minimum(np.abs(it.qvec - ij.qvec).max(1),
                    np.abs(it.qvec + ij.qvec).max(1))
    assert np.max(dq) < 1e-8
    extent = np.linalg.norm(ij.centers().max(0) - ij.centers().min(0))
    assert np.max(np.abs(it.centers() - ij.centers())) < 1e-8 * extent
    assert np.max(np.abs(tt.xyz - tj.xyz)) < 1e-8 * extent


def test_mapper_with_retriangulation_and_pruning_meets_ground_truth(runs):
    """``test_e2e_extras.py``'s bars."""
    _, images, tracks, _ = runs["port"]
    scene = runs["scene"]
    est_R = np.asarray(jlie.quat_to_matrix(jnp.asarray(images.qvec)))
    gt_R = np.asarray(jlie.quat_to_matrix(jnp.asarray(scene.qvec)))
    gt_C = np.asarray(jlie.camera_center(jnp.asarray(scene.qvec),
                                         jnp.asarray(scene.tvec)))
    ate = absolute_translation_errors(images.centers(), gt_C)
    extent = np.linalg.norm(gt_C.max(0) - gt_C.min(0))
    assert np.max(rotation_angles_deg(est_R, gt_R)) < 1.0
    assert np.max(ate / extent) < 0.01
    assert tracks.num_tracks > 80
    assert (images.cluster_id >= 0).sum() >= 10
