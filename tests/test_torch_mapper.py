"""Whole-slice parity: COLMAP database -> ``solve_global_mapper`` -> sparse
model in the port against the JAX package, on ``tests/test_e2e.py``'s scene
(14 images, 220 points), both in float64 on the CPU, the port fed the RANSAC
uniforms JAX draws.

Tolerances: the same registered images and the same track count; poses and
points within 1e-6 (quaternions up to sign, centers and points relative to
the scene extent), intrinsics within 1e-6 relative or 1e-9 absolute (the
radial k1, 1.7e-3, differs by 5e-11).  The whole runs differ by 1.4e-9 in rotation, 4e-9 in
translation and 4e-9 in points (measured): one relative pose whose RANSAC
winner sits at a near-double root of the 5-point polynomial differs by
1.7e-6 (``tests/test_torch_relpose.py``), which rotation averaging spreads
to 1.3e-7 and global positioning and bundle adjustment shrink.  Both runs
must also meet ``tests/test_e2e.py``'s bars against the ground truth:
rotation error < 1 degree and ATE < 1% of the extent after similarity
alignment.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsfm_tpu.config import Config as JConfig
from instantsfm_tpu.eval.align import (absolute_translation_errors,
                                       rotation_angles_deg)
from instantsfm_tpu.io.colmap_db import read_colmap_database as jread_db
from instantsfm_tpu.math import lie as jlie
from instantsfm_tpu.pipeline.mapper import solve_global_mapper as jmapper
from instantsfm_tpu_torch.config import Config
from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
from instantsfm_tpu_torch.pipeline import positioning as tgp
from instantsfm_tpu_torch.pipeline import relpose as trp
from instantsfm_tpu_torch.pipeline import rotation_averaging as tra
from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper
from instantsfm_tpu_torch.pipeline.writer import write_reconstruction
from instantsfm_tpu_torch.solve import schur_wchain as k1
from tests.test_torch_relpose import jax_uniforms, write_e2e_db

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_DEVICE = {"ISFM_NO_SHARD": "1", "ISFM_RELPOSE_ONE_DEVICE": "1"}
STAGES = ["preprocessing", "view_graph_calibration",
          "relative_pose_estimation", "rotation_averaging",
          "track_establishment", "global_positioning", "bundle_adjustment"]


def _quiet(*a, **k):
    pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The database, its ground truth, and the JAX and port mapper runs
    (each: cameras, images, tracks, timings, stage names hooked)."""
    root = tmp_path_factory.mktemp("mapper")
    dbpath, scene = write_e2e_db(str(root))
    saved = {k: os.environ.get(k) for k in ONE_DEVICE}
    os.environ.update(ONE_DEVICE)
    try:
        vg, cams, imgs, name = jread_db(dbpath)
        jax_out = jmapper(vg, cams, imgs, JConfig(name), log=_quiet)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
    hooked = []
    launches = k1.schur_wchain.launches
    vg, cams, imgs, name = read_colmap_database(dbpath)
    port_out = solve_global_mapper(
        vg, cams, imgs, Config(name), log=_quiet, device="cpu",
        stage_hook=lambda stage, *a: hooked.append(stage),
        ransac_uniforms=jax_uniforms(0))
    return dict(db=dbpath, root=root, scene=scene, jax=jax_out,
                port=port_out, hooked=hooked,
                k1_launches=k1.schur_wchain.launches - launches)


def _gt_errors(qvec, tvec, scene):
    """(rotation errors in degrees, ATE / extent) after alignment, for
    world->cam poses (xyzw qvec, tvec)."""
    est_R = np.asarray(jlie.quat_to_matrix(jnp.asarray(qvec)))
    gt_R = np.asarray(jlie.quat_to_matrix(jnp.asarray(scene.qvec)))
    center = lambda q, t: np.asarray(jlie.camera_center(jnp.asarray(q),
                                                        jnp.asarray(t)))
    gt_C = center(scene.qvec, scene.tvec)
    ate = absolute_translation_errors(center(qvec, tvec), gt_C)
    return (rotation_angles_deg(est_R, gt_R),
            ate / np.linalg.norm(gt_C.max(0) - gt_C.min(0)))


def test_mapper_matches_jax(runs):
    cj, ij, tj, timings_j = runs["jax"]
    ct, it, tt, timings_t = runs["port"]
    assert list(timings_t) == STAGES == list(timings_j)
    assert runs["hooked"] == ["relpose", "rotation_averaging",
                              "global_positioning", "bundle_adjustment"]
    assert it.registered.sum() == 14
    assert np.array_equal(it.registered, ij.registered)
    assert tt.num_tracks == tj.num_tracks > 100
    assert np.array_equal(tt.obs_image, tj.obs_image)
    assert np.array_equal(tt.obs_feature, tj.obs_feature)
    dq = np.minimum(np.abs(it.qvec - ij.qvec).max(1),
                    np.abs(it.qvec + ij.qvec).max(1))
    assert np.max(dq) < 1e-6
    extent = np.linalg.norm(ij.centers().max(0) - ij.centers().min(0))
    assert np.max(np.abs(it.centers() - ij.centers())) < 1e-6 * extent
    assert np.max(np.abs(tt.xyz - tj.xyz)) < 1e-6 * extent
    np.testing.assert_allclose(ct.params, cj.params, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_mapper_meets_ground_truth(runs, pkg):
    _, images, _, _ = runs[pkg]
    rot, ate = _gt_errors(images.qvec, images.tvec, runs["scene"])
    assert np.max(rot) < 1.0, rot
    assert np.max(ate) < 0.01, ate


def test_sparse_model_round_trips(runs, tmp_path):
    cameras, images, tracks, _ = runs["port"]
    out = str(tmp_path / "sparse")
    write_reconstruction(out, cameras, images, tracks)
    cams_m, imgs_m, pts_m = cmio.read_model(os.path.join(out, "0"))
    assert len(cams_m) == 1 and len(imgs_m) == 14
    assert len(pts_m) == tracks.num_tracks
    for i, img in imgs_m.items():
        q = images.qvec[i]
        assert np.allclose(img.qvec_wxyz, [q[3], q[0], q[1], q[2]])
        assert np.allclose(img.tvec, images.tvec[i])


def test_cli_sfm_on_cpu(runs, tmp_path):
    """``python -m instantsfm_tpu_torch.cli.sfm --device cpu`` on the same
    database (its own seeded RANSAC draws): a sparse model of every image
    within the ground-truth bars."""
    scene_dir = tmp_path / "scene"
    scene_dir.mkdir()
    os.symlink(runs["db"], scene_dir / "database.db")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "instantsfm_tpu_torch.cli.sfm",
         "--data_path", str(scene_dir), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    cams_m, imgs_m, pts_m = cmio.read_model(str(scene_dir / "sparse" / "0"))
    assert len(imgs_m) == 14 and len(pts_m) > 100
    ids = sorted(imgs_m)
    qvec = np.array([np.roll(imgs_m[i].qvec_wxyz, -1) for i in ids])
    tvec = np.array([imgs_m[i].tvec for i in ids])
    rot, ate = _gt_errors(qvec, tvec, runs["scene"])
    assert np.max(rot) < 1.0 and np.max(ate) < 0.01


def test_entry_points_refuse_unported_options(runs):
    vg, cams, imgs, name = read_colmap_database(runs["db"])
    from instantsfm_tpu_torch.cli import sfm as cli
    if not torch.cuda.is_available():
        cfg = Config(name)
        for call in (
                lambda: solve_global_mapper(vg, cams, imgs, cfg, log=_quiet),
                lambda: trp.estimate_relative_pose(vg, cams, imgs),
                lambda: tra.estimate_rotations(vg, imgs,
                                               cfg.ROTATION_ESTIMATOR_OPTIONS,
                                               cfg.L1_SOLVER_OPTIONS),
                lambda: tgp.global_positioning(cams, imgs, runs["port"][2],
                                               cfg.GLOBAL_POSITIONER_OPTIONS),
                lambda: cli.main(["--data_path", str(runs["root"])]),
                # the recorder's options are taken and reach the device check
                lambda: cli.main(["--data_path", str(runs["root"]),
                                  "--enable_gui", "--record_recon"])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def test_k1_counts_only_card_launches(runs):
    """On the CPU the mapper's GP and BA run K1's plain version: the launch
    counter, which counts kernel launches only, does not move."""
    assert runs["k1_launches"] == 0


class _Solved(Exception):
    pass


@pytest.mark.parametrize("device,f32,want", [
    ("cpu", False, torch.float64), ("cpu", True, torch.float32),
    ("cuda", False, torch.float32), ("cuda", True, torch.float32)])
def test_cli_sfm_precision(runs, monkeypatch, device, f32, want):
    """``cli.sfm`` solves in float64 only on the CPU without ``--f32``, as
    the JAX package's CLI does on its CPU backend; on the card it solves in
    float32.  The mapper is replaced by a stub that records its dtype, and
    the device check by one that accepts ``cuda``, so no card is needed."""
    from instantsfm_tpu_torch.cli import sfm as cli

    def solve(*args, dtype, device, **kw):
        raise _Solved(dtype, device)

    monkeypatch.setattr("instantsfm_tpu_torch.pipeline.mapper."
                        "solve_global_mapper", solve)
    monkeypatch.setattr("instantsfm_tpu_torch.utils.device.resolve_device",
                        torch.device)
    argv = ["--data_path", str(runs["root"]), "--device", device]
    with pytest.raises(_Solved) as got:
        cli.main(argv + ["--f32"] * f32)
    assert got.value.args == (want, torch.device(device))
