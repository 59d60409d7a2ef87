"""The port's multi-process paths (``instantsfm_tpu_torch/parallel/
multihost.py``) against one process.

One gloo group of two CPU processes (``tests/torch_dist.py``, a module
fixture), formed through ``ISFM_COORDINATOR`` / ``ISFM_NUM_PROCESSES`` /
``ISFM_PROCESS_ID``, runs the host exchanges, relative pose (chunks of 8
pairs, owned by rank k mod 2, then exchanged), ``generate_database`` (each
rank extracts and matches a strided slice, rank 0 writes) and the global
mapper on ``chip_smoke.write_ring_db``'s 14-image ring (float64).  This
process runs each once more alone.

Relative pose must match one process as ``tests/test_multihost.py`` holds
JAX: masks equal, poses within 1e-12; the database must hold the same
keypoints, descriptors and matches.  The mapper registers the same images
with the same tracks; its poses and points agree within 1e-6 of the scene
extent (quaternions within 1e-6 up to sign): alone, global positioning
and bundle adjustment take the dense Schur solve at this size, and over
two ranks matrix-free PCG, each to the LM's own tolerances.
"""

import os

import numpy as np
import pytest

import chip_smoke
from instantsfm_tpu_torch.config import Config
from instantsfm_tpu_torch.features.handler import generate_database
from instantsfm_tpu_torch.features.matching import match_all_pairs
from instantsfm_tpu_torch.io.colmap_db import (ColmapDatabase,
                                               read_colmap_database)
from instantsfm_tpu_torch.parallel import multihost
from instantsfm_tpu_torch.pipeline import preprocess, relpose
from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper
from tests.torch_cpu import lean_cpu  # noqa: F401  (module fixture)
from tests.torch_dist import run_group


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    db = str(root / "ring.db")
    chip_smoke.write_ring_db(db, num_cams=14, num_pts=600, window=6)
    chip_smoke.render_plane_scene(str(root), "cpu", n_cams=8, W=240, H=180,
                                  f=200.0)
    rng = np.random.default_rng(0)
    desc = rng.standard_normal((6, 64, 32)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    valid = rng.uniform(size=(6, 64)) < 0.9
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    return dict(root=str(root), relpose_db=db, mapper_db=db,
                images=str(root / "images"),
                descriptors=(desc, valid, pairs))


@pytest.fixture(scope="module")
def group(scene, tmp_path_factory):
    """Both ranks' results, from one group of two."""
    tmp = str(tmp_path_factory.mktemp("multihost_group"))
    r0, r1 = run_group(2, "multihost", scene, tmp)
    return dict(ranks=(r0, r1), db=os.path.join(tmp, "database.db"))


def _relpose(db):
    vg, cams, imgs, _ = read_colmap_database(db)
    preprocess.update_image_pairs_config(vg, cams, imgs)
    preprocess.decompose_relpose(vg, cams, imgs)
    relpose.undistort_images(cams, imgs, device="cpu")
    relpose.estimate_relative_pose(vg, cams, imgs, chunk_pairs=8,
                                   device="cpu")
    return vg


def test_initialize_through_isfm_environment(group):
    """``initialize`` read ``ISFM_*``: two ranks, ids 0 and 1; a second
    call in the group changes nothing and reports several processes.
    Without any of it, a process forms no group."""
    r0, r1 = group["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["count"] == r1["count"] == 2
    assert r0["again"] and r1["again"]
    for k in ("ISFM_COORDINATOR", "MASTER_ADDR"):
        assert k not in os.environ
    assert multihost.initialize(device="cpu") is False
    assert multihost.process_count() == 1


def test_host_exchanges_keep_every_byte(group):
    """``allgather_host_arrays`` returns each rank's array bit for bit
    (int64 past 2**32, bool, uint8, float64), and ``gather_pair_results``
    reassembles strided slices in order."""
    for r in group["ranks"]:
        for rank in (0, 1):
            want = {"i64": np.arange(5, dtype=np.int64) * (2 ** 40 + rank),
                    "bool": np.arange(7) % (rank + 2) == 0,
                    "u8": np.full((2, 3), 250 + rank, np.uint8),
                    "f64": np.full(4, np.pi * (rank + 1))}
            for k, v in want.items():
                got = r["allgather"][k][rank]
                assert got.dtype == v.dtype
                np.testing.assert_array_equal(got, v)
        np.testing.assert_array_equal(
            r["gathered"], np.arange(11)[:, None] * 10 + np.arange(3))


def test_match_pairs_distributed_matches_one_process(group, scene):
    desc, valid, pairs = scene["descriptors"]
    want = match_all_pairs(list(desc), list(valid), ratio=0.95,
                           max_matches=64, pairs=pairs, device="cpu")
    for r in group["ranks"]:
        assert set(r["matches"]) == set(want)
        for k in pairs:
            np.testing.assert_array_equal(r["matches"][k], want[k])


def test_relpose_two_processes_match_one(group, scene):
    """Each chunk's draws are keyed by the chunk, so the owner's estimates
    equal one process's; every rank ends with the whole view graph."""
    vg = _relpose(scene["relpose_db"])
    assert vg.valid.sum() >= 30
    for r in group["ranks"]:
        got = r["relpose"]
        np.testing.assert_array_equal(got["valid"], vg.valid)
        np.testing.assert_array_equal(got["inlier_mask"], vg.inlier_mask)
        for k, want in (("qvec", vg.qvec), ("tvec", vg.tvec), ("E", vg.E_mat),
                        ("F", vg.F_mat), ("H", vg.H_mat)):
            np.testing.assert_allclose(got[k], want, atol=1e-12, rtol=0)


def _db_rows(path):
    with ColmapDatabase.connect(path) as db:
        return {t: db.conn.execute(f"SELECT * FROM {t}").fetchall() for t in
                ("cameras", "images", "keypoints", "descriptors", "matches",
                 "two_view_geometries")}


def test_generate_database_two_processes_match_one(group, scene, tmp_path):
    """Rank 0 writes the database the single process writes, row for row;
    rank 1 writes nothing and returns None."""
    r0, r1 = group["ranks"]
    assert r1["database"] is None
    want = generate_database(scene["images"], str(tmp_path / "database.db"),
                             max_keypoints=512, log=lambda *a: None,
                             device="cpu")
    assert r0["database"]["verified_pairs"] == want["verified_pairs"] > 5
    for k in ("images", "pairs", "keypoints", "matches", "verified_matches"):
        assert r0["database"][k] == want[k], k
    got_rows = _db_rows(group["db"])
    for table, rows in _db_rows(str(tmp_path / "database.db")).items():
        assert got_rows[table] == rows, table


def test_mapper_two_processes_match_one(group, scene):
    vg, cams, imgs, name = read_colmap_database(scene["mapper_db"])
    _, imgs, tracks, _ = solve_global_mapper(vg, cams, imgs, Config(name),
                                             log=lambda *a: None,
                                             device="cpu")
    assert imgs.registered.sum() == 14
    extent = np.linalg.norm(imgs.centers().max(0) - imgs.centers().min(0))
    for r in group["ranks"]:
        got = r["mapper"]
        np.testing.assert_array_equal(got["registered"], imgs.registered)
        np.testing.assert_array_equal(got["obs_image"], tracks.obs_image)
        dq = np.minimum(np.abs(got["qvec"] - imgs.qvec).max(1),
                        np.abs(got["qvec"] + imgs.qvec).max(1))
        assert dq.max() < 1e-6, dq.max()
        c = -np.einsum("nji,nj->ni", _rot(got["qvec"]), got["tvec"])
        assert np.abs(c - imgs.centers()).max() < 1e-6 * extent
        assert np.abs(got["xyz"] - tracks.xyz).max() < 1e-6 * extent


def _rot(q):
    from instantsfm_tpu_torch.math import lie
    return lie.quat_to_matrix_np(q)
