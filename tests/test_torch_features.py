"""The feature front-end of the port against the JAX package on the CPU
(JAX in x64), on inputs made from a numpy seed:

* SIFT on ``tests/test_features.py``'s blob image (240x320,
  ``max_keypoints=512``, ``num_octaves=3``): the valid keypoint sets agree
  to all but 1% (float32 blurs summed in another order can flip an
  extremum at a threshold); the common keypoints' xy agree exactly, their
  scales to 1e-12 relative, their descriptors to 1e-5 and their
  orientations to 1e-5, except where the orientation histogram's top two
  bins tie (then they differ by whole bins), for at most 1% of them;
* ``match_pair_batch`` on random unit descriptors with masked rows: equal
  matches and counts;
* ``generate_database`` on ``test_features.py``'s three shifted images:
  the same keypoints (exactly), stored descriptors (uint8 of desc * 512,
  within one level: a descriptor that differs by 1e-7 can cross an
  integer) and match rows, read back with each package's reader;
* ``io.image.resize`` against PIL's bilinear resize: within one grey level;
* ``cli.feat`` then ``cli.sfm`` with ``--device cpu`` on a small render of
  ``tests/test_pixels_e2e.py``'s scene: a database and a sparse model.
"""

import os
import sqlite3
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsfm_tpu.features import matching as jmatching
from instantsfm_tpu.features import sift as jsift
from instantsfm_tpu.features.handler import generate_database as jgenerate
from instantsfm_tpu.io.colmap_db import read_colmap_database as jread_db
from instantsfm_tpu_torch.features import matching, sift
from instantsfm_tpu_torch.features.handler import generate_database, load_gray
from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
from instantsfm_tpu_torch.io.image import imwrite, resize
from tests.test_features import _render_blobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIFTS = [(0, 0), (5, 3), (-6, 2)]


def _quiet(*a, **k):
    pass


def _blob_keypoints():
    img, _ = _render_blobs(np.random.default_rng(0))
    jcfg = jsift.SiftConfig(max_keypoints=512, num_octaves=3)
    cfg = sift.SiftConfig(max_keypoints=512, num_octaves=3)
    return jsift.extract(img, jcfg), sift.extract(img, cfg, device="cpu")


def test_sift_matches_jax():
    want, got = _blob_keypoints()
    for a, b in zip(want, got):
        assert a.shape == b.shape
    key = lambda out: {(float(x), float(y), round(float(s), 9)): k
                       for k, ((x, y), s, v) in enumerate(zip(out[0], out[1],
                                                              out[4])) if v}
    kj, kt = key(want), key(got)
    common = sorted(set(kj) & set(kt))
    assert len(kj) > 40
    assert len(set(kj) ^ set(kt)) <= 0.01 * len(kj)
    ij = np.array([kj[c] for c in common])
    it = np.array([kt[c] for c in common])
    np.testing.assert_array_equal(got[0][it], want[0][ij])
    np.testing.assert_allclose(got[1][it], want[1][ij], rtol=1e-12)
    dori = np.abs(got[2][it] - want[2][ij])
    flips = dori > 1e-5
    np.testing.assert_allclose(dori[flips] / (2 * np.pi / 36),
                               np.round(dori[flips] / (2 * np.pi / 36)),
                               atol=1e-4)
    assert flips.sum() <= 0.01 * len(common)
    keep = ~flips
    np.testing.assert_allclose(got[3][it][keep], want[3][ij][keep], atol=1e-5)
    # the descriptors are unit vectors, as test_features.py checks for JAX
    n = np.linalg.norm(got[3][got[4]], axis=-1)
    np.testing.assert_allclose(n[n > 0], 1.0, atol=1e-4)


def test_match_pair_batch_matches_jax():
    """Three pairs of 256 unit descriptors: the second image holds a noisy
    permutation of the first's and random ones; some rows masked, one pair
    wholly masked on one side."""
    rng = np.random.default_rng(1)
    B, K, D = 3, 256, 128
    d1 = rng.standard_normal((B, K, D)).astype(np.float32)
    perm = np.stack([rng.permutation(K) for _ in range(B)])
    d2 = np.take_along_axis(d1, perm[..., None], 1) \
        + 0.3 * rng.standard_normal((B, K, D)).astype(np.float32)
    d2[:, K // 2:] = rng.standard_normal((B, K - K // 2, D))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    v1 = rng.uniform(size=(B, K)) > 0.2
    v2 = rng.uniform(size=(B, K)) > 0.2
    v2[2] = False
    for max_matches in (64, 256):
        mj, cj = jmatching.match_pair_batch(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
            0.9, max_matches)
        mt, ct = matching.match_pair_batch(
            torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(v1),
            torch.as_tensor(v2), 0.9, max_matches)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert ct[0] > 20 and ct[2] == 0


@pytest.fixture(scope="module")
def shifted_images(tmp_path_factory):
    """``test_features.py``'s three shifted blob images as PNG files."""
    root = tmp_path_factory.mktemp("feat")
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    base, _ = _render_blobs(np.random.default_rng(0), n=80)
    for i, sh in enumerate(SHIFTS):
        img = np.roll(np.roll(base, sh[1], axis=0), sh[0], axis=1)
        imwrite(os.path.join(img_dir, f"im{i}.png"),
                (img * 255).astype(np.uint8))
    return str(root)


def _tables(dbpath):
    with sqlite3.connect(dbpath) as conn:
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in ("cameras", "images", "keypoints", "descriptors",
                          "matches", "two_view_geometries", "feature_name")}


def test_generate_database_matches_jax(shifted_images, tmp_path):
    img_dir = os.path.join(shifted_images, "images")
    dbs = {}
    for pkg, fn in (("jax", jgenerate), ("port", generate_database)):
        dbs[pkg] = str(tmp_path / f"{pkg}.db")
        kw = dict(device="cpu") if pkg == "port" else {}
        fn(img_dir, dbs[pkg], max_image_size=512, max_keypoints=512,
           min_num_matches=10, log=_quiet, **kw)
    tj, tt = _tables(dbs["jax"]), _tables(dbs["port"])
    for t in ("cameras", "images", "keypoints", "matches",
              "two_view_geometries", "feature_name"):
        assert tt[t] == tj[t], t
    for rj, rt in zip(tj["descriptors"], tt["descriptors"], strict=True):
        assert rt[:3] == rj[:3]
        a = np.frombuffer(rt[3], np.uint8).astype(int)
        b = np.frombuffer(rj[3], np.uint8).astype(int)
        assert np.abs(a - b).max() <= 1 and np.mean(a != b) < 1e-3
    vg_j, _, im_j, name_j = jread_db(dbs["jax"])
    vg_t, _, im_t, name_t = read_colmap_database(dbs["port"])
    assert name_t == name_j == "sift_tpu"
    assert im_t.num_images == im_j.num_images == 3
    np.testing.assert_array_equal(im_t.kp_xy, im_j.kp_xy)
    assert vg_t.num_pairs == vg_j.num_pairs >= 2
    for e in range(vg_t.num_pairs):
        np.testing.assert_array_equal(vg_t.pair_matches(e),
                                      vg_j.pair_matches(e))
    # each package reads the other's database
    assert read_colmap_database(dbs["jax"])[2].num_images == 3
    assert jread_db(dbs["port"])[2].num_images == 3


@pytest.mark.parametrize("name", ["superpoint", "disk+lightglue", "dedode"])
def test_learned_front_ends_raise(shifted_images, tmp_path, name):
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        generate_database(os.path.join(shifted_images, "images"),
                          str(tmp_path / "x.db"), feature_name=name,
                          device="cpu")


def test_resize_matches_pil(shifted_images):
    from PIL import Image

    rng = np.random.default_rng(2)
    for shape, size in (((360, 480), (300, 400)), ((240, 320, 3), (90, 120)),
                        ((480, 640), (171, 228))):
        img = (rng.uniform(0, 1, shape) * 255).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize(size[::-1],
                                                      Image.BILINEAR))
        got = resize(img, *size)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= 1
    # load_gray shrinks past max_image_size by the same resize
    path = os.path.join(shifted_images, "images", "im0.png")
    img, scale, (w, h) = load_gray(path, 160)
    assert (w, h) == (320, 240) and scale == 0.5 and img.shape == (120, 160)


def test_cli_feat_then_sfm_on_cpu(tmp_path):
    """``python -m instantsfm_tpu_torch.cli.feat`` then ``cli.sfm``, both
    with ``--device cpu``, on ``tests/test_pixels_e2e.py``'s scene rendered
    by the port (``chip_smoke.render_plane_scene``: 16 views, here at
    240x180): a database of the 16 images, then a sparse model of at least
    15 with more than 100 points; a second ``cli.feat`` leaves the database
    as it is.  (The three shifted images above are one image translated,
    which no relative pose explains: on them the mapper's pairs fall below
    its inlier bars.)"""
    import chip_smoke

    scene = tmp_path / "scene"
    chip_smoke.render_plane_scene(str(scene), "cpu", W=240, H=180, f=200.0)
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = lambda mod, *extra: subprocess.run(
        [sys.executable, "-m", f"instantsfm_tpu_torch.cli.{mod}",
         "--data_path", str(scene), "--device", "cpu", *extra],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    proc = run("feat", "--max_keypoints", "3000", "--match_ratio", "0.9")
    assert proc.returncode == 0, proc.stderr[-2000:]
    db = scene / "database.db"
    stamp = os.path.getmtime(db)
    _, _, images, name = read_colmap_database(str(db))
    assert name == "sift_tpu" and images.num_images == 16
    proc = run("feat")
    assert proc.returncode == 0 and "already exists" in proc.stdout
    assert os.path.getmtime(db) == stamp
    proc = run("sfm")
    assert proc.returncode == 0, proc.stderr[-2000:]
    cams, imgs, pts = cmio.read_model(str(scene / "sparse" / "0"))
    assert len(cams) == 1 and len(imgs) >= 15 and len(pts) > 100
