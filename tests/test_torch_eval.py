"""The port's ``eval`` package against the JAX package's on the CPU.

Small seeded scenes: ``align``'s functions in float64 (20 cameras, a pair
sample below N(N-1)) within 1e-10 and ``auc`` exactly; ``evaluate_scene``
through ``evaluate_dataset`` on the ETH3D layout and the T&T MVSNet layout
(``tests/test_eval_harness.py``'s scene writers, with a perturbed estimate)
within 1e-10 per field; the reports' CSV bytes and their diff equal; the
chamfer distances within 1e-6 relative; the downloader gated in both with
``urllib.request.urlopen`` made to raise, so nothing reaches the network."""

import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

from instantsfm_tpu.eval import align as jax_align
from instantsfm_tpu.eval import benchmark as jax_bench
from instantsfm_tpu.eval import chamfer as jax_chamfer
from instantsfm_tpu.eval import download as jax_download
from instantsfm_tpu_torch.eval import align, benchmark, chamfer, download
from tests.test_eval_harness import _ring_poses, _write_model_dir

TOL = 1e-10


def _close(a, b, tol=TOL):
    """Nested dicts of floats equal within ``tol`` (inf equal to inf)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, float) and np.isinf(a):
        assert a == b
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def poses():
    """20 ring cameras, an estimate perturbed by 0.5 degree and 0.02 units,
    one image unregistered."""
    rng = np.random.default_rng(0)
    q, t = _ring_poses(20)
    dq = R.from_rotvec(np.deg2rad(0.5) * rng.standard_normal((20, 3)))
    q_est = (dq * R.from_quat(q)).as_quat()
    t_est = t + 0.02 * rng.standard_normal(t.shape)
    registered = np.ones(20, bool)
    registered[7] = False
    return q, t, q_est, t_est, registered


def test_align_matches_jax(poses):
    q, t, q_est, t_est, registered = poses
    R_est, R_gt = R.from_quat(q_est).as_matrix(), R.from_quat(q).as_matrix()
    C_est = np.einsum("nji,nj->ni", R_est, -t_est)
    C_gt = np.einsum("nji,nj->ni", R_gt, -t)
    for a, b in zip(align.umeyama(C_est, C_gt), jax_align.umeyama(C_est, C_gt)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        align.absolute_translation_errors(C_est, C_gt),
        jax_align.absolute_translation_errors(C_est, C_gt), rtol=0, atol=TOL)
    np.testing.assert_allclose(align.rotation_angles_deg(R_est, R_gt),
                               jax_align.rotation_angles_deg(R_est, R_gt),
                               rtol=0, atol=TOL)
    # 380 ordered pairs, 200 of them sampled: the sample is the same
    kw = dict(max_pairs=200, seed=3, min_proj_center_dist=0.01)
    err = align.relative_pose_errors_deg(q_est, t_est, q, t, registered,
                                         device="cpu", **kw)
    want = jax_align.relative_pose_errors_deg(q_est, t_est, q, t, registered,
                                              **kw)
    assert err.shape == want.shape == (200,)
    assert np.array_equal(np.isinf(err), np.isinf(want)) and np.isinf(err).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(err[fin], want[fin], rtol=0, atol=TOL)
    for th, me in (((1.0, 3.0, 5.0, 10.0), 0.0), ((0.02, 0.5), 0.01)):
        # the same function: equal on the same errors
        assert align.auc(want, th, me) == jax_align.auc(want, th, me)
        np.testing.assert_allclose(align.auc(err, th, me),
                                   jax_align.auc(want, th, me), rtol=0,
                                   atol=TOL)
    assert align.REFERENCE_AUC_SCALE == jax_align.REFERENCE_AUC_SCALE


def test_relative_pose_errors_refuse_missing_card(poses):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        align.relative_pose_errors_deg(*poses)


def _eth3d(root, q, t, q_est, t_est):
    names = [f"im{i}.jpg" for i in range(len(q))]
    scene = os.path.join(root, "eth3d", "dslr", "courtyard")
    os.makedirs(os.path.join(scene, "images"))
    _write_model_dir(os.path.join(scene, "dslr_calibration_undistorted"),
                     q, t, names)
    _write_model_dir(os.path.join(scene, "sparse", "0"), q_est[:-2],
                     t_est[:-2], names[:-2])
    _write_model_dir(os.path.join(scene, "sparse_glomap", "0"), q, t, names)


def _tt(root, q, t, q_est, t_est):
    from PIL import Image
    scene = os.path.join(root, "tt", "training", "Barn")
    os.makedirs(os.path.join(scene, "images"))
    os.makedirs(os.path.join(scene, "cams_1"))
    for i in range(len(q)):
        name = f"{i:08d}"
        Image.fromarray(np.zeros((48, 64), np.uint8)).save(
            os.path.join(scene, "images", name + ".jpg"))
        ext = np.eye(4)
        ext[:3, :3] = R.from_quat(q[i]).as_matrix()
        ext[:3, 3] = t[i]
        K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
        lines = ["extrinsic"]
        lines += [" ".join(f"{v:.17g}" for v in row) for row in ext]
        lines += ["", "intrinsic"]
        lines += [" ".join(f"{v:.17g}" for v in row) for row in K]
        lines += ["", "0 0"]
        with open(os.path.join(scene, "cams_1", name + "_cam.txt"), "w") as f:
            f.write("\n".join(lines))
    _write_model_dir(os.path.join(scene, "sparse", "0"), q_est, t_est,
                     [f"{i:08d}.jpg" for i in range(len(q))])


@pytest.fixture(scope="module")
def reports(tmp_path_factory, poses):
    """Both packages' ``evaluate_dataset`` on their own copy of an ETH3D and
    a T&T directory (T&T's ``sparse_gt`` is built by each package), and
    each package's report."""
    q, t, q_est, t_est, _ = poses
    base = tmp_path_factory.mktemp("eval")
    out = {}
    for pkg, bench in (("jax", jax_bench), ("port", benchmark)):
        root = str(base / pkg)
        _eth3d(root, q[:8], t[:8], q_est[:8], t_est[:8])
        _tt(root, q[8:14], t[8:14], q_est[8:14], t_est[8:14])
        kw = {} if pkg == "jax" else dict(device="cpu")
        res = {}
        for ds in ("eth3d", "tt"):
            res.update(bench.evaluate_dataset(root, ds, log=lambda *a: None,
                                              **kw))
        csv = os.path.join(root, "report.csv")
        bench.write_report(res, csv, log=lambda *a: None)
        out[pkg] = dict(root=root, results=res, csv=csv)
    return out


def test_evaluate_scene_matches_jax(reports):
    a, b = reports["port"]["results"], reports["jax"]["results"]
    assert sorted(a) == ["dslr/courtyard", "training/Barn"]
    assert set(a["dslr/courtyard"]) == {"instantsfm", "glomap"}
    assert a["dslr/courtyard"]["instantsfm"]["num_registered"] == 6
    _close(a, b)
    gt = os.path.join("tt", "training", "Barn", "sparse_gt")
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(reports["port"]["root"], gt, f), "rb") as fa, \
                open(os.path.join(reports["jax"]["root"], gt, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_reports_match_jax(reports, tmp_path):
    with open(reports["port"]["csv"], "rb") as fa, \
            open(reports["jax"]["csv"], "rb") as fb:
        assert fa.read() == fb.read()
    import csv
    other = str(tmp_path / "other.csv")
    with open(reports["port"]["csv"]) as f:
        rows = list(csv.DictReader(f))
    rows[0]["rel_auc@1deg"] = f"{float(rows[0]['rel_auc@1deg']) - 0.125:.4f}"
    with open(other, "w", newline="") as f:
        w = csv.DictWriter(f, list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    quiet = lambda *a: None
    assert benchmark.compare_reports(reports["port"]["csv"], other, log=quiet) \
        == jax_bench.compare_reports(reports["jax"]["csv"], other, log=quiet)


def test_chamfer_matches_jax():
    rng = np.random.default_rng(1)
    p1 = rng.uniform(-0.5, 0.5, (1500, 3))
    p2 = rng.uniform(-0.5, 0.5, (1200, 3))
    d = chamfer.chamfer_distance_kdtree(p1, p2)
    assert d == jax_chamfer.chamfer_distance_kdtree(p1, p2)
    dd = chamfer.chamfer_distance_device(p1, p2, chunk=512, device="cpu")
    np.testing.assert_allclose(
        dd, jax_chamfer.chamfer_distance_device(p1, p2, chunk=512), rtol=1e-6)
    np.testing.assert_allclose(dd, d, rtol=1e-4)


@pytest.mark.parametrize("dataset", ["eth3d", "blended_mvs", "imc2023"])
def test_download_is_gated_like_jax(tmp_path, monkeypatch, dataset):
    def refuse(*a, **k):
        raise urllib.error.URLError("network refused in the test")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    msgs = []
    for mod in (download, jax_download):
        with pytest.raises(RuntimeError) as e:
            mod.DOWNLOADERS[dataset](str(tmp_path / mod.__name__))
        msgs.append(str(e.value))
    # the same command to run elsewhere
    assert msgs[0].split("\n", 1)[1] .replace(
        "instantsfm_tpu_torch", "") == msgs[1].split("\n", 1)[1].replace(
        "instantsfm_tpu", "")
    assert download.ETH3D_FILES == jax_download.ETH3D_FILES
    assert download.BLENDED_MVS_FILES == jax_download.BLENDED_MVS_FILES
