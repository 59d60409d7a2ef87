"""The port's pair-inlier scoring and fisheye undistorter against the JAX
package's, ``chip_smoke.write_ring_db`` against ``bench_e2e.py``'s
database writer, and ``chip_smoke.k1_check``'s bound on a cancelling
track, and its rejection of faults, one of them a dropped row that the
flat bound (a share of the absolute chain) lets through.

Pair inliers: ``tests/test_aux_components.py::test_pair_inliers_scoring``'s
two-view scene with the pair set in turn to CALIBRATED (its ground-truth
pose), UNCALIBRATED (F from that pose and the intrinsics) and PLANAR (the
homography of the plane z = 6 under that pose): the masks must be equal.
Fisheye: an OPENCV_FISHEYE model; the remap grid within 1e-9 px of JAX's,
the image within 1 level, ``geo_locs.txt`` byte-equal.  The ring database:
40 images, 3,000 points, window 4, scale 2, at most 50 matches a pair: the
same pairs, matches and keypoint counts, keypoints within 1e-9 px.  K1's
check: on tracks of 64 rows whose sum t_p cancels, the plain version in
float32 against float64 passes the absolute-chain bound and fails the old
per-camera sum of |u|; a result with one track row dropped or one row's
camera moved fails the new bound, there and at PC = 8."""

import dataclasses
import os
import sqlite3

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import chip_smoke
from instantsfm_tpu.io import colmap_model as jax_cmio
from instantsfm_tpu.pipeline import fisheye_undistorter as jax_fisheye
from instantsfm_tpu.pipeline import pair_inliers as jax_pairs
from instantsfm_tpu.pipeline.relpose import undistort_images as jax_undistort
from instantsfm_tpu.scene import cameras as jax_cm
from instantsfm_tpu_torch.io.image import imread, imwrite
from instantsfm_tpu_torch.pipeline import fisheye_undistorter, pair_inliers
from instantsfm_tpu_torch.pipeline.relpose import undistort_images
from instantsfm_tpu_torch.scene import cameras as cm
from instantsfm_tpu_torch.scene import types as port_types
from instantsfm_tpu_torch.solve import schur_wchain as k1
from tests.test_relpose import _build_scene, _two_view_scene

OPTS = dict(max_epipolar_error_E=1.0, max_epipolar_error_F=4.0,
            max_epipolar_error_H=4.0)


def _port_scene(vg, cameras, images):
    """The port's types holding the JAX scene's arrays."""
    copy = lambda obj, cls: cls(**{
        f.name: (lambda v: v.copy() if isinstance(v, np.ndarray) else v)(
            getattr(obj, f.name)) for f in dataclasses.fields(cls)})
    return (copy(vg, port_types.ViewGraph), copy(cameras, port_types.Cameras),
            copy(images, port_types.Images))


@pytest.fixture(scope="module")
def two_view():
    params, xy1, xy2, R_rel, t_rel, gt_inlier = _two_view_scene(
        np.random.default_rng(0), noise_px=0.1)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    tx = np.array([[0, -t_rel[2], t_rel[1]], [t_rel[2], 0, -t_rel[0]],
                   [-t_rel[1], t_rel[0], 0]])
    Ki = np.linalg.inv(K)
    return dict(params=params, xy1=xy1, xy2=xy2, gt_inlier=gt_inlier,
                q=R.from_matrix(R_rel).as_quat(),
                t=t_rel / np.linalg.norm(t_rel),
                F=Ki.T @ tx @ R_rel @ Ki,
                H=K @ (R_rel + np.outer(t_rel, [0, 0, 1.0 / 6.0])) @ Ki)


@pytest.mark.parametrize("config", [port_types.CONFIG_CALIBRATED,
                                    port_types.CONFIG_UNCALIBRATED,
                                    port_types.CONFIG_PLANAR],
                         ids=["calibrated", "uncalibrated", "planar"])
def test_pair_inliers_match_jax(two_view, config):
    s = two_view
    vg, cameras, images = _build_scene(s["params"], s["xy1"], s["xy2"])
    jax_undistort(cameras, images)
    vg.config[0] = config
    vg.qvec[0], vg.tvec[0] = s["q"], s["t"]
    vg.F_mat[0], vg.H_mat[0] = s["F"], s["H"]
    pvg, pcams, pimgs = _port_scene(vg, cameras, images)
    pimgs.kp_bearing = None
    undistort_images(pcams, pimgs, device="cpu")
    np.testing.assert_allclose(pimgs.kp_bearing, images.kp_bearing, rtol=0,
                               atol=1e-12)
    jax_pairs.image_pair_inliers_count(vg, cameras, images, OPTS)
    pair_inliers.image_pair_inliers_count(pvg, pcams, pimgs, OPTS,
                                          device="cpu")
    np.testing.assert_array_equal(pvg.inlier_mask, vg.inlier_mask)
    inl = pvg.inlier_mask
    assert 0 < inl.sum() < len(inl)
    if config != port_types.CONFIG_PLANAR:
        assert inl[s["gt_inlier"]].mean() > 0.8
        assert inl[~s["gt_inlier"]].mean() < 0.1


def test_fisheye_undistorter_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    W, H = 128, 96
    params = np.array([80., 80, W / 2, H / 2, 0.05, -0.01, 0.001, 0.0])
    cams = [jax_cmio.ModelCamera(1, jax_cm.OPENCV_FISHEYE, W, H, params),
            jax_cmio.ModelCamera(2, jax_cm.PINHOLE, W, H, params[:4])]
    imgs = [jax_cmio.ModelImage(i + 1, np.array([1., 0, 0, 0]),
                                rng.standard_normal(3), cam, name,
                                np.zeros((0, 2)), np.zeros(0, np.int64))
            for i, (cam, name) in enumerate([(1, "a.png"), (2, "b.png"),
                                             (1, "c.png")])]
    sparse = str(tmp_path / "sparse")
    jax_cmio.write_model(cams, imgs, [], sparse)
    img_dir = str(tmp_path / "images")
    os.makedirs(img_dir)
    for name, shape in (("a.png", (H, W, 3)), ("b.png", (H, W, 3)),
                        ("c.png", (H, W))):
        imwrite(os.path.join(img_dir, name),
                rng.integers(0, 256, shape, dtype=np.uint8))

    grid = fisheye_undistorter.remap_grid(
        cm.OPENCV_FISHEYE, cm.pad_params(params), W, H, device="cpu")
    yy, xx = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    uv = np.stack([(xx - W / 2) / 80.0, (yy - H / 2) / 80.0], -1)
    import jax.numpy as jnp
    want = np.asarray(jax_cm.img_from_plane(
        jax_cm.OPENCV_FISHEYE, jnp.asarray(jax_cm.pad_params(params)),
        jnp.asarray(uv.reshape(-1, 2)))).reshape(H, W, 2)
    np.testing.assert_allclose(grid, want, rtol=0, atol=1e-9)

    quiet = lambda *a: None
    out = {}
    for pkg, mod, kw in (("port", fisheye_undistorter, dict(device="cpu")),
                         ("jax", jax_fisheye, {})):
        work = tmp_path / pkg
        out[pkg] = mod.undistort_fisheye_images(
            sparse, img_dir, str(work / "undist"), log=quiet, **kw)
    assert sorted(out["port"]) == sorted(out["jax"]) == [1, 3]
    for i, name in ((1, "a.png"), (3, "c.png")):
        a, b = out["port"][i].astype(int), out["jax"][i].astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
        a = imread(str(tmp_path / "port" / "undist" / name)).astype(int)
        b = imread(str(tmp_path / "jax" / "undist" / name)).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
    with open(tmp_path / "port" / "geo_locs.txt", "rb") as fa, \
            open(tmp_path / "jax" / "geo_locs.txt", "rb") as fb:
        assert fa.read() == fb.read()


def _db_rows(path):
    with sqlite3.connect(path) as c:
        kp = {i: np.frombuffer(d, np.float32).reshape(r, cols)
              for i, r, cols, d in c.execute(
                  "SELECT image_id, rows, cols, data FROM keypoints")}
        matches = {p: np.frombuffer(d, np.uint32).reshape(r, cols)
                   for p, r, cols, d in c.execute(
                       "SELECT pair_id, rows, cols, data FROM matches")}
        geoms = {p: np.frombuffer(d, np.uint32).reshape(r, cols)
                 for p, r, cols, d in c.execute(
                     "SELECT pair_id, rows, cols, data "
                     "FROM two_view_geometries")}
    return kp, matches, geoms


def test_write_ring_db_matches_bench_e2e(tmp_path):
    from bench_e2e import build_scene_db

    kw = dict(num_cams=40, num_pts=3000, window=4, scene_scale=2.0,
              max_matches_per_pair=50)
    gt, n_pairs, n_matches = chip_smoke.write_ring_db(
        str(tmp_path / "port.db"), **kw)
    assert build_scene_db(str(tmp_path / "jax.db"), **kw) == (n_pairs,
                                                              n_matches)
    ref = np.load(str(tmp_path / "jax.db") + ".gt.npz")
    np.testing.assert_allclose(gt["centers"], ref["centers"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(gt["t"], ref["tvec"], rtol=0, atol=1e-12)
    port, jax_ = _db_rows(str(tmp_path / "port.db")), _db_rows(
        str(tmp_path / "jax.db"))
    assert port[0].keys() == jax_[0].keys() and len(port[0]) == 40
    for i in port[0]:
        assert port[0][i].shape == jax_[0][i].shape
        np.testing.assert_allclose(port[0][i], jax_[0][i], rtol=0, atol=1e-9)
    for table in (1, 2):
        assert port[table].keys() == jax_[table].keys()
        for p in port[table]:
            np.testing.assert_array_equal(port[table][p], jax_[table][p])
    counts = [len(m) for m in port[1].values()]
    assert n_pairs == 160 and max(counts) == 50


def _cancelling_inputs():
    """Tracks of 64 rows whose sum t_p = SUM_k W_k^T x[cam_k] cancels to
    rounding (each track's last row set against the others), PC = 3, as
    float64 numpy (layout, W, V_inv, x)."""
    rng = np.random.default_rng(0)
    C, PC = 6, 3
    bp = chip_smoke.k1_layout([64, 64, 64, 8], C, 0)
    W = rng.standard_normal((len(bp.cam_idx), PC, 3)) * bp.valid[:, None, None]
    x = rng.standard_normal((C, PC))
    for p in range(bp.num_slots):
        rows = np.nonzero((bp.pt_idx == p) & bp.valid)[0]
        if len(rows) < 2:
            continue
        s = np.einsum("rij,ri->j", W[rows[:-1]], x[bp.cam_idx[rows[:-1]]])
        xc = x[bp.cam_idx[rows[-1]]]
        W[rows[-1]] = -np.outer(xc, s) / (xc @ xc)
    A = rng.standard_normal((bp.num_slots, 3, 3))
    return bp, W, A @ A.transpose(0, 2, 1) + np.eye(3), x


def _mixed_inputs():
    """``chip_smoke.k1_layout`` at PC = 8: 300 tracks of 2 to 64 rows on 20
    cameras, seeded normal W, V_inv and x, as float64 numpy."""
    rng = np.random.default_rng(1)
    C, PC = 20, 8
    bp = chip_smoke.k1_layout(rng.choice([2, 5, 8, 20, 64], 300), C, 1)
    W = rng.standard_normal((len(bp.cam_idx), PC, 3)) * bp.valid[:, None, None]
    A = rng.standard_normal((bp.num_slots, 3, 3))
    return (bp, W, A @ A.transpose(0, 2, 1) + np.eye(3),
            rng.standard_normal((C, PC)))


def _long_track_inputs():
    """8 tracks of 2,048 rows on 4 cameras whose sums t_p cancel to
    rounding, PC = 3, as float64 numpy (layout, W, V_inv, x): a camera
    entry sums 4,096 rows, each a 2,048-term track sum long, so one row's
    share of the absolute chain is about 1e-7."""
    rng = np.random.default_rng(2)
    C, PC = 4, 3
    bp = chip_smoke.k1_layout([2048] * 8, C, 2)
    W = rng.standard_normal((len(bp.cam_idx), PC, 3)) * bp.valid[:, None, None]
    x = rng.standard_normal((C, PC))
    for p in range(bp.num_slots):
        rows = np.nonzero((bp.pt_idx == p) & bp.valid)[0]
        if len(rows) < 2:
            continue
        s = np.einsum("rij,ri->j", W[rows[:-1]], x[bp.cam_idx[rows[:-1]]])
        xc = x[bp.cam_idx[rows[-1]]]
        W[rows[-1]] = -np.outer(xc, s) / (xc @ xc)
    A = rng.standard_normal((bp.num_slots, 3, 3))
    return bp, W, A @ A.transpose(0, 2, 1) + np.eye(3), x


def _k1_f32_f64(bp, W, V_inv, x, W_got=None, cam_got=None):
    """The plain version in float32 (on ``W_got`` and ``cam_got`` where
    given) and in float64 on the float32 values, and the scales of K1's
    tolerance (``chip_smoke.k1_scales``, in float64)."""
    f32 = [torch.tensor(a, dtype=torch.float32) for a in (W, V_inv, x)]
    f64 = [a.double() for a in f32]       # the same values in float64
    idx = [torch.as_tensor(bp.cam_idx), torch.as_tensor(bp.pt_idx)]
    got = k1.schur_wchain_reference(
        f32[0] if W_got is None else torch.tensor(W_got, dtype=torch.float32),
        *f32[1:], idx[0] if cam_got is None else torch.as_tensor(cam_got),
        idx[1], bp.buckets)
    want = k1.schur_wchain_reference(*f64, *idx, bp.buckets)
    scales = chip_smoke.k1_scales(*f64, *idx, bp.buckets)
    # the float32 result is held to the float32 roundoff
    return got.double(), want, scales, torch.float32


def _check(name, got, want, scales, dtype):
    return chip_smoke.k1_check(name, got.to(dtype), want.to(dtype),
                               chip_smoke.K1Scales(*(t.to(dtype)
                                                     for t in scales)))


def test_k1_check_bound_holds_on_cancelling_tracks():
    """On tracks whose sum t_p cancels, float32 against float64 on the same
    inputs is within K1's bound and within 1e-5 of the absolute chain, but
    far beyond 1e-5 of the sum of |u|; the bound reaches further than the
    flat one."""
    got, want, scales, dt = _k1_f32_f64(*_cancelling_inputs())
    rec = _check("cancelling tracks", got, want, scales, dt)
    assert rec["max_abs_err"] > 0
    assert rec["max_err_over_abs_chain"] < chip_smoke.K1_TOL[torch.float32]
    assert rec["max_err_over_abs_sum"] > 10 * chip_smoke.K1_TOL[torch.float32]
    assert 0 < rec["min_bound_over_abs_y"] <= rec["min_tol_chain_over_abs_y"]
    with pytest.raises(AssertionError, match="absolute chain"):
        _check("the old scale", got, want, scales._replace(
            chain=scales.u_abs), dt)


@pytest.mark.parametrize("layout", ["cancelling", "mixed_pc8"])
@pytest.mark.parametrize("fault", ["row_dropped", "cam_moved"])
def test_k1_check_bound_rejects_a_wrong_result(layout, fault):
    """A result computed with one track row dropped (its W zeroed), or one
    row's camera moved to the next camera, fails K1's bound against the
    right result: on the cancelling tracks (the row is in the first track)
    and on a PC = 8 layout of mixed track lengths."""
    bp, W, V_inv, x = (_cancelling_inputs() if layout == "cancelling"
                       else _mixed_inputs())
    row = int(np.nonzero((bp.pt_idx == 0) & bp.valid)[0][0])
    W_got, cam_got = None, None
    if fault == "row_dropped":
        W_got = W.copy()
        W_got[row] = 0.0
    else:
        cam_got = bp.cam_idx.copy()
        cam_got[row] = (cam_got[row] + 1) % len(x)
    got, want, scales, dt = _k1_f32_f64(bp, W, V_inv, x, W_got, cam_got)
    with pytest.raises(AssertionError, match="absolute chain"):
        _check(f"{layout}, {fault}", got, want, scales, dt)


def test_k1_check_rejects_what_the_flat_bound_let_through():
    """On 2,048-row tracks that cancel, 4,096 rows a camera: float32 holds
    K1's bound, and a result with one row dropped is within the flat bound
    (1e-5 of the absolute chain, the check before the rounding count)
    everywhere, but beyond K1's, which reaches over ten times further."""
    inputs = _long_track_inputs()
    got, want, scales, dt = _k1_f32_f64(*inputs)
    rec = _check("long cancelling tracks", got, want, scales, dt)
    assert rec["min_bound_over_abs_y"] < 0.1 * rec["min_tol_chain_over_abs_y"]
    bp, W, V_inv, x = inputs
    W_got = W.copy()
    W_got[int(np.nonzero((bp.pt_idx == 0) & bp.valid)[0][0])] = 0.0
    got, want, scales, dt = _k1_f32_f64(bp, W, V_inv, x, W_got)
    flat = chip_smoke.K1_TOL[dt] * scales.chain
    assert ((got - want).abs() <= flat).all()
    with pytest.raises(AssertionError, match="absolute chain"):
        _check("long cancelling tracks, row dropped", got, want, scales, dt)
