"""Port parity for the bundle-adjustment stage: torch (float64, CPU) against
the JAX package (x64, single-device path) on the same small scene; the
entry points' device guard; convert.from_numpy round trips.

Tolerance: both packages run the same LM iterations in float64 but sum in
another order and pad the tracks differently (JAX aligns bucket spans to
its Pallas tile), so poses agree to 1e-6 (rotation quaternions, absolute)
and 1e-5 (translations, relative to the scene's scale of ~6), and each
round's LM iteration count agrees within one."""

import copy

import jax
import numpy as np
import pytest
import torch

from instantsfm_tpu import config as jconfig
from instantsfm_tpu.pipeline import ba as jba
from instantsfm_tpu.scene import types as jtypes
from instantsfm_tpu.solve.blocked import bucketize_problem
from instantsfm_tpu.utils import debug as jdebug
from instantsfm_tpu_torch import config as tconfig
from instantsfm_tpu_torch import convert
from instantsfm_tpu_torch.pipeline import ba as tba
from instantsfm_tpu_torch.scene import types as ttypes
from instantsfm_tpu_torch.solve import block_lm as tbl
from instantsfm_tpu_torch.solve import problems as tproblems
from instantsfm_tpu_torch.solve import robust as trobust
from instantsfm_tpu_torch.utils import debug as tdebug
from tests.synthetic import make_scene
from tests.test_block_lm import _ba_setup


def _scene_arrays(num_cams=10, num_pts=150, seed=0):
    """Perturbed synthetic scene as the arrays Cameras/Images/Tracks hold."""
    scene = make_scene(num_cams=num_cams, num_pts=num_pts, noise=0.5,
                       seed=seed)
    rng = np.random.default_rng(seed + 1)
    C, O = len(scene.qvec), len(scene.obs_cam)
    # keypoints of each image = its observations, in image order
    order = np.argsort(scene.obs_cam, kind="stable")
    kp_offset = np.zeros(C + 1, np.int64)
    np.cumsum(np.bincount(scene.obs_cam, minlength=C), out=kp_offset[1:])
    feat = np.empty(O, np.int32)
    feat[order] = np.arange(O) - kp_offset[scene.obs_cam[order]]
    obs_offset = np.zeros(len(scene.points) + 1, np.int64)
    np.cumsum(np.bincount(scene.obs_pt, minlength=len(scene.points)),
              out=obs_offset[1:])
    return dict(
        cameras=dict(model_ids=np.full(1, scene.model_id, np.int32),
                     widths=np.full(1, 640), heights=np.full(1, 480),
                     params=scene.params[None].copy(),
                     has_prior_focal=np.ones(1, bool),
                     has_refined_focal=np.zeros(1, bool)),
        images=dict(cam_idx=np.zeros(C, np.int32),
                    names=[f"{i}.png" for i in range(C)],
                    qvec=scene.qvec.copy(),
                    tvec=scene.tvec + 0.05 * rng.standard_normal((C, 3)),
                    registered=np.ones(C, bool),
                    cluster_id=np.zeros(C, np.int32),
                    kp_xy=scene.obs_xy[order], kp_offset=kp_offset),
        tracks=dict(xyz=scene.points + 0.05 * rng.standard_normal(
                        scene.points.shape),
                    color=np.zeros((len(scene.points), 3), np.uint8),
                    obs_image=scene.obs_cam.astype(np.int32),
                    obs_feature=feat, obs_offset=obs_offset,
                    track_id=np.arange(len(scene.points), dtype=np.int64)))


def _build(types_mod, arrays):
    a = copy.deepcopy(arrays)
    return (types_mod.Cameras(**a["cameras"]), types_mod.Images(**a["images"]),
            types_mod.Tracks(**a["tracks"]))


@pytest.mark.parametrize("group", ["BUNDLE_ADJUSTER_OPTIONS",
                                   "GLOBAL_POSITIONER_OPTIONS",
                                   "INLIER_THRESHOLD_OPTIONS"])
def test_option_groups_match_jax(group):
    assert getattr(tconfig, group) == jconfig.COLMAP_CONFIG[group]


def test_bundle_adjustment_rounds_matches_jax(monkeypatch):
    monkeypatch.setenv("ISFM_NO_SHARD", "1")      # JAX single-device path
    arrays = _scene_arrays()
    opts = dict(jconfig.COLMAP_CONFIG["BUNDLE_ADJUSTER_OPTIONS"],
                max_num_iterations=30)
    thr = jconfig.COLMAP_CONFIG["INLIER_THRESHOLD_OPTIONS"][
        "max_reprojection_error"]

    jcam, jimg, jtrk = _build(jtypes, arrays)
    jdebug.drain_stats()
    jtrk = jba.bundle_adjustment_rounds(jcam, jimg, jtrk, opts, thr)
    j_iters = jdebug.drain_stats()["ba_lm_iters"]

    tcam, timg, ttrk = _build(ttypes, arrays)
    tdebug.drain_stats()
    ttrk = tba.bundle_adjustment_rounds(tcam, timg, ttrk, opts, thr,
                                        device="cpu")
    t_iters = tdebug.drain_stats()["ba_lm_iters"]

    assert len(t_iters) == len(j_iters) == 3
    assert all(abs(a - b) <= 1 for a, b in zip(t_iters, j_iters)), \
        (t_iters, j_iters)
    sign = np.sign(np.sum(timg.qvec * jimg.qvec, axis=-1, keepdims=True))
    np.testing.assert_allclose(timg.qvec * sign, jimg.qvec, atol=1e-6)
    np.testing.assert_allclose(timg.tvec, jimg.tvec, rtol=1e-5, atol=6e-5)
    np.testing.assert_allclose(tcam.params, jcam.params, rtol=1e-6)
    np.testing.assert_allclose(ttrk.xyz, jtrk.xyz, atol=6e-5)
    np.testing.assert_array_equal(ttrk.obs_offset, jtrk.obs_offset)


def test_bundle_adjustment_matches_jax(monkeypatch):
    """One BA solve (the non-sharded branch of JAX's optimize_auto)."""
    monkeypatch.setenv("ISFM_NO_SHARD", "1")
    arrays = _scene_arrays(seed=2)
    opts = dict(jconfig.COLMAP_CONFIG["BUNDLE_ADJUSTER_OPTIONS"],
                max_num_iterations=20)

    jcam, jimg, jtrk = _build(jtypes, arrays)
    jdebug.drain_stats()
    jba.bundle_adjustment(jcam, jimg, jtrk, opts)
    j_iters = jdebug.drain_stats()["ba_lm_iters"]

    tcam, timg, ttrk = _build(ttypes, arrays)
    tdebug.drain_stats()
    tba.bundle_adjustment(tcam, timg, ttrk, opts, device="cpu")
    t_iters = tdebug.drain_stats()["ba_lm_iters"]

    assert abs(t_iters[0] - j_iters[0]) <= 1, (t_iters, j_iters)
    sign = np.sign(np.sum(timg.qvec * jimg.qvec, axis=-1, keepdims=True))
    np.testing.assert_allclose(timg.qvec * sign, jimg.qvec, atol=1e-6)
    np.testing.assert_allclose(timg.tvec, jimg.tvec, rtol=1e-5, atol=6e-5)
    np.testing.assert_allclose(tcam.params, jcam.params, rtol=1e-6)
    np.testing.assert_allclose(ttrk.xyz, jtrk.xyz, atol=6e-5)


def test_bundle_adjustment_single_round_reduces_error():
    arrays = _scene_arrays(seed=3)
    cam, img, trk = _build(ttypes, arrays)
    gt = make_scene(num_cams=10, num_pts=150, noise=0.5, seed=3)
    err0 = np.abs(img.tvec - gt.tvec).mean()
    tba.bundle_adjustment(cam, img, trk, dict(
        tconfig.BUNDLE_ADJUSTER_OPTIONS, max_num_iterations=20), device="cpu")
    # BA fixes the gauge only up to a similarity; the residual pose error
    # after BA stays well below the 0.05 perturbation
    assert np.all(np.isfinite(img.tvec)) and np.all(np.isfinite(trk.xyz))
    assert np.abs(img.tvec - gt.tvec).mean() < err0


@pytest.mark.parametrize("entry", ["bundle_adjustment_rounds",
                                   "bundle_adjustment", "optimize",
                                   "lm_step"])
def test_entry_points_raise_without_card(entry):
    """device defaults to "cuda"; with no card the call raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cam, img, trk = _build(ttypes, _scene_arrays(num_cams=4, num_pts=20))
    opts = tconfig.BUNDLE_ADJUSTER_OPTIONS
    problem, params, obs = _ba_setup(make_scene(num_cams=4, num_pts=20))
    tp, to, _ = convert.from_numpy(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, obs), device="cpu")
    tprob = tproblems.make_ba_problem(2)
    z = torch.zeros((), dtype=torch.float64)
    calls = {
        "bundle_adjustment_rounds":
            lambda: tba.bundle_adjustment_rounds(cam, img, trk, opts, 1e-2),
        "bundle_adjustment": lambda: tba.bundle_adjustment(cam, img, trk, opts),
        "optimize": lambda: tbl.optimize(tprob, trobust.trivial(),
                                         tbl.LMConfig(), tp, to),
        "lm_step": lambda: tbl.lm_step(tprob, trobust.trivial(),
                                       tbl.LMConfig(),
                                       tbl.LMState(tp, z, z, z, z), to),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_convert_round_trips():
    problem, params, obs = _ba_setup(make_scene(num_cams=6, num_pts=40))
    params, obs, buckets, _ = bucketize_problem(params, obs, track_pad=4)
    p_np = jax.tree_util.tree_map(np.asarray, params)
    o_np = jax.tree_util.tree_map(np.asarray, obs)
    tp, to, tb = convert.from_numpy(p_np, o_np, buckets, device="cpu",
                                    dtype=torch.float64)
    assert tb == buckets
    assert to.cam_idx.dtype == torch.int32 and to.valid.dtype == torch.bool
    back_p, back_o = convert.to_numpy(tp), convert.to_numpy(to)
    assert isinstance(back_p, tbl.Params)
    for k in p_np.cam:
        np.testing.assert_array_equal(back_p.cam[k], p_np.cam[k])
    np.testing.assert_array_equal(back_p.pts, p_np.pts)
    np.testing.assert_array_equal(back_p.scales_free, p_np.scales_free)
    np.testing.assert_array_equal(back_o.cam_idx, o_np.cam_idx)
    np.testing.assert_array_equal(back_o.data["x"], o_np.data["x"])
    np.testing.assert_array_equal(back_o.valid, o_np.valid)
    f32 = convert.from_numpy(p_np, o_np, device="cpu", dtype=torch.float32)[0]
    assert f32.pts.dtype == torch.float32
