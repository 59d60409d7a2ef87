"""The port's measuring entry points against the JAX package's, on the CPU.

``utils/roofline.py``'s LM-step count equals JAX's integer for integer;
``bench_torch.make_ba`` draws ``bench.make_ba``'s scene (the numpy draws
bit for bit, the quaternions to 1e-12 in float64, float32 within one ulp);
``bench_e2e_torch.write_ring_db`` writes ``bench_e2e.build_scene_db``'s
database as each package's reader reads it back; one ``bench_torch`` LM
step in float64 matches JAX x64's within ``tests/test_torch_ba.py``'s
tolerances; ``bench_e2e_torch.run_pipeline`` records a pass on the CPU; and
every entry point's ``main()`` raises without a card."""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_e2e
import bench_e2e_torch
import bench_torch
from instantsfm_tpu.io.colmap_db import read_colmap_database as jread
from instantsfm_tpu.math import lie as jlie
from instantsfm_tpu.solve import block_lm as jbl
from instantsfm_tpu.solve import robust as jrobust
from instantsfm_tpu.solve.blocked import bucketize_problem as jbucketize
from instantsfm_tpu.solve.problems import make_ba_problem as jmake_ba_problem
from instantsfm_tpu.utils import roofline as jroofline
from instantsfm_tpu_torch.io.colmap_db import read_colmap_database as tread
from instantsfm_tpu_torch.utils import roofline as troofline

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@pytest.mark.parametrize("O,C,T,PC,cg,F,scales,onehot", [
    (401_408, 200, 50_176, 8, 25, 4, False, False),      # ETH3D-indoor BA
    (401_408, 200, 50_176, 8, 25, 4, False, True),
    (15_600_000, 2000, 250_000, 8, 100, 4, False, False),  # 2,000 images
    (8_050_000, 2000, 350_000, 3, 100, 4, True, False),    # GP at 2,000
    (8_001_536, 500, 1_000_000, 8, 25, 8, False, True),    # T&T, float64
    (1, 1, 1, 1, 0, 4, True, True),
])
def test_lm_step_cost_matches_jax(O, C, T, PC, cg, F, scales, onehot):
    kw = dict(O=O, C=C, T=T, PC=PC, cg_iters=cg, dtype_bytes=F,
              has_scales=scales, onehot_cam_reduce=onehot)
    assert tuple(troofline.lm_step_cost(**kw)) == tuple(
        jroofline.lm_step_cost(**kw))


@pytest.mark.parametrize("t_step", [1e-4, 2e-3, 5e-2, 1e3])
def test_analyze_analytic_matches_jax(t_step):
    """The same share and binding term as JAX's on a chip with the H100's
    peaks (JAX divides its peak FLOP rate by 4 for float32 products)."""
    cost = troofline.lm_step_cost(O=401_408, C=200, T=50_176, PC=8,
                                  onehot_cam_reduce=False)
    spec = troofline.H100_SXM
    got = troofline.analyze_analytic(cost, t_step, spec)
    want = jroofline.analyze_analytic(
        jroofline.LMStepCost(*cost), t_step,
        spec=jroofline.ChipSpec("h100", 4 * spec.peak_flops_f32,
                                spec.peak_bw))
    assert got.bound == want.bound
    np.testing.assert_equal(got.roofline_frac, want.roofline_frac)
    assert got.t_light == want.t_light
    assert got.membw_util == want.membw_util


def test_chip_spec_needs_published_peaks():
    assert troofline.chip_spec("NVIDIA H100 80GB HBM3") == troofline.H100_SXM
    with pytest.raises(ValueError):
        troofline.chip_spec("cpu")


def test_make_ba_matches_jax():
    problem, params, obs = bench.make_ba(12, 200, 8, seed=0)
    tproblem, tparams, tobs = bench_torch.make_ba(12, 200, 8, seed=0,
                                                  device="cpu")
    assert (tproblem.cam_dim, tproblem.res_dim) == (problem.cam_dim,
                                                    problem.res_dim)
    pairs = ((tobs.cam_idx, obs.cam_idx), (tobs.pt_idx, obs.pt_idx),
             (tobs.valid, obs.valid), (tparams.cam["t"], params.cam["t"]),
             (tparams.cam["intr"], params.cam["intr"]),
             (tparams.pts, params.pts), (tparams.scales, params.scales),
             (tparams.scales_free, params.scales_free))
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # through a quaternion: float32 within one ulp
    np.testing.assert_array_max_ulp(tparams.cam["q"].numpy(),
                                    np.asarray(params.cam["q"]), maxulp=1)
    for k in ("x", "y"):
        np.testing.assert_array_max_ulp(tobs.data[k].numpy(),
                                        np.asarray(obs.data[k]), maxulp=1)
    # the float64 quaternions against JAX's conversion of the same matrices
    a = bench_torch.ba_arrays(12, 200, 8, seed=0)
    R = jlie.quat_to_matrix(jnp.asarray(a["q"]))
    np.testing.assert_allclose(np.asarray(jlie.matrix_to_quat(R)), a["q"],
                               rtol=0, atol=1e-12)


def test_write_ring_db_matches_build_scene_db(tmp_path):
    kw = dict(num_cams=12, num_pts=500, window=4)
    _, n_pairs, n_matches = bench_e2e_torch.write_ring_db(
        str(tmp_path / "port.db"), **kw)
    assert bench_e2e.build_scene_db(str(tmp_path / "jax.db"), **kw) == (
        n_pairs, n_matches)
    tvg, tcam, timg, tname = tread(str(tmp_path / "port.db"))
    jvg, jcam, jimg, jname = jread(str(tmp_path / "jax.db"))
    assert tname == jname and timg.names == jimg.names and n_pairs > 0
    for f in ("model_ids", "widths", "heights", "params", "has_prior_focal"):
        np.testing.assert_array_equal(getattr(tcam, f), getattr(jcam, f))
    np.testing.assert_array_equal(timg.kp_offset, jimg.kp_offset)
    np.testing.assert_allclose(timg.kp_xy, jimg.kp_xy, rtol=0, atol=1e-9)
    for f in ("pair_i", "pair_j", "valid", "config", "E_mat", "F_mat",
              "H_mat", "matches", "match_offset", "inlier_mask"):
        np.testing.assert_array_equal(getattr(tvg, f), getattr(jvg, f), f)


def test_bench_lm_step_matches_jax():
    """One step of ``bench_torch.setup`` (float64) against JAX's ``lm_step``
    at ``bench.py``'s configuration on the same arrays (x64)."""
    step, fresh_state, _, _, _ = bench_torch.setup(12, 200, 8, seed=0,
                                                   dtype=torch.float64,
                                                   device="cpu")
    got = step(fresh_state())

    a = bench_torch.ba_arrays(12, 200, 8, seed=0)
    O = len(a["obs_cam"])
    params = jbl.Params(
        cam={k: jnp.asarray(a[k]) for k in ("q", "t", "intr")},
        pts=jnp.asarray(a["pts"]), scales=jnp.zeros((O, 1)),
        scales_free=jnp.zeros(O, bool))
    obs = jbl.Observations(
        cam_idx=jnp.asarray(a["obs_cam"], jnp.int32),
        pt_idx=jnp.asarray(a["obs_pt"], jnp.int32),
        data={"x": jnp.asarray(a["x"]), "y": jnp.asarray(a["y"])},
        valid=jnp.asarray(a["valid"]))
    params, obs, buckets, _ = jbucketize(params, obs, track_pad=256)
    cfg = jbl.LMConfig(pcg_iters=25, pcg_tol=1e-4, max_rejects=2)
    problem, kernel = jmake_ba_problem(2), jrobust.huber(1.0)
    want = jax.jit(lambda s, o: jbl.lm_step(problem, kernel, cfg, s, o,
                                            buckets=buckets))(
        jbl.LMState(params, jnp.asarray(1e-4), jnp.asarray(jnp.inf)), obs)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5)
    np.testing.assert_allclose(got.params.cam["q"].numpy(),
                               np.asarray(want.params.cam["q"]), atol=1e-6)
    np.testing.assert_allclose(got.params.cam["t"].numpy(),
                               np.asarray(want.params.cam["t"]),
                               rtol=1e-5, atol=6e-5)
    np.testing.assert_allclose(got.params.cam["intr"].numpy(),
                               np.asarray(want.params.cam["intr"]),
                               rtol=1e-6)


def test_run_pipeline_records_a_pass_on_cpu(tmp_path):
    db = str(tmp_path / "database.db")
    gt, n_pairs, _ = bench_e2e_torch.write_ring_db(db, num_cams=14,
                                                   num_pts=600, window=6)
    rec, _, images, tracks = bench_e2e_torch.run_pipeline(
        db, str(tmp_path / "sparse"), "cpu")
    assert rec["registered"] == rec["images"] == 14
    assert rec["tracks"] == tracks.num_tracks > 0
    assert os.path.exists(tmp_path / "sparse" / "0" / "images.bin")
    assert set(rec["stage_s"]) >= {"rotation_averaging", "global_positioning",
                                   "bundle_adjustment"}
    assert len(rec["ra_syncs"]) == 2 and rec["ra_syncs_total"] > 0
    assert len(rec["ba_lm_iters"]) == 3 and rec["gp_lm_iters"]
    # 14 images take the dense Schur solve: no PCG, no K1
    assert rec["k1_launches_total"] == rec["pcg_iters_total"] == 0
    assert rec["peak_device_gb"] is None
    acc = bench_e2e_torch.accuracy_vs_gt(images, gt)
    assert acc["registered"] == 14 and acc["rot_err_deg_max"] < 1.0
    assert acc["ate_rel_max"] < 0.01


@pytest.mark.parametrize("module", [
    "bench_torch", "bench_e2e_torch", "bench_gs_torch",
    "tools/bench_relpose_torch", "tools/bench_lightglue_torch",
    "tools/trace_ba_step_torch", "tools/trace_gp_step_torch",
    "tools/trace_gs_step_torch", "tools/probe_accuracy_torch",
    "tools/pc8_spread_torch"])
def test_entry_points_raise_without_card(module, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would measure")
    monkeypatch.syspath_prepend(TOOLS)
    monkeypatch.setattr(sys, "argv", [module])
    mod = importlib.import_module(os.path.basename(module))
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.main()
