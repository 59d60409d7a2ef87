"""The port's measuring entry points against the JAX package's, on the CPU.

The benchmark's frozen LM-step count (``sfmbench/yardstick/roofline.py``,
which ``bench_torch.py`` reads) equals JAX's integer for integer;
``bench_torch.make_ba`` draws ``bench.make_ba``'s scene (the numpy draws
bit for bit, the quaternions to 1e-12 in float64, float32 within one ulp);
``bench_e2e_torch.write_ring_db`` writes ``bench_e2e.build_scene_db``'s
database as each package's reader reads it back; one ``bench_torch`` LM
step in float64 matches JAX x64's within ``tests/test_torch_ba.py``'s
tolerances; ``bench_e2e_torch.run_pipeline`` records a pass on the CPU; and
every entry point's ``main()`` raises without a card.

The benchmark's 3DGS step count (``yardstick/gs_roofline.py::gs_step_cost``,
which ``bench_gs_torch.py`` reads; its tile and chunk sizes are
``gs/composite.py``'s) on ``bench_gs_torch``'s step at 1,000 gaussians and
64x48, one step on the CPU through the plain versions: each part against a
tally made apart (the parameter tensors' sizes, ``rasterize.tile_windows``,
``chip_smoke.composite_work``, the pixels), the same count at tile
capacity 256 and 512 where no tile overflows, the SSIM term against torch's
FLOP counter on a separable depthwise filter that equals ``gs/ssim.py``'s,
``bench_gs.py``'s roofline keys on a record built from a fake time, and
every part of a profiled step assigned (``bench.time_by_scope``, as the
trace tool uses it)."""

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
import bench_gs_torch
import bench_torch
import chip_smoke
from tests.torch_cpu import lean_cpu  # noqa: F401  (module fixture)
from instantsfm_tpu.io.colmap_db import read_colmap_database as jread
from instantsfm_tpu.math import lie as jlie
from instantsfm_tpu.solve import block_lm as jbl
from instantsfm_tpu.solve import robust as jrobust
from instantsfm_tpu.solve.blocked import bucketize_problem as jbucketize
from instantsfm_tpu.solve.problems import make_ba_problem as jmake_ba_problem
from instantsfm_tpu.utils import roofline as jroofline
from instantsfm_tpu_torch.gs import composite as k23
from instantsfm_tpu_torch.gs import rasterize as traster
from instantsfm_tpu_torch.gs import ssim as tssim
from instantsfm_tpu_torch.io.colmap_db import read_colmap_database as tread
from instantsfm_tpu_torch.utils import bench as tbench
# the benchmark's counts (``bench_torch`` puts ``sfmbench`` on the path)
from yardstick import gs_roofline as ygs
from yardstick import roofline as yroofline

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
    assert tuple(yroofline.lm_step_cost(**kw)) == tuple(
        jroofline.lm_step_cost(**kw))


@pytest.mark.parametrize("t_step", [1e-4, 2e-3, 5e-2, 1e3])
def test_analyze_analytic_matches_jax(t_step):
    """The same share and binding term as JAX's on a chip with the H100's
    peaks (JAX divides its peak FLOP rate by 4 for float32 products)."""
    cost = yroofline.lm_step_cost(O=401_408, C=200, T=50_176, PC=8,
                                  onehot_cam_reduce=False)
    spec = yroofline.H100_SXM
    got = bench_torch.analyze_analytic(cost, t_step, spec)
    want = jroofline.analyze_analytic(
        jroofline.LMStepCost(*cost), t_step,
        spec=jroofline.ChipSpec("h100", 4 * spec.peak_flops_f32,
                                spec.peak_bw))
    assert got.bound == want.bound
    np.testing.assert_equal(got.roofline_frac, want.roofline_frac)
    assert got.t_light == want.t_light
    assert got.membw_util == want.membw_util


def test_chip_spec_needs_published_peaks():
    assert yroofline.chip_spec("NVIDIA H100 80GB HBM3") == yroofline.H100_SXM
    with pytest.raises(ValueError):
        yroofline.chip_spec("cpu")


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


GS_SMALL = dict(num_gaussians=1000, width=64, height=48, device="cpu")


@pytest.fixture(scope="module")
def gs_step():
    """``bench_gs_torch``'s step at ``GS_SMALL`` after one step."""
    step = bench_gs_torch.setup(**GS_SMALL)
    step()
    return step


def _render(step, tile_capacity):
    """``bench_gs_torch.step_work`` on the step's view at
    ``tile_capacity``, the tiles' gaussian counts, and K2/K3's inputs and
    log T."""
    W, H = GS_SMALL["width"], GS_SMALL["height"]
    inputs = step.inputs()
    with torch.no_grad():
        p = traster.project_view(*inputs, W, H, sh_degree=3)
        counts = traster.tile_windows(p.means2d, p.radii, p.valid, p.depths,
                                      W, H, 16, tile_capacity).counts
        attrs, nchunks, ntx = traster.tile_attrs(p, W, H, 16, tile_capacity)
        logt = k23.composite_fwd(attrs, nchunks, ntx)[1]
    return (bench_gs_torch.step_work(*inputs, W, H, 16, tile_capacity),
            counts, (attrs, logt, ntx))


def test_gs_step_cost_parts_match_a_tally(gs_step):
    step = gs_step
    work, counts, (attrs, logt, ntx) = _render(step, 512)
    assert work == step.work()
    cost = ygs.gs_step_cost(**work)
    parts = cost.parts
    assert tuple(parts) == ygs.GS_PARTS
    for i in range(3):
        assert cost[i] == sum(p[i] for p in parts.values())
    G = step.params["means"].shape[0]
    assert work["G"] == G
    sh = step.params["sh0"].numel() + step.params["shN"].numel()
    floats = sum(p.numel() for p in step.params.values())
    assert floats == 59 * G                  # 3 + 4 + 3 + 1 + 48 at SH 3
    assert parts["adam"] == (13 * floats, 2 * floats, 28 * floats)
    # SH: the coefficients and means read, the colours written; backward
    # reads the colours' gradient, coefficients and means, writes theirs
    assert parts["sh_fwd"].hbm_bytes == 4 * (sh + 3 * G + 3 * G)
    assert parts["sh_bwd"].hbm_bytes == 4 * (3 * G + 2 * sh + 2 * 3 * G)
    # intersections: every (tile, gaussian) pair tile_windows sorts
    I = int(counts.sum())
    assert work["intersections"] == work["kept"] == I > 0
    assert parts["tile_sort"].hbm_bytes == (17 * G + 40 * I
                                            + 4 * (attrs.shape[0] + 1))
    assert parts["gather"].hbm_bytes == 40 * G + 44 * I
    # K2/K3: the pairs of the entered chunks and the live ones
    cw = chip_smoke.composite_work(attrs, logt, ntx)
    assert work["chunks_entered"] == cw["chunks_entered"] > 0
    assert work["live_pairs"] == cw["live_pairs"] > 0
    assert cw["pairs"] == cw["chunks_entered"] * 128 * 256
    assert parts["k2"].flops == 16 * cw["pairs"] + 12 * cw["live_pairs"]
    assert parts["k3"].sfu == cw["pairs"] + 3 * cw["live_pairs"]
    # the pixels: the loss reads the render and the target once
    pix = GS_SMALL["width"] * GS_SMALL["height"]
    assert parts["loss_fwd"].hbm_bytes == 2 * 4 * 3 * pix + 4
    assert parts["loss_bwd"].hbm_bytes == 3 * 4 * 3 * pix
    assert parts["k2"].hbm_bytes == (40 * cw["chunks_entered"] * 128
                                     + 4 * attrs.shape[0] + 20 * pix
                                     + 4 * cw["chunks_entered"] * 256)


def test_gs_step_cost_ignores_tile_capacity(gs_step):
    """No tile overflows 256 here, so capacity 256 and 512 render the same
    view; only the padding differs, and the count does not see it."""
    (w256, c256, (a256, _, _)), (w512, c512, (a512, _, _)) = (
        _render(gs_step, 256), _render(gs_step, 512))
    assert int(c512.max()) < 256 and torch.equal(c256, c512)
    assert a256.shape[1] == 256 and a512.shape[1] == 512
    assert w256 == w512
    assert ygs.gs_step_cost(**w256) == ygs.gs_step_cost(**w512)


def test_yardstick_tile_sizes_are_the_kernels():
    """The benchmark's count and ``chip_smoke.py``'s K2/K3 bounds read the
    yardstick's tile side, tile pixels, chunk rows and depth column: they
    must be the compositing kernels' own."""
    assert (ygs.TILE, ygs.P, ygs.CHUNK, ygs.DE) == (k23.TILE, k23.P,
                                                    k23.CHUNK, k23.DE)


def test_gs_step_cost_counts_ssim_as_its_separable_filter(gs_step):
    """The loss's filter term is the 11-tap separable filter's: torch's
    FLOP counter on a depthwise 1x11 then 11x1 'valid' convolution, which
    computes gs/ssim.py's band products' result."""
    from torch.utils.flop_counter import FlopCounterMode
    W, H = GS_SMALL["width"], GS_SMALL["height"]
    maps = torch.rand(1, 15, H, W, dtype=torch.float64)   # 5 maps x 3 ch
    win = tssim._gauss_window(11, 1.5, torch.float64, "cpu")
    with FlopCounterMode(display=False) as fc:
        rows = torch.nn.functional.conv2d(
            maps, win.view(1, 1, 1, 11).expand(15, 1, 1, 11), groups=15)
        out = torch.nn.functional.conv2d(
            rows, win.view(1, 1, 11, 1).expand(15, 1, 11, 1), groups=15)
    np.testing.assert_allclose(out.numpy(),
                               tssim._filter2d(maps, win).numpy(),
                               rtol=0, atol=1e-12)
    five = fc.get_total_flops()
    assert ygs.ssim_filter_flops(W, H, 5) == five
    n3, nv = 3 * W * H, 3 * (W - 10) * (H - 10)
    parts = ygs.gs_step_cost(**gs_step.work()).parts
    assert parts["loss_fwd"].flops == 3 * n3 + 3 * n3 + five + 18 * nv
    assert parts["loss_bwd"].flops == (2 * n3 + 7 * n3 + five * 8 / 5
                                       + 3 * 18 * nv)
    # not the band products' count: 2 H W W' + 2 H' H W' a map and channel
    band = 2 * 15 * (H * W * (W - 10) + (H - 10) * H * (W - 10))
    assert band > 5 * five


@pytest.mark.parametrize("t_step", [2e-3, 19.4e-3])
def test_bench_gs_record_has_bench_gs_keys(gs_step, t_step):
    """``bench_gs_torch``'s roofline keys, built from a fake step time as
    ``test_analyze_analytic_matches_jax`` builds its own: ``bench_gs.py``'s
    names (but ``vs_baseline``, its second name for ``roofline_frac``),
    the share equal to the bound over the time."""
    import ast
    src = open(os.path.join(os.path.dirname(TOOLS), "bench_gs.py")).read()
    jax_keys = {k.value for node in ast.walk(ast.parse(src))
                if isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "update"
                for arg in node.args if isinstance(arg, ast.Dict)
                for k in arg.keys}
    assert "roofline_frac" in jax_keys and "mfu" in jax_keys
    work = gs_step.work()
    rec = bench_gs_torch.roofline_record(work, t_step, yroofline.H100_SXM)
    assert jax_keys - {"vs_baseline"} <= set(rec)
    assert "vs_baseline" not in rec and "roofline_note" not in rec
    cost = ygs.gs_step_cost(**work)
    spec = yroofline.H100_SXM
    t_light = max(cost.hbm_bytes / spec.peak_bw,
                  cost.flops / spec.peak_flops_f32, cost.sfu / spec.peak_sfu)
    assert rec["roofline_frac"] == pytest.approx(t_light / t_step, rel=1e-12)
    assert rec["bound_ms"] == pytest.approx(t_light * 1e3, rel=1e-12)
    assert rec["mfu"] == pytest.approx(
        cost.flops / t_step / spec.peak_flops_f32, rel=1e-12)
    assert rec["membw_util"] == pytest.approx(
        cost.hbm_bytes / t_step / spec.peak_bw, rel=1e-12)
    assert rec["bound"] in ("bytes", "operations", "sfu")
    assert rec["chip"] == spec.name
    assert rec["gflops_per_iter"] == cost.flops / 1e9
    assert rec["hbm_gb_per_iter"] == cost.hbm_bytes / 1e9
    assert set(rec["roofline_parts"]) == set(ygs.GS_PARTS)
    assert max(rec["roofline_parts"].values()) <= rec["bound_ms"] <= sum(
        rec["roofline_parts"].values())


def test_time_by_scope_assigns_every_part(gs_step):
    """One profiled step on the CPU: every counted part gets its ops' time
    through the step's scopes and the autograd nodes' sequence numbers,
    and what no part takes is a small share."""
    from torch.profiler import ProfilerActivity, profile
    step = gs_step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    parts, rest = tbench.time_by_scope(prof, 1, bench_gs_torch.PART_SCOPES,
                                       bench_gs_torch.PART_KERNELS,
                                       device=False)
    assert set(parts) == set(ygs.GS_PARTS)
    assert all(ms > 0 for ms in parts.values())
    assert sum(ms for _, ms in rest) < 0.1 * sum(parts.values())
