"""Port parity for the 3DGS training path: SSIM/PSNR, splat init, the
per-group Adam, the DefaultStrategy, the data layer and three whole
``Runner`` steps, torch (CPU) against the JAX package.

The scene for the data layer and the Runner is written with the port's own
COLMAP and PNG writers (``chip_smoke.make_gs_scene``, photos rendered by
the port's rasterizer).  The port's rasterizer keeps every gaussian-tile
pair; the JAX Runner is given budgets that cut none at this size, and the
Runner starts at opacity 0.1, so no tile saturates: the JAX Runner's jnp
compositing (no early exit) then computes the same function as the
port's K2/K3."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from tests.torch_cpu import lean_cpu  # noqa: F401  (module fixture)
from instantsfm_tpu.gs import data as jdata
from instantsfm_tpu.gs import splats as jsp
from instantsfm_tpu.gs import ssim as jssim
from instantsfm_tpu.gs import strategy as jst
from instantsfm_tpu.gs.trainer import GSConfig as JGSConfig
from instantsfm_tpu.gs.trainer import Runner as JRunner
from instantsfm_tpu_torch import convert
from instantsfm_tpu_torch.cli import gs as tcli
from instantsfm_tpu_torch.gs import data as tdata
from instantsfm_tpu_torch.gs.projection import quat_scale_to_cov
from instantsfm_tpu_torch.gs import splats as tsp
from instantsfm_tpu_torch.gs import ssim as tssim
from instantsfm_tpu_torch.gs import strategy as tst
from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner
from instantsfm_tpu_torch.io import colmap_model as tcm

LRS = {"means": 1.6e-4, "scales": 5e-3, "quats": 1e-3, "opacities": 5e-2,
       "sh0": 2.5e-3, "shN": 2.5e-3 / 20}   # make_optimizer's defaults


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gs_scene"))
    chip_smoke.make_gs_scene(root, "cpu", 120, 6, 96, 72)
    return root


# ------------------------------------------------------------ SSIM, PSNR

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ssim_psnr_match_jax(dtype):
    """Band-matrix blurs on both sides: float64 within 1e-12, float32
    within 1e-5 (products summed in other orders)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (40, 52, 3)).astype(dtype)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(dtype)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for f_t, f_j in ((tssim.ssim, jssim.ssim), (tssim.psnr, jssim.psnr)):
        got = float(f_t(torch.tensor(a), torch.tensor(b)))
        want = float(f_j(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - want) <= tol * abs(want), (f_t.__name__, got, want)
    batch = np.stack([a, b])
    got = float(tssim.ssim(torch.tensor(batch), torch.tensor(batch[::-1].copy())))
    want = float(jssim.ssim(jnp.asarray(batch), jnp.asarray(batch[::-1])))
    assert abs(got - want) <= tol * abs(want)


# --------------------------------------------------------- splats, Adam

def test_init_splats_matches_jax():
    """Every numpy-drawn field is bit-identical; the scales come from a
    float32 distance matrix (|q|^2 + |r|^2 - 2 q.r) that two BLAS sum in
    other orders, so they agree to 1e-5 relative in the scale (the
    subtraction loses digits for near neighbours)."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (300, 3))
    col = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    j = jsp.init_splats(pts, col, 400, sh_degree=2)
    t = tsp.init_splats(pts, col, 400, sh_degree=2, device="cpu")
    for f in ("means", "quats", "opacities", "sh0", "shN", "alive"):
        np.testing.assert_array_equal(_np(getattr(t, f)), _np(getattr(j, f)),
                                      err_msg=f)
    np.testing.assert_allclose(np.exp(_np(t.scales)), np.exp(_np(j.scales)),
                               rtol=1e-5)


def test_knn_mean_dist_matches_jax():
    """Exact neighbours and the sampled-reference path (n > sample_cap);
    1e-5 relative, as for the scales above."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (500, 3))
    for cap in (65536, 200):
        np.testing.assert_allclose(
            tsp.knn_mean_dist(pts, sample_cap=cap, chunk=128, device="cpu"),
            jsp.knn_mean_dist(pts, sample_cap=cap, chunk=128), rtol=1e-5)


def _adam_state(opt_state, field):
    """optax's ScaleByAdamState of one group of make_optimizer's
    partition."""
    return opt_state.inner_states[field].inner_state[0]


def _random_params(rng, N=50, K=4):
    shapes = {"means": (N, 3), "scales": (N, 3), "quats": (N, 4),
              "opacities": (N,), "sh0": (N, 1, 3), "shN": (N, K - 1, 3)}
    return {f: rng.standard_normal(s).astype(np.float32)
            for f, s in shapes.items()}


def test_adam_matches_optax():
    """Three updates on the same gradients, means lr decaying as optax's
    exponential_decay(lr, max_steps, 0.01).  Each step moves an element by
    up to about lr; the two agree to 1e-4 of each group's lr (float32
    rounding of m / (sqrt(v) + eps))."""
    rng = np.random.default_rng(3)
    params = _random_params(rng)
    scene_scale, max_steps = 2.0, 10
    tx = jsp.make_optimizer(scene_scale, max_steps=max_steps)
    jparams = {f: jnp.asarray(v) for f, v in params.items()}
    jstate = tx.init(jparams)
    tparams = {f: torch.tensor(v, requires_grad=True)
               for f, v in params.items()}
    opt = tsp.make_optimizer(tparams, scene_scale, max_steps=max_steps)
    for k in range(3):
        grads = {f: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-6, 2)
                     ).astype(np.float32) for f, v in params.items()}
        ups, jstate = tx.update({f: jnp.asarray(g) for f, g in grads.items()},
                                jstate, jparams)
        jparams = optax.apply_updates(jparams, ups)
        for f, p in tparams.items():
            p.grad = torch.tensor(grads[f])
        tsp.set_lr(opt, k)
        opt.step()
        for f in params:
            lr = LRS[f] * (scene_scale * 0.01 ** (k / max_steps)
                           if f == "means" else 1.0)
            np.testing.assert_allclose(_np(tparams[f]), _np(jparams[f]),
                                       rtol=0, atol=1e-4 * lr, err_msg=f)
            mu = _np(_adam_state(jstate, f).mu[f])
            np.testing.assert_allclose(
                _np(opt.state[tparams[f]]["exp_avg"]), mu, rtol=0,
                atol=1e-6 * np.abs(mu).max())


# ------------------------------------------------------------- strategy

def _strategy_setup():
    """JAX and port splats, optimizers after one identical update, and a
    strategy state with duplicating, splitting, faint and oversized
    gaussians."""
    rng = np.random.default_rng(4)
    N, P = 128, 60
    pts = rng.uniform(-1, 1, (P, 3))
    js = jsp.init_splats(pts, rng.uniform(0, 1, (P, 3)), N, sh_degree=1)
    scales = np.array(js.scales)
    scales[10:20] = np.log(0.05)          # large: split when hot
    scales[40:45] = np.log(0.3)           # too big (prune_too_big)
    opac = np.array(js.opacities)
    opac[30:38] = -8.0                    # too faint
    js = js._replace(scales=jnp.asarray(scales), opacities=jnp.asarray(opac))
    ts = convert.splats_from_numpy({f: np.asarray(v) for f, v in
                                    js._asdict().items()}, device="cpu")
    tx = jsp.make_optimizer(1.0)
    fp = jsp.float_params(js)
    jstate = tx.init(fp)
    grads = {f: rng.standard_normal(v.shape).astype(np.float32)
             for f, v in fp.items()}
    ups, jstate = tx.update({f: jnp.asarray(g) for f, g in grads.items()},
                            jstate, fp)
    js = jsp.with_float_params(js, optax.apply_updates(fp, ups))
    tp = tsp.float_params(ts)
    for f, p in tp.items():
        p.requires_grad_(True)
        p.grad = torch.tensor(grads[f])
    opt = tsp.make_optimizer(tp, 1.0)
    tsp.set_lr(opt, 0)
    opt.step()
    probe = np.zeros((N, 2), np.float32)
    probe[:25] = 0.01                     # hot: 0..9 duplicate, 10..19 split
    radii = np.where(np.arange(N) < P, 3.0, 0.0).astype(np.float32)
    valid = np.arange(N) < P
    return js, jstate, ts, opt, probe, radii, valid


# The port takes the probe's gradient in normalised device units, x times
# W / 2 and y times H / 2 (gsplat's DefaultStrategy); the JAX package sums
# the pixel gradient, so it is handed the probe scaled by the same factors.
VIEW_W, VIEW_H = 96, 72


def _ndc(probe):
    return probe * np.array([VIEW_W / 2, VIEW_H / 2], np.float32)


def test_accumulate_matches_jax():
    js, _, ts, _, probe, radii, valid = _strategy_setup()
    jstate = jst.accumulate(jst.init_state(128), jnp.asarray(_ndc(probe)),
                            jnp.asarray(radii), jnp.asarray(valid))
    tstate = tst.accumulate(tst.init_state(128), torch.tensor(probe),
                            torch.tensor(radii), torch.tensor(valid),
                            VIEW_W, VIEW_H)
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)


@pytest.mark.parametrize("prune_too_big", [False, True])
def test_refine_matches_jax(prune_too_big):
    """One grow + prune pass fed the JAX split noise: masks and counts
    exact, the grown values and the zeroed Adam moments as in JAX.  With
    ``prune_too_big`` the port judges size by the scales after the growth,
    as gsplat does, so it also prunes the children of oversized growers,
    which JAX judges by their slots' scales before the growth."""
    js, jstate, ts, opt, probe, radii, valid = _strategy_setup()
    sstate_j = jst.accumulate(jst.init_state(128), jnp.asarray(_ndc(probe)),
                              jnp.asarray(radii), jnp.asarray(valid))
    sstate_t = tst.accumulate(tst.init_state(128), torch.tensor(probe),
                              torch.tensor(radii), torch.tensor(valid),
                              VIEW_W, VIEW_H)
    key = jax.random.PRNGKey(5)
    noise = jax.random.normal(jax.random.split(key)[1], (128, 3),
                              js.means.dtype)
    js2, jstate2, _, jg, jp = jst.refine(js, jstate, sstate_j, key, 1.0,
                                         prune_too_big=prune_too_big)
    ts2, tstate2, tg, tp = tst.refine(ts, opt, sstate_t, 1.0,
                                      prune_too_big=prune_too_big,
                                      noise=torch.tensor(np.asarray(noise)))
    children = ~_np(js.alive) & _np(js2.alive)
    oversized = np.exp(_np(js2.scales)).max(-1) > 0.1
    extra = children & oversized if prune_too_big else children & False
    assert prune_too_big == bool(extra.any())
    assert (tg, tp) == (int(jg), int(jp) + int(extra.sum()))
    assert tg == 25 and (tp > 8 if prune_too_big else tp == 8)
    refined = convert.splats_to_numpy(ts2)
    np.testing.assert_array_equal(refined["alive"], _np(js2.alive) & ~extra)
    for f in tsp.FLOAT_FIELDS:
        np.testing.assert_allclose(refined[f], _np(getattr(js2, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
        p = getattr(ts2, f)
        for mom, jm in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            want = _np(getattr(_adam_state(jstate2, f), jm)[f])
            got = _np(opt.state[p][mom])
            flat = lambda a: a.reshape(len(a), -1)
            np.testing.assert_array_equal(np.all(flat(got) == 0, 1),
                                          np.all(flat(want) == 0, 1))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert all(float(v.abs().sum()) == 0 for v in tstate2)


def test_reset_opacity_matches_jax():
    """Opacities clamp to logit(0.01); as in JAX every group's moments are
    zeroed."""
    js, jstate, ts, opt, *_ = _strategy_setup()
    js2, jstate2 = jst.reset_opacity(js, jstate)
    tst.reset_opacity(ts, opt)
    np.testing.assert_allclose(_np(ts.opacities), _np(js2.opacities),
                               rtol=1e-7)
    for f in tsp.FLOAT_FIELDS:
        assert not np.any(_np(_adam_state(jstate2, f).mu[f]))
        st = opt.state[getattr(ts, f)]
        assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()


# --------------------------------------------------------- data, Runner

@pytest.mark.parametrize("model", ["PINHOLE", "SIMPLE_RADIAL"])
def test_parser_matches_jax(scene, tmp_path, model):
    """Poses, intrinsics, normalized points, scene scale and the decoded
    (for SIMPLE_RADIAL: undistorted) images."""
    root = scene
    if model == "SIMPLE_RADIAL":
        root = str(tmp_path)
        os.symlink(os.path.join(scene, "images"),
                   os.path.join(root, "images"))
        cams, imgs, pts = tcm.read_model(os.path.join(scene, "sparse", "0"))
        c = cams[1]
        cams[1] = tcm.ModelCamera(c.id, 2, c.width, c.height,
                                  np.array([c.params[0], *c.params[2:], 0.05]))
        tcm.write_model(list(cams.values()), list(imgs.values()),
                        list(pts.values()), os.path.join(root, "sparse", "0"))
    jp, tp = jdata.Parser(root, test_every=3), tdata.Parser(root, test_every=3)
    assert tp.image_names == jp.image_names and tp.model_id == jp.model_id
    for f in ("camtoworlds", "Ks", "points", "points_rgb", "transform",
              "widths", "heights"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    assert tp.scene_scale == jp.scene_scale
    for i in (0, 4):
        np.testing.assert_allclose(tp.load_image(i), jp.load_image(i),
                                   atol=1e-6)
    for split in ("train", "val"):
        np.testing.assert_array_equal(tdata.Dataset(tp, split).indices,
                                      jdata.Dataset(jp, split).indices)


def test_runner_three_steps_match_jax(scene, tmp_path):
    """The whole slice: three Runner steps (SH degree 0 then 1) in both
    packages from the same start.  Per-step losses agree to 1e-5 relative
    (float32 compositing in other summation orders).  Adam moves an element
    by up to about its group's lr per step whatever the size of its
    gradient, so parameters are compared in units of lr: within 0.05 lr
    (measured at most 0.017 lr, in the scales).  The quaternions are the
    exception: the initial gaussians are isotropic, so their quaternion
    gradients are float noise that Adam turns into steps of either sign;
    they stay within the 6 lr that 3 steps allow, and the covariances they
    give agree to 1e-3 relative (measured 1.4e-4)."""
    kw = dict(data_dir=scene, max_steps=3, test_every=3, sh_degree=1,
              sh_degree_interval=1, eval_steps=(), save_steps=(),
              capacity_mult=2.0)
    # the port keeps every gaussian-tile pair; JAX's budgets here cut none:
    # a window of 6 x 6 tiles holds the 6 x 5 tiles of the view, and a
    # tile can hold the whole pool (1,264 slots)
    jr = JRunner(JGSConfig(result_dir=str(tmp_path / "jax"),
                           tiles_per_gauss=36, tile_capacity=1280, **kw),
                 log=lambda *a: None)
    tr = Runner(GSConfig(result_dir=str(tmp_path / "port"), **kw),
                log=lambda *a: None, device="cpu")
    for f in ("means", "quats", "opacities", "sh0", "shN"):
        np.testing.assert_array_equal(_np(getattr(tr.splats, f)),
                                      _np(getattr(jr.splats, f)))
    j_losses, t_losses = jr.train(), tr.train()
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    np.testing.assert_array_equal(_np(tr.splats.alive), _np(jr.splats.alive))
    for f in tsp.FLOAT_FIELDS:
        lr = LRS[f] * (tr.scene_scale if f == "means" else 1.0)
        diff = np.abs(_np(getattr(tr.splats, f)) - _np(getattr(jr.splats, f)))
        assert diff.max() <= (6 if f == "quats" else 0.05) * lr, (
            f, diff.max() / lr)
    alive = _np(tr.splats.alive)
    cov = [_np(quat_scale_to_cov(torch.tensor(_np(s.quats)[alive]),
                                 torch.exp(torch.tensor(_np(s.scales)[alive])))
               ).reshape(-1, 9) for s in (tr.splats, jr.splats)]
    rel = np.abs(cov[0] - cov[1]).max(1) / np.abs(cov[1]).max(1)
    assert rel.max() <= 1e-3, rel.max()


def test_cli_trains_evaluates_and_checkpoints(scene, tmp_path):
    """Train, eval and checkpoint, then the PLY from the final checkpoint
    (one vertex per alive gaussian) and an ellipse trajectory (an npz of
    frames where imageio's mp4 writer is missing)."""
    out = str(tmp_path / "cli")
    assert tcli.main(["--data_path", scene, "--result_dir", out,
                      "--max_steps", "2", "--device", "cpu", "--export_ply",
                      "--render_traj", "ellipse"]) == 0
    ckpt = os.path.join(out, "ckpts", "ckpt_2.npz")
    assert os.path.exists(os.path.join(out, "stats", "val_2.json"))
    alive = int(np.load(ckpt)["alive"].sum())
    with open(os.path.join(out, "point_cloud.ply"), "rb") as f:
        ply = f.read()
    assert f"element vertex {alive}\n".encode() in ply
    assert len(ply.split(b"end_header\n", 1)[1]) \
        == alive * 4 * (6 + 3 + 3 * 15 + 1 + 3 + 4)    # SH degree 3
    videos = os.listdir(os.path.join(out, "videos"))
    assert len(videos) == 1 and videos[0].startswith("traj_ellipse.")
    if videos[0].endswith(".npz"):
        frames = np.load(os.path.join(out, "videos", videos[0]))["frames"]
        assert frames.shape == (60, 72, 96, 3) and frames.dtype == np.uint8
