"""Port parity for the 3DGS trainer's options, torch (CPU) against the JAX
package: selective Adam, the pose and appearance modules, the bilateral
grid, the depth loss, the MCMC relocation and noise, LPIPS, PNG
compression, the PLY export, the trajectories, and three whole ``Runner``
steps with every option but MCMC from one start.

The scene is ``chip_smoke.make_gs_scene``'s, 120 SfM points and 6 views at
96x72, written once per module; the Runner cases start at opacity 0.5 so
that the rendered alpha passes the depth loss's 0.5 bar at some SfM
points, and no tile saturates with so few gaussians, so the JAX Runner's
jnp compositing (no early exit) computes the same function as the port's
K2/K3."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from tests.torch_cpu import lean_cpu  # noqa: F401  (module fixture)
from instantsfm_tpu.gs import bilateral as jbil
from instantsfm_tpu.gs import camera_opt as jcam
from instantsfm_tpu.gs import compression as jcomp
from instantsfm_tpu.gs import lpips as jlpips
from instantsfm_tpu.gs import optim as joptim
from instantsfm_tpu.gs import ply as jply
from instantsfm_tpu.gs import rasterize as jras
from instantsfm_tpu.gs import splats as jsp
from instantsfm_tpu.gs import strategy as jst
from instantsfm_tpu.gs import traj as jtraj
from instantsfm_tpu.gs.trainer import GSConfig as JGSConfig
from instantsfm_tpu.gs.trainer import Runner as JRunner
from instantsfm_tpu_torch import convert
from instantsfm_tpu_torch.gs import bilateral as tbil
from instantsfm_tpu_torch.gs import camera_opt as tcam
from instantsfm_tpu_torch.gs import composite as tcomp
from instantsfm_tpu_torch.gs import compression as tcomp_png
from instantsfm_tpu_torch.gs import lpips as tlpips
from instantsfm_tpu_torch.gs import optim as toptim
from instantsfm_tpu_torch.gs import ply as tply
from instantsfm_tpu_torch.gs import splats as tsp
from instantsfm_tpu_torch.gs import strategy as tst
from instantsfm_tpu_torch.gs import traj as ttraj
from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner, depth_loss

LRS = {"means": 1.6e-4, "scales": 5e-3, "quats": 1e-3, "opacities": 5e-2,
       "sh0": 2.5e-3, "shN": 2.5e-3 / 20}   # make_optimizer's defaults
AUX_LRS = {"pose": 1e-5, "app": 1e-3, "bilgrid": 2e-3}   # GSConfig's


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(got, want, rel, name=""):
    """|got - want| <= rel * max|want| elementwise."""
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


def _adam_state(opt_state, field):
    """optax's ScaleByAdamState of one group of make_optimizer's
    partition."""
    return opt_state.inner_states[field].inner_state[0]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gs_opts_scene"))
    chip_smoke.make_gs_scene(root, "cpu", 120, 6, 96, 72)
    return root


@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    """Seeded random LPIPS weights in the npz layout, from the port's
    ``random_weights``."""
    path = str(tmp_path_factory.mktemp("lpips") / "alex.npz")
    np.savez(path, **tlpips.random_weights(torch.Generator().manual_seed(0)))
    return path


# ------------------------------------------------------- selective Adam

def test_selective_adam_matches_optax():
    """Three masked updates of make_optimizer, each on another visibility
    mask: parameters within 1e-4 of each group's lr and moments within
    1e-6 of their max (float32 rounding of m / (sqrt(v) + eps)); rows
    unseen in a step keep their parameters and both moments bit for bit,
    in both packages."""
    rng = np.random.default_rng(0)
    N, scene_scale, max_steps = 40, 2.0, 10
    shapes = {"means": (N, 3), "scales": (N, 3), "quats": (N, 4),
              "opacities": (N,), "sh0": (N, 1, 3), "shN": (N, 3, 3)}
    params = {f: rng.standard_normal(s).astype(np.float32)
              for f, s in shapes.items()}
    tx = joptim.selective(jsp.make_optimizer(scene_scale, max_steps=max_steps))
    jparams = {f: jnp.asarray(v) for f, v in params.items()}
    jstate = tx.init(jparams)
    jupdate = jax.jit(lambda g, st, p, vis: tx.update(g, st, p, visible=vis))
    tparams = {f: torch.tensor(v, requires_grad=True)
               for f, v in params.items()}
    opt = tsp.make_optimizer(tparams, scene_scale, max_steps=max_steps)
    for k in range(3):
        visible = rng.uniform(size=N) < 0.6
        grads = {f: rng.standard_normal(v.shape).astype(np.float32)
                 for f, v in params.items()}
        before = {f: _np(p).copy() for f, p in tparams.items()}
        jbefore = {f: _np(p).copy() for f, p in jparams.items()}
        mom_before = {f: [_np(opt.state[p][m]).copy() for m in toptim.MOMENTS]
                      if opt.state.get(p) else None
                      for f, p in tparams.items()}
        ups, jstate = jupdate({f: jnp.asarray(g) for f, g in grads.items()},
                              jstate, jparams, jnp.asarray(visible))
        jparams = optax.apply_updates(jparams, ups)
        for f, p in tparams.items():
            p.grad = torch.tensor(grads[f])
        tsp.set_lr(opt, k)
        toptim.selective_step(opt, torch.tensor(visible))
        for f, p in tparams.items():
            lr = LRS[f] * (scene_scale * 0.01 ** (k / max_steps)
                           if f == "means" else 1.0)
            np.testing.assert_allclose(_np(p), _np(jparams[f]), rtol=0,
                                       atol=1e-4 * lr, err_msg=f)
            np.testing.assert_array_equal(_np(p)[~visible],
                                          before[f][~visible])
            np.testing.assert_array_equal(_np(jparams[f])[~visible],
                                          jbefore[f][~visible])
            st = opt.state[p]
            for m, jm, j in zip(toptim.MOMENTS, ("mu", "nu"), range(2)):
                want = _np(getattr(_adam_state(jstate, f), jm)[f])
                got = _np(st[m])
                _close(got, want, 1e-6, f"{f} {m}")
                old = (np.zeros_like(got) if mom_before[f] is None
                       else mom_before[f][j])
                np.testing.assert_array_equal(got[~visible], old[~visible])
            assert int(st["step"]) == k + 1


def test_selective_adam_moments_reach_zero_moments():
    """``strategy.zero_moments`` zeroes the entries the selective step
    keeps: the optimizer's state is the same objects."""
    p = torch.ones((5, 3), requires_grad=True)
    opt = torch.optim.Adam([{"params": [p]}], lr=0.1)
    p.grad = torch.ones((5, 3))
    vis = torch.tensor([True, False, True, True, False])
    toptim.selective_step(opt, vis)
    assert (opt.state[p]["exp_avg"][~vis] == 0).all()
    assert (opt.state[p]["exp_avg"][vis] != 0).all()
    tst.zero_moments(opt, torch.tensor([True, False, False, False, False]))
    assert (opt.state[p]["exp_avg"][0] == 0).all()
    assert (opt.state[p]["exp_avg_sq"][2:4] != 0).all()


# ----------------------------------------------- pose and appearance

def test_pose_adjust_matches_jax():
    """float64: camtoworld @ T and the gradient of the inverse's entries
    w.r.t. the 9 deltas, through ``torch.linalg.inv`` (rel 1e-12)."""
    rng = np.random.default_rng(1)
    deltas = 0.1 * rng.standard_normal((4, 9))
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    c2w[:3, 3] = rng.standard_normal(3)
    weight = rng.standard_normal((4, 4))

    def jf(d):
        M = jcam.apply_pose_adjust({"pose_deltas": d}, jnp.asarray(c2w), 2)
        return jnp.sum(jnp.linalg.inv(M) * weight), M

    (jv, jM), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(deltas))
    m = tcam.CameraOptModule(4).double()
    with torch.no_grad():
        m.pose_deltas.copy_(torch.tensor(deltas))
    M = m(torch.tensor(c2w), 2)
    tv = torch.sum(torch.linalg.inv(M) * torch.tensor(weight))
    tv.backward()
    _close(M, jM, 1e-12, "camtoworld")
    assert abs(tv.item() - float(jv)) <= 1e-12 * abs(float(jv))
    _close(m.pose_deltas.grad, jg, 1e-12, "grad")
    assert not _np(m.pose_deltas.grad)[[0, 1, 3]].any()


def test_appearance_matches_jax():
    """JAX's ``init_appearance`` weights loaded through
    ``convert.gs_aux_from_numpy``; the MLP output in float64 within rel
    1e-12 (the port's float32 module cast to float64)."""
    rng = np.random.default_rng(2)
    params = jcam.init_appearance(5, embed_dim=16, sh_degree=2)
    params = {k: np.asarray(v) for k, v in params.items()}
    params["embeds"] = rng.standard_normal(params["embeds"].shape)
    params["b1"] = rng.standard_normal(params["b1"].shape)
    feats = rng.standard_normal((30, 32))
    dirs = rng.standard_normal((30, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    m = convert.gs_aux_from_numpy({"app": params}, device="cpu")["app"]
    assert m.w1.shape == params["w1"].shape
    got = m.double()(torch.tensor(feats), 3, torch.tensor(dirs), 2)
    # the loaded weights are float32: compare with JAX on the same values
    want32 = jcam.apply_appearance(
        {k: jnp.asarray(np.asarray(v, np.float32), jnp.float64)
         for k, v in params.items()},
        jnp.asarray(feats), 3, jnp.asarray(dirs), 2)
    _close(got, want32, 1e-12)


# -------------------------------------------------------- bilateral grid

def _grid_and_rgb(rng, n=3, gh=5, gw=6, gg=4, H=13, W=17):
    grids = np.asarray(jbil.init_bilateral_grid(n, gw, gh, gg)["grids"],
                       np.float64)
    grids = grids + 0.1 * rng.standard_normal(grids.shape)
    rgb = rng.uniform(0, 1, (H, W, 3))
    rgb[0, :5] = 0.0                      # luminance 0: the clip's low tie
    rgb[1, :5] = 1.0                      # luminance 1: the high tie
    rgb[2, :5] = 1.0 / (gg - 1)           # on a grid plane
    return grids, rgb


def test_slice_grid_and_tv_match_jax():
    """float64: the sliced image, the TV term and the gradients of a
    weighted sum w.r.t. rgb and the grids (rel 1e-12), pixels on the
    luminance clip's ties included (their gradient halved in both)."""
    rng = np.random.default_rng(3)
    grids, rgb = _grid_and_rgb(rng)
    weight = rng.standard_normal(rgb.shape)

    def jf(g, x):
        out = jbil.slice_grid({"grids": g}, 1, x)
        return (jnp.sum(out * weight)
                + 10.0 * jbil.total_variation_loss({"grids": g})), out

    (jv, jout), (jgg, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jnp.asarray(grids),
                                           jnp.asarray(rgb))
    g = torch.tensor(grids, requires_grad=True)
    x = torch.tensor(rgb, requires_grad=True)
    out = tbil.slice_grid(g, 1, x)
    tv = torch.sum(out * torch.tensor(weight)) \
        + 10.0 * tbil.total_variation_loss(g)
    tv.backward()
    _close(out, jout, 1e-12, "sliced")
    assert abs(tv.item() - float(jv)) <= 1e-12 * abs(float(jv))
    _close(g.grad, jgg, 1e-12, "d grids")
    _close(x.grad, jgx, 1e-12, "d rgb")
    m = tbil.BilateralGrid(3, 6, 5, 4)
    np.testing.assert_array_equal(
        _np(m.grids),
        np.asarray(jbil.init_bilateral_grid(3, 6, 5, 4)["grids"]))


def test_slice_grid_float32_at_render_size():
    """float32 at 800x608 (the card's shape) against JAX's float64 on the
    same inputs: within 1e-5 of the max (the float32 linspace and
    products)."""
    rng = np.random.default_rng(4)
    grids, rgb = _grid_and_rgb(rng, n=1, gh=16, gw=16, gg=8, H=608, W=800)
    want = jbil.slice_grid({"grids": jnp.asarray(grids)}, 0, jnp.asarray(rgb))
    got = tbil.slice_grid(torch.tensor(grids, dtype=torch.float32), 0,
                          torch.tensor(rgb, dtype=torch.float32))
    _close(got, want, 1e-5)


# ---------------------------------------------------------- depth loss

def _options_cfg(cls, scene, out, **kw):
    # a window of 6 x 6 tiles holds the 6 x 5 tiles of the view, so JAX's
    # fixed budget cuts no pair, as the port's sized windows cut none
    base = dict(data_dir=scene, result_dir=out, max_steps=3, test_every=3,
                sh_degree=1, sh_degree_interval=1, tile_capacity=128,
                tiles_per_gauss=36, eval_steps=(), save_steps=(),
                capacity_mult=2.0, init_opa=0.5)
    base.update(kw)
    return cls(**base)


def test_depth_loss_and_gradients_match_jax(scene, tmp_path, monkeypatch):
    """One view's training loss with the depth term, JAX's ``Runner._loss``
    with its rasterizer on the Pallas route (interpret mode) against the
    port's ``Runner._loss`` through K3's plain version: the loss within rel
    1e-5 and the gradients w.r.t. the splat fields within 1e-4 of each
    field's max (float32 compositing in other summation orders).  The
    quaternions are left out: the initial gaussians are isotropic, so
    their quaternion gradients are float noise (``test_torch_gs_train.py``
    says the same of the Runner).  The depth term is active, and the
    gradient K3 receives has nonzero alpha and depth rows."""
    orig = jras.rasterize
    monkeypatch.setattr(jras, "rasterize",
                        lambda *a, **k: orig(*a, use_pallas=True, **k))
    jr = JRunner(_options_cfg(JGSConfig, scene, str(tmp_path / "j"),
                              depth_loss=True), log=lambda *a: None)
    tr = Runner(_options_cfg(GSConfig, scene, str(tmp_path / "t"),
                             depth_loss=True), log=lambda *a: None,
                device="cpu")
    v = jr.trainset[1]
    tv = tr._prepare(tr.trainset[1])
    assert v["image_id"] == tv["image_id"]
    batch = {"image": jnp.asarray(v["image"]),
             "K": jnp.asarray(v["K"], jnp.float32),
             "camtoworld": jnp.asarray(v["camtoworld"], jnp.float32),
             "image_id": jnp.asarray(v["image_id"]),
             "points": jnp.asarray(_np(tv["points"])),
             "depths": jnp.asarray(_np(tv["depths"])),
             "points_valid": jnp.asarray(_np(tv["points_valid"]))}
    fp = jsp.float_params(jr.splats)
    offset = jnp.zeros((fp["means"].shape[0], 2), jnp.float32)

    def jl(fp):
        sp = jsp.with_float_params(jr.splats, fp)
        return jr._loss(sp, {}, batch, offset, 1, jax.random.PRNGKey(0))[0]

    jv, jg = jax.jit(jax.value_and_grad(jl))(fp)

    captured = []
    bwd = tcomp.composite_bwd_reference
    monkeypatch.setattr(tcomp, "composite_bwd_reference",
                        lambda *a: captured.append(a[2]) or bwd(*a))
    loss, (out, _, _) = tr._loss(tr.splats, tv, None, 1)
    loss.backward()
    assert abs(loss.item() - float(jv)) <= 1e-5 * abs(float(jv))
    for f in tsp.FLOAT_FIELDS:
        if f != "quats":
            assert np.abs(_np(jg[f])).max() > 0, f
            _close(getattr(tr.splats, f).grad, jg[f], 1e-4, f)
    term = depth_loss(out, tv["points"], tv["depths"], tv["points_valid"])
    assert term.item() > 0
    (gout,) = captured
    assert gout[:, 3].abs().max() > 0 and gout[:, 4].abs().max() > 0


# ---------------------------------------------------------------- MCMC

def _mcmc_setup():
    rng = np.random.default_rng(5)
    N, P = 128, 90
    pts = rng.uniform(-1, 1, (P, 3))
    js = jsp.init_splats(pts, rng.uniform(0, 1, (P, 3)), N, sh_degree=1)
    opac = np.array(js.opacities)
    opac[:P] = rng.normal(-2.0, 1.5, P)
    opac[5:15] = -8.0                     # dead: relocated
    js = js._replace(opacities=jnp.asarray(opac))
    ts = convert.splats_from_numpy({f: np.asarray(v) for f, v in
                                    js._asdict().items()}, device="cpu")
    tx = jsp.make_optimizer(1.0)
    fp = jsp.float_params(js)
    grads = {f: rng.standard_normal(v.shape).astype(np.float32)
             for f, v in fp.items()}
    ups, jstate = tx.update({f: jnp.asarray(g) for f, g in grads.items()},
                            tx.init(fp), fp)
    js = jsp.with_float_params(js, optax.apply_updates(fp, ups))
    tp = tsp.float_params(ts)
    for f, p in tp.items():
        p.requires_grad_(True)
        p.grad = torch.tensor(grads[f])
    opt = tsp.make_optimizer(tp, 1.0)
    tsp.set_lr(opt, 0)
    opt.step()
    return js, jstate, ts, opt


def test_mcmc_relocate_matches_jax():
    """JAX's relocation against the port's fed JAX's own draws: the port's
    inverse-CDF ``choice`` on the uniforms of JAX's key gives the indices
    ``jax.random.choice(p=...)`` gives; the moved fields within 1e-6 and
    the dead rows' Adam moments zeroed as in JAX."""
    js, jstate, ts, opt = _mcmc_setup()
    key = jax.random.PRNGKey(9)
    js2, jstate2, jn = jst.mcmc_relocate(js, jstate, key, 0.005)
    N = js.alive.shape[0]
    opac = jax.nn.sigmoid(js.opacities)
    dead = js.alive & (opac < 0.005)
    probs = jnp.where(js.alive & ~dead, opac, 0.0)
    probs = probs / jnp.maximum(probs.sum(), 1e-12)
    sub = jax.random.split(key)[1]
    src = jax.random.choice(sub, N, (N,), p=probs)
    u = jax.random.uniform(sub, (N,), probs.dtype)
    got_src = tst.choice(torch.tensor(np.asarray(probs)), N,
                         uniforms=torch.tensor(np.asarray(u)))
    np.testing.assert_array_equal(_np(got_src), np.asarray(src))
    n = tst.mcmc_relocate(ts, opt, 0.005, src=torch.tensor(np.asarray(src)))
    assert n == int(jn) >= 10
    for f in tsp.FLOAT_FIELDS:
        np.testing.assert_allclose(_np(getattr(ts, f)),
                                   _np(getattr(js2, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
        for mom, jm in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            want = _np(getattr(_adam_state(jstate2, f), jm)[f])
            np.testing.assert_allclose(_np(opt.state[getattr(ts, f)][mom]),
                                       want, rtol=1e-6, atol=1e-12)
            assert not want[5:15].any() and want.any()
    np.testing.assert_array_equal(_np(ts.alive), _np(js2.alive))


def test_mcmc_noise_matches_jax():
    """The SGLD noise with JAX's normals: means within 1e-6 relative to
    the largest step; rows outside the pool do not move."""
    js, _, ts, _ = _mcmc_setup()
    key = jax.random.PRNGKey(11)
    want = jst.mcmc_noise(js, key, 1.6e-4, 5e5)
    noise = jax.random.normal(key, js.means.shape, js.means.dtype)
    before = _np(ts.means).copy()
    tst.mcmc_noise(ts, 1.6e-4, 5e5, noise=torch.tensor(np.asarray(noise)))
    step = np.abs(_np(want.means) - before).max()
    np.testing.assert_allclose(_np(ts.means), _np(want.means), rtol=0,
                               atol=1e-6 * step)
    dead = ~_np(ts.alive)
    np.testing.assert_array_equal(_np(ts.means)[dead], before[dead])
    assert (_np(ts.means)[~dead] != before[~dead]).any()


# ---------------------------------------------------------------- LPIPS

def test_lpips_matches_jax(lpips_npz, monkeypatch):
    """JAX's random weights through ``convert.lpips_from_numpy``: the
    distance of an image to itself is 0 in both; of a perturbed image,
    float32 on both sides, within 1e-5 relative; the port's random
    weights round-trip through the npz gate of both packages."""
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (2, 64, 72, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1) \
        .astype(np.float32)
    jlp = jax.jit(jlpips.lpips)
    jw = jlpips.random_weights(jax.random.PRNGKey(0), jnp.float32)
    net = convert.lpips_from_numpy({k: np.asarray(v) for k, v in jw.items()},
                                   device="cpu")
    assert float(net(torch.tensor(a), torch.tensor(a))) == 0.0
    assert float(jlp(jnp.asarray(a), jnp.asarray(a), jw)) == 0.0
    got = float(net(torch.tensor(a), torch.tensor(b)))
    want = float(jlp(jnp.asarray(a), jnp.asarray(b), jw))
    assert got > 0 and abs(got - want) <= 1e-5 * want, (got, want)
    got1 = float(net(torch.tensor(a[0]), torch.tensor(b[0])))
    assert got1 > 0 and got1 != got        # one image, [H, W, 3]

    monkeypatch.setenv("INSTANTSFM_LPIPS_WEIGHTS", lpips_npz)
    tw, jw2 = tlpips.try_load_default(), jlpips.try_load_default()
    assert sorted(tw) == sorted(jw2)
    net = convert.lpips_from_numpy(tw, device="cpu")
    got = float(net(torch.tensor(a), torch.tensor(b)))
    want = float(jlp(jnp.asarray(a), jnp.asarray(b), jw2))
    assert abs(got - want) <= 1e-5 * want
    monkeypatch.setenv("INSTANTSFM_LPIPS_WEIGHTS", lpips_npz + ".absent")
    assert tlpips.try_load_default() is None


def test_lpips_checkpoint_converters_match_jax(tmp_path):
    """A checkpoint in the ``lpips`` package's names (torchvision's trunk,
    the LPIPS heads) converts to the same npz in both packages, which the
    port's module loads with its shapes."""
    g = torch.Generator().manual_seed(1)
    sd, cin = {}, 3
    for i, (ci, (cout, k, *_)) in enumerate(zip([0, 3, 6, 8, 10],
                                                tlpips._ALEX)):
        sd[f"net.slice{i + 1}.{ci}.weight"] = torch.randn(
            (cout, cin, k, k), generator=g)
        sd[f"net.slice{i + 1}.{ci}.bias"] = torch.randn(cout, generator=g)
        sd[f"lin{i}.model.1.weight"] = torch.rand((1, cout, 1, 1),
                                                  generator=g)
        cin = cout
    pth = str(tmp_path / "alex.pth")
    torch.save(sd, pth)
    t = tlpips.load_weights(tlpips.convert_torch_checkpoint(
        pth, str(tmp_path / "t.npz")))
    j = tlpips.load_weights(jlpips.convert_torch_checkpoint(
        pth, str(tmp_path / "j.npz")))
    assert sorted(t) == sorted(j) and len(t) == 15
    for k in t:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    net = convert.lpips_from_numpy(t, device="cpu")
    torch.testing.assert_close(net.conv1.weight, sd["net.slice2.3.weight"])
    torch.testing.assert_close(net.lin4, sd["lin4.model.1.weight"].reshape(-1))


# ----------------------------------------------- compression, PLY, traj

def _pool(n=257, extra=31, sh_degree=2):
    rng = np.random.default_rng(7)
    js = jsp.init_splats(rng.uniform(-3, 3, (n, 3)), rng.uniform(0, 1, (n, 3)),
                         capacity=n + extra, sh_degree=sh_degree)
    js = js._replace(shN=jnp.asarray(
        0.1 * rng.standard_normal(js.shN.shape).astype(np.float32)))
    ts = convert.splats_from_numpy({f: np.asarray(v) for f, v in
                                    js._asdict().items()}, device="cpu")
    return js, ts


def test_compression_cross_reads_jax(tmp_path):
    """Each package reads the other's PNG planes to the same arrays
    (exactly), and both write the same ``meta.json``."""
    js, ts = _pool()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmeta = jcomp.compress_splats(js, jdir)
    tmeta = tcomp_png.compress_splats(ts, tdir)
    assert tmeta == jmeta and tmeta["n"] == 257
    with open(os.path.join(jdir, "meta.json")) as f, \
            open(os.path.join(tdir, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    want = jcomp.decompress_splats(jdir)
    for reader in (tcomp_png.decompress_splats, jcomp.decompress_splats):
        for d in (jdir, tdir):
            got = reader(d)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    alive = _np(ts.alive)
    means = _np(ts.means)[alive]
    span = means.max(0) - means.min(0)
    assert (np.abs(want["means"] - means) <= span / (2 ** 16 - 1) * 0.51
            + 1e-7).all()


def test_ply_is_byte_identical(tmp_path):
    """The same bytes from the pool and from a checkpoint."""
    js, ts = _pool(sh_degree=3)
    ckpt = str(tmp_path / "ckpt.npz")
    np.savez(ckpt, step=1, **convert.splats_to_numpy(ts))
    paths = [str(tmp_path / f"{n}.ply") for n in ("j", "t", "tc")]
    jply.export_ply(paths[0], *(np.asarray(getattr(js, f)) for f in
                                ("means", "scales", "quats", "opacities",
                                 "sh0", "shN", "alive")))
    tply.export_ply(paths[1], *(_np(getattr(ts, f)) for f in
                                ("means", "scales", "quats", "opacities",
                                 "sh0", "shN", "alive")))
    tply.export_ply_from_checkpoint(ckpt, paths[2])
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] == data[2]
    assert b"element vertex 257\n" in data[0]


def test_trajectories_match_jax():
    """The interpolated, ellipse and spiral paths within 1e-12."""
    rng = np.random.default_rng(8)
    c2w = np.tile(np.eye(4), (12, 1, 1))
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, 12, endpoint=False)):
        c = np.array([4 * np.cos(ang), 3 * np.sin(ang), 1 + 0.1 * i])
        z = -c / np.linalg.norm(c)
        x = np.cross(z, [0, 0, 1.0])
        x /= np.linalg.norm(x)
        c2w[i, :3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2w[i, :3, 3] = c + 0.01 * rng.standard_normal(3)
    for t, j, args in ((ttraj.generate_interpolated_path,
                        jtraj.generate_interpolated_path, (c2w[::3], 5)),
                       (ttraj.generate_ellipse_path,
                        jtraj.generate_ellipse_path, (c2w, 20)),
                       (ttraj.generate_spiral_path,
                        jtraj.generate_spiral_path, (c2w, 20))):
        got, want = t(*args), j(*args)
        assert got.shape == want.shape and got.shape[1:] == (4, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# --------------------------------------------------------------- Runner

def test_runner_three_steps_with_options_match_jax(scene, tmp_path,
                                                   lpips_npz, monkeypatch):
    """The whole slice: three Runner steps with pose_opt, app_opt, the
    bilateral grid, the depth loss, selective Adam, PNG compression at the
    step-3 eval and pose noise, in both packages from one start (JAX's
    auxiliary parameters loaded through ``convert.gs_aux_from_numpy``); SH
    degree 0 in the steps (one JAX compile; ``test_torch_gs_train.py``
    trains at degree 1), 1 in the eval.
    Per-step losses within rel 1e-5; the splats within 0.05 of each group's
    lr as in ``test_torch_gs_train.py`` (quaternions 6 lr), the auxiliary
    parameters within 0.05 of their lr (Adam moves an element by up to
    about lr a step); the appearance MLP moved by weight decay alone, as
    in JAX; val PSNR, SSIM and LPIPS within rel 1e-4; the compressed
    models within one quantisation step.

    The bilateral grids: 99.5% of the cells within 0.05 lr (measured
    99.87%, the 99th percentile at 3.5e-7 lr) and all within the 6 lr of
    three Adam steps.  The others sit on the luminance plane 0 of the
    image's right edge, fed by black background pixels only, whose SSIM
    gradient is float cancellation noise (the variance of a flat patch)
    that Adam scales to steps of either sign; JAX under x64 computes that
    slice in float64 (its linspace), the port in float32."""
    monkeypatch.setenv("INSTANTSFM_LPIPS_WEIGHTS", lpips_npz)
    kw = dict(pose_opt=True, app_opt=True, use_bilateral_grid=True,
              depth_loss=True, visible_adam=True, compression="png",
              pose_noise=0.01, eval_steps=(3,), sh_degree_interval=10)
    jr = JRunner(_options_cfg(JGSConfig, scene, str(tmp_path / "jax"), **kw),
                 log=lambda *a: None)
    tr = Runner(_options_cfg(GSConfig, scene, str(tmp_path / "port"), **kw),
                log=lambda *a: None, device="cpu")
    aux0 = {k: {n: np.asarray(v) for n, v in p.items()}
            for k, p in jr.aux_params.items()}
    for k, m in convert.gs_aux_from_numpy(aux0, device="cpu").items():
        tr.aux[k].load_state_dict(m.state_dict())
    np.testing.assert_array_equal(tr.parser.camtoworlds,
                                  jr.parser.camtoworlds)
    assert len(tr.trainset[0]["points"]) > 0          # the depth loss reads

    j_losses, t_losses = jr.train(), tr.train()
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    np.testing.assert_array_equal(_np(tr.splats.alive), _np(jr.splats.alive))
    for f in tsp.FLOAT_FIELDS:
        lr = LRS[f] * (tr.scene_scale if f == "means" else 1.0)
        diff = np.abs(_np(getattr(tr.splats, f)) - _np(getattr(jr.splats, f)))
        assert diff.max() <= (6 if f == "quats" else 0.05) * lr, (
            f, diff.max() / lr)
    for k, params in jr.aux_params.items():
        mod = tr.aux[k]
        for name, want in params.items():
            got = _np(getattr(mod, name))
            moved = np.abs(np.asarray(want) - aux0[k][name]).max()
            diff = np.abs(got - np.asarray(want)) / AUX_LRS[k]
            if k == "bilgrid":
                assert diff.max() <= 6 and np.mean(diff <= 0.05) >= 0.995, (
                    diff.max(), np.mean(diff <= 0.05))
            else:
                assert diff.max() <= 0.05, (k, name, diff.max())
            if name in ("w1", "w2"):
                assert moved > 0.5 * AUX_LRS[k]        # weight decay's Adam
            if name in ("embeds", "b1", "b2"):
                assert moved == 0
    assert np.abs(_np(tr.aux["pose"].pose_deltas)).max() > 0
    tstats, jstats = tr.stats[3], jr.stats[3]
    assert sorted(tstats) == sorted(jstats) == ["lpips", "num_GS", "psnr",
                                                "ssim"]
    for k in ("psnr", "ssim", "lpips"):
        assert abs(tstats[k] - jstats[k]) <= 1e-4 * abs(jstats[k]), k
    got = tcomp_png.decompress_splats(str(tmp_path / "port" / "compression"
                                          / "step3"))
    want = jcomp.decompress_splats(str(tmp_path / "jax" / "compression"
                                       / "step3"))
    for k in want:
        a = got[k].reshape(len(got[k]), -1)
        b = want[k].reshape(len(want[k]), -1)
        span = np.maximum(b.max(0) - b.min(0), 1e-9)
        step = span / (2 ** 16 - 1 if k == "means" else 255)
        lr = LRS[k] * (tr.scene_scale if k == "means" else 1.0)
        assert (np.abs(a - b) <= 1.01 * step
                + (6 if k == "quats" else 0.05) * lr).all(), k


def test_runner_mcmc_relocates_and_keeps_the_pool(scene, tmp_path):
    """``strategy="mcmc"``: no refine and no opacity reset; the relocation
    runs on its cadence and moves the low-opacity rows; noise moves alive
    rows only, so the rows outside the pool never change.  The render keeps
    a 4 x 4 window of tiles a gaussian (the JAX package's budget), under
    which some row is below ``min_opacity`` at both relocations."""
    tr = Runner(_options_cfg(GSConfig, scene, str(tmp_path), max_steps=5,
                             strategy="mcmc", init_opa=0.1,
                             tiles_per_gauss=16),
                log=lambda *a: None, device="cpu")
    tr.mcmc_cfg = tst.MCMCConfig(refine_start_iter=2, refine_every=2,
                                 min_opacity=0.099)
    alive = _np(tr.splats.alive)
    outside = _np(tr.splats.means)[~alive].copy()
    losses = tr.train()
    assert np.all(np.isfinite(losses)) and not tr.refines
    assert [r["step"] for r in tr.relocations] == [2, 4]
    assert all(r["moved"] > 0 for r in tr.relocations)
    np.testing.assert_array_equal(_np(tr.splats.alive), alive)
    np.testing.assert_array_equal(_np(tr.splats.means)[~alive], outside)
