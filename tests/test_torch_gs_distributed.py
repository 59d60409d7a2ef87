"""Gaussian-sharded 3DGS (``instantsfm_tpu_torch/gs/distributed.py``) and
the Runner's distributed branch against one device and against the JAX
package.

One gloo group of two CPU processes (``tests/torch_dist.py``, a module
fixture) runs: the distributed loss and its gradients on a 96-gaussian toy
pool (JAX's ``tests/test_gs_distributed.py`` pool) over 4 views of 48x40,
each rank projecting its 48 gaussians for all views and compositing all 96
for its 2 views after the all-to-all; one train step with Adam on each
rank's shard; and a ``Runner(distributed=True)`` of 4 steps of batch 2 with
a refine at step 2 (growth and pruning over the whole pool) on
``chip_smoke.make_gs_scene``'s 120-point, 6-view scene.  This process runs
each on one device.  float32 throughout: the loss, the gradients (relative
to each field's largest), the step and the Runner's losses and pool agree
within 1e-5, but for the Runner's quaternions (``_pool_close``); the
refines grow and prune the same counts.

JAX's ``make_distributed_loss`` and ``make_distributed_train_step`` run on
the same pool and views over a mesh of two of the conftest's virtual
devices (the layout of the two ranks: each composites 2 views), through
its plain compositing as on every CPU.  The loss, the gradients, the
radii, the seen mask and the renders agree within 1e-5; the pool after one
Adam step within 1e-5, where both sides step each entry by its learning
rate times the sign of its gradient.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from instantsfm_tpu_torch.gs import rasterize as raster_mod
from instantsfm_tpu_torch.gs.projection import quat_scale_to_cov
from instantsfm_tpu_torch.gs import splats as splats_mod
from instantsfm_tpu_torch.gs import ssim as ssim_mod
from instantsfm_tpu_torch.gs.splats import FIELDS, FLOAT_FIELDS, Splats
from instantsfm_tpu_torch.gs.trainer import Runner
from tests.torch_cpu import lean_cpu  # noqa: F401  (module fixture)
from tests.torch_dist import gs_runner_cfg, run_group

W, H, SH_DEGREE, B = 48, 40, 1, 4
TOL = 1e-5


def _toy_pool(rng, G=96, sh_degree=SH_DEGREE):
    K = (sh_degree + 1) ** 2
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        means=f32(rng.uniform(-1, 1, (G, 3))),
        scales=f32(np.log(rng.uniform(0.05, 0.15, (G, 3)))),
        quats=f32(np.tile([0, 0, 0, 1.0], (G, 1))),
        opacities=f32(rng.normal(0.5, 0.2, G)),
        sh0=f32(rng.uniform(-0.5, 0.5, (G, 1, 3))),
        shN=f32(0.01 * rng.standard_normal((G, K - 1, 3))),
        alive=rng.uniform(size=G) < 0.9)


def _views():
    c2ws, Ks = [], []
    for i in range(B):
        ang = 2 * np.pi * i / B
        c = np.array([3 * np.cos(ang), 3 * np.sin(ang), 0.8])
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([x, y, z], 1)
        c2w[:3, 3] = c
        c2ws.append(c2w)
        Ks.append([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]])
    return (np.asarray(c2ws, np.float32), np.asarray(Ks, np.float32))


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    rng = np.random.default_rng(0)
    c2w, K = _views()
    scene = str(tmp_path_factory.mktemp("gs_scene"))
    chip_smoke.make_gs_scene(scene, "cpu", 120, 6, 96, 72)
    return dict(W=W, H=H, sh_degree=SH_DEGREE, pool=_toy_pool(rng), c2w=c2w,
                K=K, images=rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
                scene=scene)


@pytest.fixture(scope="module")
def group(payload, tmp_path_factory):
    return run_group(2, "gs", payload,
                     str(tmp_path_factory.mktemp("gs_group")))


def _pool(payload, grad=True):
    sp = Splats(**{k: torch.as_tensor(v).clone()
                   for k, v in payload["pool"].items()})
    for f in FLOAT_FIELDS:
        getattr(sp, f).requires_grad_(grad)
    return sp


@pytest.fixture(scope="module")
def jax_dist(payload):
    """JAX's distributed loss with its gradients (the regularizers at 0.01)
    and one distributed train step, over a two-device mesh."""
    import jax
    import jax.numpy as jnp

    from instantsfm_tpu.gs import distributed as jdist
    from instantsfm_tpu.gs import splats as jsplats

    mesh = jdist.make_mesh(jax.devices()[:2])
    pool = jdist.shard_splats(mesh, jsplats.Splats(
        **{k: jnp.asarray(v) for k, v in payload["pool"].items()}))
    images = jnp.asarray(payload["images"])
    c2w, K = jnp.asarray(payload["c2w"]), jnp.asarray(payload["K"])
    fparams = jsplats.float_params(pool)
    offset = jnp.zeros((pool.means.shape[0], 2), jnp.float32)
    loss_fn = jdist.make_distributed_loss(
        mesh, W, H, SH_DEGREE, tile_capacity=128, opacity_reg=0.01,
        scale_reg=0.01)
    (loss, (radii, seen, rgb)), (g_params, g_offset) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 2), has_aux=True))(
        fparams, pool.alive, offset, images, c2w, K)
    out = dict(loss=float(loss), g_offset=np.asarray(g_offset),
               grads={k: np.asarray(v) for k, v in g_params.items()},
               radii=np.asarray(radii), seen=np.asarray(seen),
               rgb=np.asarray(rgb))

    tx = jsplats.make_optimizer(1.0)
    step = jdist.make_distributed_train_step(mesh, tx, W, H,
                                             tile_capacity=128)
    pool, _, loss, _, _, _ = step(
        pool, tx.init(fparams),
        {"image": images, "camtoworld": c2w, "K": K}, SH_DEGREE)
    out["step"] = dict(loss=float(loss),
                       pool={k: np.asarray(getattr(pool, k)) for k in FIELDS})
    return out


def _single_loss(sp, payload, offset, opacity_reg=0.0, scale_reg=0.0):
    """The Runner's per-view loss averaged over the views, one device."""
    opac = torch.sigmoid(sp.opacities) * sp.alive
    shc = torch.cat([sp.sh0, sp.shN], 1)
    losses, outs = [], []
    for c2w, K, img in zip(payload["c2w"], payload["K"], payload["images"]):
        out = raster_mod.rasterize(
            sp.means, sp.quats, torch.exp(sp.scales), opac, shc,
            torch.linalg.inv(torch.as_tensor(c2w)), torch.as_tensor(K), W, H,
            sh_degree=SH_DEGREE, tile_capacity=128,
            background=torch.zeros(3), means2d_offset=offset)
        gt = torch.as_tensor(img)
        loss = 0.8 * torch.mean(torch.abs(out.rgb - gt)) \
            + 0.2 * (1 - ssim_mod.ssim(out.rgb, gt))
        if opacity_reg:
            loss = loss + opacity_reg * torch.mean(
                torch.abs(torch.sigmoid(sp.opacities)) * sp.alive)
        if scale_reg:
            loss = loss + scale_reg * torch.mean(
                torch.abs(torch.exp(sp.scales)) * sp.alive[:, None])
        losses.append(loss)
        outs.append(out)
    return torch.stack(losses).mean(), outs


def _assert_rel(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= TOL, (what, err)


def test_distributed_loss_and_gradients_match_one_device(group, payload):
    sp = _pool(payload)
    offset = torch.zeros((sp.means.shape[0], 2), requires_grad=True)
    loss, outs = _single_loss(sp, payload, offset, 0.01, 0.01)
    loss.backward()
    for r in group:
        assert abs(r["loss"] - loss.item()) <= TOL * loss.item()
        for f in FLOAT_FIELDS:
            _assert_rel(r["grads"][f], getattr(sp, f).grad.numpy(), f)
        _assert_rel(r["g_offset"], offset.grad.numpy(), "offset")
        np.testing.assert_array_equal(
            r["radii"],
            torch.stack([o.radii for o in outs]).amax(0).detach().numpy())
        np.testing.assert_array_equal(
            r["seen"], torch.stack([o.valid for o in outs]).any(0).numpy())
        # rank r composited views [2r, 2r + 2), gathered in rank order
        _assert_rel(r["rgb"],
                    torch.stack([o.rgb for o in outs]).detach().numpy(), "rgb")


def test_distributed_train_step_matches_one_device(group, payload):
    sp = _pool(payload)
    opt = splats_mod.make_optimizer(splats_mod.float_params(sp), 1.0)
    loss, _ = _single_loss(sp, payload, None)
    opt.zero_grad()
    loss.backward()
    opt.step()
    for r in group:
        assert abs(r["step"]["loss"] - loss.item()) <= TOL * loss.item()
        for f in FIELDS:
            np.testing.assert_allclose(r["step"]["pool"][f],
                                       getattr(sp, f).detach().numpy(),
                                       atol=TOL, rtol=0, err_msg=f)


def test_distributed_loss_and_gradients_match_jax(group, jax_dist):
    """The two ranks' loss, gradients, radii, seen mask and renders against
    JAX's sharded loss on the same two-way split."""
    for r in group:
        assert abs(r["loss"] - jax_dist["loss"]) <= TOL * jax_dist["loss"]
        for f in FLOAT_FIELDS:
            _assert_rel(r["grads"][f], jax_dist["grads"][f], f)
        _assert_rel(r["g_offset"], jax_dist["g_offset"], "offset")
        np.testing.assert_array_equal(r["radii"], jax_dist["radii"])
        np.testing.assert_array_equal(r["seen"], jax_dist["seen"])
        _assert_rel(r["rgb"], jax_dist["rgb"], "rgb")


def test_distributed_train_step_matches_jax(group, jax_dist):
    """One distributed Adam step on each rank's shard against JAX's step
    with the same learning rates (``make_optimizer`` at scene scale 1)."""
    for r in group:
        want = jax_dist["step"]
        assert abs(r["step"]["loss"] - want["loss"]) <= TOL * want["loss"]
        for f in FIELDS:
            np.testing.assert_allclose(r["step"]["pool"][f], want["pool"][f],
                                       atol=TOL, rtol=0, err_msg=f)


def _pool_close(got, want, quats_lr):
    """Pools of the Runner check: the quaternions of the initial gaussians
    (isotropic, so their gradients are float noise that Adam turns into
    steps of either sign, as ``tests/test_torch_gs_train.py`` finds) within
    the 2 lr a step allows and through the covariances they give, within
    1e-3 relative; every other field within 1e-5."""
    for f in FIELDS:
        if f != "quats":
            np.testing.assert_allclose(got[f], want[f], atol=TOL, rtol=0,
                                       err_msg=f)
    assert np.abs(got["quats"] - want["quats"]).max() <= 8 * quats_lr
    alive = want["alive"]
    cov = [quat_scale_to_cov(torch.as_tensor(p["quats"][alive]),
                             torch.exp(torch.as_tensor(p["scales"][alive])))
           .numpy().reshape(-1, 9) for p in (got, want)]
    rel = np.abs(cov[0] - cov[1]).max(1) / np.abs(cov[1]).max(1)
    assert rel.max() <= 1e-3, rel.max()


def test_runner_distributed_branch_matches_one_process(group, payload,
                                                       tmp_path):
    """Four steps with a refine over the whole pool: the same losses,
    growth and pruning, pool, eval and checkpoint as one process."""
    cfg, strategy = gs_runner_cfg(payload["scene"], str(tmp_path), False)
    runner = Runner(cfg, log=lambda *a: None, device="cpu")
    runner.strategy_cfg = strategy
    losses = runner.train()
    (ref,) = runner.refines
    assert ref["grown"] > 0 and ref["pruned"] > 0
    stats = runner.eval(4)
    ckpt = np.load(runner.save_checkpoint(4))
    (quats_lr,) = [g["lr"] for g in runner.optimizer.param_groups
                   if g["name"] == "quats"]
    for r in group:
        got = r["runner"]
        assert got["world"] == 2
        assert any("distributed rendering over 2 ranks" in m
                   for m in got["logs"])
        np.testing.assert_allclose(got["losses"], losses, rtol=TOL)
        assert got["refines"] == runner.refines
        _pool_close(got["pool"], ckpt, quats_lr)
        for k, v in stats.items():
            assert abs(got["stats"][k] - v) <= TOL * max(abs(v), 1), k
    _pool_close(np.load(group[0]["runner"]["ckpt"]), ckpt, quats_lr)


def test_runner_distributed_on_one_process_trains_on_one_device(payload,
                                                                tmp_path):
    """Without a group of several ranks ``distributed=True`` logs JAX's
    "ignored" line and trains on one device."""
    cfg, _ = gs_runner_cfg(payload["scene"], str(tmp_path), True)
    logs = []
    runner = Runner(cfg, log=logs.append, device="cpu")
    assert runner.world == 1
    assert any("distributed=True ignored" in m for m in logs)
