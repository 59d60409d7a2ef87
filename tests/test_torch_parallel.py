"""The port's multi-process LM engine (``instantsfm_tpu_torch/parallel/
sharded.py``) against one process and against the JAX package.

The host partition functions must give JAX's arrays exactly, at 2, 3 and 8
shards.  One gloo group of two CPU processes (``tests/torch_dist.py``, a
module fixture) runs, in float64 on the 10-camera scenes of
``tests/test_sharded.py``: three point-local LM steps on BA and on GP,
and ``optimize_auto`` (five LM iterations, too few for the window test, so
both sides run all five).
They are held to ``tests/test_sharded.py``'s bars: cost rtol 1e-6, points
1e-6, rotations 1e-8, GP centers 1e-7; ``optimize_auto`` to JAX's
``optimize_auto`` on the conftest's 8 virtual devices within that file's
``test_optimize_auto_*_parity`` bars (a 2-way against an 8-way split:
sums in other orders).

A second group, of four processes formed through torchrun's variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), runs the point-local steps against JAX's on 4 of the
virtual devices and one process's, ``optimize_sharded`` against one
process's ``optimize_auto`` (the bars above), ``gather_pair_results`` of 11
pairs, the replicated stages (view-graph calibration, rotation averaging)
with each rank's solves moved, which must leave rank 0's (one process's)
result on every rank, and the gaussian-sharded 3DGS loss and gradients of
4 views against one process's (float32: loss within 1e-5, gradients within
1e-4 of each field's largest) and against JAX's ``make_distributed_loss``
on 4 virtual devices (loss and gradients within 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsfm_tpu.parallel import sharded as jsh
from instantsfm_tpu.solve import block_lm as jbl
from instantsfm_tpu.solve import robust as jrobust
from instantsfm_tpu.solve.blocked import bucketize_problem as jbucketize
from instantsfm_tpu_torch import convert
from instantsfm_tpu_torch.parallel import sharded as tsh
from instantsfm_tpu_torch.solve import block_lm as tbl
from tests.synthetic import make_scene
from tests.test_block_lm import _ba_setup
from tests.test_sharded import _gp_setup
from tests.torch_cpu import lean_cpu  # noqa: F401  (module fixture)
from tests.torch_dist import lm_problem, lm_state0, run_group

STEPS = 3
WORLD4, PAIRS4 = 4, 11


def _jax_problem(kind):
    if kind == "ba":
        return _ba_setup(make_scene(num_cams=10, num_pts=120))
    return _gp_setup()


def _jax_cfg(kind):
    _, _, cfg = lm_problem(kind)
    return jbl.LMConfig(**dataclasses.asdict(cfg))


def _jax_kernel(kind):
    return jrobust.huber(1.0 if kind == "ba" else 0.1)


def _to_torch(params, obs):
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    p, o, _ = convert.from_numpy(as_np(params), as_np(obs), device="cpu",
                                 dtype=torch.float64)
    return p, o


@pytest.fixture(scope="module")
def problems():
    return {k: _jax_problem(k) for k in ("ba", "gp")}


@pytest.fixture(scope="module")
def group(problems, tmp_path_factory):
    """Every multi-process result of this file, from one group of two."""
    payload = {"steps": STEPS,
               "problems": {k: _to_torch(p, o)
                            for k, (_, p, o) in problems.items()}}
    r0, r1 = run_group(2, "lm", payload,
                       str(tmp_path_factory.mktemp("lm_group")))
    # the cameras, the cost and the gathered points are the same on both
    flat = lambda v: np.concatenate([np.ravel(v[k]) for k in sorted(v)]) \
        if isinstance(v, dict) else np.ravel(np.asarray(v, np.float64))
    for key, a in r0.items():
        for field, v in a.items():
            np.testing.assert_array_equal(
                flat(v), flat(r1[key][field]),
                err_msg=f"{key}.{field} differs between the ranks")
    return r0


@pytest.fixture(scope="module")
def single(problems):
    """Three single-process ``lm_step``s of the port, per problem."""
    out = {}
    for kind, (_, params, obs) in problems.items():
        problem, kernel, cfg = lm_problem(kind)
        tp, to = _to_torch(params, obs)
        state = lm_state0(tp, cfg)
        for _ in range(STEPS):
            state = tbl.lm_step(problem, kernel, cfg, state, to, device="cpu")
        out[kind] = state
    return out


@pytest.fixture(scope="module")
def gs_scene(tmp_path_factory):
    import chip_smoke
    scene = str(tmp_path_factory.mktemp("gs_world4"))
    chip_smoke.make_gs_scene(scene, "cpu", 600, 6, 96, 72)
    return scene


@pytest.fixture(scope="module")
def ring_db(tmp_path_factory):
    import chip_smoke
    db = str(tmp_path_factory.mktemp("ring4") / "ring.db")
    chip_smoke.write_ring_db(db, num_cams=14, num_pts=600, window=6)
    return db


@pytest.fixture(scope="module")
def group4(problems, gs_scene, ring_db, tmp_path_factory):
    """Every result of the four-process group, by rank."""
    payload = {"device": "cpu", "pairs": PAIRS4, "ring_db": ring_db,
               "lm": {k: (*_to_torch(p, o), STEPS)
                      for k, (_, p, o) in problems.items()},
               # the port's sizing, every pair kept; JAX is given budgets
               # under which it cuts nothing (below)
               "gs": dict(scene=gs_scene, sh_degree=1, tiles_per_gauss=None,
                          tile_capacity=None)}
    return run_group(WORLD4, "world", payload,
                     str(tmp_path_factory.mktemp("world4")),
                     launcher="torchrun")


def _jax_pointlocal(kind, problems, n=8):
    problem, params, obs = problems[kind]
    cfg = _jax_cfg(kind)
    mesh = jsh.make_mesh(jax.devices()[:n])
    pp, po, meta = jsh.partition_points(params, obs, n)
    pp, po = jsh.shard_problem_pointlocal(mesh, pp, po)
    state = jbl.LMState(pp, jnp.asarray(1.0 / cfg.radius_init),
                        jnp.asarray(jnp.inf))
    step = jsh.make_pointlocal_lm_step(mesh, problem, _jax_kernel(kind), cfg,
                                       state, po)
    for _ in range(STEPS):
        state = step(state, po)
    return state, meta


def _close(got, want, kind):
    """``tests/test_sharded.py``'s bars."""
    np.testing.assert_allclose(got["cost"], float(want.cost), rtol=1e-6)
    cam = convert.to_numpy(want.params.cam)
    if kind == "ba":
        np.testing.assert_allclose(got["pts"], np.asarray(want.params.pts),
                                   atol=1e-6)
        np.testing.assert_allclose(got["cam"]["q"], cam["q"], atol=1e-8)
    else:
        np.testing.assert_allclose(got["cam"]["c"], cam["c"], atol=1e-7)


# ---------------------------------------------------- host partitioning

@pytest.mark.parametrize("n", [2, 3, 8])
def test_partition_functions_match_jax(problems, n):
    """``partition_points``, ``unpartition_*`` and ``partition_bucketed``
    give JAX's arrays exactly."""
    _, params, obs = problems["gp"]
    tp, to = _to_torch(params, obs)
    jp, jo, jmeta = jsh.partition_points(params, obs, n)
    pp, po, meta = tsh.partition_points(tp, to, n)
    for a, b in ((jmeta.bounds, meta.bounds),
                 (jmeta.obs_bounds, meta.obs_bounds)):
        np.testing.assert_array_equal(a, b)
    assert (jmeta.T_pad, jmeta.O_pad) == (meta.T_pad, meta.O_pad)
    for a, b in ((jp.pts, pp.pts), (jp.scales, pp.scales),
                 (jp.scales_free, pp.scales_free), (jo.cam_idx, po.cam_idx),
                 (jo.pt_idx, po.pt_idx), (jo.valid, po.valid),
                 *((jo.data[k], po.data[k]) for k in jo.data)):
        np.testing.assert_array_equal(np.asarray(a), convert.to_numpy(b))
    np.testing.assert_array_equal(
        jsh.unpartition_points(jp.pts, jmeta),
        tsh.unpartition_points(pp.pts, meta))
    np.testing.assert_array_equal(
        jsh.unpartition_scales(jp.scales, jmeta),
        tsh.unpartition_scales(pp.scales, meta))

    # the same bucketed problem through both partitions
    pad = -(-max(16, n) // n) * n
    bp, bo, buckets, _ = jbucketize(params, obs, track_pad=pad)
    tbp, tbo = _to_torch(bp, bo)
    jp, jo, jm = jsh.partition_bucketed(bp, bo, buckets, n)
    pp, po, m = tsh.partition_bucketed(tbp, tbo, buckets, n)
    np.testing.assert_array_equal(jm.pt_take, m.pt_take)
    np.testing.assert_array_equal(jm.obs_take, m.obs_take)
    assert jm.local_buckets == m.local_buckets
    assert (jm.local_T, jm.local_O) == (m.local_T, m.local_O)
    for a, b in ((jp.pts, pp.pts), (jp.scales, pp.scales),
                 (jo.cam_idx, po.cam_idx), (jo.pt_idx, po.pt_idx),
                 (jo.valid, po.valid), (jo.data["tx"], po.data["tx"])):
        np.testing.assert_array_equal(np.asarray(a), convert.to_numpy(b))


# ------------------------------------------------------ sharded LM steps

@pytest.mark.parametrize("kind", ["ba", "gp"])
def test_pointlocal_step_matches_single_and_jax(group, single, problems,
                                                kind):
    """Three point-local steps at world size 2 against three single-process
    steps of the port and three of JAX's point-local step on 8 devices."""
    got = group[f"{kind}_pointlocal"]
    _close(got, single[kind], kind)
    jstate, jmeta = _jax_pointlocal(kind, problems)
    np.testing.assert_allclose(got["cost"], float(jstate.cost), rtol=1e-6)
    if kind == "ba":
        np.testing.assert_allclose(
            got["pts"], jsh.unpartition_points(jstate.params.pts, jmeta),
            atol=1e-6)
        np.testing.assert_allclose(got["cam"]["q"],
                                   np.asarray(jstate.params.cam["q"]),
                                   atol=1e-8)
    else:
        np.testing.assert_allclose(got["cam"]["c"],
                                   np.asarray(jstate.params.cam["c"]),
                                   atol=1e-7)


@pytest.mark.parametrize("kind", ["ba", "gp"])
def test_optimize_auto_matches_jax(group, problems, kind, monkeypatch):
    """``optimize_auto`` over the group of two against JAX's over its 8
    virtual devices (bucketed, point-local, five LM iterations)."""
    problem, params, obs = problems[kind]
    monkeypatch.delenv("ISFM_NO_SHARD", raising=False)
    cam, pts, hist = jsh.optimize_auto(problem, _jax_kernel(kind),
                                       _jax_cfg(kind), params, obs)
    got = group[f"{kind}_auto"]
    assert len(got["history"]) == len(hist)
    if kind == "ba":
        np.testing.assert_allclose(got["pts"], np.asarray(pts), atol=1e-8)
        np.testing.assert_allclose(got["cam"]["q"], np.asarray(cam["q"]),
                                   atol=1e-10)
        np.testing.assert_allclose(got["cam"]["t"], np.asarray(cam["t"]),
                                   atol=1e-8)
    else:
        np.testing.assert_allclose(got["pts"], np.asarray(pts), atol=1e-7)
        np.testing.assert_allclose(got["cam"]["c"], np.asarray(cam["c"]),
                                   atol=1e-8)


def test_initialize_through_torchrun_variables(group4):
    """``initialize`` read torchrun's variables: four ranks in order, each
    with its ``LOCAL_RANK``, over gloo on the CPU, no ``ISFM_*`` set; a
    second call changes nothing."""
    for r, out in enumerate(group4):
        assert (out["rank"], out["world"]) == (r, WORLD4)
        assert out["local_rank"] == str(r)
        assert out["backend"] == "gloo" and out["again"]
        assert not out["isfm_env"]


def test_gather_pair_results_at_world4(group4):
    """11 pairs over 4 ranks: strided slices of 3, 3, 3 and 2, padded to
    the longest, reassembled in order on every rank."""
    assert [len(out["mine"]) for out in group4] == [3, 3, 3, 2]
    for out in group4:
        np.testing.assert_array_equal(
            out["mine"], np.arange(out["rank"], PAIRS4, WORLD4))
        np.testing.assert_array_equal(
            out["gathered"],
            np.arange(PAIRS4)[:, None] * 10 + np.arange(3))


@pytest.mark.parametrize("kind", ["ba", "gp"])
def test_pointlocal_step_world4_matches_single_and_jax(group4, single,
                                                       problems, kind):
    """Three point-local steps at world size 4 against three
    single-process steps of the port and three of JAX's point-local step
    on 4 virtual devices (the same partition)."""
    got = group4[0][f"{kind}_pointlocal"]
    for out in group4[1:]:
        np.testing.assert_array_equal(out[f"{kind}_pointlocal"]["pts"],
                                      got["pts"])
    _close(got, single[kind], kind)
    jstate, jmeta = _jax_pointlocal(kind, problems, WORLD4)
    np.testing.assert_allclose(got["cost"], float(jstate.cost), rtol=1e-6)
    if kind == "ba":
        np.testing.assert_allclose(
            got["pts"], jsh.unpartition_points(jstate.params.pts, jmeta),
            atol=1e-6)
        np.testing.assert_allclose(got["cam"]["q"],
                                   np.asarray(jstate.params.cam["q"]),
                                   atol=1e-8)
    else:
        np.testing.assert_allclose(got["cam"]["c"],
                                   np.asarray(jstate.params.cam["c"]),
                                   atol=1e-7)


@pytest.mark.parametrize("kind", ["ba", "gp"])
def test_optimize_sharded_world4_matches_one_process(group4, problems,
                                                     kind):
    """``optimize_sharded`` over four ranks (bucketing with the track pad
    rounded to 4, the cameras broadcast from rank 0, the points gathered
    back) against one process's ``optimize_auto`` on the whole problem:
    the same LM iterations, and ``test_optimize_auto_matches_jax``'s
    bars."""
    problem, kernel, cfg = lm_problem(kind)
    tp, to = _to_torch(*problems[kind][1:])
    cam, pts, hist = tsh.optimize_auto(problem, kernel, cfg, tp, to,
                                       device="cpu")
    got = group4[0][f"{kind}_sharded"]
    assert len(got["history"]) == len(hist)
    pts, cam = convert.to_numpy(pts), convert.to_numpy(cam)
    if kind == "ba":
        np.testing.assert_allclose(got["pts"], pts, atol=1e-8)
        np.testing.assert_allclose(got["cam"]["q"], cam["q"], atol=1e-10)
        np.testing.assert_allclose(got["cam"]["t"], cam["t"], atol=1e-8)
    else:
        np.testing.assert_allclose(got["pts"], pts, atol=1e-7)
        np.testing.assert_allclose(got["cam"]["c"], cam["c"], atol=1e-8)


def test_replicated_stages_take_rank0_result(group4, ring_db):
    """View-graph calibration and rotation averaging run whole on every
    rank, whose float atomics on a card move their solves' last bits; each
    rank here moves them by its rank, and every rank still ends with rank
    0's focal lengths, rotations and valid pairs, which are one process's
    (the host's thresholds and the sharded solves' problems that follow
    must be the same on every rank)."""
    from tests.torch_dist import replicated_stages
    want = replicated_stages(ring_db, "cpu")
    for out in group4:
        for k, v in want.items():
            np.testing.assert_array_equal(out["replicated"][k], v, err_msg=k)


def test_distributed_gs_world4_matches_one_process(group4):
    """The gaussian-sharded 3DGS loss of 4 views (one a rank after the
    all-to-all) and its gathered gradients against one process's
    (``chip_smoke.gs_shard_check``, each rank's own single-device loss of
    the 4 views): the same loss and gradients on every rank."""
    want = group4[0]["gs"]
    for out in group4:
        got = out["gs"]
        assert abs(got["loss_dist"] - got["loss_single"]) \
            <= 1e-5 * got["loss_single"]
        assert max(got["grad_rel"].values()) <= 1e-4, got["grad_rel"]
        assert got["loss_single"] == want["loss_single"]
        for f, g in got["grads_dist"].items():
            np.testing.assert_array_equal(g, want["grads_dist"][f],
                                          err_msg=f)


def test_distributed_gs_world4_matches_jax(group4):
    """The four ranks' gaussian-sharded loss and gathered gradients against
    JAX's ``make_distributed_loss`` on a mesh of 4 of the conftest's
    virtual devices, from rank 0's pool and views (the same four-way split
    of the pool and one view a device): loss and gradients within 1e-5
    (the gradients relative to each field's largest), as
    ``tests/test_torch_gs_distributed.py`` holds them at world 2."""
    from instantsfm_tpu.gs import distributed as jdist
    from instantsfm_tpu.gs import splats as jsplats

    got, views = group4[0]["gs"], group4[0]["gs"]["views"]
    pool = jsplats.Splats(**{k: jnp.asarray(v)
                             for k, v in got["pool"].items()})
    G = pool.means.shape[0]
    mesh = jdist.make_mesh(jax.devices()[:WORLD4])
    pool = jdist.shard_splats(mesh, jdist.pad_splats(pool, WORLD4))
    H, W = views["image"].shape[1:3]
    # a window of every tile (6 x 5 of them) and a slot for every row of
    # the pool: JAX cuts no pair, as the port cuts none
    loss_fn = jdist.make_distributed_loss(
        mesh, W, H, 1, tiles_per_gauss=36,
        tile_capacity=-(-pool.means.shape[0] // 128) * 128)
    offset = jnp.zeros((pool.means.shape[0], 2), jnp.float32)
    (loss, _), (g_params, g_offset) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 2), has_aux=True))(
        jsplats.float_params(pool), pool.alive, offset,
        jnp.asarray(views["image"]), jnp.asarray(views["camtoworld"]),
        jnp.asarray(views["K"]))
    want = {k: np.asarray(v)[:G] for k, v in g_params.items()}
    want["offset"] = np.asarray(g_offset)[:G]
    for out in group4:
        assert abs(out["gs"]["loss_dist"] - float(loss)) \
            <= 1e-5 * float(loss)
    for f, g in want.items():
        err = np.abs(got["grads_dist"][f] - g).max()
        assert err <= 1e-5 * max(np.abs(g).max(), 1e-30), (f, err)


def test_lm_step_under_a_group_needs_a_named_solver(problems):
    """Under a process group "auto" would choose dense or PCG from the
    rank's own point count; ``lm_step`` refuses it before any collective."""
    problem, kernel, cfg = lm_problem("ba")
    tp, to = _to_torch(*problems["ba"][1:])
    with pytest.raises(ValueError, match="auto"):
        tbl.lm_step(problem, kernel, dataclasses.replace(cfg, solver="auto"),
                    lm_state0(tp, cfg), to, device="cpu", group=object())
