"""Process groups of the port's CPU tests: one spawner and the scenarios
its worker processes run.

``run_group(world, scenario, payload, tmp)`` starts ``world`` processes of
``python tests/torch_dist.py`` (by its path: an installed package named
``tests`` would shadow this directory's); each joins a group through the ``ISFM_*``
environment, or through torchrun's (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) with ``launcher="torchrun"``
(``parallel.multihost.initialize``, 60 s timeout on every collective;
gloo, or NCCL with one card a rank where ``payload["device"]`` is
``"cuda"``), runs ``SCENARIOS[scenario](payload, tmp)`` and pickles its
result.  This module imports torch, the port and ``chip_smoke`` only,
never JAX, so a worker starts in about two seconds.  Workers run torch on one thread: the
ops are small, and beside the suite's other workers torch's thread team
spins (``tests/torch_cpu.py``).
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLECTIVE_TIMEOUT_S = 60.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(world: int, scenario: str, payload, tmp: str,
              timeout: float = 300.0, launcher: str = "isfm"):
    """Results of ``scenario`` on every rank of a group of ``world``
    processes, in rank order.  A worker that fails, or a group that does
    not end within ``timeout`` seconds, fails the caller with the
    workers' output."""
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("ISFM_NO_SHARD", None)
    port = str(_free_port())
    if launcher == "torchrun":
        ranks = [dict(MASTER_ADDR="localhost", MASTER_PORT=port,
                      WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))
                 for r in range(world)]
    else:
        ranks = [dict(ISFM_COORDINATOR=f"localhost:{port}",
                      ISFM_NUM_PROCESSES=str(world), ISFM_PROCESS_ID=str(r))
                 for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, tmp],
        env=dict(env, **ranks[r]), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {scenario} exited "
                                 f"{p.returncode}:\n{out[-6000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _np(x):
    from instantsfm_tpu_torch.convert import to_numpy
    return to_numpy(x)


# ------------------------------------------------------------ scenarios

def lm_problem(kind):
    """(problem, kernel, cfg) of the sharded LM checks: BA (SIMPLE_RADIAL,
    Huber 1) or GP (Huber 0.1), PCG, as ``tests/test_sharded.py``."""
    from instantsfm_tpu_torch.solve import robust
    from instantsfm_tpu_torch.solve.block_lm import LMConfig
    from instantsfm_tpu_torch.solve.problems import (make_ba_problem,
                                                     make_gp_problem)
    if kind == "ba":
        return (make_ba_problem(2), robust.huber(1.0),
                LMConfig(max_iterations=5, pcg_iters=50, solver="pcg"))
    return (make_gp_problem(), robust.huber(0.1),
            LMConfig(max_iterations=5, pcg_iters=60, solver="pcg",
                     radius_init=1e3))


def lm_state0(params, cfg):
    from instantsfm_tpu_torch.solve.block_lm import LMState
    f = lambda v: torch.tensor(v, dtype=params.pts.dtype)
    return LMState(params, f(1.0 / cfg.radius_init), f(float("inf")), f(0.0),
                   f(0.0))


def scenario_lm(payload, tmp):
    """Point-local LM steps and ``optimize_auto`` at this group's size, on
    every problem of the payload."""
    import torch.distributed as dist

    from instantsfm_tpu_torch.parallel import multihost, sharded
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    for kind, (params, obs) in payload["problems"].items():
        problem, kernel, cfg = lm_problem(kind)
        pp, po, meta = sharded.partition_points(params, obs, world)
        lp, lo = sharded.rank_slice(pp, po, rank, meta.T_pad, meta.O_pad)
        step = sharded.make_pointlocal_lm_step(problem, kernel, cfg,
                                               device="cpu")
        state = lm_state0(lp, cfg)
        for _ in range(payload["steps"]):
            state = step(state, lo)
        pts = multihost.all_gather_rows(state.params.pts)
        out[f"{kind}_pointlocal"] = dict(
            cost=float(state.cost), cam=_np(state.params.cam),
            pts=sharded.unpartition_points(pts, meta))

        cam, pts, hist = sharded.optimize_auto(problem, kernel, cfg, params,
                                               obs, device="cpu")
        out[f"{kind}_auto"] = dict(cam=_np(cam), pts=_np(pts), history=hist)
    return out


def scenario_multihost(payload, tmp):
    """The host exchanges, relative pose, ``generate_database`` and the
    mapper in this group."""
    from instantsfm_tpu_torch.config import Config
    from instantsfm_tpu_torch.features.handler import generate_database
    from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
    from instantsfm_tpu_torch.parallel import multihost
    from instantsfm_tpu_torch.pipeline import preprocess, relpose
    from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper

    rank, P = multihost.process_index(), multihost.process_count()
    out = dict(rank=rank, count=P, again=multihost.initialize(device="cpu"))
    # host arrays travel byte for byte, whatever their dtype
    local = {"i64": np.arange(5, dtype=np.int64) * (2 ** 40 + rank),
             "bool": np.arange(7) % (rank + 2) == 0,
             "u8": np.full((2, 3), 250 + rank, np.uint8),
             "f64": np.full(4, np.pi * (rank + 1))}
    out["allgather"] = {k: multihost.allgather_host_arrays(v)
                        for k, v in local.items()}
    mine = multihost.local_pair_slice(11)
    out["gathered"] = multihost.gather_pair_results(
        mine, (mine[:, None] * 10 + np.arange(3)).astype(np.int64), 11,
        fill=-1)
    desc, valid, pairs = payload["descriptors"]
    out["matches"] = multihost.match_pairs_distributed(
        list(desc), list(valid), pairs, ratio=0.95, max_matches=64,
        device="cpu")

    vg, cams, imgs, _ = read_colmap_database(payload["relpose_db"])
    preprocess.update_image_pairs_config(vg, cams, imgs)
    preprocess.decompose_relpose(vg, cams, imgs)
    relpose.undistort_images(cams, imgs, device="cpu")
    relpose.estimate_relative_pose(vg, cams, imgs, chunk_pairs=8,
                                   device="cpu")
    out["relpose"] = dict(qvec=vg.qvec, tvec=vg.tvec, E=vg.E_mat,
                          F=vg.F_mat, H=vg.H_mat, valid=vg.valid,
                          inlier_mask=vg.inlier_mask)

    out["database"] = generate_database(
        payload["images"], os.path.join(tmp, "database.db"),
        max_keypoints=512, log=lambda *a: None, device="cpu")

    vg, cams, imgs, name = read_colmap_database(payload["mapper_db"])
    cams, imgs, tracks, _ = solve_global_mapper(
        vg, cams, imgs, Config(name), log=lambda *a: None, device="cpu")
    out["mapper"] = dict(qvec=imgs.qvec, tvec=imgs.tvec,
                         registered=imgs.registered, xyz=tracks.xyz,
                         obs_image=tracks.obs_image)
    return out


def gs_runner_cfg(scene, result_dir, distributed):
    """The Runner of the distributed-trainer check: 4 steps of batch 2 at
    SH degree 1, refined at step 2 with a low growth threshold, so that
    growth and pruning both choose slots among the whole pool."""
    from instantsfm_tpu_torch.gs.strategy import StrategyConfig
    from instantsfm_tpu_torch.gs.trainer import GSConfig
    cfg = GSConfig(data_dir=scene, result_dir=result_dir, max_steps=4,
                   batch_size=2, sh_degree=1, eval_steps=(4,),
                   save_steps=(4,), tb_every=0, tile_capacity=128,
                   distributed=distributed)
    strategy = StrategyConfig(grow_grad2d=2e-5, prune_opa=0.0995,
                              refine_start_iter=2, refine_every=2,
                              refine_stop_iter=3)
    return cfg, strategy


def scenario_gs(payload, tmp):
    """The distributed loss and its gradients, one train step, and the
    Runner's distributed branch, in this group."""
    import torch.distributed as dist

    from instantsfm_tpu_torch.gs import distributed as gd
    from instantsfm_tpu_torch.gs import splats as splats_mod
    from instantsfm_tpu_torch.gs.splats import FLOAT_FIELDS, Splats
    from instantsfm_tpu_torch.gs.trainer import Runner
    rank, D = dist.get_rank(), dist.get_world_size()
    W, H, sh_degree = payload["W"], payload["H"], payload["sh_degree"]
    pool = Splats(**{k: torch.as_tensor(v)
                     for k, v in payload["pool"].items()})
    B = len(payload["c2w"])
    mine = slice(rank * B // D, (rank + 1) * B // D)
    batch = {"camtoworld": torch.as_tensor(payload["c2w"]),
             "K": torch.as_tensor(payload["K"]),
             "image": torch.as_tensor(payload["images"][mine])}
    out = {}

    shard = gd.shard_splats(gd.pad_splats(pool, D), rank, D)
    for f in FLOAT_FIELDS:
        getattr(shard, f).requires_grad_(True)
    offset = torch.zeros((shard.means.shape[0], 2), requires_grad=True)
    objective, loss, radii, seen, rgb = gd.distributed_loss(
        shard, offset, batch, W, H, sh_degree, tile_capacity=128,
        opacity_reg=0.01, scale_reg=0.01)
    objective.backward()
    out["loss"] = float(loss)
    out["grads"] = {f: _np(gd.gather_rows(getattr(shard, f).grad))
                    for f in FLOAT_FIELDS}
    out["g_offset"] = _np(gd.gather_rows(offset.grad))
    out["radii"] = _np(gd.gather_rows(radii))
    out["seen"] = _np(gd.gather_rows(seen))
    out["rgb"] = _np(gd.gather_rows(rgb.detach()))

    shard = gd.shard_splats(gd.pad_splats(pool, D), rank, D)
    for f in FLOAT_FIELDS:
        getattr(shard, f).requires_grad_(True)
    opt = splats_mod.make_optimizer(splats_mod.float_params(shard), 1.0)
    step = gd.make_distributed_train_step(opt, W, H, tile_capacity=128)
    loss, g_offset, radii, seen = step(shard, batch, sh_degree)
    out["step"] = dict(loss=float(loss),
                       pool=_np(vars(gd.gather_splats(shard))))

    cfg, strategy = gs_runner_cfg(payload["scene"], os.path.join(tmp, "gs"),
                                  True)
    logs = []
    runner = Runner(cfg, log=logs.append, device="cpu")
    runner.strategy_cfg = strategy
    losses = runner.train()
    out["runner"] = dict(losses=losses, refines=runner.refines, logs=logs,
                         pool=_np(vars(runner.pool())),
                         world=runner.world, stats=runner.eval(4),
                         ckpt=runner.save_checkpoint(4))
    return out


def to_device(x, device):
    """Tensors in ``x`` (nested dicts and named tuples) moved to
    ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    return x


def replicated_stages(db, device, offset=0):
    """The mapper's stages from view-graph calibration to rotation
    averaging (the ones every rank of a group runs whole) on the database
    ``db``, where ``offset`` moves this process's solves before the host
    reads them, as another card's float atomics would: the calibration's
    focal lengths scaled by 1 + 1e-3 ``offset`` and its pair errors raised
    by 3 ``offset`` (past the 2 px threshold on every pair), the rotation
    solve's quaternions moved by 1e-6 ``offset``.  Returns the focal
    lengths, valid pairs and rotations the stages leave."""
    from instantsfm_tpu_torch.config import Config
    from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
    from instantsfm_tpu_torch.pipeline import (filters, preprocess, relpose,
                                               rotation_averaging, vgc)
    vg, cams, imgs, name = read_colmap_database(db)
    cfg = Config(name)
    solve_f, solve_q = vgc._vgc_solve, rotation_averaging._ra_core

    def moved_f(*args, **kwargs):
        f, err = solve_f(*args, **kwargs)
        return f * (1 + 1e-3 * offset), err + 3.0 * offset

    vgc._vgc_solve = moved_f
    rotation_averaging._ra_core = lambda *a, **k: solve_q(*a, **k) \
        + 1e-6 * offset
    inl = cfg.INLIER_THRESHOLD_OPTIONS
    try:
        preprocess.update_image_pairs_config(vg, cams, imgs)
        preprocess.decompose_relpose(vg, cams, imgs)
        vgc.solve_view_graph_calibration(
            vg, cams, imgs, cfg.VIEW_GRAPH_CALIBRATOR_OPTIONS, device=device)
        focal = np.array([cams.focal(c) for c in range(cams.num_cameras)])
        valid = vg.valid.copy()
        relpose.undistort_images(cams, imgs, device=device)
        relpose.estimate_relative_pose(vg, cams, imgs, chunk_pairs=8,
                                       device=device)
        filters.filter_inlier_num(vg, inl["min_inlier_num"])
        filters.filter_inlier_ratio(vg, inl["min_inlier_ratio"])
        vg.keep_largest_connected_component(imgs)
        rotation_averaging.estimate_rotations(
            vg, imgs, cfg.ROTATION_ESTIMATOR_OPTIONS, cfg.L1_SOLVER_OPTIONS,
            device=device)
    finally:
        vgc._vgc_solve, rotation_averaging._ra_core = solve_f, solve_q
    return dict(focal=focal, valid=valid, qvec=imgs.qvec.copy(),
                registered=imgs.registered.copy())


def gs_world(g, rank, world, device):
    """``chip_smoke.gs_shard_check`` on the scene ``g["scene"]``: a batch
    of one view a rank, the loss and gradients on one device and
    gaussian-sharded over the group, as numpy; rank 0 adds the pool and
    the views it started from."""
    import chip_smoke
    from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner
    runner = Runner(GSConfig(
        data_dir=g["scene"],
        result_dir=os.path.join(g["scene"], f"out_{os.getpid()}"),
        batch_size=world, sh_degree=g["sh_degree"],
        tiles_per_gauss=g["tiles_per_gauss"],
        tile_capacity=g["tile_capacity"], eval_steps=(), save_steps=(),
        tb_every=0), log=lambda *a: None, device=device)
    chk = chip_smoke.gs_shard_check(runner, rank, world, seed=0)
    out = {k: chk[k] for k in ("loss_single", "loss_dist", "grad_rel",
                               "k2_launches", "k3_launches")}
    out["grads_single"] = _np(chk["grads_single"])
    out["grads_dist"] = _np(chk["grads_dist"])
    if rank == 0:
        out["pool"] = _np(vars(chk["pool"]))
        out["views"] = {k: _np(torch.stack([v[k] for v in chk["views"]]))
                        for k in ("camtoworld", "K", "image")}
    return out


def scenario_world(payload, tmp):
    """At this group's size: how ``initialize`` formed the group,
    ``gather_pair_results`` of ``payload["pairs"]`` strided pairs, per LM
    problem of ``payload["lm"]`` its point-local steps and
    ``optimize_sharded``, with ``payload["ring_db"]`` the replicated stages
    with each rank's solves moved by its rank (``replicated_stages``), and,
    with ``payload["gs"]``, the gaussian-sharded 3DGS loss and gradients of
    one batch with one view a rank against one device's (``gs_world``),
    on ``payload["device"]``."""
    import torch.distributed as dist

    from instantsfm_tpu_torch.parallel import multihost, sharded
    from instantsfm_tpu_torch.solve import schur_wchain as k1
    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device(payload["device"])
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    out = dict(rank=rank, world=world, backend=dist.get_backend(),
               device=str(device), local_rank=os.environ.get("LOCAL_RANK"),
               isfm_env=any(k.startswith("ISFM_") for k in os.environ),
               again=multihost.initialize(device=device.type))
    n = payload["pairs"]
    mine = multihost.local_pair_slice(n)
    out["mine"] = mine
    out["gathered"] = multihost.gather_pair_results(
        mine, (mine[:, None] * 10 + np.arange(3)).astype(np.int64), n,
        fill=-1)
    for kind, (params, obs, steps) in payload["lm"].items():
        params, obs = to_device(params, device), to_device(obs, device)
        problem, kernel, cfg = lm_problem(kind)
        if steps:
            pp, po, meta = sharded.partition_points(params, obs, world)
            lp, lo = sharded.rank_slice(pp, po, rank, meta.T_pad, meta.O_pad)
            step = sharded.make_pointlocal_lm_step(problem, kernel, cfg,
                                                   device=device)
            state = lm_state0(lp, cfg)
            for _ in range(steps):
                state = step(state, lo)
            pts = multihost.all_gather_rows(state.params.pts)
            out[f"{kind}_pointlocal"] = dict(
                cost=float(state.cost), cam=_np(state.params.cam),
                pts=sharded.unpartition_points(pts, meta))
        k1.schur_wchain.launches = 0
        cam, pts, hist = sharded.optimize_sharded(problem, kernel, cfg,
                                                  params, obs, device=device)
        out[f"{kind}_sharded"] = dict(cam=_np(cam), pts=_np(pts),
                                      history=hist,
                                      k1_launches=k1.schur_wchain.launches)
    if payload.get("ring_db"):
        out["replicated"] = replicated_stages(payload["ring_db"], device,
                                              offset=rank)
    if payload.get("gs"):
        out["gs"] = gs_world(payload["gs"], rank, world, device)
    return out


SCENARIOS = {"lm": scenario_lm, "multihost": scenario_multihost,
             "gs": scenario_gs, "world": scenario_world}


def _worker(scenario, tmp):
    torch.set_num_threads(1)
    # Runners mirror their scalars into tensorboard where it imports,
    # which pulls in TensorFlow where installed; the JSONL log is enough
    sys.modules["torch.utils.tensorboard"] = None
    from instantsfm_tpu_torch.parallel import multihost
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    device = payload.get("device", "cpu") if isinstance(payload, dict) \
        else "cpu"
    if not multihost.initialize(device=device,
                                timeout_s=COLLECTIVE_TIMEOUT_S):
        raise RuntimeError("no process group: neither ISFM_* nor "
                           "torchrun's variables are set")
    result = SCENARIOS[scenario](payload, tmp)
    with open(os.path.join(tmp, f"result{multihost.process_index()}.pkl"),
              "wb") as f:
        pickle.dump(result, f)
    multihost.shutdown()


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
