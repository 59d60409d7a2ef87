"""Global positioning stage on torch tensors.

Counterpart of ``instantsfm_tpu/pipeline/positioning.py``: estimates all
camera centers + 3D points (+ per-observation projective scales) at once by
LM on the pairwise residual ``t_obs - s (X - c)`` where ``t_obs = Rᵀ b`` is
the observation bearing rotated to the world frame.  The solve runs on the
block LM engine (``solve/block_lm.py``) with 3-wide camera blocks and the
scale blocks eliminated, so every PCG matvec goes through K1
(``solve/schur_wchain.py``) at PC = 3.

* tracks with fewer than ``min_num_view_per_track`` observations are dropped
  and images left with no tracks are unregistered;
* random init (numpy, ``seed``) scaled by mean valid depth * 4 (default
  100), drawn in track order (the JAX package's draws);
* inverse-depth scales are frozen where metric depth is available;
* uncalibrated cameras get residual weight 0.5;
* Huber(1e-1) kernel, TrustRegion(radius=1e3, max=1e8), <= 100 iterations,
  moving-window ftol 5e-4.

The spanning-tree init (``opts["init"] == "tree"``) is opt-in, as in the
JAX package, where it was measured negative.  The solve goes through
``parallel.sharded.optimize_auto``: one device, or the point-local solve
over every rank of a process group.  Spans: ``gp.prepare`` (the problem
from the tracks), ``gp.optimize`` (the solve) and ``gp.writeback`` (its
read ``gp.result``).
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.scene.types import Cameras, Images, Tracks
from instantsfm_tpu_torch.solve import robust
from instantsfm_tpu_torch.parallel.sharded import optimize_auto
from instantsfm_tpu_torch.solve.block_lm import LMConfig, Observations, Params
from instantsfm_tpu_torch.solve.problems import make_gp_problem
from instantsfm_tpu_torch.utils import debug as _dbg
from instantsfm_tpu_torch.utils.device import resolve_device


def _tree_init(view_graph, images, tracks, reg_idx, scene_scale):
    """Spanning-tree direction init (opt-in).

    With rotations known after rotation averaging, each relative-pose edge
    fixes the direction of c_i - c_j (= R_j^T t_ij up to a positive scale):
    walk the max-inlier spanning tree with unit steps, then
    midpoint-triangulate every track from those cameras.  Returns
    (centers [Nr, 3], points [T, 3]) scaled to an RMS of ``scene_scale``,
    or None if the graph does not reach every registered image."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order, minimum_spanning_tree

    n = images.num_images
    reg = images.registered
    mask = view_graph.valid & reg[view_graph.pair_i] & reg[view_graph.pair_j]
    ei = view_graph.pair_i[mask]
    ej = view_graph.pair_j[mask]
    if len(ei) == 0:
        return None
    w = view_graph.num_inliers_per_pair()[mask].astype(np.float64)
    g = sp.coo_matrix((-w - 1.0, (ei, ej)), shape=(n, n)).tocsr()
    mst = minimum_spanning_tree(g)
    mst = mst + mst.T
    root = int(ei[0])
    order, pred = breadth_first_order(mst, root, directed=False,
                                      return_predecessors=True)
    key = ei.astype(np.int64) * n + ej
    edge_row = dict(zip(map(int, key), map(int, np.nonzero(mask)[0])))

    t = view_graph.tvec[mask]
    nrm = np.linalg.norm(t, axis=-1, keepdims=True)
    t_hat = np.zeros_like(t)
    np.divide(t, nrm, out=t_hat, where=nrm > 1e-12)

    centers_w = np.zeros((n, 3))
    have = np.zeros(n, bool)
    have[root] = True
    row_pos = {int(r): k for k, r in enumerate(np.nonzero(mask)[0])}
    q_unit = images.qvec / np.linalg.norm(images.qvec, axis=-1, keepdims=True)
    for node in order:
        parent = pred[node]
        if parent < 0 or node == root:
            continue
        a, b = (node, parent) if node < parent else (parent, node)
        r = edge_row.get(int(a) * n + int(b))
        if r is None or not have[parent]:
            continue
        d_w = lie.quat_rotate_inv_np(q_unit[view_graph.pair_j[r]],
                                     t_hat[row_pos[int(r)]])
        if view_graph.pair_i[r] == node:     # node = i: c_i = c_j + d_w
            centers_w[node] = centers_w[parent] + d_w
        else:                                # node = j: c_j = c_i - d_w
            centers_w[node] = centers_w[parent] - d_w
        have[node] = True
    if not have[reg_idx].all():
        return None
    c = centers_w[reg_idx]
    c = c - c.mean(axis=0)
    rms = float(np.sqrt(np.mean(np.sum(c * c, -1)))) or 1.0
    c = c * (scene_scale / rms)

    # midpoint triangulation: (sum_i (I - b b^T)) p = sum_i (I - b b^T) c_i
    kp_flat = images.kp_index(tracks.obs_image, tracks.obs_feature)
    b_w = lie.quat_rotate_inv_np(images.qvec[tracks.obs_image],
                                 images.kp_bearing[kp_flat])
    b_w /= np.maximum(np.linalg.norm(b_w, axis=-1, keepdims=True), 1e-12)
    full_c = np.zeros((n, 3))
    full_c[reg_idx] = c
    ci = full_c[tracks.obs_image]
    P = np.eye(3)[None] - b_w[:, :, None] * b_w[:, None, :]     # [O, 3, 3]
    tr_idx = tracks.obs_track_idx()
    A = np.zeros((tracks.num_tracks, 3, 3))
    rhs = np.zeros((tracks.num_tracks, 3))
    np.add.at(A, tr_idx, P)
    np.add.at(rhs, tr_idx, np.einsum("oij,oj->oi", P, ci))
    # regularize rank-deficient (near-parallel) tracks toward the centroid
    A += 1e-6 * np.eye(3)[None]
    pts = np.linalg.solve(A, rhs[..., None])[..., 0]
    # clamp runaways (parallel bearings can send the midpoint far out)
    r_pt = np.linalg.norm(pts, axis=-1)
    pts[~np.isfinite(r_pt) | (r_pt > 10.0 * scene_scale)] = 0.0
    return c, pts


@_dbg.traced("gp.prepare")
def _problem(cameras, images, tracks, opts, depths_available, dtype, seed,
             view_graph, dev):
    """The tracks kept, the registered images and GP's start and
    observations on the device."""
    # ---- drop short tracks (whole tracks)
    tracks = tracks.filter_tracks(
        tracks.track_lengths() >= int(opts["min_num_view_per_track"]))

    # ---- unregister images with no observations
    used = np.zeros(images.num_images, bool)
    used[np.unique(tracks.obs_image)] = True
    images.registered &= used

    reg_idx = np.nonzero(images.registered)[0]
    dense = -np.ones(images.num_images, np.int64)
    dense[reg_idx] = np.arange(len(reg_idx))

    tracks = tracks.filter_observations(images.registered[tracks.obs_image])

    # ---- random init
    rng = np.random.default_rng(seed)
    scene_scale = 100.0
    if depths_available and images.kp_depth is not None:
        valid = images.kp_depth[images.kp_depth > 0]
        if len(valid):
            scene_scale = float(np.mean(valid)) * 4.0
    centers = scene_scale * rng.uniform(-1, 1, (len(reg_idx), 3))
    points = scene_scale * rng.uniform(-1, 1, (tracks.num_tracks, 3))
    if (view_graph is not None and not depths_available
            and opts.get("init") == "tree"):
        init = _tree_init(view_graph, images, tracks, reg_idx, scene_scale)
        if init is not None:
            centers, points = init

    # ---- observation arrays
    kp_flat = images.kp_index(tracks.obs_image, tracks.obs_feature)
    bearings = images.kp_bearing[kp_flat]
    t_obs = lie.quat_rotate_inv_np(images.qvec[tracks.obs_image], bearings)
    cam_idx = dense[tracks.obs_image].astype(np.int32)
    pt_idx = tracks.obs_track_idx()
    calibrated = cameras.has_prior_focal[images.cam_idx[tracks.obs_image]]
    w = np.where(calibrated, 1.0, 0.5)
    O = tracks.num_observations

    if depths_available and images.kp_depth is not None:
        depth = images.kp_depth[kp_flat]
        has_depth = depth > 0
        scales = np.where(has_depth, 1.0 / np.maximum(depth, 1e-12), 1.0)
        scales_free = ~has_depth
    else:
        scales = np.ones(O)
        scales_free = np.ones(O, bool)

    t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a),
                                            device=dev).to(dt)
    params = Params(cam={"c": t(centers)}, pts=t(points),
                    scales=t(scales[:, None]),
                    scales_free=t(scales_free, torch.bool))
    obs = Observations(
        cam_idx=t(cam_idx, torch.int32), pt_idx=t(pt_idx, torch.int32),
        data={"tx": t(t_obs[:, 0]), "ty": t(t_obs[:, 1]),
              "tz": t(t_obs[:, 2]), "w": t(w)},
        valid=torch.ones(O, dtype=torch.bool, device=dev))
    return tracks, reg_idx, params, obs


def global_positioning(cameras: Cameras, images: Images, tracks: Tracks,
                       opts: dict, depths_available: bool = False,
                       dtype=torch.float64, seed: int = 0,
                       verbose: bool = False, view_graph=None,
                       device="cuda") -> Tracks:
    """Solve centers and points; writes ``images.tvec`` (t = -R c) and
    returns the tracks with their new points.  ``opts["init"] == "tree"``
    with a ``view_graph`` starts from the spanning-tree init."""
    dev = resolve_device(device)
    tracks, reg_idx, params, obs = _problem(
        cameras, images, tracks, opts, depths_available, dtype, seed,
        view_graph, dev)
    cfg = LMConfig(max_iterations=int(opts["max_num_iterations"]),
                   function_tolerance=float(opts["function_tolerance"]),
                   radius_init=1e3, radius_max=1e8)
    kernel = robust.huber(float(opts["thres_loss_function"]))

    with _dbg.span("gp.optimize"):
        cam, pts, history = optimize_auto(
            make_gp_problem(), kernel, cfg, params, obs, verbose=verbose,
            device=dev)
    _dbg.stat_add("gp_lm_iters", len(history))

    # ---- write back (t = -R c)
    with _dbg.span("gp.writeback"):
        new_centers, xyz = _dbg.read("gp.result", (cam["c"], pts))
        images.tvec[reg_idx] = -lie.quat_rotate_np(
            images.qvec[reg_idx], new_centers.astype(np.float64))
        tracks.xyz = xyz.astype(np.float64)
    return tracks
