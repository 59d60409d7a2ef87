"""Chip smoke test of the PyTorch/CUDA port (instantsfm_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # the check
    python3 chip_smoke.py --profile  # also profile one BA LM step

Phases (any failure exits non-zero):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel of the port with nvcc (timed);
  3. kernel parity: each kernel against its plain torch version on the card
     at the shapes the solvers give it, float32 and float64, with timings
     (CUDA events) and the analytic memory/arithmetic bound;
  4. main path: ``pipeline.ba.bundle_adjustment_rounds`` (3 rounds, float32)
     on a seeded synthetic scene at the ETH3D-indoor shape (200 images, 50k
     points, 8 observations per point), then one global-positioning LM
     step at the same size; launch counters prove both went through K1.
     The process's first ``torch.func.vmap(jacfwd)`` call, a one-time
     set-up cost of torch, is timed on its own just before;
  5. prints the kernels line, the card line and, last, the ok line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from instantsfm_tpu_torch import config
from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.pipeline import ba
from instantsfm_tpu_torch.scene import cameras as cm
from instantsfm_tpu_torch.scene.types import Cameras, Images, Tracks
from instantsfm_tpu_torch.solve import block_lm, robust
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.solve.blocked import bucketize, bucketize_problem
from instantsfm_tpu_torch.solve.problems import make_ba_problem, make_gp_problem
from instantsfm_tpu_torch.utils import build, debug

OUT_DIR = "chiprun_out"
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,        # non-tensor-core FP32
              torch.float64: 34e12}        # non-tensor-core FP64
L2_FLUSH_BYTES = 256 << 20                 # overwritten to empty the 50 MB L2
BA_ITER_CAP = 40                           # max LM iterations per BA round
SEED = 0


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, reps, flush=None):
    """Mean device time of one call of ``fn`` over ``reps`` calls (CUDA
    events, after two warm-up calls).

    Without ``flush`` the calls run back to back, so a call may find its
    inputs in the 50 MB L2 left by the one before.  With ``flush`` (a
    tensor larger than L2) the buffer is overwritten before every call and
    each call is timed on its own, from device memory, as the bound counts.

    A sleep kernel holds the stream while the host queues every call, so
    the events time the device alone: a Python wrapper's dispatch (tens of
    us a call) would otherwise leave the card idle between short kernels
    and be counted as kernel time.  The first event must still be pending
    once all calls are queued, or the sleep is lengthened and the run
    repeated."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(reps if flush is not None else 1)]
    cycles = 10 ** 7
    for _ in range(6):
        torch.cuda._sleep(cycles)
        if flush is None:
            pairs[0][0].record()
            for _ in range(reps):
                fn()
            pairs[0][1].record()
        else:
            for start, end in pairs:
                flush.zero_()
                start.record()
                fn()
                end.record()
        queued_ahead = not pairs[0][0].query()
        torch.cuda.synchronize()
        if queued_ahead:
            return sum(s.elapsed_time(e) for s, e in pairs) / reps
        cycles *= 4
    raise RuntimeError("time_ms: the host could not queue the calls ahead "
                       "of the device")


# ------------------------------------------------------------ K1 parity

def k1_layout(lengths, C, seed):
    """Bucketized layout for tracks of the given lengths (host numpy)."""
    rng = np.random.default_rng(seed)
    pt = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    O = len(pt)
    cam = rng.integers(0, C, O).astype(np.int32)
    return bucketize(cam, pt, {}, np.ones(O, bool),
                     np.zeros((O, 1), np.float32), np.zeros(O, bool),
                     len(lengths))


def k1_inputs(bp, C, PC, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    Op, T = len(bp.cam_idx), bp.num_slots
    valid = torch.as_tensor(bp.valid, device=device)
    W = torch.randn((Op, PC, 3), generator=g, device=device, dtype=dtype)
    W = W * valid[:, None, None]
    A = torch.randn((T, 3, 3), generator=g, device=device, dtype=dtype)
    V_inv = A @ A.transpose(1, 2) + torch.eye(3, device=device, dtype=dtype)
    x = torch.randn((C, PC), generator=g, device=device, dtype=dtype)
    cam = torch.as_tensor(bp.cam_idx, device=device)
    pt = torch.as_tensor(bp.pt_idx, device=device)
    return W, V_inv, x, cam, pt, bp.buckets


def k1_bound(W, V_inv, x, buckets):
    """(bound_ms, bound_by, bytes, flops): each input read once, u written
    once; flops of t = Wᵀx, the group sums, z = V_inv s and u = W z."""
    O, PC = W.shape[0], W.shape[1]
    s = W.element_size()
    nbytes = (O * PC * 3 * s + 2 * 4 * O + V_inv.shape[0] * 9 * s
              + x.numel() * s + O * PC * s)
    flops = sum(Tb * L * (6 * PC + 3 * int(math.log2(L)) + 15 + 5 * PC)
                for (_, _, Tb, L) in buckets)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[W.dtype]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def k1_case(name, lengths, C, PC, dtype, device, reps):
    bp = k1_layout(lengths, C, SEED)
    W, V_inv, x, cam, pt, buckets = k1_inputs(bp, C, PC, dtype, device, SEED)
    want = k1.schur_wchain_reference(W, V_inv, x, cam, pt, buckets)
    got = k1.schur_wchain(W, V_inv, x, cam, pt, buckets)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"K1 {name}: bad output {tuple(got.shape)}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    rtol, atol = ((1e-4, 1e-5 * scale) if dtype == torch.float32
                  else (1e-10, 1e-10 * scale))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"K1 {name}: {m}")
    pad_rows = ~torch.as_tensor(bp.valid, device=device)
    if pad_rows.any() and got[pad_rows].abs().max().item() != 0.0:
        raise AssertionError(f"K1 {name}: padded rows are not exactly zero")
    kernel = lambda: k1.schur_wchain(W, V_inv, x, cam, pt, buckets)
    plain = lambda: k1.schur_wchain_reference(W, V_inv, x, cam, pt, buckets)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    ms = time_ms(kernel, reps, flush)
    ms_warm_l2 = time_ms(kernel, reps)
    plain_ms = time_ms(plain, max(reps // 10, 3), flush)
    bound_ms, bound_by, nbytes, flops = k1_bound(W, V_inv, x, buckets)
    rec = dict(case=name, dtype=str(dtype).replace("torch.", ""), PC=PC,
               rows=W.shape[0], points=V_inv.shape[0], cams=C,
               L=sorted({b[3] for b in buckets}), max_abs_err=err,
               max_abs_u=scale, ms=ms, ms_warm_l2=ms_warm_l2,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               mbytes=nbytes / 1e6, mflop=flops / 1e6)
    log("K1 " + json.dumps(rec))
    return rec


def kernel_parity(device):
    rng = np.random.default_rng(SEED)
    mixed = rng.choice([2, 5, 8, 20, 32, 50, 64, 300, 512, 1500, 2048],
                       size=1500)
    cases = []
    for dtype, reps in ((torch.float32, 100), (torch.float64, 100)):
        cases.append(k1_case("eth3d_indoor_ba", [8] * 50_000, 200, 8, dtype,
                             device, reps))
        cases.append(k1_case("tnt_ba", [8] * 1_000_000, 500, 8, dtype,
                             device, max(reps // 10, 10)))
        cases.append(k1_case("eth3d_indoor_gp", [8] * 50_000, 200, 3, dtype,
                             device, reps))
        for PC in (8, 3):
            cases.append(k1_case(f"mixed_L_pc{PC}", mixed, 200, PC, dtype,
                                 device, reps))
    return cases


# ------------------------------------------------------------ main path

def make_scene(num_cams=200, num_pts=50_000, obs_per_pt=8, seed=SEED):
    """Seeded synthetic scene at the ETH3D-indoor shape (as bench.py's
    make_ba): cameras on a ring looking at the origin, SIMPLE_RADIAL,
    0.5 px noise.  Returns ground truth and a perturbed start (rotations
    0.002 rad, translations 0.15, points 0.3)."""
    rng = np.random.default_rng(seed)
    cam_params = cm.pad_params([500.0, 320.0, 240.0, 0.01])
    angles = rng.uniform(0, 2 * np.pi, num_cams)
    centers = np.stack([8 * np.cos(angles), 8 * np.sin(angles),
                        rng.uniform(0, 2, num_cams)], -1)
    Rs = []
    for c in centers:
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 0, 1.0], z)
        x /= np.linalg.norm(x)
        Rs.append(np.stack([x, np.cross(z, x), z], 0))
    Rs = np.asarray(Rs)
    qs = lie.matrix_to_quat(torch.as_tensor(Rs)).numpy()
    ts = -np.einsum("cij,cj->ci", Rs, centers)
    pts = rng.uniform(-2, 2, (num_pts, 3))

    obs_pt = np.repeat(np.arange(num_pts), obs_per_pt)
    obs_cam = rng.integers(0, num_cams, num_pts * obs_per_pt)
    xyz = np.einsum("oij,oj->oi", Rs[obs_cam], pts[obs_pt]) + ts[obs_cam]
    keep = xyz[:, 2] > 0.2
    uv = xyz[:, :2] / np.maximum(xyz[:, 2:], 0.2)
    r2 = np.sum(uv * uv, -1, keepdims=True)
    xy = uv * (1 + 0.01 * r2) * 500.0 + np.array([320.0, 240.0])
    xy += 0.5 * rng.standard_normal(xy.shape)
    obs_pt, obs_cam, xy = obs_pt[keep], obs_cam[keep], xy[keep]

    dq = lie.so3_exp(torch.as_tensor(0.002 * rng.standard_normal(
        (num_cams, 3)))).numpy()
    q0 = lie.quat_mul(torch.as_tensor(dq), torch.as_tensor(qs)).numpy()
    t0 = ts + 0.15 * rng.standard_normal(ts.shape)
    p0 = pts + 0.3 * rng.standard_normal(pts.shape)

    # keypoints of each image = its observations, in image order
    O = len(obs_pt)
    order = np.argsort(obs_cam, kind="stable")
    kp_offset = np.zeros(num_cams + 1, np.int64)
    np.cumsum(np.bincount(obs_cam, minlength=num_cams), out=kp_offset[1:])
    feat = np.empty(O, np.int32)
    feat[order] = np.arange(O) - kp_offset[obs_cam[order]]
    obs_offset = np.zeros(num_pts + 1, np.int64)
    np.cumsum(np.bincount(obs_pt, minlength=num_pts), out=obs_offset[1:])
    cameras = Cameras(np.full(1, cm.SIMPLE_RADIAL, np.int32), np.full(1, 640),
                      np.full(1, 480), cam_params[None].copy(),
                      np.ones(1, bool), np.zeros(1, bool))
    images = Images(np.zeros(num_cams, np.int32),
                    [f"{i:04d}.png" for i in range(num_cams)], q0, t0,
                    np.ones(num_cams, bool), np.zeros(num_cams, np.int32),
                    xy[order], kp_offset)
    tracks = Tracks(p0, np.zeros((num_pts, 3), np.uint8),
                    obs_cam.astype(np.int32), feat, obs_offset,
                    np.arange(num_pts, dtype=np.int64))
    gt = dict(q=qs, t=ts, centers=centers, pts=pts)
    return cameras, images, tracks, gt


def umeyama(src, dst):
    """Similarity (s, R, t) minimising ||s R src + t - dst||."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(b.T @ a / len(src))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / np.mean(np.sum(a * a, 1))
    return s, R, mu_d - s * R @ mu_s


def pose_errors(images, gt):
    """(mean rotation error in degrees, mean center error relative to the
    ring radius) after aligning the estimated centers to ground truth."""
    c_est = images.centers()
    s, R, t = umeyama(c_est, gt["centers"])
    c_al = s * c_est @ R.T + t
    R_est = lie.quat_to_matrix(torch.as_tensor(images.qvec)).numpy()
    R_gt = lie.quat_to_matrix(torch.as_tensor(gt["q"])).numpy()
    # world->cam rotations: R_est ~ R_gt R  after the alignment
    dR = np.einsum("nij,nkj->nik", R_est, np.einsum("nij,jk->nik", R_gt, R))
    ang = np.degrees(np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2,
                                       -1, 1)))
    radius = np.linalg.norm(gt["centers"] - gt["centers"].mean(0), axis=1).mean()
    return float(ang.mean()), float(
        np.linalg.norm(c_al - gt["centers"], axis=1).mean() / radius)


def scene_problem(cameras, images, tracks, dtype, device):
    """BA (Params, Observations) over every image and observation."""
    oi, ot = tracks.obs_image, tracks.obs_track_idx()
    xy = images.kp_xy[images.kp_index(oi, tracks.obs_feature)]
    t = lambda a, dt=dtype: torch.as_tensor(
        np.ascontiguousarray(a), device=device).to(dt)
    O = len(oi)
    params = block_lm.Params(
        cam={"q": t(images.qvec), "t": t(images.tvec),
             "intr": t(cameras.params[images.cam_idx])},
        pts=t(tracks.xyz), scales=t(np.zeros((O, 1))),
        scales_free=t(np.zeros(O, bool), torch.bool))
    obs = block_lm.Observations(t(oi, torch.int32), t(ot, torch.int32),
                                {"x": t(xy[:, 0]), "y": t(xy[:, 1])},
                                t(np.ones(O, bool), torch.bool))
    return params, obs


def scene_cost(cameras, images, tracks, device):
    """Huber(1) reprojection cost of every observation (float64)."""
    params, obs = scene_problem(cameras, images, tracks, torch.float64, device)
    return float(block_lm.compute_cost(make_ba_problem(cameras.uniform_model_id),
                                       params, obs, robust.huber(1.0)))


def run_ba(device):
    cameras, images, tracks, gt = make_scene()
    opts = dict(config.BUNDLE_ADJUSTER_OPTIONS, max_num_iterations=BA_ITER_CAP)
    thr = config.INLIER_THRESHOLD_OPTIONS["max_reprojection_error"]
    cost0 = scene_cost(cameras, images, tracks, device)
    rot0, cen0 = pose_errors(images, gt)
    log(f"BA scene: {images.num_images} images, {tracks.num_tracks} points, "
        f"{tracks.num_observations} observations; LM iteration cap "
        f"{BA_ITER_CAP} per round (config max_num_iterations="
        f"{config.BUNDLE_ADJUSTER_OPTIONS['max_num_iterations']})")

    debug.drain_stats()
    torch.cuda.synchronize()
    k1.schur_wchain.launches = 0
    t0 = time.perf_counter()
    tracks_out = ba.bundle_adjustment_rounds(
        cameras, images, tracks, opts, thr, rounds=3, dtype=torch.float32,
        device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = k1.schur_wchain.launches
    stats = debug.drain_stats()

    finite = all(np.all(np.isfinite(a)) for a in
                 (images.qvec, images.tvec, tracks.xyz, cameras.params))
    cost1 = scene_cost(cameras, images, tracks, device)
    rot1, cen1 = pose_errors(images, gt)
    pcg_iters = stats.get("pcg_iters", [])
    lm_steps = len(stats.get("lm_tries", []))
    step_ms = [s * 1e3 for s in stats["lm_step_s"]]
    rec = dict(seconds=seconds, lm_iters_per_round=stats["ba_lm_iters"],
               lm_steps=lm_steps, damped_solves=sum(stats["lm_tries"]),
               pcg_iters_total=sum(pcg_iters), pcg_solves=len(pcg_iters),
               pcg_iters_per_solve=pcg_iters,
               ms_per_lm_step=seconds * 1e3 / max(lm_steps, 1),
               first_step_ms=step_ms[0],
               median_later_step_ms=float(np.median(step_ms[1:])),
               step_ms=step_ms,
               k1_launches=launches, cost_before=cost0, cost_after=cost1,
               rot_err_deg_before=rot0, rot_err_deg_after=rot1,
               center_err_rel_before=cen0, center_err_rel_after=cen1,
               obs_kept=int(tracks_out.num_observations))
    log("BA " + json.dumps(rec))
    checks = {
        "outputs finite": finite,
        "cost falls": cost1 < cost0,
        "K1 launched at least once per PCG iteration":
            launches >= sum(pcg_iters) and launches > 0,
        "rotation error no worse": rot1 <= rot0,
        "center error no worse": cen1 <= cen0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"BA main path failed: {failed}")
    return rec, gt


def run_gp_step(device, gt):
    """One global-positioning LM step (PC=3) at the BA scene's size."""
    rng = np.random.default_rng(SEED + 1)
    C, T, per = len(gt["centers"]), len(gt["pts"]), 8
    obs_pt = np.repeat(np.arange(T), per).astype(np.int32)
    obs_cam = rng.integers(0, C, T * per).astype(np.int32)
    d = gt["pts"][obs_pt] - gt["centers"][obs_cam]
    t_obs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    O = len(obs_pt)
    f32 = lambda a: torch.as_tensor(a, device=device, dtype=torch.float32)
    params = block_lm.Params(
        cam={"c": f32(gt["centers"] + 0.5 * rng.standard_normal((C, 3)))},
        pts=f32(gt["pts"] + 0.5 * rng.standard_normal((T, 3))),
        scales=f32(np.ones((O, 1))),
        scales_free=torch.ones(O, dtype=torch.bool, device=device))
    obs = block_lm.Observations(
        torch.as_tensor(obs_cam, device=device),
        torch.as_tensor(obs_pt, device=device),
        {"tx": f32(t_obs[:, 0]), "ty": f32(t_obs[:, 1]),
         "tz": f32(t_obs[:, 2]), "w": f32(np.ones(O))},
        torch.ones(O, dtype=torch.bool, device=device))
    params, obs, buckets, _ = bucketize_problem(params, obs)
    problem, kernel = make_gp_problem(), robust.huber(0.1)
    cfg = block_lm.LMConfig(solver="pcg", radius_init=1e3)
    dev32 = lambda v: torch.tensor(v, device=device, dtype=torch.float32)
    state = block_lm.LMState(params, dev32(1.0 / cfg.radius_init),
                             dev32(float("inf")), dev32(0.0), dev32(0.0))
    cost0 = float(block_lm.compute_cost(problem, params, obs, kernel))
    debug.drain_stats()
    torch.cuda.synchronize()
    k1.schur_wchain.launches = 0
    t0 = time.perf_counter()
    state = block_lm.lm_step(problem, kernel, cfg, state, obs,
                             buckets=buckets, device=device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = k1.schur_wchain.launches
    stats = debug.drain_stats()
    cost1 = float(state.cost)
    rec = dict(ms=ms, rows=int(obs.valid.shape[0]), k1_launches=launches,
               pcg_iters=stats["pcg_iters"], damped_solves=stats["lm_tries"],
               cost_before=cost0, cost_after=cost1)
    log("GP " + json.dumps(rec))
    ok = (math.isfinite(cost1) and cost1 <= cost0 and launches > 0
          and launches >= sum(stats["pcg_iters"])
          and torch.isfinite(state.params.cam["c"]).all().item())
    if not ok:
        raise AssertionError("GP lm_step failed its checks")
    return rec


def profile_ba_step(device):
    """Device time by kernel over one BA LM step at the main-path shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cameras, images, tracks, _ = make_scene()
    params, obs = scene_problem(cameras, images, tracks, torch.float32, device)
    params, obs, buckets, _ = bucketize_problem(params, obs)
    problem, kernel = make_ba_problem(cm.SIMPLE_RADIAL), robust.huber(1.0)
    cfg = block_lm.LMConfig()
    dev32 = lambda v: torch.tensor(v, device=device, dtype=torch.float32)
    state = block_lm.LMState(params, dev32(1e-4), dev32(float("inf")),
                             dev32(0.0), dev32(0.0))
    for _ in range(2):
        state = block_lm.lm_step(problem, kernel, cfg, state, obs,
                                 buckets=buckets, device=device)
    torch.cuda.synchronize()
    debug.drain_stats()
    steady_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        state = block_lm.lm_step(problem, kernel, cfg, state, obs,
                                 buckets=buckets, device=device)
        torch.cuda.synchronize()
        steady_ms.append((time.perf_counter() - t0) * 1e3)
    steady_pcg = debug.drain_stats().get("pcg_iters")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state = block_lm.lm_step(problem, kernel, cfg, state, obs,
                                 buckets=buckets, device=device)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = debug.drain_stats()
    rows = []
    for ev in prof.key_averages():
        # device-side events only: the aten::* host rows repeat the time of
        # the kernels they launched
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "ba_lm_step_trace.json"))
    rec = dict(steady_step_ms=steady_ms, steady_pcg_iters=steady_pcg,
               wall_ms=wall_ms, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / wall_ms,
               pcg_iters=stats.get("pcg_iters"),
               damped_solves=stats.get("lm_tries"),
               top=[dict(us=us, n=n, name=name[:80]) for us, n, name in rows[:15]])
    log("PROFILE " + json.dumps(rec))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one BA LM step (torch.profiler)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    # full-precision float32 products and convolutions (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.build_all(["schur_wchain"])
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_ptxas.txt"), "w") as f:
        for name, info in build.BUILD_INFO.items():
            f.write(f"== {name} ({info['seconds']:.1f} s)\n{info['log']}\n")
    log(f"build: {build_s:.1f} s (nvcc, sm_90a)")

    cases = kernel_parity(device)
    # one-time cost of the process's first vmap(jacfwd) call, timed apart
    # from the BA stage: an add under it runs torch._refs.add, whose first
    # call imports torch._dynamo (and sympy, torch.distributed.tensor)
    t0 = time.perf_counter()
    z = torch.zeros((2, 3), device=device)
    torch.func.vmap(lambda x: torch.func.jacfwd(lambda d: x + d)(x[0]))(z)
    torch.cuda.synchronize()
    log(f"first torch.func.vmap(jacfwd) call: {time.perf_counter() - t0:.3f} s")
    # --profile: also print the BA stage's host spans and LM iterations
    debug.ENABLED = args.profile
    ba_rec, gt = run_ba(device)
    debug.ENABLED = False
    gp_rec = run_gp_step(device, gt)
    if args.profile:
        profile_ba_step(device)

    main_case = next(c for c in cases if c["case"] == "eth3d_indoor_ba"
                     and c["dtype"] == "float32")
    f32_cases = [c for c in cases if c["dtype"] == "float32"]
    kernels = [dict(
        name="schur_wchain", route="cuda",
        source="instantsfm_tpu_torch/csrc/schur_wchain.cu",
        replaces="instantsfm_tpu/solve/pallas_schur.py:145",
        replaces_fn="instantsfm_tpu/solve/pallas_schur.py::schur_wchain",
        launches=ba_rec["k1_launches"], launches_gp_step=gp_rec["k1_launches"],
        max_abs_err=main_case["max_abs_err"],
        max_err_f32=max(c["max_abs_err"] for c in f32_cases),
        max_rel_err_f32=max(c["max_abs_err"] / c["max_abs_u"]
                            for c in f32_cases),
        ms=main_case["ms"], ms_warm_l2=main_case["ms_warm_l2"],
        plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
        library_ms=None, build_s=build_s)]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
