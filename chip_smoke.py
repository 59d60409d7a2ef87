"""Chip smoke test of the PyTorch/CUDA port (instantsfm_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # the check
    python3 chip_smoke.py --profile  # also profile one BA LM step, the
                                     # relative-pose stage and a 3DGS step

Phases (any failure exits non-zero):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel of the port with nvcc, one process per
     source, all started together (timed);
  3. kernel parity: each kernel against its plain torch version on the card
     (K1 at the shapes the solvers give it and at 4,000 cameras, past its
     shared-memory camera table, float32 and float64; K2/K3 on
     hand-built tiles that reach every branch and on tiles whose gaussians
     sit on the edges of the kernels' cull), with timings (CUDA events)
     and the analytic memory/arithmetic bound;
  4. BA path: ``pipeline.ba.bundle_adjustment_rounds`` (3 rounds, float32)
     on a seeded synthetic scene at the ETH3D-indoor shape (200 images, 50k
     points, 8 observations per point), then one global-positioning LM
     step at the same size; launch counters prove both went through K1.
     The process's first ``torch.func.vmap(jacfwd)`` call, a one-time
     set-up cost of torch, is timed on its own just before;
  5. SfM path: a seeded COLMAP database at the ETH3D-indoor scale (200
     images on a ring, 20k points, each image matched with the next 12,
     0.4 px noise, 8% outlier matches) goes through
     ``read_colmap_database -> pipeline.mapper.solve_global_mapper``
     (float32) ``-> write_reconstruction`` and the model is read back; it
     must register every image within 1 degree and 1% of the extent of the
     ground truth, and K1 must have run in global positioning and in bundle
     adjustment and match its plain version on the first input each stage
     gave it (one ``SFM`` line: seconds per stage, LM iterations, K1
     launches and errors, host syncs, pose errors);
  6. SfM with retriangulation and pruning: the same database through the
     mapper with both stages on (float32); it must register every image
     within 1 degree and 1% of the extent, give at least 180 of the 200
     images a cluster id, and launch K1 at PC = 2 in retriangulation's
     frozen-pose BA, where K1 is held against its plain version on the
     first such input (one ``SFM_RETRI`` line: seconds of retriangulation
     and pruning, refinement rounds and changed shares, clusters, K1
     launches per stage, the PC > 8 plain-route calls);
  7. pixels to poses: ``tests/test_pixels_e2e.py``'s scene (four textured
     planes) rendered by the port's rasterizer in 16 views at 480x360 and
     written as PNG, then ``cli.feat`` (SIFT and matching on the card) and
     ``cli.sfm`` on the card; ``sparse/0`` must register 15 of 16 views
     with more than 300 points, ATE < 2% of the extent and rotation
     errors < 0.5 degree (``PIXELS`` line: extraction, matching and mapper
     seconds);
  8. feature throughput: 200 views of that scene at 640x480,
     ``generate_database`` with 4,096 keypoints an image and exhaustive
     matching, 19,900 pairs (``FEAT`` line: extraction and matching
     seconds, peak device memory, matching's bound), then one mapper pass
     over that database (registered views and pose errors, no bar);
  9. 3DGS path: a seeded scene of 100k SfM points and 24 views at 800x608
     (photos rendered by the port's rasterizer with SH degree 3, written as
     PNG and a COLMAP model), then ``gs.trainer.Runner`` trains 40 steps at
     SH degree 3 with refine and opacity reset on the card, evaluates and
     saves a checkpoint; launch counters prove every step went through K2
     and K3.  K2/K3 are then held against their plain versions on one
     view's real tiles;
  10. prints the kernels line, the card line and, last, the ok line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from instantsfm_tpu_torch import config
from instantsfm_tpu_torch.config import Config
from instantsfm_tpu_torch.gs import composite as k23
from instantsfm_tpu_torch.gs import rasterize as gs_raster
from instantsfm_tpu_torch.gs import sh as gs_sh
from instantsfm_tpu_torch.gs import strategy as gs_strategy
from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner
from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.io.colmap_db import (ColmapDatabase,
                                               read_colmap_database)
from instantsfm_tpu_torch.io.image import imwrite
from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.pipeline import ba, preprocess, relpose, vgc
from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper
from instantsfm_tpu_torch.pipeline.writer import write_reconstruction
from instantsfm_tpu_torch.scene import cameras as cm
from instantsfm_tpu_torch.scene.types import (CONFIG_CALIBRATED, Cameras,
                                              Images, Tracks)
from instantsfm_tpu_torch.solve import block_lm, robust
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.solve.blocked import bucketize, bucketize_problem
from instantsfm_tpu_torch.solve.problems import make_ba_problem, make_gp_problem
from instantsfm_tpu_torch.utils import build, debug

OUT_DIR = "chiprun_out"
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,        # non-tensor-core FP32
              torch.float64: 34e12}        # non-tensor-core FP64
# special-function unit (exp2, lg2, rcp): 16 results per SM per clock on
# compute capability 9.0 (CUDA C Programming Guide, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock of the 67 TFLOP/s above
PEAK_SFU = 132 * 16 * 1.98e9
L2_FLUSH_BYTES = 256 << 20                 # overwritten to empty the 50 MB L2
BA_ITER_CAP = 40                           # max LM iterations per BA round
SEED = 0
GS_POINTS, GS_VIEWS, GS_W, GS_H = 100_000, 24, 800, 608   # bench_gs.py:36
GS_STEPS, GS_RESET_EVERY = 40, 25


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, reps, flush=None, queued=True):
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
    repeated.  ``queued=False`` skips the sleep: the events then also count
    the device's idle time while the host dispatches ``fn``, the time a
    chain of small torch ops (a plain version) really costs."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(reps if flush is not None else 1)]
    cycles = 10 ** 7
    for _ in range(6):
        if queued:
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
        queued_ahead = not queued or not pairs[0][0].query()
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
    """(bound_ms, bound_by, bytes, flops, bound_ms_unfused): W, cam_idx,
    V_inv per point slot and x read once, y written once; flops of t = Wᵀx,
    the group sums, z = V_inv s, u = W z and the camera sums.
    ``bound_ms_unfused`` is the first port's count for K1 alone, which
    reads pt_idx and writes u [O', PC] in place of y."""
    O, PC = W.shape[0], W.shape[1]
    s = W.element_size()
    common = O * PC * 3 * s + 4 * O + V_inv.shape[0] * 9 * s + x.numel() * s
    nbytes = common + x.numel() * s
    unfused = common + 4 * O + O * PC * s
    flops = sum(Tb * L * (6 * PC + 3 * int(math.log2(L)) + 15 + 6 * PC)
                for (_, _, Tb, L) in buckets)
    t_ops = flops / PEAK_FLOPS[W.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops,
            max(unfused / HBM_BYTES_PER_S, t_ops) * 1e3)


# K1's tolerance, per camera entry, relative to SUM_{o: cam_o = c} |u_o|
# (k1_abs_sums): a camera's sum of u cancels, so max|y| is no scale.  The
# kernel sums tracks by a butterfly and cameras with atomics in an order
# that changes from run to run, the plain version by reshape-sums and
# index_add_: float sums of up to 2048 track rows and ~2000 camera rows
K1_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}


def k1_abs_sums(W, V_inv, x, cam_idx, pt_idx, buckets):
    """[C, PC]: the sum of |u_o| over each camera's rows (plain version)."""
    u = k1.schur_wchain_rows_reference(W, V_inv, x, cam_idx, pt_idx,
                                       buckets).abs()
    return u.new_zeros(x.shape).index_add_(0, cam_idx, u)


def k1_check(name, got, want, abs_sums):
    """Raise unless |got - want| <= K1_TOL * abs_sums at every entry.
    Returns (max abs error, max of error / abs_sums)."""
    tol = K1_TOL[got.dtype]
    err = (got - want).abs()
    bad = ~(err <= tol * abs_sums)
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries beyond {tol} "
            f"of their camera's sum of |u|, max abs err {err.max().item()}")
    rel = torch.where(abs_sums > 0, err / abs_sums, torch.zeros_like(err))
    return err.max().item(), rel.max().item()


def k1_case(name, lengths, C, PC, dtype, device, reps):
    bp = k1_layout(lengths, C, SEED)
    W, V_inv, x, cam, pt, buckets = k1_inputs(bp, C, PC, dtype, device, SEED)
    want = k1.schur_wchain_reference(W, V_inv, x, cam, pt, buckets)
    got = k1.schur_wchain(W, V_inv, x, cam, pt, buckets)
    torch.cuda.synchronize()
    if got.shape != (C, PC) or want.shape != (C, PC):
        raise AssertionError(f"K1 {name}: bad output {tuple(got.shape)}")
    err, rel_err = k1_check(f"K1 {name}", got, want,
                            k1_abs_sums(W, V_inv, x, cam, pt, buckets))
    # what the kernel absorbs (the camera sum of u), and the matvec it sits in
    u = k1.schur_wchain_rows_reference(W, V_inv, x, cam, pt, buckets)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    A = torch.randn((C, PC, PC), generator=g, device=device, dtype=dtype)
    U_d = A @ A.transpose(1, 2) + PC * torch.eye(PC, device=device,
                                                  dtype=dtype)
    kernel = lambda: k1.schur_wchain(W, V_inv, x, cam, pt, buckets)
    plain = lambda: k1.schur_wchain_reference(W, V_inv, x, cam, pt, buckets)
    seg = lambda: block_lm._seg_by_cam(u, cam, C)
    matvec = lambda: block_lm.schur_matvec(U_d, W, V_inv, cam, pt, buckets, x)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    bound_ms, bound_by, nbytes, flops, unfused_ms = k1_bound(W, V_inv, x,
                                                             buckets)
    rec = dict(case=name, dtype=str(dtype).replace("torch.", ""), PC=PC,
               rows=W.shape[0], points=V_inv.shape[0], cams=C,
               L=sorted({b[3] for b in buckets}),
               branch="shared" if k1.shared_table(C, PC, dtype) else "global",
               max_abs_err=err, max_err_over_abs_sum=rel_err,
               max_abs_y=want.abs().max().item(),
               ms=time_ms(kernel, reps, flush),
               ms_warm_l2=time_ms(kernel, reps),
               plain_ms=time_ms(plain, max(reps // 10, 3), flush),
               index_add_ms=time_ms(seg, reps, flush),
               index_add_ms_warm_l2=time_ms(seg, reps),
               matvec_ms=time_ms(matvec, reps, flush),
               bound_ms=bound_ms, bound_by=bound_by,
               bound_ms_unfused=unfused_ms,
               mbytes=nbytes / 1e6, mflop=flops / 1e6)
    log("K1 " + json.dumps(rec))
    return rec


def k1_parity(device):
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
        # past the shared table: the global-atomic branch
        cases.append(k1_case("many_cams", [8] * 50_000, 4000, 8, dtype,
                             device, reps))
        for PC in (8, 3):
            cases.append(k1_case(f"mixed_L_pc{PC}", mixed, 200, PC, dtype,
                                 device, reps))
    if {c["branch"] for c in cases} != {"shared", "global"}:
        raise AssertionError("K1 cases do not reach both camera-sum branches")
    return cases


# ------------------------------------------------------------ K2/K3 parity

def composite_branch_cases(K, seed=SEED):
    """Hand-built tiles (ntx = 3) that reach every branch of K2/K3:
    0 empty (nchunks 0); 1 saturates in chunk 0 and exits early; 2 fills all
    K slots with faint gaussians (no exit); 3 populated rows in 2 chunks of
    a budget of up to 4; 4 rows with sigma <= 0 (non-PD conics), alpha
    clipped at 0.999 and alpha under 1/255; 5 a random mix.
    Returns numpy (attrs [6, K, 16] f32, nchunks [6] int32, ntx)."""
    rng = np.random.default_rng(seed)
    ntx, n = 3, 6
    maxc = K // k23.CHUNK
    A = np.zeros((n, K, k23.ATTR), np.float32)
    nch = np.zeros(n, np.int32)

    def fill(t, rows, scale, opac):
        ox, oy = (t % ntx) * 16, (t // ntx) * 16
        A[t, :rows, 0] = ox + rng.uniform(-4, 20, rows)
        A[t, :rows, 1] = oy + rng.uniform(-4, 20, rows)
        s = rng.uniform(*scale, rows)
        A[t, :rows, 2] = 1 / s ** 2 * rng.uniform(0.7, 1.3, rows)
        A[t, :rows, 3] = rng.uniform(-0.2, 0.2, rows) / s ** 2
        A[t, :rows, 4] = 1 / s ** 2 * rng.uniform(0.7, 1.3, rows)
        A[t, :rows, 5:8] = rng.uniform(0, 1, (rows, 3))
        A[t, :rows, 8] = rng.uniform(*opac, rows)
        A[t, :rows, 9] = np.sort(rng.uniform(1, 9, rows))
        nch[t] = -(-rows // k23.CHUNK)

    fill(1, K, (30, 60), (0.9, 0.99))            # saturates in chunk 0
    nch[1] = maxc
    fill(2, K, (2, 8), (0.02, 0.08))             # all of K, no exit
    fill(3, min(K, 200), (2, 6), (0.1, 0.5))
    nch[3] = min(maxc, 4)
    fill(4, 128, (2, 6), (0.3, 0.9))
    A[4, :20, 2] *= -1                           # sigma <= 0 rows
    A[4, 20:30, 8] = 1.0                         # clipped at 0.999
    A[4, 30:40, 8] = 0.003                       # alpha < 1/255
    fill(5, min(K, 300), (1, 10), (0.05, 0.95))
    return A, nch, ntx


def composite_cull_cases(K, seed=SEED):
    """Hand-built tiles (ntx = 3) whose gaussians sit on the edges of the
    kernels' cull (``k23.cull_boxes``): 0 axis-aligned ellipses whose
    alpha = 1/255 contour is tangent (within 2e-3 px) to the borders between
    the warps' 16x2 rectangles, to their first and last rows of pixel
    centres, and to the tile's outer columns; 1 thin rotated conics with
    |b| just under sqrt(ac), det / (a + c)^2 from about 1e-5 to 1e-2, on
    both sides of the det test; 2 opacities at, just above and well above
    1/255, and at, around and above the 0.999 clip; 3 conics that are not
    positive definite (negative, indefinite, zero) among ordinary rows;
    4 means far outside the tile (1e2 to 1e6 px), large enough to reach it
    or not; 5 means on pixel centres, where sigma = 0 exactly.  Offsets stay clear of the
    float ties of the alpha threshold, so every implementation of the alpha
    terms takes the same side.  Returns numpy (attrs [6, K, 16] f32,
    nchunks [6] int32, ntx)."""
    rng = np.random.default_rng(seed + 7)
    ntx, n = 3, 6
    A = np.zeros((n, K, k23.ATTR), np.float32)
    nch = np.zeros(n, np.int32)
    f32 = np.float32
    kmin = f32(1 / 255)

    def put(t, rows, mx, my, conic, opac):
        A[t, :rows, 0], A[t, :rows, 1] = mx, my
        A[t, :rows, 2], A[t, :rows, 3], A[t, :rows, 4] = conic
        A[t, :rows, 5:8] = rng.uniform(0, 1, (rows, 3))
        A[t, :rows, 8] = opac
        A[t, :rows, 9] = np.sort(rng.uniform(1, 9, rows))
        nch[t] = -(-rows // k23.CHUNK)

    def reach(op):
        """sqrt(s), s = 2 ln(255 op): a unit gaussian's contour radius."""
        return np.sqrt(2 * np.log(255 * op.astype(np.float64)))

    R = min(K, 384)
    for t in range(n):
        ox, oy = (t % ntx) * 16, (t // ntx) * 16
        if t == 0:
            sx, sy = rng.uniform(0.8, 4, R), rng.uniform(0.8, 4, R)
            op = rng.uniform(0.05, 0.4, R)
            rx, ry = sx * reach(op), sy * reach(op)
            w = rng.integers(0, 8, R)
            # a y edge: warp border, first or last pixel-centre row
            ye = oy + 2 * w + rng.choice([0.0, 0.5, 1.5], R)
            xe = ox + rng.choice([0.0, 0.5, 15.5, 16.0], R)
            d = rng.choice([-2e-3, 2e-3], R)
            side = rng.choice([-1, 1], R)
            on_y = rng.uniform(size=R) < 0.6
            my = np.where(on_y, ye + d + side * ry, oy + rng.uniform(0, 16, R))
            mx = np.where(on_y, ox + rng.uniform(0, 16, R),
                          xe + d + side * rx)
            put(t, R, mx, my, (1 / sx ** 2, np.zeros(R), 1 / sy ** 2), op)
        elif t == 1:
            # integer conics (A, B, C < 512) times 2^-p with B just under
            # sqrt(AC): half with C = ceil((B^2 + 1) / A), det = AC - B^2 in
            # [1, A], the others with B = 0.9..0.999 sqrt(AC); means on a
            # quarter-pixel grid within 7 px of the tile (|4 dx| <= 90).
            # Every product and partial sum of sigma is then an integer
            # under 2^24 times 2^-p-4, exact in float32, so FMA contraction
            # or another order gives the same sigma
            tight = rng.uniform(size=R) < 0.5
            A_ = np.where(tight, rng.integers(16, 97, R),
                          rng.integers(32, 512, R))
            b_max = np.floor(np.sqrt(511 * A_ - 1)).astype(np.int64)
            b_tight = rng.integers(np.floor(np.sqrt(64 * A_)).astype(np.int64),
                                   b_max + 1)
            c_loose = rng.integers(32, 512, R)
            B_ = np.where(tight, b_tight, np.floor(
                np.sqrt(A_ * c_loose) * rng.choice([0.9, 0.99, 0.999], R)))
            C_ = np.where(tight, -(-(b_tight ** 2 + 1) // A_), c_loose)
            scale = 2.0 ** rng.integers(-10, -3, R)
            put(t, R, ox + rng.integers(-28, 93, R) / 4,
                oy + rng.integers(-28, 93, R) / 4,
                (A_ * scale, rng.choice([-1, 1], R) * B_ * scale, C_ * scale),
                rng.uniform(0.1, 0.9, R))
        elif t == 2:
            ops = np.array([kmin, np.nextafter(kmin, f32(1)),
                            kmin * f32(1 + 1e-5), kmin * f32(1 + 1e-3),
                            f32(0.02), np.nextafter(f32(0.999), f32(0)),
                            f32(0.999), np.nextafter(f32(0.999), f32(1)),
                            f32(1.0)], np.float32)
            op = ops[rng.integers(0, len(ops), R)]
            # means on, near (1e-3 px) and away from pixel centres
            cx = ox + rng.integers(0, 16, R) + 0.5
            cy = oy + rng.integers(0, 16, R) + 0.5
            off = rng.choice([0.0, 1e-3, 0.25], R)[:, None] * \
                rng.choice([-1, 1], (R, 2))
            s = rng.uniform(0.5, 3, R)
            put(t, R, cx + off[:, 0], cy + off[:, 1],
                (1 / s ** 2, rng.uniform(-0.2, 0.2, R) / s ** 2, 1 / s ** 2),
                op)
        elif t == 3:
            kind = rng.integers(0, 5, R)            # 0, 1: ordinary rows
            # wider for the others, so that e = exp(-sigma/2) stays finite
            s = np.where(kind < 2, rng.uniform(1, 5, R), rng.uniform(3.5, 8, R))
            a, b, c = 1 / s ** 2, rng.uniform(-0.3, 0.3, R) / s ** 2, 1 / s ** 2
            a = np.where(kind == 2, -a, a)          # negative a
            c = np.where(kind == 3, -c, c)          # indefinite
            b = np.where(kind == 4, 2 * np.sqrt(np.abs(a * c)), b)   # det < 0
            zero = rng.uniform(size=R) < 0.05       # a = b = c = 0
            a, b, c = (np.where(zero, 0.0, v) for v in (a, b, c))
            put(t, R, ox + rng.uniform(-4, 20, R), oy + rng.uniform(-4, 20, R),
                (a, b, c), rng.uniform(0.05, 0.6, R))
        elif t == 4:
            dist = rng.choice([1e2, 1e3, 1e4, 1e6], R)
            ang = rng.uniform(0, 2 * np.pi, R)
            # sigma in pixels: some reach the tile (just), some do not
            sig = dist * rng.uniform(0.2, 0.6, R)
            put(t, R, ox + 8 + dist * np.cos(ang), oy + 8 + dist * np.sin(ang),
                (1 / sig ** 2, np.zeros(R), 1 / sig ** 2),
                rng.uniform(0.05, 0.5, R))
        else:
            s = rng.uniform(0.7, 4, R)
            centred = rng.uniform(size=R) < 0.7
            mx = np.where(centred, ox + rng.integers(0, 16, R) + 0.5,
                          ox + rng.uniform(-4, 20, R))
            my = np.where(centred, oy + rng.integers(0, 16, R) + 0.5,
                          oy + rng.uniform(-4, 20, R))
            put(t, R, mx, my,
                (1 / s ** 2, rng.uniform(-0.2, 0.2, R) / s ** 2, 1 / s ** 2),
                rng.uniform(0.05, 0.5, R))
    return A, nch, ntx


def entered(logt):
    """[n, K/128] bool: the chunks K2's walk entered."""
    return logt.amax(dim=2) > 0.5 * k23.NOT_RUN


def composite_work(attrs, logt, ntx):
    """What K2/K3 must do on these inputs: the entered chunks, the
    (gaussian, pixel) pairs in them, the (row, warp) pairs the cull keeps
    and the pairs those hold (32 each), the (row, warp) pairs where some
    pixel's alpha is live, and the live pairs.  The kept counts
    (``warp_rows_kept``, ``pairs_after_cull``) are those of the plain
    mirror of the cull, ``k23.cull_rows``, which computes the kernels'
    record with the same formula; they are not read back from the kernels.
    Raises if the mirror would skip a live pair.  The kernels' own cull is
    held by output parity (``k23_case``): a skipped live pair has alpha
    > 1/255 and would move its pixel beyond the tolerance unless its T is
    tiny."""
    t_idx, c_idx = entered(logt).nonzero(as_tuple=True)
    px, py = k23.pixel_coords(attrs.shape[0], ntx, attrs.device)
    rows = torch.arange(k23.CHUNK, device=attrs.device)
    kept_all = k23.cull_rows(attrs, ntx)                     # [n, K, NWARP]
    kept = live_rows = live = 0
    for lo in range(0, len(t_idx), 256):
        t, c = t_idx[lo:lo + 256], c_idx[lo:lo + 256]
        r = c[:, None] * k23.CHUNK + rows[None, :]
        alive = k23.alpha_terms(attrs[t[:, None], r], px[t], py[t])[0] > 0
        alive_w = alive.view(len(t), k23.CHUNK, k23.NWARP, 32).any(dim=-1)
        kw = kept_all[t[:, None], r]
        if (alive_w & ~kw).any():
            raise AssertionError("the cull skips a live (gaussian, pixel) "
                                 "pair")
        kept += int(kw.sum())
        live_rows += int(alive_w.sum())
        live += int(alive.sum())
    E = len(t_idx)
    return dict(chunks_entered=E, pairs=E * k23.CHUNK * k23.P,
                warp_rows_kept=kept, pairs_after_cull=32 * kept,
                live_warp_rows=live_rows, live_pairs=live)


def _bound(nbytes, flops, sfu):
    """(bound_ms, bound_by, counts): the largest of the byte, FP32 and
    special-function times."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[torch.float32]
    t_s = sfu / PEAK_SFU
    t = max(t_b, t_f, t_s)
    return (t * 1e3, "bytes" if t_b >= max(t_f, t_s) else "operations",
            dict(mbytes=nbytes / 1e6, gflop=flops / 1e9, gsfu=sfu / 1e9,
                 bytes_ms=t_b * 1e3, fp32_ms=t_f * 1e3, sfu_ms=t_s * 1e3))


# Work units of K2/K3 (FP32 operations, special-function results):
# the cull record of a row (det, trace, s and its margin, two half-extents
# with theirs, the box, the rules; a log, two divisions, two square roots),
# one box test per (row, warp) (four compares, three ors), the alpha terms
# of a pair (offsets, the conic form, exp argument, opacity, clip, the two
# tests; an exp).
RECORD_WORK = (30, 5)
TEST_WORK = 7
ALPHA_WORK = (16, 1)
# per live pair: K2's weight, colour and depth sums and prefix (a log1p and
# an exp); K3's prefix and T, 51 for the gradient terms and their pixel
# sums (a log1p, an exp and a reciprocal)
LIVE_WORK = {"K2": (12, 2), "K3": (54, 3)}


def k23_bytes(kname, attrs, work):
    """The entered chunks' attrs read once; K2 reads nchunks and writes out
    and logt once, K3 reads the 5 live rows of gout and logt and writes all
    of g_attrs once."""
    n, K, A = attrs.shape
    inputs = 4 * work["chunks_entered"] * k23.CHUNK * A
    logt = 4 * n * (K // k23.CHUNK) * k23.P
    if kname == "K2":
        return inputs + 4 * n + 4 * n * 8 * k23.P + logt
    return inputs + 4 * n * 5 * k23.P + logt + 4 * n * K * A


def k23_bound(kname, attrs, work):
    """What the redesigned kernel must do: a cull record per row of an
    entered chunk, a box test per (row, warp), the alpha terms per pair the
    cull keeps, and the live pairs' work."""
    rows = work["chunks_entered"] * k23.CHUNK
    kept = work["pairs_after_cull"]
    live_ops, live_sfu = LIVE_WORK[kname]
    flops = (RECORD_WORK[0] * rows + TEST_WORK * rows * k23.NWARP
             + ALPHA_WORK[0] * kept + live_ops * work["live_pairs"])
    sfu = (RECORD_WORK[1] * rows + ALPHA_WORK[1] * kept
           + live_sfu * work["live_pairs"])
    return _bound(k23_bytes(kname, attrs, work), flops, sfu)


def k23_bound_all_pairs(kname, attrs, work):
    """The bound without a cull (the first port's count): the alpha terms
    of every pair of an entered chunk, and the live pairs' work."""
    pairs = work["pairs"]
    live_ops, live_sfu = LIVE_WORK[kname]
    return _bound(k23_bytes(kname, attrs, work),
                  ALPHA_WORK[0] * pairs + live_ops * work["live_pairs"],
                  ALPHA_WORK[1] * pairs + live_sfu * work["live_pairs"])


def _tied_tiles(logt_a, logt_b):
    """Tiles whose two walks entered different chunks.  Raises unless each
    is a float tie of the exit vote: the walk that went on found its
    largest log T within 1e-3 of log 1e-4."""
    ea, eb = entered(logt_a), entered(logt_b)
    tiles = (ea != eb).any(dim=1).nonzero()[:, 0]
    for t in tiles.tolist():
        c = int((ea[t] != eb[t]).nonzero()[0, 0])
        m = max(float(logt_a[t, c].max()), float(logt_b[t, c].max()))
        if abs(m - k23.LOG_EPS_T) > 1e-3:
            raise AssertionError(f"K2 tile {t}: walks differ at chunk {c} "
                                 f"(max log T {m})")
    return tiles


def _assert_rel(name, got, want, rel, max_ties=0, per_tile=False):
    """|got - want| <= rel * max|want| elementwise, the max taken over the
    whole tensor or, with ``per_tile``, over each tile (dim 0) apart;
    except for at most ``max_ties`` elements (see ``k23_case``).  Returns
    (max abs error of the others, number of elements beyond the tolerance,
    max of error / scale of the others)."""
    if per_tile:
        scale = want.abs().reshape(len(want), -1).amax(dim=1).view(
            (-1,) + (1,) * (want.dim() - 1))
    else:
        scale = want.abs().max()
    scale = scale.clamp(min=1e-30)
    err = (got - want).abs()
    bad = ~(err <= rel * scale)
    n_bad = int(bad.sum())
    if n_bad > max_ties or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {n_bad} elements beyond {rel} of the "
                             f"max, max abs err {err.max().item()}")
    if n_bad == err.numel():
        return 0.0, n_bad, 0.0
    return (err[~bad].max().item(), n_bad,
            (err / scale)[~bad].max().item())


def k23_case(name, attrs, nchunks, ntx, reps, allow_ties=False,
             per_tile=False):
    """K2 and K3 against their plain versions on the card, timed.
    Tolerances (float32, sums in other orders): rel 1e-5 of each output row
    group's max for K2, 1e-4 of each gradient column's max for K3; with
    ``per_tile`` each max is taken over each tile apart (tiles of unlike
    scales: the conic gradients of a gaussian 1e6 px away reach 1e11).  The
    kernels evaluate the alpha terms with the plain version's roundings, so
    both take the same side of each threshold; with ``allow_ties`` (a real
    view's tiles) a tile whose exit vote is a float tie is set apart, and
    up to 16 elements per output may still differ (logged as ``ties``)."""
    dev = attrs.device
    max_ties = 16 if allow_ties else 0
    g = torch.Generator(device=dev).manual_seed(SEED)
    gout = torch.randn((attrs.shape[0], 8, k23.P), generator=g, device=dev)
    want_out, want_logt = k23.composite_fwd_reference(attrs, nchunks, ntx)
    got_out, got_logt = k23.composite_fwd(attrs, nchunks, ntx)
    torch.cuda.synchronize()
    tied = _tied_tiles(got_logt, want_logt)
    if len(tied) and not allow_ties:
        raise AssertionError(f"K2 {name}: walks differ on tiles {tied}")
    keep = torch.ones(attrs.shape[0], dtype=torch.bool, device=dev)
    keep[tied] = False
    ent = entered(want_logt)[keep]
    fwd = [_assert_rel(f"K2 {name} {part}", got_out[keep][:, rows],
                       want_out[keep][:, rows], 1e-5, max_ties, per_tile)
           for part, rows in (("rgb", slice(0, 3)), ("alpha", slice(3, 4)),
                              ("depth", slice(4, 5)))]
    logt_err, logt_ties, _ = _assert_rel(
        f"K2 {name} logt", got_logt[keep][ent], want_logt[keep][ent], 1e-5,
        max_ties)
    if (got_out[:, 5:] != 0).any():
        raise AssertionError(f"K2 {name}: rows 5..7 of out are not zero")

    want_g = k23.composite_bwd_reference(attrs, want_logt, gout, ntx)
    got_g = k23.composite_bwd(attrs, got_logt, gout, ntx)
    torch.cuda.synchronize()
    bwd = [_assert_rel(f"K3 {name} column {c}", got_g[keep][..., c],
                       want_g[keep][..., c], 1e-4, max_ties, per_tile)
           for c in range(10)]
    dead = ~entered(got_logt).repeat_interleave(k23.CHUNK, dim=1)
    if (got_g[..., 10:] != 0).any() or (got_g[dead] != 0).any():
        raise AssertionError(f"K3 {name}: rows of unentered chunks or "
                             "columns 10..15 are not zero")

    work = composite_work(attrs, got_logt, ntx)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    recs = []
    for kname, kernel, plain in (
            ("K2", lambda: k23.composite_fwd(attrs, nchunks, ntx),
             lambda: k23.composite_fwd_reference(attrs, nchunks, ntx)),
            ("K3", lambda: k23.composite_bwd(attrs, got_logt, gout, ntx),
             lambda: k23.composite_bwd_reference(attrs, got_logt, gout, ntx))):
        bound_ms, bound_by, counts = k23_bound(kname, attrs, work)
        rec = dict(case=name, tiles=attrs.shape[0], K=attrs.shape[1],
                   **work, tied_tiles=len(tied),
                   ties=sum(t for _, t, _ in (fwd + [(0, logt_ties, 0)]
                                              if kname == "K2" else bwd)),
                   max_abs_err=max(e for e, _, _ in
                                   (fwd if kname == "K2" else bwd)),
                   max_rel_err=max(r for _, _, r in
                                   (fwd if kname == "K2" else bwd)),
                   ms=time_ms(kernel, reps, flush),
                   ms_warm_l2=time_ms(kernel, reps),
                   plain_ms=time_ms(plain, 3, flush, queued=False),
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_ms_all_pairs=k23_bound_all_pairs(kname, attrs,
                                                          work)[0],
                   **counts)
        if kname == "K2":
            rec["max_abs_err_logt"] = logt_err
        log(f"{kname} " + json.dumps(rec))
        if rec["ms"] < 0.95 * bound_ms:
            raise AssertionError(f"{kname} {name}: {rec['ms']} ms is under "
                                 f"95% of its bound {bound_ms} ms: the bound "
                                 "counts work the kernel does not do")
        recs.append(rec)
    return recs


def k23_parity(device):
    """K2/K3 on the branch and cull cases at K = 128 and 512:
    {case: (K2, K3)}."""
    cases = {}
    for kind, make in (("branches", composite_branch_cases),
                       ("cull", composite_cull_cases)):
        for K in (128, 512):
            A, nch, ntx = make(K)
            cases[f"{kind}_K{K}"] = k23_case(
                f"{kind}_K{K}", torch.as_tensor(A, device=device),
                torch.as_tensor(nch, device=device), ntx, reps=20,
                per_tile=kind == "cull")
    return cases


# ------------------------------------------------------------ BA path

def ring_rotation(center):
    """World->camera rotation of a camera at ``center`` looking at the
    origin (rows x, y, z)."""
    z = -center / np.linalg.norm(center)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], 0)


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
    Rs = np.stack([ring_rotation(c) for c in centers])
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
    k1.schur_wchain.launches = k1.schur_wchain.plain_calls = 0
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
               k1_launches=launches,
               k1_plain_calls=k1.schur_wchain.plain_calls,
               cost_before=cost0, cost_after=cost1,
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


# ------------------------------------------------------------ SfM path

SFM_CAMS, SFM_POINTS, SFM_WINDOW = 200, 20_000, 12   # bench_e2e.py:26-28


def write_ring_db(dbpath, num_cams=SFM_CAMS, num_pts=SFM_POINTS,
                  window=SFM_WINDOW, seed=SEED, match_noise=0.4,
                  outlier_frac=0.08, vis_angle=0.9):
    """A seeded COLMAP database at the ETH3D-indoor scale (the scene of
    ``bench_e2e.py::build_scene_db``, in numpy): ``num_cams`` SIMPLE_RADIAL
    cameras (f 520, k1 0.01, 640x480) on a ring of radius 8 looking at a
    6-unit cube of ``num_pts`` points, each camera seeing the points within
    ``vis_angle`` radians of its own bearing; keypoints are the projections
    plus ``match_noise`` px of noise; each camera is matched with the next
    ``window`` on the ring (pairs with < 30 shared points are skipped), with
    ``outlier_frac`` of every pair's matches redirected to random keypoints,
    all pairs CALIBRATED.  Returns the ground truth (world->cam xyzw qvec,
    tvec, centers) and the pair and match counts."""
    rng = np.random.default_rng(seed)
    f_px, cx, cy, k1_ = 520.0, 320.0, 240.0, 0.01
    width, height = 640, 480
    angles = np.linspace(0, 2 * np.pi, num_cams, endpoint=False)
    centers = np.stack([8.0 * np.cos(angles), 8.0 * np.sin(angles),
                        1.0 + 0.3 * rng.standard_normal(num_cams)], -1)
    points = rng.uniform(-3.0, 3.0, (num_pts, 3))
    pt_angle = np.arctan2(points[:, 1], points[:, 0])
    Rs = np.stack([ring_rotation(c) for c in centers])
    qvec = lie.matrix_to_quat(torch.as_tensor(Rs)).numpy()
    tvec = -np.einsum("cij,cj->ci", Rs, centers)

    kp, idx_of = [], []
    for i in range(num_cams):
        xyz = points @ Rs[i].T + tvec[i]
        uv = xyz[:, :2] / (xyz[:, 2:3] + 1e-12)
        xy = uv * (1.0 + k1_ * np.sum(uv * uv, 1, keepdims=True)) * f_px \
            + np.array([cx, cy])
        dang = np.abs(np.angle(np.exp(1j * (pt_angle - angles[i]))))
        vis = ((xyz[:, 2] > 0.5) & (dang < vis_angle)
               & (xy[:, 0] > 0) & (xy[:, 0] < width)
               & (xy[:, 1] > 0) & (xy[:, 1] < height))
        idx = np.nonzero(vis)[0]
        kp.append(xy[idx] + match_noise * rng.standard_normal((len(idx), 2)))
        idx_of.append(idx.astype(np.int32))

    n_pairs = n_matches = 0
    with ColmapDatabase.connect(dbpath) as db:
        db.create_tables()
        cam_id = db.add_camera(cm.SIMPLE_RADIAL, width, height,
                               [f_px, cx, cy, k1_], prior_focal=True)
        img_ids = [db.add_image(f"img{i:04d}.jpg", cam_id)
                   for i in range(num_cams)]
        for i in range(num_cams):
            db.add_keypoints(img_ids[i], kp[i])
        map_i = np.full(num_pts, -1, np.int32)   # point -> feature in image i
        for i in range(num_cams):
            map_i[:] = -1
            map_i[idx_of[i]] = np.arange(len(idx_of[i]), dtype=np.int32)
            for dj in range(1, window + 1):
                j = (i + dj) % num_cams
                fi_of_j = map_i[idx_of[j]]
                both = fi_of_j >= 0
                if int(both.sum()) < 30:
                    continue
                fi = fi_of_j[both]
                fj = np.nonzero(both)[0].astype(np.int32)
                # every ring edge once, lower image id first
                a, b = (j, i) if j < i else (i, j)
                m = np.stack([fj, fi] if j < i else [fi, fj], 1)
                n_out = int(outlier_frac * len(m))
                if n_out:
                    sel = rng.choice(len(m), n_out, replace=False)
                    m[sel, 1] = rng.integers(0, len(kp[b]), n_out)
                db.add_matches(img_ids[a], img_ids[b], m)
                db.add_two_view_geometry(img_ids[a], img_ids[b], m,
                                         config=CONFIG_CALIBRATED)
                n_pairs += 1
                n_matches += len(m)
        db.set_feature_name("colmap")
    return dict(q=qvec, t=tvec, centers=centers), n_pairs, n_matches


def sfm_errors(images, gt):
    """Rotation errors (degrees, after removing the global rotation gauge)
    and absolute center errors as a share of the ground-truth extent (after
    Umeyama similarity alignment), over the registered images."""
    reg = np.nonzero(images.registered)[0]
    return aligned_errors(images.qvec[reg], images.centers()[reg],
                          gt["q"][reg], gt["centers"][reg])


def aligned_errors(q_est, c_est, q_gt, c_gt):
    """``sfm_errors`` for world->cam xyzw quaternions and centers."""
    R_est = lie.quat_to_matrix(torch.as_tensor(q_est)).numpy()
    R_gt = lie.quat_to_matrix(torch.as_tensor(q_gt)).numpy()
    U, _, Vt = np.linalg.svd(np.einsum("nji,njk->ik", R_est, R_gt))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R_al = np.einsum("nij,jk->nik", R_est, U @ S @ Vt)
    rot = np.degrees(np.arccos(np.clip(
        (np.einsum("nij,nij->n", R_al, R_gt) - 1) / 2, -1.0, 1.0)))
    s, R, t = umeyama(c_est, c_gt)
    ate = np.linalg.norm(s * c_est @ R.T + t - c_gt, axis=1)
    extent = float(np.linalg.norm(c_gt.max(0) - c_gt.min(0)))
    return rot, ate / extent


def profile_relpose(dbpath, device):
    """The relative-pose stage of the mapper once more, under torch.profiler:
    its wall and device-busy time, and the calls and time of
    ``torch.linalg.eigh`` (the 3x3 SVDs of ``math/epipolar.py::svd3x3``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    view_graph, cameras, images, feature_name = read_colmap_database(dbpath)
    cfg = Config(feature_name)
    preprocess.update_image_pairs_config(view_graph, cameras, images)
    preprocess.decompose_relpose(view_graph, cameras, images)
    vgc.solve_view_graph_calibration(
        view_graph, cameras, images, cfg.VIEW_GRAPH_CALIBRATOR_OPTIONS,
        dtype=torch.float32, device=device)
    relpose.undistort_images(cameras, images, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        relpose.estimate_relative_pose(view_graph, cameras, images,
                                       dtype=torch.float32, device=device)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(ev.self_device_time_total for ev in events
                  if ev.device_type == DeviceType.CUDA) / 1e3
    eigh = [ev for ev in events if ev.key == "aten::linalg_eigh"]
    host_top = sorted((ev for ev in events if ev.device_type == DeviceType.CPU
                       and ev.key.startswith("aten::")),
                      key=lambda ev: -ev.self_cpu_time_total)[:8]
    batch = torch.randn((256, 3, 3), device=device)
    batch = batch.transpose(-1, -2) @ batch
    return dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        host_top=[dict(op=ev.key, n=ev.count,
                       self_ms=ev.self_cpu_time_total / 1e3)
                  for ev in host_top],
        eigh_calls=sum(ev.count for ev in eigh),
        eigh_host_ms=sum(ev.cpu_time_total for ev in eigh) / 1e3,
        eigh_device_ms=sum(ev.device_time_total for ev in eigh) / 1e3,
        eigh_ms_256x3x3=time_ms(lambda: torch.linalg.eigh(batch), 20,
                                queued=False))


def k1_sfm_check(stage, args, device):
    """K1 against its plain version on one input the mapper gave it."""
    W, V_inv, x, cam, pt, buckets = args
    want = k1.schur_wchain_reference(*args)
    got = k1.schur_wchain(*args)
    torch.cuda.synchronize()
    if not want.any():
        raise AssertionError(f"K1 on the mapper's {stage} input: y is 0")
    err, rel_err = k1_check(f"K1 on the mapper's {stage} input", got, want,
                            k1_abs_sums(*args))
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    return dict(PC=W.shape[1], rows=W.shape[0], points=V_inv.shape[0],
                cams=x.shape[0], L=sorted({b[3] for b in buckets}),
                max_abs_err=err, max_err_over_abs_sum=rel_err,
                max_abs_y=want.abs().max().item(),
                ms=time_ms(lambda: k1.schur_wchain(*args), 20, flush),
                plain_ms=time_ms(lambda: k1.schur_wchain_reference(*args), 5,
                                 flush),
                bound_ms=k1_bound(W, V_inv, x, buckets)[0])


def run_sfm(device, root, profile=False):
    """The global SfM mapper at the ETH3D-indoor scale through the port's
    entry points: a COLMAP database is written in ``root``, read back,
    solved by ``solve_global_mapper`` in float32 on the card and written as
    a sparse model, which is read back and held against the ground truth.
    The first K1 input with x != 0 of global positioning and of bundle
    adjustment is kept and K1 is held against its plain version on it.
    ``profile`` also runs the relative-pose stage once more under
    torch.profiler.  Returns (SFM record, ground truth, database path)."""
    dbpath = os.path.join(root, "database.db")
    t0 = time.perf_counter()
    gt, n_pairs, n_matches = write_ring_db(dbpath)
    build_db_s = time.perf_counter() - t0
    log(f"SfM scene: {SFM_CAMS} images, {SFM_POINTS} points, window "
        f"{SFM_WINDOW}: {n_pairs} pairs, {n_matches} matches "
        f"({build_db_s:.1f} s to write)")

    launches_at, k1_inputs_at = {}, {}

    def hook(name, *_):
        launches_at[name] = k1.schur_wchain.launches

    launch = block_lm.schur_wchain

    def keep_first_input(*args):
        # K1 runs only in GP and BA: before GP's hook, a call is GP's.
        # PCG's first matvec is of x0 = 0, whose y is 0 whatever K1 does
        stage = ("bundle_adjustment" if "global_positioning" in launches_at
                 else "global_positioning")
        if stage not in k1_inputs_at and bool(args[2].any()):
            k1_inputs_at[stage] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)
        return launch(*args)

    debug.drain_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_lm.schur_wchain = keep_first_input
    k1.schur_wchain.launches = k1.schur_wchain.plain_calls = 0
    try:
        t_start = time.perf_counter()
        view_graph, cameras, images, feature_name = read_colmap_database(
            dbpath)
        db_read_s = time.perf_counter() - t_start
        cameras, images, tracks, timings = solve_global_mapper(
            view_graph, cameras, images, Config(feature_name),
            dtype=torch.float32, log=lambda *a: None, stage_hook=hook,
            device=device)
        t0 = time.perf_counter()
        out = os.path.join(root, "sparse")
        write_reconstruction(out, cameras, images, tracks)
        write_s = time.perf_counter() - t0
        total_s = time.perf_counter() - t_start
    finally:
        block_lm.schur_wchain = launch
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = k1.schur_wchain.launches
    stats = debug.drain_stats()
    t0 = time.perf_counter()
    cams_m, imgs_m, pts_m = cmio.read_model(os.path.join(out, "0"))
    read_model_s = time.perf_counter() - t0
    relpose_prof = None
    if profile:
        t0 = time.perf_counter()
        relpose_prof = profile_relpose(dbpath, device)
        relpose_prof["seconds"] = time.perf_counter() - t0

    # launches made here to compare K1 with its plain version are not counted
    k1_sfm = {stage: k1_sfm_check(stage, args, device)
              for stage, args in k1_inputs_at.items()}
    del k1_inputs_at
    rot, ate = sfm_errors(images, gt)
    gp_launches = launches_at.get("global_positioning", 0)
    ba_launches = launches_at.get("bundle_adjustment", gp_launches) - gp_launches
    ra_syncs = stats.get("ra_syncs", [])
    rec = dict(
        images=SFM_CAMS, points=SFM_POINTS, pairs=n_pairs, matches=n_matches,
        db_read_s=db_read_s, stage_s=timings, write_s=write_s,
        total_s=total_s, build_db_s=build_db_s, read_model_s=read_model_s,
        peak_device_gb=peak_gb,
        registered=int(images.registered.sum()),
        tracks=int(tracks.num_tracks),
        observations=int(tracks.num_observations),
        model_images=len(imgs_m), model_points=len(pts_m),
        gp_lm_iters=stats.get("gp_lm_iters"),
        ba_lm_iters=stats.get("ba_lm_iters"),
        k1_launches_gp=gp_launches, k1_launches_ba=ba_launches,
        k1_launches_total=launches,
        k1_plain_calls=k1.schur_wchain.plain_calls,
        k1_max_abs_err_gp=k1_sfm.get("global_positioning", {}).get(
            "max_abs_err"),
        k1_max_abs_err_ba=k1_sfm.get("bundle_adjustment", {}).get(
            "max_abs_err"),
        k1_on_mapper_inputs=k1_sfm,
        ra_syncs=ra_syncs,
        ra_syncs_total=sum(sum(d.values()) for d in ra_syncs),
        vgc_syncs=stats.get("vgc_syncs"), relpose_profile=relpose_prof,
        rot_err_deg_max=float(rot.max()), rot_err_deg_mean=float(rot.mean()),
        ate_rel_max=float(ate.max()), ate_rel_mean=float(ate.mean()),
        card=card_line())
    log("SFM " + json.dumps(rec))
    checks = {
        f"{SFM_CAMS}/{SFM_CAMS} images registered":
            rec["registered"] == SFM_CAMS,
        "model read back has every image": len(imgs_m) == SFM_CAMS,
        "model read back has every track": len(pts_m) == rec["tracks"],
        "max rotation error < 1 degree": rec["rot_err_deg_max"] < 1.0,
        "max ATE < 1% of the extent": rec["ate_rel_max"] < 0.01,
        "K1 launched in global positioning": gp_launches > 0,
        "K1 launched in bundle adjustment": ba_launches > 0,
        "K1 launched only in those stages": launches == gp_launches + ba_launches,
        "K1 held against its plain version on a GP and a BA input":
            set(k1_sfm) == {"global_positioning", "bundle_adjustment"},
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"SfM main path failed: {failed}")
    return rec, gt, dbpath


def run_sfm_retri(device, dbpath, gt):
    """The mapper once more on the SfM phase's database, with
    retriangulation and pruning on (float32 on the card).  The first K1
    input with x != 0 at PC = 2 (the frozen-pose BA of retriangulation on
    SIMPLE_RADIAL cameras) is kept and K1 is held against its plain version
    on it.  Returns the SFM_RETRI record."""
    launches_at, retri_input, retri_by_pc = {}, {}, {}

    def hook(name, *_):
        launches_at[name] = k1.schur_wchain.launches

    launch = block_lm.schur_wchain

    def keep_pc2_input(*args):
        PC = args[0].shape[1]
        in_retri = "bundle_adjustment" in launches_at
        if in_retri and PC == 2 and not retri_input and bool(args[2].any()):
            retri_input["args"] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)
        before = k1.schur_wchain.launches
        out = launch(*args)
        if in_retri:
            retri_by_pc[PC] = (retri_by_pc.get(PC, 0)
                               + k1.schur_wchain.launches - before)
        return out

    cfg = Config("colmap")
    cfg.OPTIONS.update(skip_retriangulation=False, skip_pruning=False)
    debug.drain_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_lm.schur_wchain = keep_pc2_input
    k1.schur_wchain.launches = k1.schur_wchain.plain_calls = 0
    try:
        t0 = time.perf_counter()
        view_graph, cameras, images, feature_name = read_colmap_database(dbpath)
        cameras, images, tracks, timings = solve_global_mapper(
            view_graph, cameras, images, cfg, dtype=torch.float32,
            log=lambda *a: None, stage_hook=hook, device=device)
        total_s = time.perf_counter() - t0
    finally:
        block_lm.schur_wchain = launch
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = k1.schur_wchain.launches
    plain_calls = k1.schur_wchain.plain_calls
    stats = debug.drain_stats()

    k1_pc2 = (k1_sfm_check("retriangulation (PC = 2)", retri_input["args"],
                           device) if retri_input else None)
    rot, ate = sfm_errors(images, gt)
    gp = launches_at.get("global_positioning", 0)
    ba_ = launches_at.get("bundle_adjustment", gp)
    retri = launches_at.get("retriangulation", ba_)
    clusters = images.cluster_id[images.cluster_id >= 0]
    rec = dict(
        images=SFM_CAMS, stage_s=timings, total_s=total_s,
        peak_device_gb=peak_gb, registered=int(images.registered.sum()),
        tracks=int(tracks.num_tracks),
        observations=int(tracks.num_observations),
        retri_s=timings.get("retriangulation"),
        pruning_s=timings.get("pruning"),
        refinement_rounds=len(stats.get("retri_changed_share", [])),
        changed_share=stats.get("retri_changed_share"),
        ba_lm_iters=stats.get("ba_lm_iters"),
        clusters=int(len(np.unique(clusters))),
        images_per_cluster=np.bincount(clusters).tolist(),
        images_in_clusters=int(len(clusters)),
        k1_launches_gp=gp, k1_launches_ba=ba_ - gp,
        k1_launches_retri=retri - ba_, k1_launches_retri_by_pc=retri_by_pc,
        k1_launches_total=launches, k1_plain_calls=plain_calls,
        k1_on_retri_pc2_input=k1_pc2,
        rot_err_deg_max=float(rot.max()), rot_err_deg_mean=float(rot.mean()),
        ate_rel_max=float(ate.max()), ate_rel_mean=float(ate.mean()),
        card=card_line())
    log("SFM_RETRI " + json.dumps(rec))
    checks = {
        f"{SFM_CAMS}/{SFM_CAMS} images registered":
            rec["registered"] == SFM_CAMS,
        "max rotation error < 1 degree": rec["rot_err_deg_max"] < 1.0,
        "max ATE < 1% of the extent": rec["ate_rel_max"] < 0.01,
        "at least 90% of the images (180 of 200) carry a cluster id":
            rec["images_in_clusters"] >= 0.9 * SFM_CAMS,
        "retriangulation ran at least one refinement round":
            rec["refinement_rounds"] >= 1,
        "K1 launched at PC = 2 in retriangulation":
            retri_by_pc.get(2, 0) > 0,
        "K1 held against its plain version on a PC = 2 input":
            k1_pc2 is not None and k1_pc2["PC"] == 2,
        "K1 launched only in GP, BA and retriangulation": launches == retri,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"SfM with retriangulation and pruning "
                             f"failed: {failed}")
    return rec


# ------------------------------------------------------------ pixels path

PIX_VIEWS, PIX_W, PIX_H, PIX_F = 16, 480, 360, 400.0   # test_pixels_e2e.py
FEAT_VIEWS, FEAT_W, FEAT_H, FEAT_KEYPOINTS = 200, 640, 480, 4096


def look_at(center, target, up=(0, 1e-4, 1)):
    """World->camera rotation (rows x, y, z) of a camera at ``center``
    looking at ``target``."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, float), z)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=0)


def render_plane_scene(root, device, n_cams=PIX_VIEWS, W=PIX_W, H=PIX_H,
                       f=PIX_F, seed=SEED):
    """Photo-like views of ``tests/test_pixels_e2e.py``'s scene, rendered
    by the port's rasterizer (K2): 6,300 flat gaussians textured on four
    planes of a room corner (floor, two walls, a raised table), seen by
    ``n_cams`` pinhole cameras on an arc of 150 degrees at radius 3.5,
    written as ``root/images/v###.png``.  Returns the ground truth
    (world->cam xyzw quaternions, centers), in view order."""
    rng = np.random.default_rng(seed)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])

    def plane_blobs(n, origin, eu, ev, nrm, lift=0.0):
        uv = rng.uniform(0, 1, (n, 2))
        c = origin[None] + uv[:, :1] * eu[None] + uv[:, 1:] * ev[None]
        c[:, 2] += lift
        su = np.exp(rng.uniform(np.log(0.01), np.log(0.08), (n, 1)))
        sv = np.exp(rng.uniform(np.log(0.01), np.log(0.08), (n, 1)))
        sn = np.full((n, 1), 0.002)
        z = np.array([0.0, 0, 1])
        ax = np.cross(z, nrm)
        ang = np.arctan2(np.linalg.norm(ax), z @ nrm)
        ax = ax / (np.linalg.norm(ax) + 1e-12)
        base = lie.rotvec_to_matrix(torch.as_tensor(ax * ang))
        spin = lie.rotvec_to_matrix(torch.as_tensor(
            np.outer(rng.uniform(0, np.pi, n), nrm)))
        q = lie.matrix_to_quat(spin @ base).numpy()
        return c, np.concatenate([su, sv, sn], 1), q

    planes = [
        plane_blobs(2500, np.array([-2.0, -2, -1]), np.array([4.0, 0, 0]),
                    np.array([0.0, 4, 0]), np.array([0.0, 0, 1])),
        plane_blobs(1500, np.array([-2.0, -2, -1]), np.array([4.0, 0, 0]),
                    np.array([0.0, 0, 2.5]), np.array([0.0, 1, 0])),
        plane_blobs(1500, np.array([-2.0, -2, -1]), np.array([0.0, 4, 0]),
                    np.array([0.0, 0, 2.5]), np.array([1.0, 0, 0])),
        plane_blobs(800, np.array([-0.6, -0.6, -1]), np.array([1.2, 0, 0]),
                    np.array([0.0, 1.2, 0]), np.array([0.0, 0, 1]),
                    lift=0.8),
    ]
    n_pts = sum(len(p[0]) for p in planes)
    colors = rng.uniform(0.02, 0.98, (n_pts, 3))
    opac = rng.uniform(0.6, 1.0, n_pts)
    dev32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    gauss = [dev32(np.concatenate([p[i] for p in planes])) for i in (0, 2, 1)]
    gauss += [dev32(opac), dev32(gs_sh.rgb_to_sh(colors)[:, None, :])]

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    gt_q, gt_c = [], []
    for i, a in enumerate(np.linspace(np.deg2rad(-30), np.deg2rad(120),
                                      n_cams)):
        c = np.array([3.5 * np.cos(a), 3.5 * np.sin(a), 1.0])
        Rm = look_at(c, np.array([-0.5, -0.5, -0.3]))
        view = np.eye(4)
        view[:3, :3], view[:3, 3] = Rm, -Rm @ c
        with torch.no_grad():
            out = gs_raster.rasterize(*gauss, dev32(view), dev32(K), width=W,
                                      height=H, sh_degree=0,
                                      tiles_per_gauss=16, tile_capacity=256)
        img = (torch.clamp(out.rgb, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        imwrite(os.path.join(root, "images", f"v{i:03d}.png"), img)
        gt_q.append(lie.matrix_to_quat(torch.as_tensor(Rm)).numpy())
        gt_c.append(c)
    return dict(q=np.array(gt_q), centers=np.array(gt_c))


def model_errors(model_dir, gt):
    """(registered views, points, rotation errors in degrees, ATE / extent)
    of a sparse model written from ``render_plane_scene``'s views."""
    _, imgs_m, pts_m = cmio.read_model(model_dir)
    idx = np.array([int(im.name[1:4]) for im in imgs_m.values()])
    q = np.array([np.roll(im.qvec_wxyz, -1) for im in imgs_m.values()])
    R = lie.quat_to_matrix(torch.as_tensor(q)).numpy()
    t = np.array([im.tvec for im in imgs_m.values()])
    centers = -np.einsum("nji,nj->ni", R, t)
    rot, ate = aligned_errors(q, centers, gt["q"][idx], gt["centers"][idx])
    return len(imgs_m), len(pts_m), rot, ate


def run_pixels(device):
    """Pixels to poses through the port's command-line entry points, as
    ``tests/test_pixels_e2e.py`` does with JAX's: 16 rendered views, then
    ``cli.feat`` (SIFT and matching on the card) and ``cli.sfm`` (the mapper
    on the card, float32), then ``sparse/0`` read back and held against the
    render's ground truth with that test's bars."""
    from instantsfm_tpu_torch.cli import feat as cli_feat
    from instantsfm_tpu_torch.cli import sfm as cli_sfm
    from instantsfm_tpu_torch.features import handler

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pixels_") as work:
        t0 = time.perf_counter()
        k23.composite_fwd.launches = 0
        gt = render_plane_scene(work, device)
        render_s = time.perf_counter() - t0
        k2_render = k23.composite_fwd.launches
        feat_stats = []
        generate = handler.generate_database

        def keep_stats(*args, **kw):
            feat_stats.append(generate(*args, **kw))
            return feat_stats[-1]

        handler.generate_database = keep_stats
        try:
            t0 = time.perf_counter()
            rc_feat = cli_feat.main(["--data_path", work, "--max_keypoints",
                                     "3000", "--match_ratio", "0.9"])
            feat_s = time.perf_counter() - t0
        finally:
            handler.generate_database = generate
        t0 = time.perf_counter()
        rc_sfm = cli_sfm.main(["--data_path", work])
        sfm_s = time.perf_counter() - t0
        n_reg, n_pts, rot, ate = model_errors(
            os.path.join(work, "sparse", "0"), gt)
    st = feat_stats[0]
    rec = dict(views=PIX_VIEWS, width=PIX_W, height=PIX_H, render_s=render_s,
               k2_launches_render=k2_render, feat_cli_s=feat_s,
               extract_s=st["extract_s"], match_s=st["match_s"],
               db_write_s=st["write_s"], keypoints=st["keypoints"],
               matches=st["matches"], verified_pairs=st["verified_pairs"],
               sfm_cli_s=sfm_s, registered=n_reg, points=n_pts,
               rot_err_deg_max=float(rot.max()),
               rot_err_deg_mean=float(rot.mean()),
               ate_rel_max=float(ate.max()), ate_rel_mean=float(ate.mean()),
               card=card_line())
    log("PIXELS " + json.dumps(rec))
    checks = {
        "cli.feat and cli.sfm exit 0": rc_feat == 0 and rc_sfm == 0,
        f">= {PIX_VIEWS - 1}/{PIX_VIEWS} views registered":
            n_reg >= PIX_VIEWS - 1,
        "more than 300 points": n_pts > 300,
        "max ATE < 2% of the extent": rec["ate_rel_max"] < 0.02,
        "max rotation error < 0.5 degree": rec["rot_err_deg_max"] < 0.5,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"pixels-to-poses path failed: {failed}")
    return rec


def match_bound(pairs, K, D=128):
    """Exhaustive matching's bound, reckoned from the code: per pair a
    [K, D] x [D, K] float32 product (2 K^2 D FLOP, outside the tensor
    cores) at 67 TFLOP/s, and the [K, K] similarity written once and read
    by the top-2 and both argmaxes (4 K^2 float32) at 3.35 TB/s."""
    flops = pairs * 2 * K * K * D
    nbytes = pairs * 4 * K * K * 4
    t_ops = flops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(match_tflop=flops / 1e12, match_tbytes=nbytes / 1e12,
                match_bound_ops_s=t_ops, match_bound_bytes_s=t_bytes,
                match_bound_s=max(t_ops, t_bytes),
                match_bound_by="operations" if t_ops >= t_bytes else "bytes")


def run_feat(device):
    """Feature throughput at a real size: 200 views of the plane scene at
    640x480, ``generate_database`` with 4,096 keypoints an image and
    exhaustive matching (19,900 pairs) on the card; then one pass of the
    mapper (float32) over that database, whose registered count and pose
    errors are printed but hold no bar."""
    from instantsfm_tpu_torch.features import handler

    with tempfile.TemporaryDirectory(prefix="chip_smoke_feat_") as work:
        t0 = time.perf_counter()
        gt = render_plane_scene(work, device, n_cams=FEAT_VIEWS, W=FEAT_W,
                                H=FEAT_H, f=FEAT_W * 400.0 / PIX_W)
        render_s = time.perf_counter() - t0
        dbpath = os.path.join(work, "database.db")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st = handler.generate_database(
            os.path.join(work, "images"), dbpath, config=Config("colmap"),
            max_keypoints=FEAT_KEYPOINTS, log=lambda *a: None, device=device)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        view_graph, cameras, images, name = read_colmap_database(dbpath)
        n_images = images.num_images
        debug.drain_stats()
        k1.schur_wchain.launches = 0
        t0 = time.perf_counter()
        _, images, tracks, timings = solve_global_mapper(
            view_graph, cameras, images, Config(name), dtype=torch.float32,
            log=lambda *a: None, device=device)
        mapper_s = time.perf_counter() - t0
    reg = images.registered
    rot, ate = aligned_errors(images.qvec[reg], images.centers()[reg],
                              gt["q"][reg], gt["centers"][reg])
    rec = dict(views=FEAT_VIEWS, width=FEAT_W, height=FEAT_H,
               max_keypoints=FEAT_KEYPOINTS, render_s=render_s, **st,
               extract_ms_per_image=st["extract_s"] * 1e3 / FEAT_VIEWS,
               peak_device_gb=peak_gb,
               **match_bound(st["pairs"], FEAT_KEYPOINTS),
               mapper_s=mapper_s, mapper_stage_s=timings,
               mapper_registered=int(reg.sum()),
               mapper_tracks=int(tracks.num_tracks),
               mapper_k1_launches=k1.schur_wchain.launches,
               mapper_rot_err_deg_max=float(rot.max()),
               mapper_ate_rel_max=float(ate.max()), card=card_line())
    log("FEAT " + json.dumps(rec))
    checks = {
        f"{FEAT_VIEWS} images in the database": n_images == FEAT_VIEWS,
        "19,900 pairs matched": st["pairs"] == FEAT_VIEWS * (FEAT_VIEWS - 1) // 2,
        "keypoints found": st["keypoints"] > 100 * FEAT_VIEWS,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"feature throughput phase failed: {failed}")
    return rec


# ------------------------------------------------------------ 3DGS path

def make_gs_scene(root, device, num_pts, num_views, W, H, seed=SEED):
    """A seeded 3DGS scene on disk: ground-truth gaussians (SH degree 3) in
    a 4-unit cube, ``num_views`` PINHOLE views on a ring of radius 7
    rendered by the port's rasterizer (K2) and written as PNG in
    ``root/images``, and a COLMAP model in ``root/sparse/0`` with
    ``num_pts`` points: the gaussians' centres and 1% outliers in a shell
    of radius 3..5 that the photos do not show, as SfM leaves some.  The
    outliers are sparse, so their initial scales exceed the strategy's
    prune_scale3d."""
    rng = np.random.default_rng(seed)
    n_out = num_pts // 100
    n_gt = num_pts - n_out
    pts = rng.uniform(-2, 2, (n_gt, 3))
    colors = rng.uniform(0.1, 0.9, (n_gt, 3))
    quats = rng.standard_normal((n_gt, 4))
    scales = rng.uniform(0.015, 0.05, (n_gt, 3))
    opac = rng.uniform(0.5, 0.95, n_gt)
    sh = 0.1 * rng.standard_normal((n_gt, 16, 3))
    sh[:, 0] = gs_sh.rgb_to_sh(colors)
    d = rng.standard_normal((n_out, 3))
    outliers = d / np.linalg.norm(d, axis=1, keepdims=True) \
        * rng.uniform(3, 5, (n_out, 1))
    f = 600.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    dev32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    gauss = [dev32(a) for a in (pts, quats, scales, opac, sh)]
    os.makedirs(os.path.join(root, "images"))
    images = []
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, num_views,
                                        endpoint=False)):
        c = np.array([7 * np.cos(ang), 7 * np.sin(ang), 1.5])
        R = ring_rotation(c)
        view = np.eye(4)
        view[:3, :3], view[:3, 3] = R, -R @ c
        with torch.no_grad():
            out = gs_raster.rasterize(*gauss, dev32(view), dev32(K), width=W,
                                      height=H, sh_degree=3)
        img = (torch.clamp(out.rgb, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        name = f"v{i:03d}.png"
        imwrite(os.path.join(root, "images", name), img)
        q = lie.matrix_to_quat(torch.as_tensor(R)).numpy()        # xyzw
        images.append(cmio.ModelImage(
            i + 1, np.array([q[3], q[0], q[1], q[2]]), -R @ c, 1, name,
            np.zeros((0, 2)), np.zeros(0, np.int64)))
    sfm_xyz = np.concatenate([pts, outliers])
    sfm_rgb = (np.concatenate([colors, rng.uniform(0, 1, (n_out, 3))])
               * 255).astype(np.uint8)
    points = [cmio.ModelPoint3D(p + 1, sfm_xyz[p], sfm_rgb[p], 0.0,
                                np.array([1]), np.array([0]))
              for p in range(num_pts)]
    cameras = [cmio.ModelCamera(1, cm.PINHOLE, W, H,
                                np.array([f, f, W / 2, H / 2]))]
    cmio.write_model(cameras, images, points, os.path.join(root, "sparse", "0"))


def main_shape_tiles(runner, view_index=0):
    """K2/K3's inputs for one training view of the trained model, as the
    main path builds them: (attrs, nchunks, ntx)."""
    sp, cfg = runner.splats, runner.cfg
    v = runner.trainset[view_index]
    H, W = v["image"].shape[:2]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                  device=runner.device)
    with torch.no_grad():
        p = gs_raster.project_view(
            sp.means, sp.quats, torch.exp(sp.scales),
            torch.sigmoid(sp.opacities) * sp.alive,
            torch.cat([sp.sh0, sp.shN], dim=1),
            torch.linalg.inv(t(v["camtoworld"])), t(v["K"]), W, H,
            sh_degree=cfg.sh_degree)
        return gs_raster.tile_attrs(p, W, H, cfg.tiles_per_gauss,
                                    cfg.tile_capacity)


def profile_gs_step(runner):
    """Device time by kernel over one training step of the trained model."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    views = runner._views(np.random.default_rng(1))
    sh_degree = runner.cfg.sh_degree
    for _ in range(2):
        runner._train_step(views, sh_degree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner._train_step(views, sh_degree)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "gs_step_trace.json"))
    log("GS_PROFILE " + json.dumps(dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / wall_ms,
        top=[dict(us=us, n=n, name=name[:80]) for us, n, name in rows[:15]])))


def run_gs(device, profile=False):
    """Train 3DGS through ``Runner`` on the card; returns (GS record,
    one view's compositing inputs at the main shape)."""
    with tempfile.TemporaryDirectory(prefix="gs_smoke_") as root:
        t0 = time.perf_counter()
        make_gs_scene(root, device, GS_POINTS, GS_VIEWS, GS_W, GS_H)
        scene_s = time.perf_counter() - t0
        cfg = GSConfig(data_dir=root, result_dir=os.path.join(root, "results"),
                       max_steps=GS_STEPS, test_every=8, capacity_mult=4.0,
                       sh_degree=3, sh_degree_interval=2, tile_capacity=512,
                       tiles_per_gauss=16, eval_steps=(), save_steps=())
        t0 = time.perf_counter()
        runner = Runner(cfg, log=lambda *a: None, device=device)
        setup_s = time.perf_counter() - t0
        # refine at steps 10, 20, 30, opacity reset at 25: prune_too_big
        # needs a refine after the first reset (step > reset_every); the
        # outliers' scales make it prune at step 30
        runner.strategy_cfg = gs_strategy.StrategyConfig(
            refine_start_iter=10, refine_every=10, reset_every=GS_RESET_EVERY)
        alive0 = int(runner.splats.alive.sum())

        torch.cuda.synchronize()
        k1.schur_wchain.launches = 0
        k23.composite_fwd.launches = k23.composite_bwd.launches = 0
        t0 = time.perf_counter()
        losses = runner.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k2n, k3n = k23.composite_fwd.launches, k23.composite_bwd.launches

        t0 = time.perf_counter()
        stats = runner.eval(GS_STEPS)
        eval_s = time.perf_counter() - t0
        ckpt = runner.save_checkpoint(GS_STEPS)
        ckpt_alive = int(np.load(ckpt)["alive"].sum())
        tiles = main_shape_tiles(runner)
        if profile:
            profile_gs_step(runner)

    step_ms = [s * 1e3 for s in runner.step_s]
    rec = dict(sfm_points=GS_POINTS, views=GS_VIEWS, width=GS_W, height=GS_H,
               train_views=len(runner.trainset), val_views=len(runner.valset),
               capacity=int(runner.splats.alive.shape[0]), steps=GS_STEPS,
               scene_s=scene_s, setup_s=setup_s, train_s=train_s,
               eval_s=eval_s, first_step_ms=step_ms[0],
               median_later_step_ms=float(np.median(step_ms[1:])),
               step_ms=step_ms, loss_first=losses[0], loss_last=losses[-1],
               losses=losses, psnr=stats["psnr"], ssim=stats["ssim"],
               alive_init=alive0, refines=runner.refines,
               alive_final=stats["num_GS"], k2_launches=k2n, k3_launches=k3n,
               k1_launches=k1.schur_wchain.launches)
    log("GS " + json.dumps(rec))
    steps = GS_STEPS * cfg.batch_size
    checks = {
        "losses finite": bool(np.all(np.isfinite(losses))),
        # the opacity reset raises the loss; it falls before the reset and
        # again after it
        "loss falls before the reset":
            np.mean(losses[GS_RESET_EVERY - 5:GS_RESET_EVERY])
            < np.mean(losses[:5]),
        "loss falls after the reset":
            np.mean(losses[-5:])
            < np.mean(losses[GS_RESET_EVERY + 1:GS_RESET_EVERY + 6]),
        "three refines, alive count changed":
            len(runner.refines) == 3 and any(
                r["alive_after"] != r["alive_before"] for r in runner.refines),
        "K2 and K3 launched once per view per step": k2n == k3n == steps,
        "val PSNR finite": math.isfinite(stats["psnr"]),
        "checkpoint holds the pool": ckpt_alive == stats["num_GS"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"3DGS main path failed: {failed}")
    return rec, tiles


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


def kernel_entry(name, source, replaces, launches, case, **extra):
    """One kernel's record in the kernels line, from its main-shape case."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=case["max_abs_err"],
                ms=case["ms"], ms_warm_l2=case["ms_warm_l2"],
                plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                bound_by=case["bound_by"], library_ms=None,
                build_s=build.BUILD_INFO[os.path.basename(source)[:-len(".cu")]]
                ["seconds"], **extra)


def k1_entry(cases, ba_rec, gp_rec, sfm_rec, retri_rec):
    main_case = next(c for c in cases if c["case"] == "eth3d_indoor_ba"
                     and c["dtype"] == "float32")
    f32_cases = [c for c in cases if c["dtype"] == "float32"]
    return kernel_entry(
        "schur_wchain", "instantsfm_tpu_torch/csrc/schur_wchain.cu",
        "instantsfm_tpu/solve/pallas_schur.py:145", ba_rec["k1_launches"],
        main_case,
        replaces_fn="instantsfm_tpu/solve/pallas_schur.py::schur_wchain",
        launches_gp_step=gp_rec["k1_launches"],
        launches_sfm_gp=sfm_rec["k1_launches_gp"],
        launches_sfm_ba=sfm_rec["k1_launches_ba"],
        max_abs_err_sfm_gp=sfm_rec["k1_max_abs_err_gp"],
        max_abs_err_sfm_ba=sfm_rec["k1_max_abs_err_ba"],
        launches_retri=retri_rec["k1_launches_retri"],
        launches_retri_by_pc=retri_rec["k1_launches_retri_by_pc"],
        max_abs_err_sfm_retri=retri_rec["k1_on_retri_pc2_input"]["max_abs_err"],
        retri_pc2_input={k: retri_rec["k1_on_retri_pc2_input"][k] for k in (
            "PC", "rows", "points", "cams", "L", "ms", "plain_ms", "bound_ms")},
        bound_ms_unfused=main_case["bound_ms_unfused"],
        index_add_ms=main_case["index_add_ms"],
        index_add_ms_warm_l2=main_case["index_add_ms_warm_l2"],
        matvec_ms=main_case["matvec_ms"],
        max_err_f32=max(c["max_abs_err"] for c in f32_cases),
        max_err_over_abs_sum_f32=max(c["max_err_over_abs_sum"]
                                     for c in f32_cases))


def k23_entry(which, main_case, hand_cases, gs_rec):
    """K2 (which = 0) or K3 (1) in the kernels line."""
    return kernel_entry(
        ("composite_fwd", "composite_bwd")[which],
        "instantsfm_tpu_torch/csrc/composite_tiles.cu",
        ("instantsfm_tpu/gs/pallas_raster.py:240",
         "instantsfm_tpu/gs/pallas_raster.py:274")[which],
        gs_rec[("k2_launches", "k3_launches")[which]], main_case,
        replaces_fn=("instantsfm_tpu/gs/pallas_raster.py::_composite_fwd_raw",
                     "instantsfm_tpu/gs/pallas_raster.py::_composite_vjp_bwd"
                     )[which],
        bound_ms_all_pairs=main_case["bound_ms_all_pairs"],
        pairs=main_case["pairs"],
        pairs_after_cull=main_case["pairs_after_cull"],
        max_rel_err=main_case["max_rel_err"],
        max_rel_err_hand_built=max(c[which]["max_rel_err"]
                                   for c in hand_cases.values()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one BA LM step, the mapper's "
                         "relative-pose stage and one 3DGS training step "
                         "(torch.profiler)")
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
    build.build_all(["schur_wchain", "composite_tiles"])
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_ptxas.txt"), "w") as f:
        for name, info in build.BUILD_INFO.items():
            f.write(f"== {name} ({info['seconds']:.1f} s)\n{info['log']}\n")
    log(f"build: {build_s:.1f} s (nvcc, sm_90a, sources built in parallel)")

    k1_cases = k1_parity(device)
    k23_hand = k23_parity(device)
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sfm_") as root:
        sfm_rec, sfm_gt, dbpath = run_sfm(device, root, profile=args.profile)
        retri_rec = run_sfm_retri(device, dbpath, sfm_gt)
    run_pixels(device)
    run_feat(device)
    if args.profile:
        profile_ba_step(device)
    gs_rec, tiles = run_gs(device, profile=args.profile)
    k23_main = k23_case("gs_main", *tiles, reps=20, allow_ties=True)

    kernels = [k1_entry(k1_cases, ba_rec, gp_rec, sfm_rec, retri_rec)] + [
        k23_entry(which, k23_main[which], k23_hand, gs_rec)
        for which in (0, 1)]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
