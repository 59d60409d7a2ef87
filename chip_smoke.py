"""Chip smoke test of the PyTorch/CUDA port (instantsfm_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # the check
    python3 chip_smoke.py --profile  # also profile one BA LM step, the
                                     # relative-pose stage and a 3DGS step
                                     # with and without the options

Phases (any failure exits non-zero):
  1. device: a CUDA card is required; prints its name and power limit;
  2. build: compiles every kernel of the port with nvcc, one process per
     source, all started together (timed);
  3. kernel parity: each kernel against its plain torch version on the card
     (K1 at the shapes the solvers give it and at 4,000 cameras, past its
     shared-memory camera table, float32 and float64, within the smaller
     of ``K1_TOL`` of each camera's sum of its absolute chain and
     ``K1_SIGMAS`` times the rounding count of its sums; K2/K3 on
     hand-built tiles that reach every branch and on tiles whose gaussians
     sit on the edges of the kernels' cull; the BA build kernel, both
     modes, at the benchmark's ``ring-200.ba`` problem and on seeded
     problems of every covered camera model, poses free and frozen, both
     camera-sum branches, float32 and float64, within ``build_check``'s
     bounds: ``BA_BUILD`` lines), with timings (CUDA events) and the
     analytic memory/arithmetic bound;
  4. BA path: ``pipeline.ba.bundle_adjustment_rounds`` (3 rounds, float32)
     on a seeded synthetic scene at the ETH3D-indoor shape (200 images, 50k
     points, 8 observations per point), then one global-positioning LM
     step at the same size; launch counters prove both went through K1.
     The process's first ``torch.func.vmap(jacfwd)`` call, a one-time
     set-up cost of torch, is timed on its own just before;
  5. SfM path: a seeded COLMAP database at the ETH3D-indoor scale (200
     images on a ring, 20k points, each image matched with the next 12,
     0.4 px noise, 8% outlier matches) goes through
     ``bench_e2e_torch.run_pipeline`` (``read_colmap_database ->
     pipeline.mapper.solve_global_mapper`` (float32) ``->
     write_reconstruction``) and the model is read back; it
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
  7. the mapper at scale (``SCALE`` line): ``bench_e2e.py``'s config 4, a
     ring of 2,000 SIMPLE_RADIAL images, 300k points, each image matched
     with the next 10, at most 2,000 matches a pair (setup timed apart),
     through ``bench_e2e_torch.run_pipeline``, scored by
     the port's ``eval`` (``align`` and ``benchmark.evaluate_scene``):
     2,000/2,000 registered, mean rotation error <= 0.5 degree, max <= 1,
     ATE max < 1% of the extent; K1 must launch in GP (shared camera table,
     PC = 3) and in BA (PC = 8, C = 2,000: the global-atomic branch) and
     match its plain version on the first input each gave it; errors after
     rotation averaging, GP and each BA round, stage seconds, rotation
     averaging's host reads (``ra_syncs``), LM and PCG iterations, K1
     launches by stage and branch, AUCs, peak device and host memory;
  8. pixels to poses: ``tests/test_pixels_e2e.py``'s scene (four textured
     planes) rendered by the port's rasterizer in 16 views at 480x360 and
     written as PNG, then ``cli.feat`` (SIFT and matching on the card) and
     ``cli.sfm`` on the card; ``sparse/0`` must register 15 of 16 views
     with more than 300 points, ATE < 2% of the extent and rotation
     errors < 0.5 degree; then that test's 3DGS tail, a ``Runner`` of 50
     steps on the reconstruction (SH degree 1, pool 2x the points), whose
     loss must fall, with PSNR > 12 at step 50 and K2/K3 launched once a
     training step (``PIXELS`` line: extraction, matching, mapper and 3DGS
     seconds, K2/K3 launches);
  9. the tail on a copy of those views (``TAIL`` line): ``cli.demo``
     (features and SfM on the card, ``view.html`` with one camera per
     registered view), ``cli.sfm --record_recon`` (4 snapshots: GP, then
     three BA rounds; the model within phase 8's bars), ``cli.vis`` on the
     newest session (the video where matplotlib is installed, else its
     ImportError naming matplotlib), ``vis.pose3d --export_html``,
     pair-inlier scoring of the database's view graph and the fisheye
     undistorter on a seeded OPENCV_FISHEYE model, each card against CPU;
  10. feature throughput: 200 views of that scene at 640x480,
     ``generate_database`` with 4,096 keypoints an image and exhaustive
     matching, 19,900 pairs (``FEAT`` line: extraction and matching
     seconds, peak device memory, matching's bound), then one mapper pass
     over that database (registered views and pose errors, no bar);
  11. learned front-ends (``LEARNED`` line): seeded random weights (SuperPoint,
     DISK and LightGlue at their published widths, DeDoDe at its
     ``random_weights`` widths) written as npz and found by the handler's
     environment variables; ``superpoint+lightglue`` on 40 views at 640x480
     (2,048 keypoints, 780 pairs), ``disk+lightglue``, ``superpoint`` and
     ``dedode`` on 16; each database read back with the counts written;
     each extractor and LightGlue held against the port's CPU run; the
     JAX tests' LightGlue bars at M = 2,048 (identity >= 95%, permutation
     >= 90%); extraction and matching seconds, LightGlue's FLOP and bound,
     peak device memory;
  12. 3DGS path: a seeded scene of 100k SfM points and 24 views at 800x608
     (photos rendered by the port's rasterizer with SH degree 3, written as
     PNG and a COLMAP model), then ``gs.trainer.Runner`` trains 40 steps at
     SH degree 3 with refine and opacity reset on the card, evaluates and
     saves a checkpoint, with ``GSConfig``'s sizing (no pair cut, windows
     as long as the view's fullest tile); launch counters prove every
     step went through K2 and K3;
  13. 3DGS options on that scene (``GS_OPTS`` line): run A trains 40 steps
     with ``pose_opt``, ``app_opt``, the bilateral grid, the depth loss,
     ``visible_adam``, PNG compression and pose noise, with LPIPS (seeded
     random weights behind ``INSTANTSFM_LPIPS_WEIGHTS``) at the step-40
     eval, then exports the PLY from the checkpoint and renders an ellipse
     trajectory; K3 is held against its plain version on a depth-loss
     step's gradient (nonzero alpha and depth rows), selective Adam's
     unseen rows must stay bit for bit, the compressed model within its
     quantisation bounds, the card's LPIPS within 1e-4 of the CPU's.  Run
     B trains 40 steps with ``strategy="mcmc"``, relocating at steps 10,
     20, 30; each relocation must move its dead rows and only them, the
     rows outside the pool never move, and one relocation on the card
     must equal the CPU's on the same draws.  Run A's training options
     then take 10 steps on a small scene on the CPU and on the card, whose
     losses, pose deltas and bilateral grids must agree.  K2/K3 are then
     held against their plain versions on one view's real tiles of the GS
     phase, laid out as its training steps laid them out;
  14. multi-device paths (``DIST`` line, with the number of cards the
     machine shows; NCCL takes one rank a card): over a world-1 NCCL group
     in this process, one BA solve at phase 4's shape through
     ``parallel.sharded.optimize_sharded`` (the point-local partition, the
     all-reduces, K1 on the rank's buckets) against the single-device
     solve on the same input, one GP step at phase 4's GP size through the
     point-local step against that phase's step, and the gaussian-sharded
     3DGS loss and gradients on phase 12's scene (2 views) against one
     device's, then one distributed train step; K1 is held against its
     plain version on the first input of the sharded BA and GP, K2/K3 on
     the distributed step's first view, and each must have launched.
     Then two ranks on the card over gloo (this script with
     ``--dist-worker``, two processes) run ``cli.feat`` and ``cli.sfm`` on
     phase 8's views: extraction, matching and relative pose shared, GP
     and BA point-sharded, rank 0 writing; the database must hold phase
     8's images, keypoint counts, matched and verified pairs, and its
     matches but for ``DIST_MATCH_SHARE`` of them, the model must register
     as many views as phase 8's and meet its bars, and K1 must launch on
     both ranks.  Where the machine shows two or more cards,
     ``tools/multicard_torch.py`` then runs under torchrun at min(cards,
     4) ranks, one a card, over NCCL, on the 500-image ring (its
     2,000-image run is the tool's alone), and its failure fails the
     script; on one card the line says that it did not run;
  15. the measuring entry points (``BENCH`` line): ``bench_torch`` at the
     ETH3D-indoor BA shape, ``bench_gs_torch`` at 100k gaussians, the BA,
     GP (2,000-image shape) and 3DGS trace tools with a few steps,
     ``probe_accuracy_torch`` and ``bench_relpose_torch`` on a 200-image
     ring and ``bench_lightglue_torch``, each through its own functions;
     each must print its metric and launch the kernels of its path
     (``bench_e2e_torch`` is phases 5 and 7); ``bench_gs_torch``'s share of
     its analytic bound (``roofline_frac``) and ``mfu`` must lie in (0, 1],
     and the 3DGS trace prints each counted part's device time beside its
     bound;
  16. an installed, read-only copy of the package (``INSTALLED`` line):
     imported by a fresh process from a temporary directory, it must build
     K1 into the user cache and launch it once, held here against K1's
     plain version;
  17. prints the kernels line (K1, K2, K3 and the BA build kernel, whose
     entry counts its launches by phase), the card line and, last, the ok
     line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from instantsfm_tpu_torch import config, convert
from instantsfm_tpu_torch.config import Config
from instantsfm_tpu_torch.eval import align, benchmark
from instantsfm_tpu_torch.features import (dedode, disk, handler, lightglue,
                                           superpoint)
from instantsfm_tpu_torch.gs import composite as k23
from instantsfm_tpu_torch.gs import compression as gs_compression
from instantsfm_tpu_torch.gs.composite import entered
from instantsfm_tpu_torch.gs import lpips as gs_lpips
from instantsfm_tpu_torch.gs import optim as gs_optim
from instantsfm_tpu_torch.gs import ply as gs_ply
from instantsfm_tpu_torch.gs import rasterize as gs_raster
from instantsfm_tpu_torch.gs import sh as gs_sh
from instantsfm_tpu_torch.gs import splats as gs_splats
from instantsfm_tpu_torch.gs import strategy as gs_strategy
from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner
from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
from instantsfm_tpu_torch.io.image import imwrite
from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.parallel import multihost, sharded
from instantsfm_tpu_torch.pipeline import ba, preprocess, relpose, vgc
from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper
from instantsfm_tpu_torch.scene import cameras as cm
from instantsfm_tpu_torch.scene.types import Cameras, Images, Tracks
from instantsfm_tpu_torch.solve import ba_closed, block_lm, robust
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.solve.blocked import (bucketize, bucketize_problem,
                                                seg_by_pt)
from instantsfm_tpu_torch.solve.problems import make_ba_problem, make_gp_problem
from instantsfm_tpu_torch.utils import build, debug
from instantsfm_tpu_torch.utils.bench import card_line
from instantsfm_tpu_torch.utils.device import full_f32

from bench_e2e_torch import (RING_CAMERA, ring_image_name, ring_rotation,
                             run_pipeline, write_ring_db)

# the benchmark's frozen counts of the work (``sfmbench/yardstick``), after
# this repo's own modules on the path: ``sfmbench`` has a ``tests`` of its own
SFMBENCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sfmbench")
if SFMBENCH not in sys.path:
    sys.path.append(SFMBENCH)
from yardstick import gs_roofline, roofline  # noqa: E402
from yardstick.gs_roofline import (ALPHA_WORK, LIVE_WORK,  # noqa: E402
                                   RECORD_WORK, TEST_WORK)

OUT_DIR = "chiprun_out"
HBM_BYTES_PER_S = roofline.H100_SXM.peak_bw    # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: roofline.H100_SXM.peak_flops_f32,
              torch.float64: 34e12}             # outside the tensor cores
L2_FLUSH_BYTES = 256 << 20                 # overwritten to empty the 50 MB L2
BA_ITER_CAP = 40                           # max LM iterations per BA round
SEED = 0
GS_POINTS, GS_VIEWS, GS_W, GS_H = 100_000, 24, 800, 608   # bench_gs.py:36
GS_STEPS, GS_RESET_EVERY = 40, 25


def log(msg):
    print(msg, flush=True)


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


# K1's tolerance, per camera entry: the smaller of two bounds on the
# rounding of the chain y_c = SUM_{o: cam_o = c} W_o V_inv_p SUM_{k in
# track p} W_k^T x[cam_k].  The kernel sums tracks by a butterfly and
# cameras with atomics in an order that changes from run to run, the plain
# version by reshape-sums and index_add_: float sums of up to 2048 track
# rows and thousands of camera rows, whose terms can cancel.
#
# The flat bound: K1_TOL of the camera sum of the absolute chain
# |W_o| |V_inv_p| SUM_k |W_k|^T |x[cam_k]| (k1_scales' ``chain``).  Where y
# cancels it allows a share of y itself (0.9% on BA's 2,000-image input):
# it cannot see one row among thousands.
#
# The rounding count: each row's chain u_o rounds by at most a unit
# roundoff per level of its sums (the track's butterfly, log2 L; W^T x,
# log2 PC; the two 3-term products) times its absolute chain, and the
# camera sum rounds each of its N_c partial sums once, whose squares
# average about SUM_o u_o^2 + y_c^2 over the orders; errors of independent
# roundings add in quadrature, so the camera entry's error is of the order
# of   u * sqrt(SUM_o depth_o chain_o^2 + N_c (SUM_o u_o^2 + y_c^2)),
# u the unit roundoff.  K1_SIGMAS of it is the bound.  The sum of |u|
# (k1_u_sums) is the first port's scale, which a track's cancellation
# leaves below the rounding: it is printed, not tested.
K1_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
K1_SIGMAS = 32


class K1Scales(NamedTuple):
    chain: torch.Tensor   # [C, PC] camera sum of the absolute chain
    rss: torch.Tensor     # [C, PC] SUM_o depth_o chain_o^2
    u_abs: torch.Tensor   # [C, PC] SUM_o |u_o|
    u_sq: torch.Tensor    # [C, PC] SUM_o u_o^2
    rows: torch.Tensor    # [C, 1] rows with a nonzero chain


def k1_u_sums(W, V_inv, x, cam_idx, pt_idx, buckets):
    """[C, PC]: the sum of |u_o| over each camera's rows (the old scale)."""
    u = k1.schur_wchain_rows_reference(W, V_inv, x, cam_idx, pt_idx,
                                       buckets).abs()
    return u.new_zeros(x.shape).index_add_(0, cam_idx, u)


def k1_scales(W, V_inv, x, cam_idx, pt_idx, buckets):
    """The per-camera sums K1's tolerance is made of (``K1Scales``), from
    the plain version's rows on |W|, |V_inv|, |x| and on W, V_inv, x."""
    chain = k1.schur_wchain_rows_reference(W.abs(), V_inv.abs(), x.abs(),
                                           cam_idx, pt_idx, buckets)
    u = k1.schur_wchain_rows_reference(W, V_inv, x, cam_idx, pt_idx, buckets)
    depth = torch.zeros(W.shape[0], dtype=W.dtype, device=W.device)
    extra = math.ceil(math.log2(W.shape[1])) + 4
    for os_, _, Tb, L in buckets:
        depth[os_:os_ + Tb * L] = math.ceil(math.log2(L)) + extra
    by_cam = lambda r: r.new_zeros((x.shape[0],) + r.shape[1:]).index_add_(
        0, cam_idx, r)
    return K1Scales(chain=by_cam(chain),
                    rss=by_cam(depth[:, None] * chain ** 2),
                    u_abs=by_cam(u.abs()), u_sq=by_cam(u * u),
                    rows=by_cam((chain.amax(dim=1, keepdim=True) > 0)
                                .to(W.dtype)))


def k1_tolerance(scales, y):
    """[C, PC]: K1's bound on |y - y_plain|, the smaller of the flat bound
    and K1_SIGMAS of the rounding count."""
    unit = torch.finfo(y.dtype).eps / 2
    count = K1_SIGMAS * unit * torch.sqrt(
        scales.rss + scales.rows * (scales.u_sq + y * y))
    return torch.minimum(K1_TOL[y.dtype] * scales.chain, count)


def k1_check(name, got, want, scales):
    """Raise unless |got - want| <= ``k1_tolerance(scales, want)`` at every
    entry.  Returns the errors over each scale (the absolute chain, the sum
    of |u|, the bound) and the bounds' reach: the least bound / |want| over
    the entries with want != 0, the relative error a bound allows where it
    is tightest, for the flat bound alone (``min_tol_chain_over_abs_y``)
    and for K1's (``min_bound_over_abs_y``)."""
    err = (got - want).abs()
    flat = K1_TOL[want.dtype] * scales.chain
    tol = k1_tolerance(scales, want)
    bad = ~(err <= tol)
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries beyond their "
            f"bound (the smaller of {K1_TOL[want.dtype]} of their camera's "
            f"absolute chain and {K1_SIGMAS} sigmas of its rounding count), "
            f"max abs err {err.max().item()}")
    ratio = lambda s: torch.where(s > 0, err / s,
                                  torch.zeros_like(err)).max().item()
    nz = want != 0
    reach = lambda b: ((b[nz] / want[nz].abs()).min().item()
                       if nz.any() else None)
    return dict(max_abs_err=err.max().item(),
                max_err_over_abs_chain=ratio(scales.chain),
                max_err_over_abs_sum=ratio(scales.u_abs),
                max_err_over_bound=ratio(tol),
                min_tol_chain_over_abs_y=reach(flat),
                min_bound_over_abs_y=reach(tol))


def k1_case(name, lengths, C, PC, dtype, device, reps):
    bp = k1_layout(lengths, C, SEED)
    W, V_inv, x, cam, pt, buckets = k1_inputs(bp, C, PC, dtype, device, SEED)
    want = k1.schur_wchain_reference(W, V_inv, x, cam, pt, buckets)
    got = k1.schur_wchain(W, V_inv, x, cam, pt, buckets)
    torch.cuda.synchronize()
    if got.shape != (C, PC) or want.shape != (C, PC):
        raise AssertionError(f"K1 {name}: bad output {tuple(got.shape)}")
    check = k1_check(f"K1 {name}", got, want,
                     k1_scales(W, V_inv, x, cam, pt, buckets))
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
               **check, max_abs_y=want.abs().max().item(),
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


# ------------------------------------------------------------ BA build kernel

def build_inputs(model_id, poses, C, lengths, dtype, device, seed=SEED,
                 track_pad=8):
    """(problem, params, obs, buckets) of a seeded BA problem on ``device``:
    C cameras of ``model_id`` around the origin, tracks of the given lengths
    (bucketed; padded tracks, 10% of the rows invalid), keypoints 1.2 px
    from the projections (residuals on both sides of Huber's 1 px)."""
    rng = np.random.default_rng(seed)
    T = len(lengths)
    pt = np.repeat(np.arange(T), lengths)
    O = len(pt)
    cam = rng.integers(0, C, O)
    X = rng.uniform(-1, 1, (T, 3))
    ang = rng.normal(0, 0.1, (C, 3))
    q = np.concatenate([np.sin(ang / 2), np.ones((C, 1))], 1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.c_[rng.normal(0, 0.2, (C, 2)), rng.uniform(4, 6, C)]
    intr = np.zeros((C, cm.MAX_CAM_PARAMS))
    base = {cm.SIMPLE_PINHOLE: [520.0, 320.0, 240.0],
            cm.SIMPLE_RADIAL: [520.0, 320.0, 240.0, 0.04]}[model_id]
    intr[:, :len(base)] = base
    intr[:, 0] *= rng.uniform(0.95, 1.05, C)
    d = lambda a: torch.as_tensor(a, dtype=torch.float64)
    xyz = lie.quat_rotate(d(q)[cam], d(X)[pt]) + d(t)[cam]
    xy = (cm.img_from_cam(model_id, d(intr)[cam], xyz).numpy()
          + rng.normal(0, 1.2, (O, 2)))
    dev = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), device=device,
                                              dtype=dt)
    params = block_lm.Params(
        cam={"q": dev(q), "t": dev(t), "intr": dev(intr)}, pts=dev(X),
        scales=torch.zeros((O, 1), dtype=dtype, device=device),
        scales_free=torch.zeros(O, dtype=torch.bool, device=device))
    obs = block_lm.Observations(
        dev(cam, torch.int32), dev(pt, torch.int32),
        {"x": dev(xy[:, 0]), "y": dev(xy[:, 1])},
        dev(rng.uniform(size=O) > 0.1, torch.bool))
    params, obs, buckets, _ = bucketize_problem(params, obs,
                                                track_pad=track_pad)
    return make_ba_problem(model_id, optimize_poses=poses), params, obs, \
        buckets


def ring_ba_inputs(dtype, device, seed=SEED):
    """(problem, params, obs, buckets) of the benchmark's BA cell at its
    shape: the ``ring-200`` scene's own BA problem (``sfmbench/yardstick``:
    200 SIMPLE_RADIAL cameras, the points seen twice or more, every
    keypoint), at the true poses, bucketed."""
    from yardstick import ring
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "sfmbench", "configs", "ring-200.json")) as f:
        cfg = json.load(f)
    scene = ring.make_scene(cfg["scene"], seed)
    o = ring.ba_observations(scene)
    O, C = len(o["cam"]), len(scene["R"])
    dev = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), device=device,
                                              dtype=dt)
    params = block_lm.Params(
        cam={"q": dev(ring.matrix_to_quat_xyzw(scene["R"])),
             "t": dev(scene["t"]),
             "intr": dev(np.tile(cm.pad_params(scene["intr"]), (C, 1)))},
        pts=dev(scene["points"][o["point_ids"]]),
        scales=torch.zeros((O, 1), dtype=dtype, device=device),
        scales_free=torch.zeros(O, dtype=torch.bool, device=device))
    obs = block_lm.Observations(
        dev(o["cam"], torch.int32), dev(o["pt"], torch.int32),
        {"x": dev(o["xy"][:, 0]), "y": dev(o["xy"][:, 1])},
        torch.ones(O, dtype=torch.bool, device=device))
    params, obs, buckets, _ = bucketize_problem(params, obs)
    return make_ba_problem(cm.SIMPLE_RADIAL), params, obs, buckets


BUILD_FIELDS = ("U", "g_cam", "V", "g_pt", "W", "loss_vec")
# Float32: each entry within BUILD_F32_FACTOR times the float32 plain
# version's own error against the float64 plain version, plus BUILD_ULPS
# unit roundoffs of the entry's rounding count (``build_plain``).  Float64:
# BUILD_F64_TOL of the field's largest entry and of the entry, as the CPU
# tests hold the closed form to the autodiff build.
BUILD_F32_FACTOR = 4.0
BUILD_ULPS = 32
BUILD_F64_TOL = 1e-9
BUILD_FD_STEP = 2.0 ** -20     # the relative move of an input, float64
BUILD_CHUNK = 1 << 20          # rows a pass of ``build_plain``


def build_fields(out, PC):
    """The build's outputs (Ug, V, g_pt, W, loss_vec) by field, Ug split into
    U [C, PC, PC] and g_cam [C, PC]: the camera sums' two parts differ by
    orders of magnitude, and each is held to its own scale."""
    Ug, V, g_pt, W, loss = out
    return dict(U=Ug[:, :PC * PC].reshape(-1, PC, PC), g_cam=Ug[:, PC * PC:],
                V=V, g_pt=g_pt, W=W, loss_vec=loss)


def build_plain(problem, params, obs, kernel, buckets, dtype, counts=False):
    """The plain version's outputs by field (``build_fields``) in ``dtype``,
    evaluated BUILD_CHUNK rows at a time (``ba_closed.rows_reference`` and
    ``row_products``, the camera sums by ``index_add_``, the point sums by
    ``seg_by_pt``, as ``build_reference``).  With ``counts`` also each
    entry's rounding count, the scale of a correct float evaluation's
    error in unit roundoffs.  A row's part is its sensitivity S, the sum
    over the row's inputs (q, t, the model's parameters, X, the keypoint)
    of |d out / d in| |in| by float64 differences of BUILD_FD_STEP (the
    inputs' roundings, and the keypoint's subtraction from a projection
    some 500 px away), plus its absolute chain A, the same products of
    |r|, |Jc| and |Jp| (the last products' roundings, where the two
    residual components' terms cancel, as rotation about the optical axis
    against depth does); a per-row output's count is S + A; a sum's is
    sqrt(SUM_o (S_o + A_o)^2 + N (SUM_o out_o^2 + sum^2)), the rows' parts
    in quadrature and the roundings of its N partial sums, as in K1's
    count.  Returns (fields, counts or None)."""
    model_id, poses = problem.reproj
    PC = problem.cam_dim
    C, T = params.cam["q"].shape[0], params.pts.shape[0]
    O = obs.valid.shape[0]
    npar = cm.get_camera_model_info(model_id)["num_params"]
    ops = [a.to(dtype) for a in ba_closed.gathered(params, obs)]
    ops[2] = ops[2][:, :npar]
    NC = PC * PC + PC
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=ops[0].device)
    Ug, pt_rows, W, loss = z(C, NC), z(O, 12), z(O, 3 * PC), z(O, 1)
    if counts:
        cam_s2, cam_x2, cam_n = z(C, NC), z(C, NC), z(C, 1)
        pt_s2, pt_x2, pt_n = z(O, 12), z(O, 12), z(O, 1)
        W_count, loss_count = z(O, 3 * PC), z(O, 1)

    def rows(valid, g, chain=False):
        r, Jc, Jp = ba_closed.rows_reference(model_id, poses, *g)
        if chain:
            r, Jc, Jp = r.abs(), Jc.abs(), Jp.abs()
        cam, V_o, gp_o, W_o, loss_o = ba_closed.row_products(kernel, valid, r,
                                                             Jc, Jp)
        n = cam.shape[0]
        out = (cam, torch.cat([V_o.reshape(n, 9), gp_o], 1),
               W_o.reshape(n, -1), loss_o[:, None])
        return [a.abs() for a in out] if chain else out

    for start in range(0, O, BUILD_CHUNK):
        sl = slice(start, min(O, start + BUILD_CHUNK))
        g, ci, valid = [a[sl] for a in ops], obs.cam_idx[sl], obs.valid[sl]
        base = rows(valid, g)
        Ug.index_add_(0, ci, base[0])
        pt_rows[sl], W[sl], loss[sl] = base[1:]
        if not counts:
            continue
        sens = rows(valid, g, chain=True)
        for k, a in enumerate(g):
            for j in range(a.shape[1]):
                moved = a.clone()
                moved[:, j] *= 1.0 + BUILD_FD_STEP
                out = rows(valid, g[:k] + [moved] + g[k + 1:])
                for s, m, b in zip(sens, out, base):
                    s += (m - b).abs() / BUILD_FD_STEP
        cam_s2.index_add_(0, ci, sens[0] ** 2)
        cam_x2.index_add_(0, ci, base[0] ** 2)
        cam_n.index_add_(0, ci, (base[0] != 0).any(1, keepdim=True)
                         .to(dtype))
        pt_s2[sl], pt_x2[sl] = sens[1] ** 2, base[1] ** 2
        pt_n[sl] = (base[1] != 0).any(1, keepdim=True).to(dtype)
        W_count[sl], loss_count[sl] = sens[2], sens[3]

    seg = lambda a: seg_by_pt(a, buckets, T)
    pts = seg(pt_rows)
    fields = build_fields((Ug, pts[:, :9].reshape(T, 3, 3), pts[:, 9:],
                           W.reshape(O, PC, 3), loss[:, 0]), PC)
    if not counts:
        return fields, None
    cam_c = torch.sqrt(cam_s2 + cam_n * (cam_x2 + Ug ** 2))
    pt_c = torch.sqrt(seg(pt_s2) + seg(pt_n) * (seg(pt_x2) + pts ** 2))
    return fields, build_fields((cam_c, pt_c[:, :9].reshape(T, 3, 3),
                                 pt_c[:, 9:], W_count.reshape(O, PC, 3),
                                 loss_count[:, 0]), PC)


def build_compare(name, got, want, ref=None, counts=None):
    """Raise unless every field of ``got`` (``BUILD_FIELDS`` and
    ``loss_mode``, the loss mode's output, held to ``loss_vec``) is finite
    and within its bound of the plain version: in float64 BUILD_F64_TOL of
    ``want``'s largest entry of the field and of the entry; in float32
    BUILD_F32_FACTOR |want - ref| + BUILD_ULPS u counts, ``want`` the
    float32 plain version, ``ref`` the float64 one and ``counts`` the
    rounding counts (``build_plain``).  Returns (the worst error over its
    bound, the largest error, the worst ratio by field)."""
    want = dict(want, loss_mode=want["loss_vec"])
    by_field, max_err = {}, 0.0
    for k, g in got.items():
        if counts is None:
            w = want[k]
            err = (g - w).abs()
            bound = BUILD_F64_TOL * (w.abs().max().clamp_min(1e-30)
                                     + w.abs())
        else:
            r = ref["loss_vec" if k == "loss_mode" else k]
            err = (g.double() - r).abs()
            bound = (BUILD_F32_FACTOR * (want[k].double() - r).abs()
                     + BUILD_ULPS * torch.finfo(g.dtype).eps / 2
                     * counts["loss_vec" if k == "loss_mode" else k])
        bad = ~(err <= bound)
        if bad.any() or not torch.isfinite(g).all():
            raise AssertionError(
                f"BA build {name}: {k}: {int(bad.sum())} of {bad.numel()} "
                f"entries beyond their bound, max err {err.max().item()}")
        by_field[k] = torch.where(bound > 0, err / bound,
                                  torch.zeros_like(err)).max().item()
        max_err = max(max_err, err.max().item())
    return max(by_field.values()), max_err, by_field


def build_check(name, problem, params, obs, kernel, buckets):
    """The kernel (both modes) against its plain version on the same card
    inputs (``build_compare``'s bounds; the kernel's launches here are not
    counted in ``ba_closed.LAUNCHES``).  Returns (the worst error over its
    bound, the largest error, the worst ratio by field)."""
    PC, T = problem.cam_dim, params.pts.shape[0]
    launches = dict(ba_closed.LAUNCHES)
    got = build_fields(ba_closed.build(problem, params, obs, kernel, T,
                                       buckets), PC)
    got["loss_mode"] = ba_closed.loss_vec(problem, params, obs, kernel)
    ba_closed.LAUNCHES.update(launches)
    torch.cuda.synchronize()
    dtype = params.pts.dtype
    want = build_plain(problem, params, obs, kernel, buckets, dtype)[0]
    if dtype == torch.float64:
        return build_compare(name, got, want)
    ref, counts = build_plain(problem, params, obs, kernel, buckets,
                              torch.float64, counts=True)
    return build_compare(name, got, want, ref, counts)


def build_bound(params, obs, buckets, PC):
    """(bound_ms, bytes): a row's cam_idx, x, y and valid read and its W
    and loss written, each point slot read and its V and g_pt written, the
    cameras read and Ug written, once each, at 3.35 TB/s."""
    s = params.pts.element_size()
    O, T, C = obs.valid.shape[0], params.pts.shape[0], \
        params.cam["q"].shape[0]
    nbytes = (O * (4 + 2 * s + 1) + O * (3 * PC + 1) * s
              + T * (3 + 12) * s
              + C * (4 + 3 + params.cam["intr"].shape[1]) * s
              + C * (PC * PC + PC) * s)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def build_case(name, inputs, reps, kernel=None, plain=True):
    """One shape: the check, the kernel's time cold and warm, its loss
    mode's, the plain version's (with ``plain``), and the byte bound.  The
    launches made here are not counted in ``ba_closed.LAUNCHES``."""
    problem, params, obs, buckets = inputs
    kernel = kernel or robust.huber(1.0)
    worst, max_err, by_field = build_check(name, problem, params, obs,
                                           kernel, buckets)
    launches = dict(ba_closed.LAUNCHES)
    T = params.pts.shape[0]
    PC = problem.cam_dim
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=params.pts.device)
    run = lambda: ba_closed.build(problem, params, obs, kernel, T, buckets)
    loss = lambda: ba_closed.loss_vec(problem, params, obs, kernel)
    bound_ms, nbytes = build_bound(params, obs, buckets, PC)
    C = params.cam["q"].shape[0]
    ms = time_ms(run, reps, flush)
    rec = dict(case=name, dtype=str(params.pts.dtype).replace("torch.", ""),
               PC=PC, rows=obs.valid.shape[0], points=T, cams=C,
               L=sorted({b[3] for b in buckets}),
               branch=("shared" if ba_closed.shared_table(
                   C, PC, params.pts.dtype) else "global"),
               huber_delta=kernel.kind[1],
               max_err_over_bound=worst, max_err_over_bound_by_field=by_field,
               max_abs_err=max_err, ms=ms, ms_warm_l2=time_ms(run, reps),
               loss_ms=time_ms(loss, reps, flush),
               plain_ms=(time_ms(lambda: ba_closed.build_reference(
                   problem, params, obs, kernel, T, buckets), 3,
                   queued=False) if plain else None),
               bound_ms=bound_ms, bound_by="bytes", share=bound_ms / ms,
               mbytes=nbytes / 1e6)
    ba_closed.LAUNCHES.update(launches)
    log("BA_BUILD " + json.dumps(rec))
    return rec


def build_parity(device):
    """The BA build kernel at the benchmark's BA cell (float32), against
    its plain version there and on seeded problems of both covered models,
    poses free and frozen, both camera-sum branches, float32 and float64."""
    rng = np.random.default_rng(SEED)
    lengths = rng.choice([2, 3, 5, 8, 13, 30, 64, 200, 300, 700],
                         p=[.2, .2, .2, .15, .1, .06, .04, .02, .02, .01],
                         size=6000)
    cases = [build_case("ring_200_ba", ring_ba_inputs(torch.float32, device),
                        reps=50)]
    for dtype in (torch.float32, torch.float64):
        for model_id, poses, C in ((cm.SIMPLE_RADIAL, True, 200),
                                   (cm.SIMPLE_RADIAL, False, 200),
                                   (cm.SIMPLE_RADIAL, True, 4000),
                                   (cm.SIMPLE_RADIAL, False, 4000),
                                   (cm.SIMPLE_PINHOLE, True, 200),
                                   (cm.SIMPLE_PINHOLE, False, 4000)):
            name = (f"{cm.CAMERA_MODEL_INFO[model_id]['name'].lower()}_"
                    f"{'poses' if poses else 'frozen'}_c{C}")
            cases.append(build_case(name, build_inputs(
                model_id, poses, C, lengths, dtype, device), reps=20))
    if {c["branch"] for c in cases} != {"shared", "global"}:
        raise AssertionError("BA build cases do not reach both camera-sum "
                             "branches")
    return cases


def _copied(tree):
    """A copy of a Params or Observations tuple, its tensors cloned."""
    copy_ = lambda v: ({k: u.clone() for k, u in v.items()}
                       if isinstance(v, dict) else v.clone())
    return tree._replace(**{k: copy_(v) for k, v in tree._asdict().items()})


@contextlib.contextmanager
def build_first_input(keep):
    """While the block runs ``ba_closed.build`` is wrapped, and the first
    input for which ``keep(problem, params)`` holds is copied into the
    yielded dict (``inputs``: problem, params, obs, buckets; ``kernel``)."""
    launch = ba_closed.build
    kept = {}

    def spy(problem, params, obs, kernel, num_points, buckets):
        if not kept and keep(problem, params):
            kept.update(inputs=(problem, _copied(params), _copied(obs),
                                buckets), kernel=kernel)
        return launch(problem, params, obs, kernel, num_points, buckets)

    ba_closed.build = spy
    try:
        yield kept
    finally:
        ba_closed.build = launch


def build_path_case(name, kept, reps=10):
    """``build_case`` on the input a phase kept (``build_first_input``):
    the kernel held against its plain version on what the path gave it;
    None where the phase kept none."""
    if not kept:
        return None
    rec = build_case(name, kept["inputs"], reps, kernel=kept["kernel"],
                     plain=False)
    kept.clear()
    return rec


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


def composite_work(attrs, logt, ntx):
    """What K2/K3 must do on these inputs: the entered chunks, the
    (gaussian, pixel) pairs in them and the live pairs
    (``composite.pair_counts``, the 3DGS step's count's), the (row, warp)
    pairs the cull keeps and the pairs those hold (32 each), and the (row,
    warp) pairs where some pixel's alpha is live.  The kept counts
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
    kept = live_rows = 0
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
    return dict(k23.pair_counts(attrs, logt, ntx), warp_rows_kept=kept,
                pairs_after_cull=32 * kept, live_warp_rows=live_rows)


def k23_bound(kname, attrs, work):
    """What the redesigned kernel must do on the arrays it is handed: a cull
    record per row of an entered chunk, a box test per (row, warp), the
    alpha terms per pair the cull keeps, and the live pairs' work
    (``gs_roofline.k23_bytes`` over the padded layout)."""
    rows = work["chunks_entered"] * k23.CHUNK
    kept = work["pairs_after_cull"]
    live_ops, live_sfu = LIVE_WORK[kname]
    flops = (RECORD_WORK[0] * rows + TEST_WORK * rows * k23.NWARP
             + ALPHA_WORK[0] * kept + live_ops * work["live_pairs"])
    sfu = (RECORD_WORK[1] * rows + ALPHA_WORK[1] * kept
           + live_sfu * work["live_pairs"])
    return bound_ms(
        gs_roofline.k23_bytes(kname, work, attrs.shape[0], attrs.shape[1:]),
        flops, sfu)


def bound_ms(nbytes, flops, sfu):
    """(bound_ms, bound_by, counts): the largest of the byte, FP32 and
    special-function times of one piece of work on the H100's peaks."""
    spec = roofline.H100_SXM
    t_b = nbytes / spec.peak_bw
    t_f = flops / spec.peak_flops_f32
    t_s = sfu / spec.peak_sfu
    t = max(t_b, t_f, t_s)
    return (t * 1e3, "bytes" if t_b >= max(t_f, t_s) else "operations",
            dict(mbytes=nbytes / 1e6, gflop=flops / 1e9, gsfu=sfu / 1e9,
                 bytes_ms=t_b * 1e3, fp32_ms=t_f * 1e3, sfu_ms=t_s * 1e3))


def k23_bound_all_pairs(kname, work, tiles, layout):
    """``bound_ms`` of K2 or K3 over every pair of the entered chunks on
    the arrays of ``layout`` (the first port's count)."""
    return bound_ms(gs_roofline.k23_bytes(kname, work, tiles, layout),
                    *gs_roofline.k23_all_pairs_work(kname, work))


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
    """K2 and K3 against their plain versions on the card, timed (not with
    ``reps`` 0).  Tolerances (float32, sums in other orders): rel 1e-5 of each output row
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
    if not reps:      # the check alone
        return [dict(case=name, tiles=attrs.shape[0], tied_tiles=len(tied),
                     max_abs_err=max(e for e, _, _ in part),
                     max_rel_err=max(r for _, _, r in part))
                for part in (fwd + [(logt_err, logt_ties, 0)], bwd)]

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
                   bound_ms_all_pairs=k23_bound_all_pairs(
                       kname, work, attrs.shape[0], attrs.shape[1:])[0],
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
    with build_first_input(lambda *_: True) as kept:
        t0 = time.perf_counter()
        tracks_out = ba.bundle_adjustment_rounds(
            cameras, images, tracks, opts, thr, rounds=3,
            dtype=torch.float32, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = k1.schur_wchain.launches
    stats = debug.drain_stats()
    # the rounds share one shape: the first step captures the PCG's graphs
    capture_ms = [r["spans"].get("pcg.capture", (0, 0.0))[1] * 1e3
                  for r in debug.REGISTRY.roots("ba.round")[-3:]]

    finite = all(np.all(np.isfinite(a)) for a in
                 (images.qvec, images.tvec, tracks.xyz, cameras.params))
    # the BA build kernel on the first system the rounds built
    build_rec = build_path_case("ba_first_input", kept)
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
               first_step_ms=step_ms[0] - capture_ms[0],
               capture_ms_per_round=capture_ms,
               median_later_step_ms=float(np.median(step_ms[1:])),
               step_ms=step_ms,
               k1_launches=launches,
               k1_plain_calls=k1.schur_wchain.plain_calls,
               ba_build=build_rec,
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
        "BA build kernel held against its plain version on the rounds' "
        "first input": build_rec is not None and build_rec["PC"] == 8,
        "rotation error no worse": rot1 <= rot0,
        "center error no worse": cen1 <= cen0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"BA main path failed: {failed}")
    return rec, gt


def gp_problem(device, gt):
    """Global positioning (PC = 3) at the BA scene's size: 8 observations
    a point of random cameras, centers and points perturbed by 0.5."""
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
    return params, obs


def run_gp_step(device, gt):
    """One global-positioning LM step (PC=3) at the BA scene's size."""
    params, obs, buckets, _ = bucketize_problem(*gp_problem(device, gt))
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
    # a new shape: the step captured its PCG's graphs, timed apart
    capture_ms = debug.REGISTRY.roots("lm.step")[-1]["spans"].get(
        "pcg.capture", (0, 0.0))[1] * 1e3
    rec = dict(ms=ms - capture_ms, capture_ms=capture_ms,
               rows=int(obs.valid.shape[0]), k1_launches=launches,
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
    check = k1_check(f"K1 on the mapper's {stage} input", got, want,
                     k1_scales(*args))
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    return dict(PC=W.shape[1], rows=W.shape[0], points=V_inv.shape[0],
                cams=x.shape[0], L=sorted({b[3] for b in buckets}),
                branch="shared" if k1.shared_table(
                    x.shape[0], W.shape[1], W.dtype) else "global",
                **check, max_abs_y=want.abs().max().item(),
                ms=time_ms(lambda: k1.schur_wchain(*args), 20, flush),
                plain_ms=time_ms(lambda: k1.schur_wchain_reference(*args), 5,
                                 flush),
                bound_ms=k1_bound(W, V_inv, x, buckets)[0])


def run_sfm(device, root, profile=False):
    """The global SfM mapper at the ETH3D-indoor scale through the port's
    entry points: a COLMAP database is written in ``root``, and
    ``bench_e2e_torch.run_pipeline`` reads it back, solves it with
    ``solve_global_mapper`` in float32 on the card and writes the sparse
    model, which is read back and held against the ground truth.  The first
    K1 input with x != 0 of global positioning and of bundle adjustment is
    kept and K1 is held against its plain version on it.  ``profile`` also
    runs the relative-pose stage once more under torch.profiler.  Returns
    (SFM record, ground truth, database path)."""
    dbpath = os.path.join(root, "database.db")
    t0 = time.perf_counter()
    gt, n_pairs, n_matches = write_ring_db(dbpath)
    build_db_s = time.perf_counter() - t0
    log(f"SfM scene: {SFM_CAMS} images, {SFM_POINTS} points, window "
        f"{SFM_WINDOW}: {n_pairs} pairs, {n_matches} matches "
        f"({build_db_s:.1f} s to write)")

    done, k1_inputs_at, by_stage = set(), {}, {}

    def hook(name, *_):
        done.add(name)

    out = os.path.join(root, "sparse")
    with k1_by_stage(done, k1_inputs_at, by_stage) as shapes, \
            build_first_input(lambda *_: True) as kept:
        pipe, _, images, _ = run_pipeline(dbpath, out, device,
                                          stage_hook=hook)
    graphs = pcg_graphs(debug.REGISTRY.roots("mapper")[-1], shapes)
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
    build_rec = build_path_case("sfm_ba_first_input", kept)
    rot, ate = sfm_errors(images, gt)
    rec = dict(
        pipe, points=SFM_POINTS, pairs=n_pairs, matches=n_matches,
        build_db_s=build_db_s, read_model_s=read_model_s,
        model_images=len(imgs_m), model_points=len(pts_m),
        k1_max_abs_err_gp=k1_sfm.get("global_positioning", {}).get(
            "max_abs_err"),
        k1_max_abs_err_ba=k1_sfm.get("bundle_adjustment", {}).get(
            "max_abs_err"),
        k1_on_mapper_inputs=k1_sfm, k1_launches_by_stage=by_stage,
        pcg_graphs=graphs, ba_build=build_rec,
        relpose_profile=relpose_prof,
        rot_err_deg_max=float(rot.max()), rot_err_deg_mean=float(rot.mean()),
        ate_rel_max=float(ate.max()), ate_rel_mean=float(ate.mean()),
        card=card_line())
    log("SFM " + json.dumps(rec))
    gp_launches, ba_launches = rec["k1_launches_gp"], rec["k1_launches_ba"]
    checks = {
        f"{SFM_CAMS}/{SFM_CAMS} images registered":
            rec["registered"] == SFM_CAMS,
        "model read back has every image": len(imgs_m) == SFM_CAMS,
        "model read back has every track": len(pts_m) == rec["tracks"],
        "max rotation error < 1 degree": rec["rot_err_deg_max"] < 1.0,
        "max ATE < 1% of the extent": rec["ate_rel_max"] < 0.01,
        "K1 launched in global positioning": gp_launches > 0,
        "K1 launched in bundle adjustment": ba_launches > 0,
        "K1 launched only in those stages":
            rec["k1_launches_total"] == gp_launches + ba_launches,
        "K1 held against its plain version on a GP and a BA input":
            set(k1_sfm) == {"global_positioning", "bundle_adjustment"},
        "BA build kernel held against its plain version on BA's first "
        "input": build_rec is not None and build_rec["PC"] == 8,
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

    in_retri = lambda: "bundle_adjustment" in launches_at

    def keep_pc2_input(*args):
        if (in_retri() and args[0].shape[1] == 2 and not retri_input
                and bool(args[2].any())):
            retri_input["args"] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)

    cfg = Config("colmap")
    cfg.OPTIONS.update(skip_retriangulation=False, skip_pruning=False)
    debug.drain_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.schur_wchain.launches = k1.schur_wchain.plain_calls = 0
    with k1_tally(lambda W, C: W.shape[1] if in_retri() else None,
                  retri_by_pc, keep_pc2_input) as shapes, \
            build_first_input(lambda problem, _: problem.cam_dim == 2) \
            as kept:
        t0 = time.perf_counter()
        view_graph, cameras, images, feature_name = read_colmap_database(dbpath)
        cameras, images, tracks, timings = solve_global_mapper(
            view_graph, cameras, images, cfg, dtype=torch.float32,
            log=lambda *a: None, stage_hook=hook, device=device)
        total_s = time.perf_counter() - t0
    graphs = pcg_graphs(debug.REGISTRY.roots("mapper")[-1], shapes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = k1.schur_wchain.launches
    plain_calls = k1.schur_wchain.plain_calls
    stats = debug.drain_stats()

    k1_pc2 = (k1_sfm_check("retriangulation (PC = 2)", retri_input["args"],
                           device) if retri_input else None)
    build_rec = build_path_case("retri_pc2_first_input", kept)
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
        k1_on_retri_pc2_input=k1_pc2, pcg_graphs=graphs, ba_build=build_rec,
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
        "BA build kernel held against its plain version on a PC = 2 input":
            build_rec is not None and build_rec["PC"] == 2,
        "K1 launched only in GP, BA and retriangulation": launches == retri,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"SfM with retriangulation and pruning "
                             f"failed: {failed}")
    return rec


# ------------------------------------------------------------ scale path

# bench_e2e.py's config 4, the JAX package's 2,000-image scene
# (tools/probe_accuracy.py:44-45)
SCALE_2K = dict(num_cams=2000, num_pts=300_000, vis_angle=0.06, window=10,
                scene_scale=4.0, max_matches_per_pair=2000)
# the bars: 0.5 degree is the mean rotation target PERF_NOTES.md:20 records
# for this scene; 1 degree and 1% of the extent are tests/test_e2e.py's
SCALE_ROT_MEAN_DEG, SCALE_ROT_MAX_DEG, SCALE_ATE_MAX = 0.5, 1.0, 0.01
def scale_errors(q, centers, gt, idx):
    """(rotation errors in degrees, ATE as a share of the extent or None
    without ``centers``) of the world->cam xyzw quaternions ``q`` of images
    ``idx`` against the ground truth, through the port's ``eval.align``."""
    R_est = lie.quat_to_matrix(torch.as_tensor(q, dtype=torch.float64))
    R_gt = lie.quat_to_matrix(torch.as_tensor(gt["q"][idx]))
    rot = align.rotation_angles_deg(R_est.numpy(), R_gt.numpy())
    if centers is None:
        return rot, None
    c_gt = gt["centers"][idx]
    ate = align.absolute_translation_errors(np.asarray(centers, np.float64),
                                            c_gt)
    return rot, ate / float(np.linalg.norm(c_gt.max(0) - c_gt.min(0)))


def error_summary(rot, ate=None):
    out = dict(images=int(len(rot)), rot_err_deg_mean=float(rot.mean()),
               rot_err_deg_max=float(rot.max()))
    if ate is not None:
        out.update(ate_rel_mean=float(ate.mean()), ate_rel_max=float(ate.max()))
    return out


def write_ring_gt_model(path, gt):
    """The ring's ground truth as a COLMAP model (poses only), named as
    ``write_ring_db`` names its images."""
    model_id, width, height, params = RING_CAMERA
    cams = [cmio.ModelCamera(1, model_id, width, height, np.array(params))]
    imgs = [cmio.ModelImage(i + 1, np.r_[q[3], q[:3]], gt["t"][i], 1,
                            ring_image_name(i), np.zeros((0, 2)),
                            np.zeros(0, np.int64))
            for i, q in enumerate(gt["q"])]
    cmio.write_model(cams, imgs, [], path)


def capturing(t) -> bool:
    """Whether ``t``'s device is a CUDA device whose current stream is
    recording a CUDA graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def k1_tally(key_of, launches, keep=None):
    """Counts K1's launches by solve into ``launches`` while the block runs,
    with ``block_lm.schur_wchain`` and ``block_lm.graph_pcg`` wrapped.
    ``key_of(W, C)`` names a solve from its K1 operand W and its camera
    count (None: not counted).  On one card a solve replays captured CUDA
    graphs (``solve/pcg.py``), whose K1 launches call no wrapper, so a
    key's count runs from K1's counter at the start of a graph solve, or at
    a call of the wrapper (the eager loop, a capture's warm-up), to the
    next such point.  ``keep(*args)``, where given, sees every input that
    reaches the wrapper outside a capture.  Yields the set of the graph
    solves' shapes (C, PC, rows)."""
    launch, solve = block_lm.schur_wchain, block_lm.graph_pcg
    mark = dict(key=None, at=k1.schur_wchain.launches)
    shapes = set()

    def settle(key):
        now = k1.schur_wchain.launches
        if mark["key"] is not None:
            launches[mark["key"]] = (launches.get(mark["key"], 0) + now
                                     - mark["at"])
        mark.update(key=key, at=now)

    def spy(*args):
        if not capturing(args[0]):
            if keep is not None:
                keep(*args)
            settle(key_of(args[0], args[2].shape[0]))
        return launch(*args)

    def solve_spy(make_ops, layout, operands, b, **kwargs):
        W = operands[1]
        shapes.add((b.shape[0], W.shape[1], W.shape[0]))
        settle(key_of(W, b.shape[0]))
        return solve(make_ops, layout, operands, b, **kwargs)

    block_lm.schur_wchain, block_lm.graph_pcg = spy, solve_spy
    try:
        yield shapes
    finally:
        block_lm.schur_wchain, block_lm.graph_pcg = launch, solve
        settle(None)


@contextlib.contextmanager
def k1_by_stage(done, first_input, launches):
    """``k1_tally`` for a mapper run: K1's launches by stage and
    camera-sum branch into ``launches``, and each stage's first input whose
    x is not 0 into ``first_input``.  K1 runs only in GP and BA: a solve
    started before ``done`` holds "global_positioning" (the stage hook's
    names) is GP's.  Yields the graph solves' shapes."""
    stage = lambda: ("bundle_adjustment" if "global_positioning" in done
                     else "global_positioning")

    def key_of(W, C):
        branch = "shared" if k1.shared_table(C, W.shape[1], W.dtype) \
            else "global"
        return f"{stage()}/{branch}"

    def keep(*args):
        # PCG's first matvec is of x0 = 0, whose y is 0 whatever K1 does
        if stage() not in first_input and bool(args[2].any()):
            first_input[stage()] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)

    with k1_tally(key_of, launches, keep) as shapes:
        yield shapes


def pcg_graphs(root, shapes):
    """The PCG's CUDA graphs in a root record of ``debug``'s ring: graph
    solves, captures and their seconds, replays, and the distinct shapes
    (``k1_tally``'s) the solves had."""
    spans = root["spans"]
    n = lambda name: spans.get(name, (0, 0.0))
    return dict(solves=n("pcg.graph")[0], captures=n("pcg.capture")[0],
                capture_s=n("pcg.capture")[1], replays=n("pcg.replay")[0],
                shapes=len(shapes))


def run_scale(device, root, scene=SCALE_2K):
    """The mapper on a ring scene of ``bench_e2e.py`` at a size its users
    run (``SCALE_2K``: 2,000 images, where BA's K1 sums cameras with global
    atomics): database written (setup, timed apart), read,
    ``solve_global_mapper`` (float32), ``write_reconstruction``,
    ``read_model``; then scored through the port's ``eval``: rotation and
    absolute errors against the ring's ground truth and
    ``benchmark.evaluate_scene`` against a model written from it.  K1 is
    held against its plain version on the first input GP and BA gave it;
    its launches are counted by stage and camera-sum branch; the poses are
    scored after rotation averaging, GP and each BA round.  Returns the
    record; raises after printing it if a check fails."""
    n = scene["num_cams"]
    dbpath = os.path.join(root, "database.db")
    t0 = time.perf_counter()
    gt, n_pairs, n_matches = write_ring_db(dbpath, **scene)
    setup_s = time.perf_counter() - t0
    log(f"SCALE scene: {json.dumps(scene)}: {n_pairs} pairs, {n_matches} "
        f"matches ({setup_s:.1f} s to write)")

    done, first_input, launches, errors_at, rounds = set(), {}, {}, {}, []
    gp_images = {}

    def hook(name, cameras, images, tracks):
        done.add(name)
        reg = np.nonzero(images.registered)[0]
        if name == "rotation_averaging":
            errors_at[name] = error_summary(
                *scale_errors(images.qvec[reg], None, gt, reg))
        elif name in ("global_positioning", "bundle_adjustment"):
            errors_at[name] = error_summary(*scale_errors(
                images.qvec[reg], images.centers()[reg], gt, reg))
            gp_images.setdefault("idx", reg)

    ba_optimize = ba.optimize

    def ba_round(*args, **kwargs):
        state, history = ba_optimize(*args, **kwargs)
        cam = state.params.cam
        rounds.append((cam["q"].detach().double().cpu().numpy(),
                       cam["t"].detach().double().cpu().numpy()))
        return state, history

    sparse = os.path.join(root, "sparse")
    global_table = lambda problem, params: not ba_closed.shared_table(
        params.cam["q"].shape[0], problem.cam_dim, params.pts.dtype)
    ba.optimize = ba_round
    try:
        with k1_by_stage(done, first_input, launches) as shapes, \
                build_first_input(global_table) as kept:
            pipe, _, images, tracks = run_pipeline(dbpath, sparse, device,
                                                   stage_hook=hook)
    finally:
        ba.optimize = ba_optimize
    graphs = pcg_graphs(debug.REGISTRY.roots("mapper")[-1], shapes)
    t0 = time.perf_counter()
    cams_m, imgs_m, pts_m = cmio.read_model(os.path.join(sparse, "0"))
    read_model_s = time.perf_counter() - t0

    idx = gp_images.get("idx", np.zeros(0, np.int64))
    for r, (q, t) in enumerate(rounds):
        if len(q) == len(idx):
            c = lie.camera_center(torch.as_tensor(q), torch.as_tensor(t))
            errors_at[f"ba_round_{r}"] = error_summary(
                *scale_errors(q, c.numpy(), gt, idx))
    reg = np.nonzero(images.registered)[0]
    rot, ate = scale_errors(images.qvec[reg], images.centers()[reg], gt, reg)
    t0 = time.perf_counter()
    gt_dir = os.path.join(root, "sparse_gt")
    write_ring_gt_model(gt_dir, gt)
    scores = benchmark.evaluate_scene(gt_dir, sparse, device=device)
    eval_s = time.perf_counter() - t0
    # launches made here to compare K1 with its plain version are not counted
    k1_rec = {stage: k1_sfm_check(stage, args, device)
              for stage, args in first_input.items()}
    first_input.clear()
    build_rec = build_path_case("scale_ba_first_global_input", kept, reps=5)
    rec = dict(
        pipe, scene=scene, setup_s=setup_s, pairs=n_pairs, matches=n_matches,
        read_model_s=read_model_s, eval_s=eval_s,
        model_images=len(imgs_m), model_points=len(pts_m),
        k1_launches=launches, k1=k1_rec, pcg_graphs=graphs,
        ba_build=build_rec,
        rot_err_deg_mean=float(rot.mean()), rot_err_deg_max=float(rot.max()),
        ate_rel_mean=float(ate.mean()), ate_rel_max=float(ate.max()),
        errors_by_stage=errors_at, eval=scores, card=card_line())
    log("SCALE " + json.dumps(rec))
    ba_first = k1_rec.get("bundle_adjustment", {})
    checks = {
        f"{n}/{n} images registered": rec["registered"] == n,
        "model read back has every image": len(imgs_m) == n,
        f"mean rotation error <= {SCALE_ROT_MEAN_DEG} degree":
            rec["rot_err_deg_mean"] <= SCALE_ROT_MEAN_DEG,
        f"max rotation error <= {SCALE_ROT_MAX_DEG} degree":
            rec["rot_err_deg_max"] <= SCALE_ROT_MAX_DEG,
        "max ATE < 1% of the extent": rec["ate_rel_max"] < SCALE_ATE_MAX,
        "evaluate_scene registers every image":
            scores["num_registered"] == n,
        "K1 launched in global positioning": any(
            k.startswith("global_positioning/") and v > 0
            for k, v in launches.items()),
        "K1 launched in bundle adjustment": any(
            k.startswith("bundle_adjustment/") and v > 0
            for k, v in launches.items()),
        "K1 launched only in those stages":
            rec["k1_launches_total"] == sum(launches.values()),
        "K1 held against its plain version on a GP and a BA input":
            set(k1_rec) == {"global_positioning", "bundle_adjustment"},
    }
    if scene is SCALE_2K:
        checks["BA build kernel held against its plain version on an "
               "input of its global-atomic branch"] = (
            build_rec is not None and build_rec["branch"] == "global")
        checks["BA's first K1 input takes the global-atomic branch"] = (
            ba_first.get("branch") == "global" and not k1.shared_table(
                ba_first.get("cams", 0), 8, torch.float32))
        checks["GP's first K1 input takes the shared-table branch"] = (
            k1_rec.get("global_positioning", {}).get("branch") == "shared")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"SCALE failed: {failed}")
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


PIX_GS_STEPS = 50                                    # test_pixels_e2e.py


def pixels_gs_tail(work, device, steps=PIX_GS_STEPS):
    """``tests/test_pixels_e2e.py``'s 3DGS tail: a ``Runner`` of ``steps``
    steps (50 there; SH degree 1 from step 20, pool 2x the SfM points, 256
    gaussians a tile) on the images and the sparse model in ``work``, then
    evaluated (the test's eval at its last step, run after the loop so
    that K2's and K3's counts cover the training steps alone)."""
    cfg = GSConfig(data_dir=work, result_dir=os.path.join(work, "gs_out"),
                   max_steps=steps, eval_steps=(), save_steps=(),
                   sh_degree=1, sh_degree_interval=20, capacity_mult=2.0,
                   tile_capacity=256)
    t0 = time.perf_counter()
    runner = Runner(cfg, log=lambda *a, **k: None, device=device)
    setup_s = time.perf_counter() - t0
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    k23.composite_fwd.launches = k23.composite_bwd.launches = 0
    t0 = time.perf_counter()
    losses = runner.train()
    sync()
    train_s = time.perf_counter() - t0
    k2n, k3n = k23.composite_fwd.launches, k23.composite_bwd.launches
    stats = runner.eval(steps)
    return dict(gs_setup_s=setup_s, gs_train_s=train_s, gs_steps=steps,
                gs_train_views=len(runner.trainset),
                gs_val_views=len(runner.valset),
                gs_pool=int(runner.splats.alive.shape[0]),
                gs_median_step_ms=float(np.median(runner.step_s[1:]) * 1e3),
                gs_loss_first5=float(np.mean(losses[:5])),
                gs_loss_last10=float(np.mean(losses[-10:])),
                gs_losses_finite=bool(np.all(np.isfinite(losses))),
                gs_psnr=stats["psnr"], gs_ssim=stats["ssim"],
                gs_k2_launches=k2n, gs_k3_launches=k3n,
                gs_k23_per_step=steps * cfg.batch_size)


def run_pixels(device, work):
    """Pixels to poses to 3DGS through the port's entry points, as
    ``tests/test_pixels_e2e.py`` does with JAX's: 16 rendered views in
    ``work``, then ``cli.feat`` (SIFT and matching on the card) and
    ``cli.sfm`` (the mapper on the card, float32), then ``sparse/0`` read
    back and held against the render's ground truth with that test's bars,
    then that test's 3DGS tail (``pixels_gs_tail``) on the reconstruction:
    the loss falls, PSNR > 12 at step 50, and every training step went
    through K2 and K3.  Returns (PIXELS record, the render's ground
    truth)."""
    from instantsfm_tpu_torch.cli import feat as cli_feat
    from instantsfm_tpu_torch.cli import sfm as cli_sfm

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
    gs = pixels_gs_tail(work, device)
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
               **gs, card=card_line())
    log("PIXELS " + json.dumps(rec))
    checks = {
        "cli.feat and cli.sfm exit 0": rc_feat == 0 and rc_sfm == 0,
        f">= {PIX_VIEWS - 1}/{PIX_VIEWS} views registered":
            n_reg >= PIX_VIEWS - 1,
        "more than 300 points": n_pts > 300,
        "max ATE < 2% of the extent": rec["ate_rel_max"] < 0.02,
        "max rotation error < 0.5 degree": rec["rot_err_deg_max"] < 0.5,
        "3DGS losses finite": gs["gs_losses_finite"],
        "3DGS loss: mean of the last 10 below the first 5":
            gs["gs_loss_last10"] < gs["gs_loss_first5"],
        "3DGS PSNR > 12 at step 50": gs["gs_psnr"] > 12,
        "K2 and K3 launched once per view per training step":
            gs["gs_k2_launches"] == gs["gs_k3_launches"]
            == gs["gs_k23_per_step"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"pixels-to-poses path failed: {failed}")
    return rec, gt


TAIL_FISHEYE = (300.0, 300.0, 0.05, -0.01, 0.001, 0.0)   # fx fy k1-k4
TAIL_TIE_SHARE = 1e-4   # pair-inlier masks, card vs CPU: at most this share
                        # of matches differing (errors on a threshold)


def html_payload(path):
    """The JSON scene that ``cli.demo.write_html_view`` embeds."""
    with open(path) as f:
        return json.loads(f.read().split("const data = ", 1)[1]
                          .split(";\n", 1)[0])


def tail_pair_inliers(dbpath, device):
    """``pair_inliers.image_pair_inliers_count`` on a database's view graph,
    each pair's model estimated by the mapper's relative-pose stage on the
    card, rescored from the same inputs on the card and on the CPU."""
    from instantsfm_tpu_torch.pipeline import pair_inliers

    vg, cams, imgs, name = read_colmap_database(dbpath)
    preprocess.update_image_pairs_config(vg, cams, imgs)
    preprocess.decompose_relpose(vg, cams, imgs)
    relpose.undistort_images(cams, imgs, device=device)
    relpose.estimate_relative_pose(vg, cams, imgs, device=device)
    out = dict(pairs=int(vg.valid.sum()),
               configs=np.bincount(vg.config[vg.valid]).tolist(),
               relpose_inliers=int(vg.inlier_mask.sum()))
    masks = {}
    for label, dev in (("card", device), ("cpu", torch.device("cpu"))):
        graph = copy.deepcopy(vg)
        t0 = time.perf_counter()
        pair_inliers.image_pair_inliers_count(
            graph, cams, imgs, Config(name).INLIER_THRESHOLD_OPTIONS,
            device=dev)
        out[f"{label}_s"] = time.perf_counter() - t0
        masks[label] = graph.inlier_mask
    out.update(matches=int(len(masks["cpu"])),
               inliers=int(masks["cpu"].sum()),
               differing=int((masks["card"] != masks["cpu"]).sum()))
    return out


def tail_fisheye(work, names, device):
    """``undistort_fisheye_images`` on a seeded OPENCV_FISHEYE model of the
    views ``names`` in ``work/images``, on the card and on the CPU."""
    from instantsfm_tpu_torch.pipeline import fisheye_undistorter as fe

    fx, fy, *k = TAIL_FISHEYE
    params = np.array([fx, fy, PIX_W / 2, PIX_H / 2, *k])
    rng = np.random.default_rng(SEED)
    sparse = os.path.join(work, "fisheye", "sparse")
    cmio.write_model(
        [cmio.ModelCamera(1, cm.OPENCV_FISHEYE, PIX_W, PIX_H, params)],
        [cmio.ModelImage(i + 1, np.array([1.0, 0, 0, 0]),
                         rng.standard_normal(3), 1, name, np.zeros((0, 2)),
                         np.zeros(0, np.int64))
         for i, name in enumerate(names)], [], sparse)
    runs = (("card", device), ("cpu", torch.device("cpu")))
    grids = {label: fe.remap_grid(cm.OPENCV_FISHEYE, cm.pad_params(params),
                                  PIX_W, PIX_H, device=dev)
             for label, dev in runs}
    outs, secs, geo = {}, {}, {}
    for label, dev in runs:
        t0 = time.perf_counter()
        outs[label] = fe.undistort_fisheye_images(
            sparse, os.path.join(work, "images"),
            os.path.join(work, "fisheye", label, "undist"),
            log=lambda *a: None, device=dev)
        secs[label] = time.perf_counter() - t0
        with open(os.path.join(work, "fisheye", label, "geo_locs.txt"),
                  "rb") as f:
            geo[label] = f.read()
    return dict(
        images=len(outs["card"]), card_s=secs["card"], cpu_s=secs["cpu"],
        grid_max_diff_px=float(np.abs(grids["card"] - grids["cpu"]).max()),
        max_level_diff=max(int(np.abs(outs["card"][i].astype(int)
                                      - outs["cpu"][i].astype(int)).max())
                           for i in outs["cpu"]),
        same_images=sorted(outs["card"]) == sorted(outs["cpu"]),
        geo_locs_equal=geo["card"] == geo["cpu"])


def run_tail(device, pix_work, pix_gt):
    """The tail of the port on a copy of the pixels phase's 16 views:
    ``cli.demo`` (features and SfM on the card, then ``view.html``),
    ``cli.sfm --record_recon`` on its database (a snapshot after GP and
    after each BA round), ``cli.vis`` on the newest session (the video
    where matplotlib is installed, else its ImportError naming
    matplotlib), ``vis.pose3d --export_html``, pair-inlier scoring and the
    fisheye undistorter, each on the card against the CPU.  Returns the
    TAIL record; raises after printing it if a check fails."""
    import glob
    import importlib.util

    from instantsfm_tpu_torch.cli import demo as cli_demo
    from instantsfm_tpu_torch.cli import sfm as cli_sfm
    from instantsfm_tpu_torch.cli import vis as cli_vis
    from instantsfm_tpu_torch.vis import pose3d
    from instantsfm_tpu_torch.vis.visualizer import OfflinePlayer

    work = os.path.join(pix_work, "tail")
    shutil.copytree(os.path.join(pix_work, "images"),
                    os.path.join(work, "images"))
    sparse0 = os.path.join(work, "sparse", "0")
    t0 = time.perf_counter()
    rc_demo = cli_demo.main(["--data_path", work])
    demo_s = time.perf_counter() - t0
    demo_views = len(html_payload(os.path.join(work, "view.html"))["cameras"])
    demo_registered = len(cmio.read_model(sparse0)[1])

    t0 = time.perf_counter()
    rc_rec = cli_sfm.main(["--data_path", work, "--record_recon"])
    record_s = time.perf_counter() - t0
    n_reg, n_pts, rot, ate = model_errors(sparse0, pix_gt)
    session = sorted(glob.glob(os.path.join(work, "record", "session_*")))[-1]
    player = OfflinePlayer(session, sparse0, log=lambda *a: None)
    stages = [str(player.load_step(i)["stage"]) for i in range(len(player))]
    last = player.load_step(len(player) - 1)

    video = os.path.join(work, "replay.mp4")
    vis_argv = ["--data_path", work, "--export_video", video]
    if importlib.util.find_spec("matplotlib") is not None:
        vis_out = dict(rc=cli_vis.main(vis_argv),
                       video=bool(glob.glob(os.path.join(work, "replay.*"))))
    else:
        gate = ""
        try:
            cli_vis.main(vis_argv)
        except ImportError as e:   # the gate's own behaviour, checked below
            gate = str(e)
        vis_out = dict(matplotlib_gate=gate)
    html = os.path.join(work, "pose3d.html")
    rc_pose3d = pose3d.main(["--sparse_dir", sparse0, "--export_html", html])
    pose3d_views = len(html_payload(html)["cameras"])

    pairs = tail_pair_inliers(os.path.join(work, "database.db"), device)
    fisheye = tail_fisheye(work, sorted(os.listdir(os.path.join(work,
                                                                "images"))),
                           device)
    rec = dict(demo_s=demo_s, demo_views_in_html=demo_views,
               demo_registered=demo_registered, record_s=record_s,
               recorded_steps=len(player), stages=stages,
               last_step_cameras=int(len(last["centers"])),
               final_colors=None if player.final_colors is None
               else int(len(player.final_colors)),
               registered=n_reg, points=n_pts,
               rot_err_deg_max=float(rot.max()),
               ate_rel_max=float(ate.max()), vis=vis_out,
               pose3d_views_in_html=pose3d_views, pair_inliers=pairs,
               fisheye=fisheye, card=card_line())
    log("TAIL " + json.dumps(rec))
    checks = {
        "cli.demo, cli.sfm and vis.pose3d exit 0":
            rc_demo == 0 and rc_rec == 0 and rc_pose3d == 0,
        "view.html holds one camera per registered view":
            demo_views == demo_registered >= PIX_VIEWS - 1,
        "4 recorded steps: GP, then three BA rounds":
            stages == ["global_positioning"] + ["bundle_adjustment"] * 3,
        "the last step holds every registered view":
            rec["last_step_cameras"] == n_reg,
        "the player recolours from the final model":
            rec["final_colors"] == n_pts,
        f">= {PIX_VIEWS - 1}/{PIX_VIEWS} views registered":
            n_reg >= PIX_VIEWS - 1,
        "more than 300 points": n_pts > 300,
        "max ATE < 2% of the extent": rec["ate_rel_max"] < 0.02,
        "max rotation error < 0.5 degree": rec["rot_err_deg_max"] < 0.5,
        "cli.vis replays the session (or names matplotlib where missing)":
            (vis_out.get("rc") == 0 and vis_out.get("video"))
            or "matplotlib" in vis_out.get("matplotlib_gate", ""),
        "pose3d's view holds every registered view": pose3d_views == n_reg,
        "pair inliers: card and CPU masks equal but for threshold ties":
            pairs["differing"] <= TAIL_TIE_SHARE * pairs["matches"]
            and 0 < pairs["inliers"] < pairs["matches"],
        "fisheye: every view undistorted on both": fisheye["same_images"]
            and fisheye["images"] == PIX_VIEWS,
        "fisheye: grids within 1e-9 px, images within one level":
            fisheye["grid_max_diff_px"] <= 1e-9
            and fisheye["max_level_diff"] <= 1,
        "fisheye: the same geo_locs.txt": fisheye["geo_locs_equal"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"TAIL failed: {failed}")
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


# ------------------------------------------------------------ learned features

LEARN_VIEWS, LEARN_W, LEARN_H, LEARN_KEYPOINTS = 40, 640, 480, 2048
LEARN_OTHER_VIEWS = 16
LG_SCORE_TOL = 1e-4             # card against CPU, float32
KP_SCORE_RTOL = 1e-4            # of the largest |score|, card against CPU:
                                # DeDoDe's softmax over the image turns
                                # its logits' ~2e-6 into ~2e-5
EXTRACTORS = {   # module, config, weights -> module
    "superpoint": (superpoint, superpoint.SuperPointConfig,
                   convert.superpoint_from_numpy),
    "disk": (disk, disk.DiskConfig, convert.disk_from_numpy),
    "dedode": (dedode, dedode.DeDoDeConfig, convert.dedode_from_numpy)}
WEIGHT_ENV = {"superpoint": "INSTANTSFM_SUPERPOINT_WEIGHTS",
              "disk": "INSTANTSFM_DISK_WEIGHTS",
              "dedode": "INSTANTSFM_DEDODE_WEIGHTS"}


def learned_weights(seed=SEED):
    """Seeded random weights in the npz layout: SuperPoint (64/64/128/128
    + 256) and DISK at their published widths, LightGlue at its published
    width (256-d, 4 heads, 9 layers) for SuperPoint (256 in) and DISK (128
    in), DeDoDe at ``random_weights``' widths (the published L/B widths
    live in the checkpoints)."""
    g = torch.Generator().manual_seed(seed)
    return {"superpoint": superpoint.random_weights(g),
            "disk": disk.random_weights(g),
            "dedode": dedode.random_weights(g),
            "superpoint_lightglue": lightglue.random_weights(g, 256),
            "disk_lightglue": lightglue.random_weights(g, disk.DESC_DIM)}


def keypoints_agree(a, b, desc_tol, score_rtol=KP_SCORE_RTOL):
    """How far two runs of one extractor, (xy, score, desc, valid) each,
    agree; equal up to float rounding when the returned ``failures`` list
    is empty.  The valid keypoints are matched by their pixel.  Each one
    valid in both runs has its score within ``score_rtol`` of the largest
    finite |score| and its descriptor within ``desc_tol``; two such
    keypoints come in another order only where their scores tie within
    twice that (a swap of slots); a keypoint valid in one run only (a local
    maximum, a top-k cut or a threshold decided within rounding, which
    shifts the slots after it) is at most 1% of them.  The slots valid in
    neither run (the NMS's exact ties) are not compared here."""
    xa, sa, da, va = a
    xb, sb, db, vb = b
    finite = np.isfinite(sa)
    tol = score_rtol * max(float(np.abs(sa[finite]).max(initial=0.0)), 1e-30)
    slot_a = {tuple(x): i for i, x in enumerate(xa) if va[i]}
    pairs = [(slot_a.pop(tuple(xb[s])), s) for s in np.flatnonzero(vb)
             if tuple(xb[s]) in slot_a]
    ia, ib = (np.array(c, np.int64) for c in zip(*pairs)) if pairs else \
        (np.zeros(0, np.int64),) * 2
    order = np.argsort(ia)
    ia, ib = ia[order], ib[order]
    score_err = float(np.abs(sa[ia] - sb[ib]).max(initial=0.0))
    desc_err = float(np.abs(da[ia] - db[ib]).max(initial=0.0))
    # an inversion (j before k in run a, after it in run b) must be a tie:
    # every keypoint scoring more than 2 tol above k in run a comes before
    # k in run b
    s_a = sa[ia]
    above = np.searchsorted(-s_a, -(s_a + 2 * tol), side="left")
    prefix_max = np.maximum.accumulate(ib) if len(ib) else ib
    untied = int(np.sum((above > 0) & (prefix_max[np.maximum(above - 1, 0)]
                                       > ib)))
    n = max(int(va.sum()), int(vb.sum()), 1)
    one_run = int(vb.sum()) - len(ia) + len(slot_a)
    checks = {f"scores within {score_rtol:g} of the largest": score_err <= tol,
              f"descriptors within {desc_tol:g}": desc_err <= desc_tol,
              "slots differ only among tied scores": untied == 0,
              "at most 1% of the keypoints in one run only":
                  one_run <= 0.01 * n}
    return dict(valid=n, slots_moved=int(np.sum(ia != ib)),
                keypoints_in_one_run=one_run, untied_inversions=untied,
                score_max_abs_err=score_err, score_tol=tol,
                desc_max_abs_err=desc_err,
                failures=[k for k, ok in checks.items() if not ok])


def lightglue_flop(M0, M1, input_dim):
    """FLOP of one LightGlue pair, reckoned from the code's products (the
    softmaxes, norms and activations left out): the input projections,
    then per layer the two self blocks and the cross block, then the
    assignment."""
    def proj(rows, din, dout):
        return 2 * rows * din * dout

    D = lightglue.DIM
    flop = proj(M0 + M1, input_dim, D)
    for _ in range(lightglue.N_LAYERS):
        for m in (M0, M1):                      # self blocks
            flop += proj(m, D, 3 * D) + proj(m, D, D) + 4 * m * m * D \
                + proj(m, 2 * D, 2 * D) + proj(m, 2 * D, D)
        flop += 2 * proj(M0 + M1, D, D) + 2 * M0 * M1 * D * 3 \
            + proj(M0 + M1, D, D) + proj(M0 + M1, 2 * D, 2 * D) \
            + proj(M0 + M1, 2 * D, D)           # cross block
    return flop + proj(M0 + M1, D, D + 1) + 2 * M0 * M1 * D


def learned_card_vs_cpu(weights, img_path, lg_pair_paths, device):
    """One view per extractor and one pair for LightGlue (SuperPoint's),
    each run on the card and by the port on the CPU in float32: the same
    valid keypoints in the same slots up to ties (``keypoints_agree``),
    descriptors within 1e-4; LightGlue's log-scores over the valid entries within
    ``LG_SCORE_TOL`` and at least 99% of the mutual-argmax matches equal
    (threshold 0: with random weights no pair passes the handler's 0.1).
    Returns each one's record with its ``failures`` (empty when it
    agrees)."""
    cpu = torch.device("cpu")
    out = {}
    for name, (mod, cfg, build) in EXTRACTORS.items():
        img, _, _ = handler.load_gray(img_path, 1600, rgb=name != "superpoint")
        cfg = cfg(max_keypoints=LEARN_KEYPOINTS)
        runs = [mod.extract(img, build(weights[name], dev), cfg, dev)
                for dev in (cpu, device)]
        out[name] = keypoints_agree(*runs, desc_tol=1e-4)

    net = convert.superpoint_from_numpy(weights["superpoint"], device)
    cfg = superpoint.SuperPointConfig(max_keypoints=LEARN_KEYPOINTS)
    feats = []
    for p in lg_pair_paths:
        img, _, (w, h) = handler.load_gray(p, 1600)
        xy, _, d, v = superpoint.extract(img, net, cfg, device)
        feats.append((xy, d, v, np.array([w, h], np.float32)))
    res = []
    for dev in (device, cpu):
        lg = convert.lightglue_from_numpy(weights["superpoint_lightglue"], dev)
        (k0, d0, m0, s0), (k1, d1, m1, s1) = [
            [torch.as_tensor(a, device=dev)[None] for a in f] for f in feats]
        with torch.inference_mode(), full_f32():
            scores = lg(k0, d0, m0, k1, d1, m1, s0, s1)
            m, c, _ = lightglue.filter_matches(scores, m0, m1, 0.0,
                                               LEARN_KEYPOINTS)
        res.append((scores[0].cpu(), m[0].cpu(), int(c[0]),
                    (m0[0, :, None] & m1[0, None, :]).cpu()))
    (sg, mg, cg, mask), (sc, mc, cc, _) = res
    lg_err = float((sg - sc).abs()[mask].max())
    rows_g = {tuple(r) for r in mg[:cg].tolist()}
    rows_c = {tuple(r) for r in mc[:cc].tolist()}
    differ = len(rows_g ^ rows_c)
    checks = {
        f"log-scores within {LG_SCORE_TOL:g}": lg_err <= LG_SCORE_TOL,
        ">= 99% of the matches equal":
            differ <= 0.01 * max(len(rows_g), len(rows_c)),
    }
    out["lightglue"] = dict(M=int(feats[0][2].size), threshold=0.0,
                            matches_card=int(cg), matches_cpu=int(cc),
                            matches_differ=differ,
                            log_score_max_abs_err=lg_err,
                            failures=[k for k, ok in checks.items() if not ok])
    return out


def lightglue_semantics(weights, device, M=LEARN_KEYPOINTS, seed=SEED):
    """``tests/test_lightglue.py``'s semantic bars at full width: M random
    unit descriptors at random keypoints of a 400x400 image, threshold 0;
    an identical set matched with itself, then a permuted copy.  Shares are
    of all M keypoints (the correct matches over M)."""
    rng = np.random.default_rng(seed)
    net = convert.lightglue_from_numpy(weights["superpoint_lightglue"], device)
    kp = rng.uniform(0, 400, (M, 2)).astype(np.float32)
    d = rng.standard_normal((M, 256)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v = np.ones(M, bool)
    cfg = lightglue.LightGlueConfig(filter_threshold=0.0, max_matches=M)
    m, _ = lightglue.match_pair(kp, d, v, kp, d, v, (400.0, 400.0), net, cfg,
                                device=device)
    perm = rng.permutation(M)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(M)
    mp, _ = lightglue.match_pair(kp, d, v, kp[perm], d[perm], v,
                                 (400.0, 400.0), net, cfg, device=device)
    return dict(semantic_M=M, identity_matches=len(m),
                identity_share=float(np.sum(m[:, 0] == m[:, 1]) / M),
                permutation_matches=len(mp),
                permutation_share=float(np.sum(mp[:, 1] == inv[mp[:, 0]]) / M))


def run_learned(device):
    """The learned front-ends through ``generate_database`` on the card,
    with seeded random weights (``learned_weights``) written as npz files
    and found through the handler's environment variables:
    ``superpoint+lightglue`` on 40 views of the plane scene at 640x480
    (2,048 keypoints, 780 pairs), ``disk+lightglue``, ``superpoint`` (the
    ratio matcher at D = 256) and ``dedode`` on 16 of them; each database
    read back with the counts written; one view per extractor and one pair
    for LightGlue held against the port's CPU run; LightGlue's semantic
    bars at M = 2,048.  One ``LEARNED`` line."""
    weights = learned_weights()
    envs = list(WEIGHT_ENV.values()) + ["INSTANTSFM_LIGHTGLUE_WEIGHTS"]
    saved = {k: os.environ.get(k) for k in envs}
    fronts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_learned_") as work:
        paths = {}
        for k, w in weights.items():
            paths[k] = os.path.join(work, f"{k}.npz")
            np.savez(paths[k], **w)
        t0 = time.perf_counter()
        render_plane_scene(os.path.join(work, "all"), device,
                           n_cams=LEARN_VIEWS, W=LEARN_W, H=LEARN_H,
                           f=LEARN_W * PIX_F / PIX_W)
        render_s = time.perf_counter() - t0
        dirs = {LEARN_VIEWS: os.path.join(work, "all", "images"),
                LEARN_OTHER_VIEWS: os.path.join(work, "some", "images")}
        names = sorted(os.listdir(dirs[LEARN_VIEWS]))
        os.makedirs(dirs[LEARN_OTHER_VIEWS])
        for i in np.linspace(0, LEARN_VIEWS - 1, LEARN_OTHER_VIEWS).round():
            shutil.copy(os.path.join(dirs[LEARN_VIEWS], names[int(i)]),
                        dirs[LEARN_OTHER_VIEWS])
        try:
            for k, env in WEIGHT_ENV.items():
                os.environ[env] = paths[k]
            for name, n in (("superpoint+lightglue", LEARN_VIEWS),
                            ("disk+lightglue", LEARN_OTHER_VIEWS),
                            ("superpoint", LEARN_OTHER_VIEWS),
                            ("dedode", LEARN_OTHER_VIEWS)):
                extractor = name.split("+")[0]
                if name.endswith("+lightglue"):
                    os.environ["INSTANTSFM_LIGHTGLUE_WEIGHTS"] = \
                        paths[f"{extractor}_lightglue"]
                db = os.path.join(work, f"{extractor}_{n}.db")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                st = handler.generate_database(
                    dirs[n], db, feature_name=name, config=Config("colmap"),
                    max_keypoints=LEARN_KEYPOINTS, log=lambda *a: None,
                    device=device)
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                vg, _, images, fname = read_colmap_database(db)
                rec = dict(views=n, **st,
                           extract_ms_per_image=st["extract_s"] * 1e3 / n,
                           peak_device_gb=peak_gb,
                           db_images=images.num_images,
                           db_keypoints=len(images.kp_xy),
                           db_pairs=vg.num_pairs, db_matches=len(vg.matches),
                           db_feature_name=fname)
                if name.endswith("+lightglue"):
                    din = weights[f"{extractor}_lightglue"][
                        "input_proj_w"].shape[1]
                    flop = st["pairs"] * lightglue_flop(
                        LEARN_KEYPOINTS, LEARN_KEYPOINTS, din)
                    bound_s = flop / PEAK_FLOPS[torch.float32]
                    rec.update(lightglue_tflop=flop / 1e12,
                               lightglue_bound_s=bound_s,
                               lightglue_bound_by="operations",
                               lightglue_share_of_bound=bound_s / st["match_s"])
                fronts[name] = rec
            card_cpu = learned_card_vs_cpu(
                weights, os.path.join(dirs[LEARN_VIEWS], names[0]),
                [os.path.join(dirs[LEARN_VIEWS], p) for p in names[:2]],
                device)
            sem = lightglue_semantics(weights, device)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    rec = dict(width=LEARN_W, height=LEARN_H, max_keypoints=LEARN_KEYPOINTS,
               render_s=render_s, front_ends=fronts, card_vs_cpu=card_cpu,
               **sem, weights="seeded random; SuperPoint, DISK and LightGlue "
               "at their published widths, DeDoDe at random_weights' widths "
               "(its published L/B widths need the checkpoint)",
               card=card_line())
    log("LEARNED " + json.dumps(rec))
    checks = {"identity >= 95% at M = 2,048": sem["identity_share"] >= 0.95,
              "permutation >= 90% at M = 2,048":
                  sem["permutation_share"] >= 0.90}
    for name, r in card_cpu.items():
        checks[f"{name}: card equals CPU ({r['failures']})"] = \
            not r["failures"]
    for name, r in fronts.items():
        n = r["views"]
        checks.update({
            f"{name}: {n} images, keypoints and feature name read back":
                r["db_images"] == n and r["db_keypoints"] == r["keypoints"]
                and r["db_feature_name"] == name,
            f"{name}: matches read back":
                r["db_pairs"] == r["verified_pairs"]
                and r["db_matches"] == r["verified_matches"],
            f"{name}: {n * (n - 1) // 2} pairs, keypoints found":
                r["pairs"] == n * (n - 1) // 2 and r["keypoints"] > 100 * n,
        })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"learned front-ends failed: {failed}")
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
    prune_scale3d.  Each point's track lists the views it projects into
    (in front of the camera, inside the image), which is where the depth
    loss reads it."""
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
    sfm_xyz = np.concatenate([pts, outliers])
    f = 600.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    dev32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    gauss = [dev32(a) for a in (pts, quats, scales, opac, sh)]
    os.makedirs(os.path.join(root, "images"))
    images = []
    seen = np.zeros((num_views, num_pts), bool)
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, num_views,
                                        endpoint=False)):
        c = np.array([7 * np.cos(ang), 7 * np.sin(ang), 1.5])
        R = ring_rotation(c)
        view = np.eye(4)
        view[:3, :3], view[:3, 3] = R, -R @ c
        p_cam = (sfm_xyz - c) @ R.T
        z = np.maximum(p_cam[:, 2], 1e-9)
        u, v = p_cam[:, 0] / z * f + W / 2, p_cam[:, 1] / z * f + H / 2
        seen[i] = (p_cam[:, 2] > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
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
    sfm_rgb = (np.concatenate([colors, rng.uniform(0, 1, (n_out, 3))])
               * 255).astype(np.uint8)
    cameras = [cmio.ModelCamera(1, cm.PINHOLE, W, H,
                                np.array([f, f, W / 2, H / 2]))]
    model = os.path.join(root, "sparse", "0")
    os.makedirs(model)
    cmio.write_cameras_binary(cameras, os.path.join(model, "cameras.bin"))
    cmio.write_images_binary(images, os.path.join(model, "images.bin"))
    pt_of, view_of = seen.T.nonzero()                # tracks, point-major
    cmio.write_points3D_binary_soa(
        os.path.join(model, "points3D.bin"), np.arange(1, num_pts + 1),
        sfm_xyz, sfm_rgb, np.zeros(num_pts),
        np.concatenate([[0], np.cumsum(seen.sum(0))]), view_of + 1,
        np.zeros(len(view_of), np.int64))


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


def profile_gs_step(runner, label="GS_PROFILE", trace="gs_step_trace.json"):
    """Device time by kernel over one training step of the trained model,
    and the host's aten calls (count, and the top ones by self time)."""
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
    scopes = {e.name for e in prof.events() if e.is_user_annotation}
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0
                   and ev.key not in scopes), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    host = sorted(((ev.self_cpu_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.key.startswith("aten::")), reverse=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, trace))
    log(f"{label} " + json.dumps(dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / wall_ms,
        host_aten_calls=sum(n for _, n, _ in host),
        top=[dict(us=us, n=n, name=name[:80]) for us, n, name in rows[:15]],
        top_host=[dict(us=us, n=n, name=name[:60])
                  for us, n, name in host[:10]])))


def gs_main_cfg(root, result, **options):
    """The 3DGS main shape's configuration (SH degree 3 from step 6, pool
    4x the SfM points), with ``GSConfig``'s sizing: every gaussian-tile
    pair kept, the windows as long as the view's fullest tile."""
    kw = dict(data_dir=root, result_dir=os.path.join(root, result),
              max_steps=GS_STEPS, test_every=8, capacity_mult=4.0,
              sh_degree=3, sh_degree_interval=2, eval_steps=(),
              save_steps=())
    return GSConfig(**{**kw, **options})


def gs_refine_schedule(runner):
    """Refine at steps 10, 20, 30, opacity reset at 25: prune_too_big
    needs a refine after the first reset (step > reset_every); the
    outliers' scales make it prune at step 30."""
    runner.strategy_cfg = gs_strategy.StrategyConfig(
        refine_start_iter=10, refine_every=10, reset_every=GS_RESET_EVERY)


def run_gs(device, root, profile=False):
    """Write the 3DGS scene in ``root`` and train it through ``Runner`` on
    the card; returns (GS record, one view's compositing inputs at the
    main shape)."""
    t0 = time.perf_counter()
    make_gs_scene(root, device, GS_POINTS, GS_VIEWS, GS_W, GS_H)
    scene_s = time.perf_counter() - t0
    cfg = gs_main_cfg(root, "results")
    t0 = time.perf_counter()
    runner = Runner(cfg, log=lambda *a: None, device=device)
    setup_s = time.perf_counter() - t0
    gs_refine_schedule(runner)
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


# ------------------------------------------------------ 3DGS options path

GS_OPTS_LPIPS_TOL = 1e-4     # card against CPU, relative, float32
GS_OPTS_TRAJ_FRAMES = 24
GS_MCMC_MIN_OPACITY = 0.09   # below the start's 0.1, so that relocation
                             # has rows to move by step 10
GS_OPTS_PRE_RESET_RISE = 0.03   # run A's train-view objective at step 24
                                # against the start: +1.5% on the H100 in
                                # three runs (0.1185 -> 0.1203), bar twice that
GS_OPTS_SMALL = (600, 6, 96, 72)   # points, views, W, H: the card tests'
GS_OPTS_SMALL_STEPS = 10           # small 3DGS scene


def gs_opts_card_vs_cpu(root, steps=GS_OPTS_SMALL_STEPS):
    """Run A's training options (pose_opt, app_opt, the bilateral grid, the
    depth loss, selective Adam, pose noise 0.01) for ``steps`` Runner steps
    on a small scene written in ``root``, on the CPU and on the card from
    one start: (record, checks).  Per-step losses within rel 1e-4; the pose
    deltas within 0.05 of their lr, and moved; the bilateral grids 99.5%
    within 0.05 of their lr and all within 2 lr a step (Adam moves an
    element by up to about lr a step, and grid cells fed by flat black
    background only get float-noise gradients of either sign, as
    ``tests/test_torch_gs_options.py`` finds against JAX)."""
    make_gs_scene(root, "cpu", *GS_OPTS_SMALL)
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = GSConfig(data_dir=root, result_dir=os.path.join(root, dev),
                       max_steps=steps, test_every=3, sh_degree=1,
                       sh_degree_interval=1, tile_capacity=128,
                       eval_steps=(), save_steps=(), capacity_mult=2.0,
                       pose_opt=True, app_opt=True, use_bilateral_grid=True,
                       depth_loss=True, visible_adam=True, pose_noise=0.01)
        r = Runner(cfg, log=lambda *a: None, device=dev)
        losses = np.asarray(r.train())
        out[dev] = (losses, r.aux["pose"].pose_deltas.detach().cpu(),
                    r.aux["bilgrid"].grids.detach().cpu())
    (lc, pc, gc), (lg, pg, gg) = out["cpu"], out["cuda"]
    grid_lr = ((gg - gc).abs() / cfg.bilateral_grid_lr).numpy()
    rec = dict(steps=steps, losses_cpu=lc.tolist(), losses_card=lg.tolist(),
               loss_rel=float(np.max(np.abs(lg - lc) / np.abs(lc))),
               pose_diff_lr=float((pg - pc).abs().max()) / cfg.pose_opt_lr,
               pose_delta_max=float(pc.abs().max()),
               grid_within_005_lr=float(np.mean(grid_lr <= 0.05)),
               grid_diff_lr_max=float(grid_lr.max()))
    checks = {
        "options losses card = CPU": rec["loss_rel"] <= 1e-4,
        "options pose deltas card = CPU":
            rec["pose_diff_lr"] <= 0.05 and rec["pose_delta_max"] > 0,
        "options bilateral grids card = CPU":
            rec["grid_within_005_lr"] >= 0.995
            and rec["grid_diff_lr_max"] <= 2 * steps,
    }
    return rec, checks


class Spy:
    """Replaces ``owner.name`` by ``wrap(original, *args, **kw)`` until
    ``restore``."""

    def __init__(self, owner, name, wrap):
        self.owner, self.name = owner, name
        self.original = getattr(owner, name)
        setattr(owner, name, lambda *a, **k: wrap(self.original, *a, **k))

    def restore(self):
        setattr(self.owner, self.name, self.original)


def splat_rows(splats, optimizer, rows):
    """Copies of the float fields and their Adam moments at ``rows``."""
    out = []
    for f in gs_splats.FLOAT_FIELDS:
        p = getattr(splats, f)
        st = optimizer.state.get(p, {})
        out += [p[rows].clone()] + [st[m][rows].clone() for m in
                                    gs_optim.MOMENTS if m in st]
    return out


def decompress_within_bounds(cdir, splats):
    """The compressed model holds the alive rows within the quantisation
    bounds of ``tests/test_gs_train.py::test_png_compression_roundtrip``;
    returns the largest error over its bound."""
    back = gs_compression.decompress_splats(cdir)
    alive = splats.alive.cpu().numpy()
    worst = 0.0
    for f in gs_splats.FLOAT_FIELDS:
        a = getattr(splats, f).detach().cpu().numpy()[alive]
        a = a.reshape(len(a), -1).astype(np.float64)
        b = back[f].reshape(len(a), -1)
        span = np.maximum(a.max(0) - a.min(0), 1e-9)
        bound = (span / (2 ** 16 - 1) * 0.51 + 1e-7 if f == "means"
                 else span / 255 * 0.51 + 1e-6)
        worst = max(worst, float((np.abs(a - b) / bound).max()))
    return worst


def lpips_card_vs_cpu(weights, runner):
    """LPIPS of the first val view's render and photo on the card and on
    the CPU: ([card value, CPU value], relative difference)."""
    v = runner.valset[0]
    H, W = v["image"].shape[:2]
    with torch.no_grad():
        out = runner._render(runner.splats, runner._tensor(v["camtoworld"]),
                             runner._tensor(v["K"]), W, H,
                             runner.cfg.sh_degree, v["image_id"], None,
                             torch.zeros(3, device=runner.device))
    pair = [torch.clamp(out.rgb, 0, 1), runner._tensor(v["image"])]
    vals = []
    for dev in (runner.device, torch.device("cpu")):
        net = convert.lpips_from_numpy(weights, dev)
        with torch.no_grad(), full_f32():
            vals.append(float(net(pair[0].to(dev), pair[1].to(dev))))
    return vals, abs(vals[0] - vals[1]) / abs(vals[1])


def train_views_loss(runner, views):
    """The training objective at the current parameters, averaged over
    ``views`` (every train view, prepared), without an update: (loss, K2
    launches it made)."""
    k2 = k23.composite_fwd.launches
    with torch.no_grad():
        loss = float(np.mean([
            float(runner._loss(runner.splats, v, None,
                               runner.cfg.sh_degree)[0]) for v in views]))
    return loss, k23.composite_fwd.launches - k2


def run_gs_opts_a(device, root, weights_path, profile=False):
    """Run A: every option but MCMC at the main shape, through ``Runner``
    (compression and LPIPS at the step-40 eval, a checkpoint there), then
    the PLY from that checkpoint as ``cli.gs --export_ply`` writes it and
    an ellipse trajectory.  The training objective, averaged over every
    train view, must fall after the opacity reset (from step 25 to 40).
    Before the reset it need not fall: the bilateral grids train at their
    full lr from the first step (JAX has no warm-up; gsplat's reference
    warms up over 1,000 steps) and with the pose noise that outweighs 25
    steps of fitting; at step 24 it must stay within
    ``GS_OPTS_PRE_RESET_RISE`` of the start (``gs_opts_card_vs_cpu`` holds
    the same options' steps on the card to the CPU's).  One view a step
    makes the per-step loss too noisy to show either.  Spies keep one
    depth-loss step's K3 inputs (at its launcher), one selective step's
    unseen rows, the eval's and compression's times, and those losses
    (their time taken out of their steps'); they count no launch."""
    cfg = gs_main_cfg(root, "results_opts", pose_opt=True, app_opt=True,
                      use_bilateral_grid=True, depth_loss=True,
                      visible_adam=True, compression="png", pose_noise=0.01,
                      eval_steps=(GS_STEPS,), save_steps=(GS_STEPS,))
    t0 = time.perf_counter()
    runner = Runner(cfg, log=lambda *a: None, device=device)
    setup_s = time.perf_counter() - t0
    gs_refine_schedule(runner)
    views = [runner._prepare(runner.trainset[i])
             for i in range(len(runner.trainset))]
    depth_points = [int(v["points_valid"].sum()) for v in views]
    rec, kept = {}, {}
    all_views, probe_k2, probe_s = {}, [0], {}

    def probe_losses(original, step, *a):
        original(step, *a)
        if step in (GS_RESET_EVERY - 1, GS_RESET_EVERY):
            t = time.perf_counter()
            all_views[step], n = train_views_loss(runner, views)
            probe_k2[0] += n
            probe_s[step] = time.perf_counter() - t

    def keep_k3_inputs(original, attrs, logt, gout, ntx):
        if "k3" not in kept:
            kept["k3"] = (attrs.clone(), logt.clone(), gout.clone(), ntx)
        return original(attrs, logt, gout, ntx)

    def hold_unseen_rows(original, optimizer, visible):
        if len(kept.setdefault("selective_calls", [])) != 3:
            kept["selective_calls"].append(None)
            return original(optimizer, visible)
        hidden = (~visible).nonzero()[:, 0]
        before = splat_rows(runner.splats, optimizer, hidden)
        original(optimizer, visible)
        after = splat_rows(runner.splats, optimizer, hidden)
        kept["selective_calls"].append(dict(
            unseen=len(hidden), seen=int(visible.sum()),
            bit_identical=all(torch.equal(a, b)
                              for a, b in zip(before, after))))

    def timed(key):
        def wrap(original, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            counts = (k23.composite_fwd.launches, k23.composite_bwd.launches)
            out = original(*a, **k)
            torch.cuda.synchronize()
            rec[key + "_s"] = time.perf_counter() - t
            rec[key + "_k23_launches"] = [
                k23.composite_fwd.launches - counts[0],
                k23.composite_bwd.launches - counts[1]]
            return out
        return wrap

    all_views["start"] = train_views_loss(runner, views)[0]
    spies = [Spy(k23, "_launch_bwd", keep_k3_inputs),
             Spy(runner, "_default_strategy", probe_losses),
             Spy(gs_optim, "selective_step", hold_unseen_rows),
             Spy(runner, "eval", timed("eval")),
             Spy(gs_compression, "compress_splats", timed("compress"))]
    old_env = os.environ.get("INSTANTSFM_LPIPS_WEIGHTS")
    os.environ["INSTANTSFM_LPIPS_WEIGHTS"] = weights_path
    try:
        torch.cuda.synchronize()
        k1.schur_wchain.launches = 0
        k23.composite_fwd.launches = k23.composite_bwd.launches = 0
        t0 = time.perf_counter()
        losses = runner.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k2n, k3n = k23.composite_fwd.launches, k23.composite_bwd.launches
        k1n = k1.schur_wchain.launches
        all_views["end"] = train_views_loss(runner, views)[0]
    finally:
        for spy in spies[::-1]:
            spy.restore()
        if old_env is None:
            os.environ.pop("INSTANTSFM_LPIPS_WEIGHTS")
        else:
            os.environ["INSTANTSFM_LPIPS_WEIGHTS"] = old_env

    # K3 on the depth-loss step's gout against its plain version
    attrs, logt, gout, ntx = kept["k3"]
    got = k23.composite_bwd(attrs, logt, gout, ntx)
    want = k23.composite_bwd_reference(attrs, logt, gout, ntx)
    torch.cuda.synchronize()
    k3_err = [_assert_rel(f"K3 depth-loss gout column {c}", got[..., c],
                          want[..., c], 1e-4) for c in range(10)]
    gout_rows = {name: float(gout[:, r].abs().max())
                 for name, r in (("rgb", slice(0, 3)), ("alpha", 3),
                                 ("depth", 4))}

    with open(os.path.join(cfg.result_dir, "stats",
                           f"val_{GS_STEPS}.json")) as f:
        val = json.load(f)
    lpips_vals, lpips_rel = lpips_card_vs_cpu(
        gs_lpips.load_weights(weights_path), runner)
    cdir = os.path.join(cfg.result_dir, "compression", f"step{GS_STEPS}")
    comp_over_bound = decompress_within_bounds(cdir, runner.splats)
    ckpt = os.path.join(cfg.result_dir, "ckpts", f"ckpt_{GS_STEPS}.npz")
    t0 = time.perf_counter()
    ply = gs_ply.export_ply_from_checkpoint(
        ckpt, os.path.join(cfg.result_dir, "point_cloud.ply"))
    ply_s = time.perf_counter() - t0
    with open(ply, "rb") as f:
        header = f.read(200).split(b"end_header")[0].decode()
    ply_vertices = int(header.split("element vertex ")[1].split()[0])
    torch.cuda.synchronize()
    k2_before = k23.composite_fwd.launches
    t0 = time.perf_counter()
    traj = runner.render_traj("ellipse", n_frames=GS_OPTS_TRAJ_FRAMES)
    torch.cuda.synchronize()
    traj_s = time.perf_counter() - t0
    traj_k2 = k23.composite_fwd.launches - k2_before
    if traj.endswith(".npz"):
        traj_shape = list(np.load(traj)["frames"].shape)
    else:
        traj_shape = [GS_OPTS_TRAJ_FRAMES] if os.path.getsize(traj) else []

    if profile:
        profile_gs_step(runner, "GS_OPTS_PROFILE", "gs_opts_step_trace.json")
    eval_k2 = rec["eval_k23_launches"][0]
    step_ms = [(t - probe_s.get(i, 0.0)) * 1e3
               for i, t in enumerate(runner.step_s)]
    selective = [c for c in kept["selective_calls"] if c]
    alive = int(runner.splats.alive.sum())
    rec.update(
        setup_s=setup_s, train_s=train_s, first_step_ms=step_ms[0],
        median_later_step_ms=float(np.median(step_ms[1:])), step_ms=step_ms,
        losses=losses, train_views_loss=all_views,
        depth_points_per_view=[min(depth_points), max(depth_points)],
        k2_launches=k2n, k3_launches=k3n,
        k2_train=k2n - eval_k2 - probe_k2[0], k2_loss_probes=probe_k2[0],
        k1_launches=k1n, val=val, lpips_card_cpu=lpips_vals,
        lpips_card_vs_cpu_rel=lpips_rel, k3_depth_loss_gout_max=gout_rows,
        k3_depth_loss_max_abs_err=max(e for e, _, _ in k3_err),
        k3_depth_loss_max_rel_err=max(r for _, _, r in k3_err),
        selective=selective,
        pose_delta_max=float(
            runner.aux["pose"].pose_deltas.detach().abs().max()),
        compression_over_bound=comp_over_bound, alive=alive,
        ply_vertices=ply_vertices, ply_s=ply_s, traj=os.path.basename(traj),
        traj_shape=traj_shape, traj_frames_k2=traj_k2,
        traj_ms_per_frame=traj_s * 1e3 / GS_OPTS_TRAJ_FRAMES)
    steps = GS_STEPS * cfg.batch_size
    reset = GS_RESET_EVERY
    checks = {
        "losses finite": bool(np.all(np.isfinite(losses))),
        "train views' loss within the bar of the start before the reset":
            all_views[reset - 1]
            <= (1 + GS_OPTS_PRE_RESET_RISE) * all_views["start"],
        "train views' loss falls after the reset":
            all_views["end"] < all_views[reset],
        "every training view has SfM points": min(depth_points) > 0,
        "K2 and K3 launched once per view per step":
            rec["k2_train"] == k3n == steps,
        "K2 once per val view in eval": eval_k2 == len(runner.valset),
        "the depth-loss gout has nonzero alpha and depth rows":
            gout_rows["alpha"] > 0 and gout_rows["depth"] > 0,
        "selective Adam keeps unseen rows bit for bit":
            len(selective) == 1 and selective[0]["bit_identical"]
            and selective[0]["unseen"] > 0,
        "pose deltas moved": rec["pose_delta_max"] > 0,
        "compressed model within its quantisation bounds":
            comp_over_bound <= 1.0,
        "val_40.json holds lpips": math.isfinite(val.get("lpips", math.nan)),
        "LPIPS card matches CPU": lpips_rel <= GS_OPTS_LPIPS_TOL,
        "PLY vertices = alive": ply_vertices == alive,
        "trajectory frames written":
            traj_k2 == GS_OPTS_TRAJ_FRAMES
            and traj_shape[:1] == [GS_OPTS_TRAJ_FRAMES],
    }
    return rec, checks


def run_gs_opts_b(device, root):
    """Run B: ``strategy="mcmc"`` (with the ``mcmc`` preset's opacity and
    scale regularisers) for 40 steps, relocation at steps 10, 20, 30.  A
    spy holds each relocation: its dead rows move, the others keep their
    means.  The rows outside the pool never move; one relocation of the
    final state on the card matches the CPU fed the same draws."""
    cfg = gs_main_cfg(root, "results_mcmc", strategy="mcmc",
                      opacity_reg=0.01, scale_reg=0.01)
    t0 = time.perf_counter()
    runner = Runner(cfg, log=lambda *a: None, device=device)
    setup_s = time.perf_counter() - t0
    runner.mcmc_cfg = gs_strategy.MCMCConfig(
        refine_start_iter=10, refine_every=10,
        min_opacity=GS_MCMC_MIN_OPACITY)
    outside = ~runner.splats.alive
    means0 = runner.splats.means.detach()[outside].clone()
    moves = []

    def hold_relocation(original, splats, optimizer, min_opacity, *a, **k):
        dead = splats.alive & (torch.sigmoid(splats.opacities) < min_opacity)
        before = splats.means.detach().clone()
        n = original(splats, optimizer, min_opacity, *a, **k)
        after = splats.means.detach()
        moves.append(dict(
            dead=int(dead.sum()), returned=n,
            dead_rows_moved=bool((after[dead] != before[dead]).any(1).all()),
            others_kept=bool(torch.equal(after[~dead], before[~dead]))))
        return n

    spy = Spy(gs_strategy, "mcmc_relocate", hold_relocation)
    try:
        torch.cuda.synchronize()
        k23.composite_fwd.launches = k23.composite_bwd.launches = 0
        t0 = time.perf_counter()
        losses = runner.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        k2n, k3n = k23.composite_fwd.launches, k23.composite_bwd.launches
    finally:
        spy.restore()
    outside_kept = torch.equal(runner.splats.means.detach()[outside], means0)

    # one relocation of the final state on the card and on the CPU, with
    # the same draws
    sp = runner.splats
    opac = torch.sigmoid(sp.opacities.detach())
    src = gs_strategy.choice(
        torch.where(sp.alive & (opac >= GS_MCMC_MIN_OPACITY), opac,
                    torch.zeros_like(opac)), len(opac),
        torch.Generator(device=device).manual_seed(SEED))
    state = copy.deepcopy(runner.optimizer.state_dict())
    results = []
    for dev in (device, torch.device("cpu")):
        twin = gs_splats.Splats(**{f: getattr(sp, f).detach().to(dev).clone()
                                   for f in gs_splats.FIELDS})
        opt = gs_splats.make_optimizer(gs_splats.float_params(twin),
                                       runner.scene_scale)
        opt.load_state_dict(copy.deepcopy(state))
        n = gs_strategy.mcmc_relocate(twin, opt, GS_MCMC_MIN_OPACITY,
                                      src=src.to(dev))
        results.append((n, splat_rows(twin, opt, slice(None))))
    relocate_equal = results[0][0] == results[1][0] and all(
        torch.equal(a.cpu(), b) for a, b in zip(results[0][1], results[1][1]))

    step_ms = [t * 1e3 for t in runner.step_s]
    rec = dict(setup_s=setup_s, train_s=train_s,
               median_later_step_ms=float(np.median(step_ms[1:])),
               losses=losses, relocations=runner.relocations, moves=moves,
               outside_pool_kept=outside_kept, k2_launches=k2n,
               k3_launches=k3n, relocate_card_vs_cpu_rows=results[0][0],
               relocate_card_equals_cpu=relocate_equal)
    checks = {
        "MCMC losses finite": bool(np.all(np.isfinite(losses))),
        "MCMC: no refine": not runner.refines,
        "relocation at steps 10, 20, 30":
            [r["step"] for r in runner.relocations] == [10, 20, 30],
        "each relocation moves its dead rows, and only them":
            len(moves) == 3 and all(m["dead"] > 0 and m["dead_rows_moved"]
                                    and m["others_kept"] for m in moves),
        "noise moves alive rows only": outside_kept,
        "MCMC K2 and K3 once per view per step": k2n == k3n == GS_STEPS,
        "relocation on the card matches the CPU": relocate_equal,
    }
    return rec, checks


def run_gs_opts(device, root, gs_rec, profile=False):
    """The 3DGS trainer's options on the main shape's scene (``root``, as
    ``run_gs`` wrote it): run A, run B and ``gs_opts_card_vs_cpu`` on a
    small scene beside it; one ``GS_OPTS`` line."""
    weights_path = os.path.join(root, "lpips_alex.npz")
    np.savez(weights_path, **gs_lpips.random_weights(
        torch.Generator().manual_seed(SEED)))
    a, checks_a = run_gs_opts_a(device, root, weights_path, profile)
    b, checks_b = run_gs_opts_b(device, root)
    small, checks_small = gs_opts_card_vs_cpu(os.path.join(root, "small"))
    rec = dict(
        setup_s=a["setup_s"],
        median_step_ms=a["median_later_step_ms"],
        gs_median_step_ms=gs_rec["median_later_step_ms"],
        eval_with_lpips_s=a["eval_s"], compress_s=a["compress_s"],
        ply_s=a["ply_s"], traj_ms_per_frame=a["traj_ms_per_frame"],
        mcmc_median_step_ms=b["median_later_step_ms"], run_a=a, run_b=b,
        small_card_vs_cpu=small)
    log("GS_OPTS " + json.dumps(rec))
    failed = [k for k, ok in {**checks_a, **checks_b, **checks_small}.items()
              if not ok]
    if failed:
        raise AssertionError(f"3DGS options path failed: {failed}")
    return rec


# ------------------------------------------------------ multi-device path

DIST_GS_BATCH = 2          # views of the distributed 3DGS step
DIST_WORKER_TIMEOUT_S = 420
# SIFT sums its orientation and descriptor histograms with float atomics
# (scatter_add_) on the card, so from run to run a descriptor may move by a
# level and a ratio test at its threshold may flip (one match of 31,911 in
# one two-rank run on an H100); a lost or misplaced slice of a rank's pairs
# would move about half of them
DIST_MATCH_SHARE = 0.001
# the sharded BA's mean rotation error against the single-device solve's:
# that solve alone, on the same input, ended between 0.0053 and 0.0064
# degrees in three runs on an H100 (its float32 PCG path follows K1's
# atomic camera sums), against 0.24 degrees before it
DIST_BA_ROT_RATIO = 1.5
# the multi-card run from this script: the 500-image ring keeps it within a
# few minutes (tools/multicard_torch.py's default, 2,000 images, is its own)
MULTICARD_IMAGES = 500
MULTICARD_TIMEOUT_S = 720


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def first_k1_input(store):
    """A wrapper for ``block_lm.schur_wchain`` that keeps (a copy of) the
    first input whose x is not 0: PCG's first matvec is of x0 = 0."""
    launch = block_lm.schur_wchain

    def keep(*args):
        if not store and bool(args[2].any()):
            store.append(tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args))
        return launch(*args)
    return launch, keep


def solved_images(images, cam):
    out = copy.deepcopy(images)
    out.qvec = cam["q"].detach().cpu().numpy().astype(np.float64)
    out.tvec = cam["t"].detach().cpu().numpy().astype(np.float64)
    return out


def dist_ba(device):
    """One BA solve at phase 4's shape (float32, PCG, at most BA_ITER_CAP
    LM iterations) alone and through ``sharded.optimize_sharded`` over the
    world-1 NCCL group: the point-local partition, all-reduces and K1 on the
    rank's buckets."""
    cameras, images, tracks, gt = make_scene()
    params, obs = scene_problem(cameras, images, tracks, torch.float32,
                                device)
    opts = dict(config.BUNDLE_ADJUSTER_OPTIONS, max_num_iterations=BA_ITER_CAP)
    cfg = dataclasses.replace(ba._lm_config(opts), solver="pcg")
    problem = make_ba_problem(cameras.uniform_model_id)
    kernel = robust.huber(float(opts["thres_loss_function"]))
    cost = lambda cam, pts: float(block_lm.compute_cost(
        problem, params._replace(cam=cam, pts=pts), obs, kernel))
    cost0 = cost(params.cam, params.pts)
    rot0, cen0 = pose_errors(images, gt)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cam1, pts1, h1 = sharded.optimize_auto(problem, kernel, cfg, params, obs,
                                           device=device)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    cam1b, _, _ = sharded.optimize_auto(problem, kernel, cfg, params, obs,
                                        device=device)

    kept = []
    launch, keep = first_k1_input(kept)
    block_lm.schur_wchain = keep
    debug.drain_stats()
    k1.schur_wchain.launches = k1.schur_wchain.plain_calls = 0
    try:
        t0 = time.perf_counter()
        cam2, pts2, h2 = sharded.optimize_sharded(
            problem, kernel, cfg, params, obs, device=device)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
    finally:
        block_lm.schur_wchain = launch
    launches = k1.schur_wchain.launches
    pcg = debug.drain_stats().get("pcg_iters", [])
    k1_rec = k1_sfm_check("sharded BA", kept[0], device)
    rot1, cen1 = pose_errors(solved_images(images, cam1), gt)
    rot2, cen2 = pose_errors(solved_images(images, cam2), gt)
    rot1b, _ = pose_errors(solved_images(images, cam1b), gt)
    rec = dict(single_s=single_s, sharded_s=sharded_s,
               lm_iters_single=len(h1), lm_iters_sharded=len(h2),
               cost_before=cost0, cost_single=cost(cam1, pts1),
               cost_sharded=cost(cam2, pts2),
               rot_err_deg_before=rot0, rot_err_deg_single=rot1,
               rot_err_deg_single_again=rot1b, rot_err_deg_sharded=rot2, center_err_rel_before=cen0,
               center_err_rel_single=cen1, center_err_rel_sharded=cen2,
               k1_launches=launches, pcg_iters=sum(pcg), k1=k1_rec)
    checks = {
        "sharded BA: cost falls": rec["cost_sharded"] < cost0,
        "sharded BA: rotation error no worse": rot2 <= rot0,
        "sharded BA: center error no worse": cen2 <= cen0,
        "sharded BA: cost within 1% of the single-device solve's":
            abs(rec["cost_sharded"] - rec["cost_single"])
            <= 0.01 * rec["cost_single"],
        f"sharded BA: rotation error within {DIST_BA_ROT_RATIO}x the "
        "single-device solve's": rot2 <= DIST_BA_ROT_RATIO * rot1,
        "sharded BA: center error within 10% of the single-device "
        "solve's": cen2 <= 1.1 * cen1 + 1e-6,
        "sharded BA: K1 launched at least once per PCG iteration":
            launches >= sum(pcg) > 0,
    }
    return rec, checks


def dist_gp(device, gt, gp_rec):
    """One GP LM step at the GP phase's size through the point-local step
    over the world-1 NCCL group, against the GP phase's single-device
    step."""
    params, obs = gp_problem(device, gt)
    problem, kernel = make_gp_problem(), robust.huber(0.1)
    cfg = block_lm.LMConfig(solver="pcg", radius_init=1e3)
    params_b, obs_b, buckets, _ = bucketize_problem(params, obs)
    params_p, obs_p, meta = sharded.partition_bucketed(params_b, obs_b,
                                                       buckets, 1)
    params_l, obs_l = sharded.rank_slice(params_p, obs_p, 0, meta.local_T,
                                         meta.local_O)
    step = sharded.make_pointlocal_lm_step(problem, kernel, cfg,
                                           buckets=meta.local_buckets,
                                           device=device)
    dev32 = lambda v: torch.tensor(v, device=device, dtype=torch.float32)
    state = block_lm.LMState(params_l, dev32(1.0 / cfg.radius_init),
                             dev32(float("inf")), dev32(0.0), dev32(0.0))
    kept = []
    launch, keep = first_k1_input(kept)
    block_lm.schur_wchain = keep
    debug.drain_stats()
    torch.cuda.synchronize()
    k1.schur_wchain.launches = 0
    try:
        t0 = time.perf_counter()
        state = step(state, obs_l)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        block_lm.schur_wchain = launch
    launches = k1.schur_wchain.launches
    pcg = debug.drain_stats().get("pcg_iters", [])
    rec = dict(ms=ms, cost_after=float(state.cost),
               cost_after_single=gp_rec["cost_after"], k1_launches=launches,
               pcg_iters=sum(pcg),
               k1=k1_sfm_check("sharded GP", kept[0], device))
    checks = {
        "sharded GP step: cost within 1e-3 of the single-device step's":
            abs(rec["cost_after"] - gp_rec["cost_after"])
            <= 1e-3 * gp_rec["cost_after"],
        "sharded GP step: cost falls":
            rec["cost_after"] <= gp_rec["cost_before"],
        "sharded GP step: K1 launched at least once per PCG iteration":
            launches >= sum(pcg) > 0,
    }
    return rec, checks


def gs_shard_check(runner, rank=0, world=1, seed=SEED):
    """The gaussian-sharded 3DGS loss and its gradients against one
    device's, on ``runner``'s pool and first training batch (``world``
    divides the batch).  The pool's initial scales are perturbed per axis
    (isotropic gaussians' quaternion gradients are float noise, which no
    bar can hold); the Runner's loss averaged over the views and its
    gradients are taken on this device, then the distributed loss over the
    default group's ``world`` ranks, this rank compositing its share of
    the views, and its gathered gradients.  Returns a dict: ``pool``,
    ``views``, ``batch`` (this rank's), ``loss_single``, ``loss_dist``,
    the gradients ``grads_single`` and ``grads_dist`` by field and
    "offset", ``grad_rel`` (each field's largest error over its largest
    gradient) and the K2/K3 launches of the distributed loss."""
    from instantsfm_tpu_torch.gs import distributed as gd

    cfg = runner.cfg
    views = runner._views(np.random.default_rng(seed))
    pool = runner.splats
    G = pool.means.shape[0]
    with torch.no_grad():
        pool.scales.add_(0.3 * torch.randn(
            pool.scales.shape, generator=torch.Generator().manual_seed(seed)
        ).to(pool.scales.device))
    offset = torch.zeros((G, 2), device=pool.means.device,
                         requires_grad=True)
    loss1 = torch.stack([runner._loss(pool, v, offset, cfg.sh_degree)[0]
                         for v in views]).mean()
    loss1.backward()
    g1 = {f: getattr(pool, f).grad.clone() for f in gs_splats.FLOAT_FIELDS}
    g1["offset"] = offset.grad.clone()

    b = len(views) // world
    batch = {"camtoworld": torch.stack([v["camtoworld"] for v in views]),
             "K": torch.stack([v["K"] for v in views]),
             "image": torch.stack([v["image"]
                                   for v in views[rank * b:(rank + 1) * b]])}
    sp = gd.shard_splats(gd.pad_splats(pool, world), rank, world)
    for f in gs_splats.FLOAT_FIELDS:
        getattr(sp, f).requires_grad_(True)
    offset2 = torch.zeros((sp.means.shape[0], 2), device=sp.means.device,
                          requires_grad=True)
    H, W = views[0]["image"].shape[:2]
    k2n, k3n = k23.composite_fwd.launches, k23.composite_bwd.launches
    objective, loss2, _, _, _ = gd.distributed_loss(
        sp, offset2, batch, W, H, cfg.sh_degree,
        tiles_per_gauss=cfg.tiles_per_gauss, tile_capacity=cfg.tile_capacity)
    objective.backward()
    g2 = {f: gd.gather_rows(getattr(sp, f).grad)[:G]
          for f in gs_splats.FLOAT_FIELDS}
    g2["offset"] = gd.gather_rows(offset2.grad)[:G]
    return dict(pool=pool, views=views, batch=batch, loss_single=loss1.item(),
                loss_dist=loss2.item(), grads_single=g1, grads_dist=g2,
                grad_rel={f: (g2[f] - g1[f]).abs().max().item()
                          / max(g1[f].abs().max().item(), 1e-30) for f in g1},
                k2_launches=k23.composite_fwd.launches - k2n,
                k3_launches=k23.composite_bwd.launches - k3n)


def dist_gs(device, root, result="dist", batch=DIST_GS_BATCH, rank=0,
            world=1):
    """``gs_shard_check`` on the GS phase's scene (``batch`` views) over
    the default group's ``world`` ranks, against this card; then one
    distributed train step from the same pool, whose K2 and K3 launches
    are counted and timed; K2/K3 held against their plain versions on the
    step's first view of this rank.  Returns (record, checks)."""
    from instantsfm_tpu_torch.gs import distributed as gd

    runner = Runner(gs_main_cfg(root, result, batch_size=batch),
                    log=lambda *a: None, device=device)
    chk = gs_shard_check(runner, rank, world)
    pool, mine, sh_degree = chk["pool"], chk["batch"], runner.cfg.sh_degree
    b = batch // world

    def shard():
        sp = gd.shard_splats(gd.pad_splats(pool, world), rank, world)
        for f in gs_splats.FLOAT_FIELDS:
            getattr(sp, f).requires_grad_(True)
        return sp

    kept = []
    composite = gs_raster.composite.composite_tiles

    def keep_first(attrs, nchunks, ntx):
        if not kept:
            kept.append((attrs.detach().clone(), nchunks.clone(), ntx))
        return composite(attrs, nchunks, ntx)

    sp = shard()
    opt = gs_splats.make_optimizer(gs_splats.float_params(sp),
                                   runner.scene_scale)
    step = gd.make_distributed_train_step(
        opt, GS_W, GS_H, tiles_per_gauss=runner.cfg.tiles_per_gauss,
        tile_capacity=runner.cfg.tile_capacity)
    gs_raster.composite.composite_tiles = keep_first
    torch.cuda.synchronize()
    k23.composite_fwd.launches = k23.composite_bwd.launches = 0
    try:
        t0 = time.perf_counter()
        loss3, g_offset, radii, seen = step(sp, mine, sh_degree)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        gs_raster.composite.composite_tiles = composite
    k2n, k3n = k23.composite_fwd.launches, k23.composite_bwd.launches
    k2_rec, k3_rec = k23_case(f"dist_rank{rank}_view0", *kept[0], reps=0,
                              allow_ties=True)
    grad_rel = chk["grad_rel"]
    rec = dict(views=batch, views_per_rank=b, world=world,
               pool=pool.means.shape[0], loss_single=chk["loss_single"],
               loss_dist=chk["loss_dist"], loss_step=loss3.item(),
               grad_max_rel_err=grad_rel,
               step_ms=step_ms, k2_launches=k2n, k3_launches=k3n,
               k2=k2_rec, k3=k3_rec, seen=int(seen.sum()))
    checks = {
        "distributed 3DGS: loss within 1e-5 of one device's":
            abs(rec["loss_dist"] - rec["loss_single"])
            <= 1e-5 * rec["loss_single"],
        "distributed 3DGS: gradients within 1e-4 of one device's "
        "(relative to each field's largest)":
            max(grad_rel.values()) <= 1e-4,
        "distributed 3DGS step: loss finite": math.isfinite(rec["loss_step"]),
        "distributed 3DGS step: K2 and K3 launched once per view of the "
        "rank": k2n == k3n == b,
    }
    return rec, checks


def dist_worker(rank, port, work, device="cuda"):
    """One of two ranks on one card over gloo: ``cli.feat`` then
    ``cli.sfm`` on ``work``; writes ``work/rank{rank}.json``."""
    from instantsfm_tpu_torch.cli import feat as cli_feat
    from instantsfm_tpu_torch.cli import sfm as cli_sfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(coordinator=f"localhost:{port}", num_processes=2,
                         process_id=rank, device=device, backend="gloo",
                         timeout_s=DIST_WORKER_TIMEOUT_S)
    feat_stats = []
    generate = handler.generate_database

    def keep_stats(*args, **kw):
        feat_stats.append(generate(*args, **kw))
        return feat_stats[-1]

    handler.generate_database = keep_stats
    k1.schur_wchain.launches = 0
    t0 = time.perf_counter()
    try:
        rc_feat = cli_feat.main(["--data_path", work, "--max_keypoints",
                                 "3000", "--match_ratio", "0.9",
                                 "--device", device])
    finally:
        handler.generate_database = generate
    feat_s = time.perf_counter() - t0
    multihost.barrier()
    t0 = time.perf_counter()
    rc_sfm = cli_sfm.main(["--data_path", work, "--device", device, "--f32"])
    sfm_s = time.perf_counter() - t0
    multihost.barrier()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, rc_feat=rc_feat, rc_sfm=rc_sfm,
                       feat_s=feat_s, sfm_s=sfm_s,
                       k1_launches=k1.schur_wchain.launches,
                       feat=feat_stats[0] if feat_stats else None), f)
    multihost.shutdown()


def db_differences(db_a, db_b):
    """How the COLMAP database ``db_b`` differs from ``db_a``: whether the
    images, each image's keypoint count, the matched pairs and the verified
    pairs are the same, and how many matches (image row pairs) lie in one
    database only, against ``db_a``'s total."""
    import sqlite3

    def read(db):
        con = sqlite3.connect(db)
        try:
            q = lambda sql: con.execute(sql).fetchall()
            return dict(
                images=q("SELECT image_id, name FROM images ORDER BY 1"),
                keypoints=q("SELECT image_id, rows FROM keypoints ORDER BY 1"),
                matches={pid: set(map(tuple, np.frombuffer(
                    blob or b"", np.uint32).reshape(n, 2).tolist()))
                    for pid, n, blob in q("SELECT pair_id, rows, data FROM "
                                          "matches")},
                verified=sorted(r[0] for r in q(
                    "SELECT pair_id FROM two_view_geometries")))
        finally:
            con.close()

    a, b = read(db_a), read(db_b)
    return dict(
        same_images=a["images"] == b["images"],
        same_keypoint_counts=a["keypoints"] == b["keypoints"],
        same_matched_pairs=a["matches"].keys() == b["matches"].keys(),
        same_verified_pairs=a["verified"] == b["verified"],
        matches=sum(len(m) for m in a["matches"].values()),
        matches_differing=sum(len(m ^ b["matches"].get(pid, set()))
                              for pid, m in a["matches"].items()))


def dist_two_ranks(pix_work, pix_gt, pix_rec):
    """Two ranks on the one card over gloo (NCCL takes one rank a card):
    ``cli.feat`` and ``cli.sfm`` on the PIXELS phase's views, each rank
    extracting and matching its slice, relative pose exchanging chunks and
    GP and BA sharding their points (PCG, K1 on each rank); rank 0 writes
    the database, which must hold the PIXELS phase's images, keypoint
    counts, matched and verified pairs, and its matches but for
    ``DIST_MATCH_SHARE`` of them (``db_differences``), and the model, which
    must register as many views as that phase's and meet its bars."""
    work = os.path.join(pix_work, "two_ranks")
    shutil.copytree(os.path.join(pix_work, "images"),
                    os.path.join(work, "images"))
    port = free_port()
    logs = [open(os.path.join(work, f"rank{r}.log"), "w") for r in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", str(r),
         str(port), work], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in (0, 1)]
    try:
        for p in procs:
            p.wait(timeout=DIST_WORKER_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    seconds = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        tails = []
        for r in (0, 1):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                tails.append(f"rank {r}:\n" + f.read()[-3000:])
        raise AssertionError("two ranks on one card failed:\n"
                             + "\n".join(tails))
    ranks = []
    for r in (0, 1):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    n_reg, n_pts, rot, ate = model_errors(os.path.join(work, "sparse", "0"),
                                          pix_gt)
    st = ranks[0]["feat"]
    db = db_differences(os.path.join(pix_work, "database.db"),
                        os.path.join(work, "database.db"))
    rec = dict(seconds=seconds, feat_s=[r["feat_s"] for r in ranks],
               sfm_s=[r["sfm_s"] for r in ranks],
               k1_launches=[r["k1_launches"] for r in ranks],
               keypoints=st["keypoints"], matches=st["matches"],
               verified_pairs=st["verified_pairs"],
               keypoints_one_rank=pix_rec["keypoints"],
               matches_one_rank=pix_rec["matches"],
               verified_pairs_one_rank=pix_rec["verified_pairs"],
               registered=n_reg, registered_one_rank=pix_rec["registered"],
               points=n_pts, rot_err_deg_max=float(rot.max()),
               ate_rel_max=float(ate.max()), database_vs_one_rank=db)
    checks = {
        "two ranks: cli.feat and cli.sfm exit 0 on both":
            all(r["rc_feat"] == 0 and r["rc_sfm"] == 0 for r in ranks),
        "two ranks: rank 1 wrote no database": ranks[1]["feat"] is None,
        "two ranks: one rank's images and keypoint count per image":
            db["same_images"] and db["same_keypoint_counts"],
        "two ranks: one rank's matched and verified pairs":
            db["same_matched_pairs"] and db["same_verified_pairs"],
        f"two ranks: at most {DIST_MATCH_SHARE:.1%} of one rank's matches "
        "differ": db["matches_differing"] <= DIST_MATCH_SHARE * db["matches"],
        "two ranks: as many views registered as one rank":
            n_reg == pix_rec["registered"],
        f"two ranks: >= {PIX_VIEWS - 1}/{PIX_VIEWS} views registered":
            n_reg >= PIX_VIEWS - 1,
        "two ranks: more than 300 points": n_pts > 300,
        "two ranks: max ATE < 2% of the extent": rec["ate_rel_max"] < 0.02,
        "two ranks: max rotation error < 0.5 degree":
            rec["rot_err_deg_max"] < 0.5,
        "two ranks: K1 launched on both ranks":
            all(n > 0 for n in rec["k1_launches"]),
    }
    return rec, checks


def run_multicard(world, images=MULTICARD_IMAGES):
    """``tools/multicard_torch.py --images images`` under torchrun at
    ``world`` ranks, one a card (its whole output in
    ``OUT_DIR/multicard_smoke.log``); returns the key numbers of its
    summary line, or raises where it fails, does not end within
    ``MULTICARD_TIMEOUT_S`` (its processes are then killed) or prints no
    summary."""
    import signal

    repo = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "multicard_smoke.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={world}",
           os.path.join(repo, "tools", "multicard_torch.py"),
           "--images", str(images)]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=repo, stdout=subprocess.PIPE,
                                stderr=log, text=True, start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=MULTICARD_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        log.write(out)
    seconds = time.perf_counter() - t0
    summary = next((json.loads(line) for line in reversed(out.splitlines())
                    if line.startswith('{"multicard"')), None)
    if proc.returncode or summary is None or not summary["ok"]:
        raise AssertionError(
            f"multi-card run at {world} ranks failed (exit "
            f"{proc.returncode}): " + (json.dumps(summary["multicard"][
                "failed"]) if summary else out[-3000:]))
    m = summary["multicard"]
    four, one = m["scale"]["four"], m["scale"]["one"]
    return dict(world=world, images=images, seconds=seconds,
                scale_s=four["total_s"], scale_s_one_card=one["total_s"],
                rot_err_deg_mean=four["rot_err_deg_mean"],
                rot_err_deg_mean_one_card=one["rot_err_deg_mean"],
                k1_launches_by_rank=[r["k1_launches"]
                                     for r in m["scale"]["four_by_rank"]],
                feat_s=m["feat"]["four"]["seconds"],
                feat_s_one_card=m["feat"]["one"]["seconds"],
                gs_median_step_ms=m["gs"]["four"]["median_later_step_ms"],
                gs_median_step_ms_one_card=m["gs"]["one"][
                    "median_later_step_ms"],
                gs_psnr=m["gs"]["four"]["psnr"],
                gs_psnr_one_card=m["gs"]["one"]["psnr"])


def run_dist(device, gs_root, pix_work, pix_gt, pix_rec, gt, gp_rec):
    """The multi-device paths (``DIST`` line): over a world-1 NCCL group in
    this process, the sharded BA solve and GP step and the distributed
    3DGS step, each against its single-device run; then two ranks on the
    card over gloo through the CLIs (``dist_two_ranks``); then, where the
    machine shows two or more cards, ``run_multicard``."""
    multihost.initialize(coordinator=f"localhost:{free_port()}",
                         num_processes=1, process_id=0, device=device)
    try:
        backend = torch.distributed.get_backend()
        ba_rec, ba_checks = dist_ba(device)
        gp_rec_d, gp_checks = dist_gp(device, gt, gp_rec)
        gs_rec, gs_checks = dist_gs(device, gs_root)
    finally:
        multihost.shutdown()
    two_rec, two_checks = dist_two_ranks(pix_work, pix_gt, pix_rec)
    cards = torch.cuda.device_count()
    multi_checks = {}
    if cards < 2:
        multicard = "not run: one card"
    else:
        try:
            multicard = run_multicard(min(cards, 4))
        except AssertionError as e:
            multicard = str(e)
        multi_checks["multi-card run passes"] = isinstance(multicard, dict)
    rec = dict(backend=backend, world=1, ba=ba_rec, gp=gp_rec_d, gs=gs_rec,
               two_ranks_gloo=two_rec, cards=cards, multicard=multicard,
               card=card_line())
    log("DIST " + json.dumps(rec))
    failed = [k for c in (ba_checks, gp_checks, gs_checks, two_checks,
                          multi_checks)
              for k, ok in c.items() if not ok]
    if failed:
        raise AssertionError(f"multi-device path failed: {failed}")
    return rec


# ------------------------------------------------------ measuring entry points

BENCH_TRACE_STEPS = 3


def launched(fn):
    """(fn(), the K1, K2 and K3 launches and K1's plain-version calls it
    made): every count is set to 0 just before ``fn`` and read just after."""
    k1.schur_wchain.launches = k1.schur_wchain.plain_calls = 0
    k23.composite_fwd.launches = k23.composite_bwd.launches = 0
    out = fn()
    return out, dict(k1=k1.schur_wchain.launches,
                     k1_plain=k1.schur_wchain.plain_calls,
                     k2=k23.composite_fwd.launches,
                     k3=k23.composite_bwd.launches)


def top_kernels(rec, n=8):
    """A trace record with only its ``n`` largest kernels (and unassigned
    kernels, where it assigns kernels to parts)."""
    short = lambda ks: [dict(k, name=k["name"][:60]) for k in ks[:n]]
    out = dict(rec, kernels=short(rec["kernels"]))
    if "unassigned" in rec:
        out.update(unassigned=short(rec["unassigned"]),
                   unassigned_ms_per_step=sum(
                       k["ms_per_step"] for k in rec["unassigned"]))
    return out


def run_bench(device):
    """Each measuring entry point's main path once, at its real size:
    ``bench_torch`` (the ETH3D-indoor BA step), ``bench_gs_torch`` (100k
    gaussians), the trace tools with ``BENCH_TRACE_STEPS`` steps (the GP
    step at the 2,000-image shape), ``probe_accuracy_torch`` and
    ``bench_relpose_torch`` on the SfM phase's 200-image scene and
    ``bench_lightglue_torch`` at its defaults.  (``bench_e2e_torch`` runs
    in the SFM and SCALE phases.)  Every record must carry its metric, the
    card, and launches of the kernels its path runs; no K1 call may take the
    plain version.  Returns the BENCH record."""
    import bench_gs_torch
    import bench_torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import bench_lightglue_torch
    import bench_relpose_torch
    import probe_accuracy_torch
    import trace_ba_step_torch
    import trace_gp_step_torch
    import trace_gs_step_torch

    rec, launches = {}, {}
    t0 = time.perf_counter()
    rec["bench_torch"], launches["bench_torch"] = launched(
        lambda: bench_torch.measure(200, 50_000, 8, 5, device))
    rec["bench_gs_torch"], launches["bench_gs_torch"] = launched(
        lambda: bench_gs_torch.measure(device))
    for name, tool in (("trace_ba_step_torch", trace_ba_step_torch),
                       ("trace_gp_step_torch", trace_gp_step_torch),
                       ("trace_gs_step_torch", trace_gs_step_torch)):
        out, launches[name] = launched(
            lambda: tool.trace(BENCH_TRACE_STEPS, device))
        rec[name] = top_kernels(out)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as root:
        scene = dict(num_cams=SFM_CAMS, num_pts=SFM_POINTS, window=SFM_WINDOW)
        (probe, _), launches["probe_accuracy_torch"] = launched(
            lambda: probe_accuracy_torch.probe(scene, device, root))
        rec["probe_accuracy_torch"] = probe
        dbpath = os.path.join(root, "database.db")
        relpose_s = [bench_relpose_torch.timed_pass(dbpath, device)[0]
                     for _ in range(2)]
        rec["bench_relpose_torch"] = dict(
            metric="relpose_pairs_per_sec", cold_s=relpose_s[0],
            warm_s=relpose_s[1], pairs=probe["pairs"],
            value=probe["pairs"] / relpose_s[1])
    rec["bench_lightglue_torch"] = bench_lightglue_torch.measure(32, 1024, 8,
                                                                 device)
    rec.update(seconds=time.perf_counter() - t0, launches=launches,
               card=card_line())
    log("BENCH " + json.dumps(rec))
    metrics = {"bench_torch": "ba_iters_per_sec",
               "bench_gs_torch": "gs_train_iters_per_sec",
               "bench_relpose_torch": "relpose_pairs_per_sec",
               "bench_lightglue_torch": "lightglue_pairs_per_sec"}
    bt, bg = rec["bench_torch"], rec["bench_gs_torch"]
    share = lambda v: math.isfinite(v) and 0 < v <= 1
    checks = {
        **{f"{k} prints {m}": rec[k]["metric"] == m
           and math.isfinite(rec[k]["value"]) and rec[k]["value"] > 0
           for k, m in metrics.items()},
        "bench_torch's roofline share in (0, 1]":
            0 < bt["roofline_frac"] <= 1,
        # past 1 the 3DGS step's count is wrong, not the card slow
        "bench_gs_torch's roofline_frac and mfu in (0, 1]":
            share(bg["roofline_frac"]) and share(bg["mfu"]),
        "bench_gs_torch bounds every part": set(bg["roofline_parts"])
            == set(gs_roofline.GS_PARTS),
        "bench_torch names the card": bt["device"]["kind"]
            == torch.cuda.get_device_name(0),
        "K1 launched under bench_torch, the BA and GP traces and the probe":
            all(launches[k]["k1"] > 0 for k in (
                "bench_torch", "trace_ba_step_torch", "trace_gp_step_torch",
                "probe_accuracy_torch")),
        "K2 and K3 launched once a step under bench_gs_torch and the trace":
            rec["bench_gs_torch"]["k2_launches_per_step"] == 1
            and rec["bench_gs_torch"]["k3_launches_per_step"] == 1
            and rec["trace_gs_step_torch"]["k2_launches_per_step"] == 1
            and rec["trace_gs_step_torch"]["k3_launches_per_step"] == 1,
        "no K1 call took the plain version": not any(
            v["k1_plain"] for v in launches.values()),
        "every trace saw device time": all(
            rec[k]["device_busy_ms_per_step"] for k in (
                "trace_ba_step_torch", "trace_gp_step_torch",
                "trace_gs_step_torch")),
        "the probe scored all four stages": [
            r["stage"] for r in probe["stage_accuracy"]] == [
            "relpose", "rotation_averaging", "global_positioning",
            "bundle_adjustment"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"BENCH failed: {failed}")
    return rec


INSTALLED_SCRIPT = """
import json, os, sys
import numpy as np, torch
import instantsfm_tpu_torch
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.utils import build
work = sys.argv[1]
z = np.load(os.path.join(work, "k1_in.npz"))
t = lambda k: torch.as_tensor(z[k], device="cuda")
buckets = tuple(tuple(int(v) for v in b) for b in z["buckets"])
y = k1.schur_wchain(t("W"), t("V_inv"), t("x"), t("cam"), t("pt"), buckets)
torch.cuda.synchronize()
np.save(os.path.join(work, "k1_out.npy"), y.cpu().numpy())
print(json.dumps(dict(package=instantsfm_tpu_torch.__file__,
                      build_dir=str(build.build_dir()),
                      libraries=sorted(os.listdir(build.build_dir())),
                      launches=k1.schur_wchain.launches)))
"""


def run_installed(device):
    """The port as a read-only installed package: ``instantsfm_tpu_torch``
    copied (sources and ``csrc/``, no ``build/``) into a temporary
    directory made read-only, imported from there by a fresh process whose
    user cache is another empty temporary directory.  It must build K1 into
    that cache and launch it once; its output is held against K1's plain
    version here.  Returns the INSTALLED record."""
    src = os.path.dirname(os.path.abspath(build.__file__))
    pkg = os.path.dirname(src)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_installed_") as tmp:
        site, cache = os.path.join(tmp, "site"), os.path.join(tmp, "cache")
        copy_dir = os.path.join(site, "instantsfm_tpu_torch")
        shutil.copytree(pkg, copy_dir, ignore=shutil.ignore_patterns(
            "build", "__pycache__"))
        bp = k1_layout([8] * 20_000, 200, SEED)
        W, V_inv, x, cam, pt, buckets = k1_inputs(bp, 200, 8, torch.float32,
                                                  device, SEED)
        np.savez(os.path.join(tmp, "k1_in.npz"), W=W.cpu().numpy(),
                 V_inv=V_inv.cpu().numpy(), x=x.cpu().numpy(),
                 cam=cam.cpu().numpy(), pt=pt.cpu().numpy(),
                 buckets=np.asarray(buckets, np.int64))
        for d, _, files in os.walk(site):
            for f in files:
                os.chmod(os.path.join(d, f), 0o444)
            os.chmod(d, 0o555)
        env = dict(os.environ, PYTHONPATH=site, XDG_CACHE_HOME=cache,
                   PYTHONDONTWRITEBYTECODE="1")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, "-c", INSTALLED_SCRIPT, tmp], cwd=tmp,
                env=env, capture_output=True, text=True, timeout=600)
        finally:
            for d, _, _ in os.walk(site):
                os.chmod(d, 0o755)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"INSTALLED: the installed copy failed:\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        got = torch.as_tensor(np.load(os.path.join(tmp, "k1_out.npy")),
                              device=device)
    want = k1.schur_wchain_reference(W, V_inv, x, cam, pt, buckets)
    check = k1_check("K1 from the installed copy", got, want,
                     k1_scales(W, V_inv, x, cam, pt, buckets))
    rec = dict(out, seconds=seconds, **{k: check[k] for k in (
        "max_abs_err", "max_err_over_abs_chain", "max_err_over_bound")})
    log("INSTALLED " + json.dumps(rec))
    checks = {
        "imported the copy": rec["package"].startswith(copy_dir),
        "built into the user cache": rec["build_dir"].startswith(cache),
        "K1 built there": any(f.startswith("libschur_wchain-")
                              for f in rec["libraries"]),
        "K1 launched once": rec["launches"] == 1,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"INSTALLED failed: {failed}")
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


def kernel_entry(name, source, replaces, launches, case, **extra):
    """One kernel's record in the kernels line, from its main-shape case."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=case["max_abs_err"],
                ms=case["ms"], ms_warm_l2=case["ms_warm_l2"],
                plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                bound_by=case["bound_by"], library_ms=None,
                build_s=build.BUILD_INFO[os.path.basename(source)[:-len(".cu")]]
                ["seconds"], **extra)


def k1_entry(cases, ba_rec, gp_rec, sfm_rec, retri_rec, dist_rec,
             scale_rec, bench_rec):
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
        launches_dist_ba=dist_rec["ba"]["k1_launches"],
        launches_dist_gp=dist_rec["gp"]["k1_launches"],
        launches_dist_two_ranks=dist_rec["two_ranks_gloo"]["k1_launches"],
        max_abs_err_dist_ba=dist_rec["ba"]["k1"]["max_abs_err"],
        max_abs_err_dist_gp=dist_rec["gp"]["k1"]["max_abs_err"],
        launches_retri_by_pc=retri_rec["k1_launches_retri_by_pc"],
        max_abs_err_sfm_retri=retri_rec["k1_on_retri_pc2_input"]["max_abs_err"],
        retri_pc2_input={k: retri_rec["k1_on_retri_pc2_input"][k] for k in (
            "PC", "rows", "points", "cams", "L", "ms", "plain_ms", "bound_ms")},
        launches_scale=scale_rec["k1_launches"],
        launches_by_entry_point={
            "bench_e2e_torch.py (SFM, 200 images)":
                sfm_rec["k1_launches_total"],
            "bench_e2e_torch.py (SCALE, 2,000 images)":
                scale_rec["k1_launches_total"],
            **{k: v["k1"] for k, v in bench_rec["launches"].items()
               if v["k1"]}},
        scale_inputs={stage: {k: c[k] for k in (
            "PC", "rows", "cams", "branch", "ms", "plain_ms", "bound_ms",
            "max_abs_err", "max_err_over_abs_chain", "max_err_over_abs_sum",
            "max_err_over_bound", "min_tol_chain_over_abs_y",
            "min_bound_over_abs_y")}
            for stage, c in scale_rec["k1"].items()},
        bound_ms_unfused=main_case["bound_ms_unfused"],
        index_add_ms=main_case["index_add_ms"],
        index_add_ms_warm_l2=main_case["index_add_ms_warm_l2"],
        matvec_ms=main_case["matvec_ms"],
        max_err_f32=max(c["max_abs_err"] for c in f32_cases),
        max_err_over_abs_chain_f32=max(c["max_err_over_abs_chain"]
                                       for c in f32_cases),
        max_err_over_abs_sum_f32=max(c["max_err_over_abs_sum"]
                                     for c in f32_cases),
        max_err_over_bound_f32=max(c["max_err_over_bound"]
                                   for c in f32_cases),
        min_tol_chain_over_abs_y_f32=min(c["min_tol_chain_over_abs_y"]
                                         for c in f32_cases),
        min_bound_over_abs_y_f32=min(c["min_bound_over_abs_y"]
                                     for c in f32_cases))


def build_entry(cases, path_cases, launches):
    """The BA build kernel in the kernels line: a port kernel with no TPU
    counterpart, in place of ``build_system``'s ``vmap(jacfwd)`` path;
    ``path_cases`` are the checks on the inputs the phases gave it."""
    main_case = next(c for c in cases if c["case"] == "ring_200_ba")
    keys = ("dtype", "PC", "rows", "cams", "branch", "max_err_over_bound",
            "max_abs_err", "ms", "bound_ms", "share")
    return kernel_entry(
        "ba_build", "instantsfm_tpu_torch/csrc/ba_build.cu", None,
        sum(v["build"] for v in launches.values()), main_case,
        replaces_fn="instantsfm_tpu_torch/solve/block_lm.py::build_system "
                    "(its vmap(jacfwd) path; the JAX package's is jax.jacfwd, "
                    "no Pallas kernel)",
        loss_ms=main_case["loss_ms"], share=main_case["share"],
        max_err_over_bound=max(c["max_err_over_bound"]
                               for c in [*cases, *path_cases.values()]),
        path_inputs={phase: {k: c[k] for k in keys}
                     for phase, c in path_cases.items()},
        launches_by_entry_point=launches)


def k23_entry(which, main_case, hand_cases, gs_rec, pix_rec, opts_rec,
              dist_rec, bench_rec):
    """K2 (which = 0) or K3 (1) in the kernels line."""
    extra = {} if which == 0 else dict(
        max_rel_err_depth_loss=opts_rec["run_a"]["k3_depth_loss_max_rel_err"],
        max_abs_err_depth_loss=opts_rec["run_a"]["k3_depth_loss_max_abs_err"])
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
                                   for c in hand_cases.values()),
        launches_pixels_tail=pix_rec[("gs_k2_launches",
                                      "gs_k3_launches")[which]],
        launches_gs_opts=opts_rec["run_a"][("k2_train", "k3_launches")[which]],
        launches_gs_mcmc=opts_rec["run_b"][("k2_launches",
                                            "k3_launches")[which]],
        launches_dist=dist_rec["gs"][("k2_launches", "k3_launches")[which]],
        max_rel_err_dist=dist_rec["gs"][("k2", "k3")[which]]["max_rel_err"],
        launches_by_entry_point={
            k: v[("k2", "k3")[which]] for k, v in bench_rec["launches"].items()
            if v[("k2", "k3")[which]]},
        **extra)


def first_jacfwd(device):
    """Pay the process's first vmap(jacfwd) call, a one-time cost timed
    apart from the stages: an add under it runs torch._refs.add, whose
    first call imports torch._dynamo (and sympy, torch.distributed.tensor)."""
    t0 = time.perf_counter()
    z = torch.zeros((2, 3), device=device)
    torch.func.vmap(lambda x: torch.func.jacfwd(lambda d: x + d)(x[0]))(z)
    torch.cuda.synchronize()
    log(f"first torch.func.vmap(jacfwd) call: {time.perf_counter() - t0:.3f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one BA LM step, the mapper's "
                         "relative-pose stage and one 3DGS training step, "
                         "with and without the options (torch.profiler)")
    ap.add_argument("--dist-worker", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.dist_worker:
        rank, port, work = args.dist_worker
        dist_worker(int(rank), int(port), work)
        return 0
    device = torch.device("cuda")
    # full-precision float32 products and convolutions (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.build_all(["schur_wchain", "composite_tiles", "ba_build"])
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_ptxas.txt"), "w") as f:
        for name, info in build.BUILD_INFO.items():
            f.write(f"== {name} ({info['seconds']:.1f} s)\n{info['log']}\n")
    log(f"build: {build_s:.1f} s (nvcc, sm_90a, sources built in parallel)")
    build_launches, seen = {}, dict(ba_closed.LAUNCHES)

    def launched(phase):
        """The BA build kernel's launches (build, loss mode) in ``phase``
        (the checks' own launches are not counted)."""
        build_launches[phase] = {k: v - seen[k]
                                 for k, v in ba_closed.LAUNCHES.items()}
        seen.update(ba_closed.LAUNCHES)

    k1_cases = k1_parity(device)
    k23_hand = k23_parity(device)
    build_cases = build_parity(device)
    first_jacfwd(device)
    # --profile: also print the BA phase's spans and reads (seconds, counts)
    debug.REGISTRY.totals.clear()
    ba_rec, gt = run_ba(device)
    launched("ba")
    if args.profile:
        log("BA_SPANS " + json.dumps(debug.REGISTRY.totals))
    gp_rec = run_gp_step(device, gt)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sfm_") as root:
        sfm_rec, sfm_gt, dbpath = run_sfm(device, root, profile=args.profile)
        launched("sfm")
        retri_rec = run_sfm_retri(device, dbpath, sfm_gt)
        launched("sfm_retri")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as root:
        scale_rec = run_scale(device, root)
    launched("scale")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pixels_") as pix_work:
        pix_rec, pix_gt = run_pixels(device, pix_work)
        run_tail(device, pix_work, pix_gt)
        run_feat(device)
        run_learned(device)
        if args.profile:
            profile_ba_step(device)
        with tempfile.TemporaryDirectory(prefix="gs_smoke_") as gs_root:
            gs_rec, tiles = run_gs(device, gs_root, profile=args.profile)
            opts_rec = run_gs_opts(device, gs_root, gs_rec, args.profile)
            dist_rec = run_dist(device, gs_root, pix_work, pix_gt, pix_rec,
                                gt, gp_rec)
    launched("pixels_gs_dist")
    k23_main = k23_case("gs_main", *tiles, reps=20, allow_ties=True)
    bench_rec = run_bench(device)
    launched("bench")
    run_installed(device)

    kernels = [k1_entry(k1_cases, ba_rec, gp_rec, sfm_rec, retri_rec,
                        dist_rec, scale_rec, bench_rec)] + [
        k23_entry(which, k23_main[which], k23_hand, gs_rec, pix_rec, opts_rec,
                  dist_rec, bench_rec)
        for which in (0, 1)] + [build_entry(build_cases, {
            phase: rec["ba_build"] for phase, rec in (
                ("ba", ba_rec), ("sfm", sfm_rec), ("sfm_retri", retri_rec),
                ("scale", scale_rec)) if rec.get("ba_build")},
            build_launches)]
    log(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
