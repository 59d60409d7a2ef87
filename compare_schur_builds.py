"""Time the first port's Schur-chain kernel K1, followed by the camera sum
of its output, beside this checkout's fused K1 on one CUDA card.

Run from the repository root:

    python3 compare_schur_builds.py OLD.cu [OLD.cu ...]

Each OLD.cu is a version of ``instantsfm_tpu_torch/csrc/schur_wchain.cu``
with the first port's C interface, which writes the per-row u [O', PC]
(e.g. ``git show 91b782b:instantsfm_tpu_torch/csrc/schur_wchain.cu``),
built with ``nvcc`` and the port's flags into a temporary directory.  For
each OLD.cu it prints:

* one ``COMPARE`` line per shape (the ETH3D-indoor BA at PC = 8, the
  Tanks-and-Temples BA at PC = 8 and the ETH3D GP at PC = 3 of
  ``chip_smoke.py``, float32, the same inputs for both builds): the largest
  difference of the old y (u from the old kernel, then
  ``block_lm._seg_by_cam``) from this kernel's y, absolute and over each
  camera's sum of |u|; the old build's registers and spills; and cold-L2
  device times (``chip_smoke.time_ms``) of the old pair and of this kernel
  in the order old, this, this, old, and of the old kernel alone
  (``ms_old_k1_alone``, same order);
* one ``HOST`` line at the ETH3D BA shape: the host time of one call, with
  the card held by a sleep kernel so the host never waits: the old C
  launch followed by the camera sum, this C launch (memset and kernel),
  this wrapper (``schur_wchain``), and the PCG's Schur matvec with each
  (``U_d x - y``), in the order old, this, this, old;
* one ``BA`` line per run of ``chip_smoke.py``'s BA stage (3 rounds at the
  ETH3D-indoor shape, f32) with the old pair or this kernel in the PCG's
  matvec, in the order old, this, this, old, twice: seconds, LM steps and
  iterations per round, each later step's time and PCG iterations, their
  median, a line fitted through them (ms a PCG iteration, fixed ms a
  step), and the rotation error after.

Launches made here go around the wrappers and are not counted.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import lru_cache

import numpy as np
import torch

import chip_smoke as cs
from instantsfm_tpu_torch import config
from instantsfm_tpu_torch.pipeline import ba
from instantsfm_tpu_torch.solve import block_lm
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.utils import build, debug

REPS = 50
HOST_CALLS = 100
BA_RUNS = 2
SHAPES = (("eth3d_indoor_ba", 50_000, 200, 8),
          ("tnt_ba", 1_000_000, 500, 8),
          ("eth3d_indoor_gp", 50_000, 200, 3))
THIS_MATVEC = block_lm.schur_matvec


def build_libs(sources, out_dir):
    """Compile every source at once (one nvcc each) and load it with the
    first port's signature: [(source, CDLL, ptxas lines)]."""
    procs = []
    for i, src in enumerate(sources):
        so = os.path.join(out_dir, f"libold{i}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", so, src]
        procs.append((src, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for src, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.schur_wchain_launch.argtypes = [i, i, p, p, p, p, p, p, i, p, p,
                                            p, p, p]
        lib.schur_wchain_launch.restype = i
        libs.append((src, lib, log))
    return libs


def ptxas_lines(log, pc=None):
    """ptxas's registers, shared memory and spills by kernel name (float32
    kernels of camera width pc only, where given)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("Used" in ln or "spill" in ln):
            out[name] = out.get(name, "") + ln.strip().replace(
                "ptxas info    : ", "") + "; "
    return {k: v for k, v in out.items()
            if pc is None or f"IfLi{pc}E" in k}


@lru_cache(maxsize=8)
def old_launch_table(buckets):
    """The first port's table: one block per BLOCK rows (L <= BLOCK) or per
    group, as int64 host arrays (row_start, rows, log_l, blk_off)."""
    row_start, rows, log_l, blk_off = [], [], [], [0]
    for (os_, ps, Tb, L) in buckets:
        row_start.append(os_)
        rows.append(Tb * L)
        log_l.append(L.bit_length() - 1)
        blk_off.append(blk_off[-1] + -(-(Tb * L) // max(k1.BLOCK, L)))
    return tuple(np.asarray(a, np.int64)
                 for a in (row_start, rows, log_l, blk_off))


def old_launch(lib, W, V_inv, x, cam, pt, buckets, u):
    """The first port's kernel: u [O', PC] through its C interface."""
    tab = old_launch_table(tuple(buckets))
    if lib.schur_wchain_launch(
            0, W.shape[1], W.data_ptr(), V_inv.data_ptr(), x.data_ptr(),
            cam.data_ptr(), pt.data_ptr(), u.data_ptr(), len(tab[0]),
            *(a.ctypes.data for a in tab),
            torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("old K1 launch failed")


def old_pair(lib, W, V_inv, x, cam, pt, buckets):
    """y the first port's way: the old kernel's u, then its camera sum."""
    u = torch.empty((W.shape[0], W.shape[1]), dtype=W.dtype, device=W.device)
    old_launch(lib, W, V_inv, x, cam, pt, buckets, u)
    return block_lm._seg_by_cam(u, cam, x.shape[0])


def old_matvec(lib):
    """The first port's Schur matvec, U_d x - (old kernel + camera sum)."""
    def matvec(U_d, W, V_inv, cam_idx, pt_idx, buckets, x):
        return block_lm._mv(U_d, x) - old_pair(
            lib, W.contiguous(), V_inv.contiguous(), x.contiguous(),
            cam_idx.contiguous(), pt_idx.contiguous(), buckets)
    return matvec


def this_launch(W, V_inv, x, cam, buckets, y):
    """This build's kernel through its C interface, into y."""
    row_start, rows, pt_start, log_l, item_off = k1.launch_table(buckets)
    C, PC = x.shape
    err = k1._lib().schur_wchain_launch(
        0, PC, int(k1.shared_table(C, PC, W.dtype)), W.data_ptr(),
        V_inv.data_ptr(), x.data_ptr(), cam.data_ptr(), y.data_ptr(),
        W.shape[0], V_inv.shape[0], C, len(row_start), row_start.ctypes.data,
        rows.ctypes.data, pt_start.ctypes.data, log_l.ctypes.data,
        item_off.ctypes.data, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 launch failed ({err})")


def host_us(fn, calls=HOST_CALLS):
    """Host time of one call of ``fn`` in us: the mean over ``calls`` calls
    queued behind a sleep kernel, so the host never waits for the card.
    The sleep is lengthened until it outlasts the calls."""
    fn()
    torch.cuda.synchronize()
    cycles = 10 ** 7
    for _ in range(6):
        torch.cuda._sleep(cycles)
        held = torch.cuda.Event()
        held.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        seconds = time.perf_counter() - t0
        pending = not held.query()
        torch.cuda.synchronize()
        if pending:
            return seconds / calls * 1e6
        cycles *= 4
    raise RuntimeError("the sleep kernel never outlasted the calls")


def inputs(npts, C, PC):
    bp = cs.k1_layout([8] * npts, C, cs.SEED)
    return cs.k1_inputs(bp, C, PC, torch.float32, torch.device("cuda"),
                        cs.SEED)


def compare(name, npts, C, PC, src, lib, log, flush):
    W, V_inv, x, cam, pt, buckets = inputs(npts, C, PC)
    abs_sums = cs.k1_abs_sums(W, V_inv, x, cam, pt, buckets)
    y = torch.empty_like(x)
    u = torch.empty((W.shape[0], PC), device=W.device)
    this = lambda: this_launch(W, V_inv, x, cam, buckets, y)
    old_alone = lambda: old_launch(lib, W, V_inv, x, cam, pt, buckets, u)
    old = lambda: old_pair(lib, W, V_inv, x, cam, pt, buckets)
    this()
    err = (old() - y).abs()
    times = lambda a, b: [cs.time_ms(fn, REPS, flush) for fn in (a, b, b, a)]
    cs.log("COMPARE " + json.dumps(dict(
        source=src, shape=name, rows=W.shape[0], cams=C, PC=PC,
        ptxas_old=ptxas_lines(log, PC), max_abs_diff_y=err.max().item(),
        max_diff_over_abs_sum=(err / abs_sums.clamp(min=1e-30)).max().item(),
        order=["old", "this", "this", "old"], ms=times(old, this),
        ms_old_k1_alone=times(old_alone, this),
        bound_ms=cs.k1_bound(W, V_inv, x, buckets)[0])))


def host_times(src, lib):
    W, V_inv, x, cam, pt, buckets = inputs(50_000, 200, 8)
    y = torch.empty_like(x)
    U_d = torch.eye(8, device=x.device).expand(200, 8, 8).contiguous()
    old_mv = old_matvec(lib)
    pairs = {
        "launch": (lambda: old_pair(lib, W, V_inv, x, cam, pt, buckets),
                   lambda: this_launch(W, V_inv, x, cam, buckets, y)),
        "wrapper": (lambda: old_pair(lib, W, V_inv, x, cam, pt, buckets),
                    lambda: k1.schur_wchain(W, V_inv, x, cam, pt, buckets)),
        "matvec": (lambda: old_mv(U_d, W, V_inv, cam, pt, buckets, x),
                   lambda: THIS_MATVEC(U_d, W, V_inv, cam, pt, buckets, x)),
    }
    rec = {"source": src, "shape": "eth3d_indoor_ba", "calls": HOST_CALLS,
           "order": ["old", "this", "this", "old"]}
    for what, (old, this) in pairs.items():
        rec[f"{what}_us"] = [host_us(fn) for fn in (old, this, this, old)]
    cs.log("HOST " + json.dumps(rec))


def ba_stage(who, matvec):
    """chip_smoke.py's BA stage with ``matvec`` as the PCG's Schur operator."""
    cameras, images, tracks, gt = cs.make_scene()
    opts = dict(config.BUNDLE_ADJUSTER_OPTIONS,
                max_num_iterations=cs.BA_ITER_CAP)
    thr = config.INLIER_THRESHOLD_OPTIONS["max_reprojection_error"]
    block_lm.schur_matvec = matvec
    try:
        debug.drain_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ba.bundle_adjustment_rounds(cameras, images, tracks, opts, thr,
                                    rounds=3, dtype=torch.float32,
                                    device=torch.device("cuda"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        block_lm.schur_matvec = THIS_MATVEC
    stats = debug.drain_stats()
    step_ms = [s * 1e3 for s in stats["lm_step_s"]]
    # PCG iterations of each LM step: the sum over its damped tries
    ends = np.cumsum(stats["lm_tries"])
    pcg = [int(sum(stats["pcg_iters"][e - n:e]))
           for e, n in zip(ends, stats["lm_tries"])]
    slope, fixed = np.polyfit(pcg[1:], step_ms[1:], 1)
    cs.log("BA " + json.dumps(dict(
        kernel=who, seconds=seconds, lm_iters_per_round=stats["ba_lm_iters"],
        lm_steps=len(step_ms), median_later_step_ms=float(np.median(
            step_ms[1:])), later_step_ms=step_ms[1:], later_pcg_iters=pcg[1:],
        ms_per_pcg_iter=slope, fixed_ms_per_step=fixed,
        rot_err_deg_after=cs.pose_errors(images, gt)[0])))


def main(argv=None):
    sources = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("compare_schur_builds: no CUDA device available",
              file=sys.stderr)
        return 1
    if not sources:
        print(__doc__, file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}")
    build.build_all(["schur_wchain"])
    cs.log("ptxas this: " + json.dumps(ptxas_lines(
        build.BUILD_INFO["schur_wchain"]["log"])))
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    # the process's one-time set-up of vmap(jacfwd), before any BA run
    z = torch.zeros((2, 3), device="cuda")
    torch.func.vmap(lambda v: torch.func.jacfwd(lambda d: v + d)(v[0]))(z)
    with tempfile.TemporaryDirectory(prefix="schur_builds_") as tmp:
        for src, lib, log in build_libs(sources, tmp):
            for shape in SHAPES:
                compare(*shape, src, lib, log, flush)
            host_times(src, lib)
            for _ in range(BA_RUNS):
                for who in ("old", "this", "this", "old"):
                    ba_stage(who, old_matvec(lib) if who == "old"
                             else THIS_MATVEC)
    return 0


if __name__ == "__main__":
    sys.exit(main())
