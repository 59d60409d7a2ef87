"""The port's multi-process paths on several cards over NCCL, each held
against one card in the same run.

Started by torchrun from the repository root, one process per card:

    torchrun --standalone --nproc_per_node=4 tools/multicard_torch.py \\
        [--images 2000|500|200]

Every rank builds K1 and K2/K3 into the checkout's build directory at the
same time (seconds per rank).  Rank 0 writes the ring database of
``--images`` (2,000: ``chip_smoke.SCALE_2K``, ``bench_e2e.py``'s config 4;
500: ``PERF.md`` §4's 500-image config; 200: the SFM phase's scene), rank 1
renders the FEAT phase's 200 views at 640x480, rank 2
writes the GS phase's 3DGS scene (100k points, 24 views at 800x608), and
then, over the default NCCL group:

1. FEAT: ``cli.feat`` on those views (each rank extracts and matches its
   strided slice, rank 0 writes the database), then ``cli.sfm`` on it;
2. GS: one batch of 4 views from one start, the gaussian-sharded loss and
   gradients against the same card's single-device ones (``chip_smoke
   .dist_gs``'s bars), one distributed train step with K2/K3 held against
   their plain versions on the rank's view; then ``cli.gs --distributed
   --batch_size 4`` for 40 steps with the GS phase's configuration and
   refine schedule;
3. SCALE: ``cli.sfm --f32`` on the ring database (relative pose's chunks
   shared, GP and BA point-sharded), scored against the ring's ground
   truth and by ``eval.benchmark.evaluate_scene``; K1's launches by stage
   and branch on each rank, and K1 held against its plain version on each
   rank's first GP and BA input (``chip_smoke.k1_sfm_check``); seconds per
   stage, peak device memory per card, peak host RSS per process.

Each rank prints one ``RANK`` JSON line.  Then the one-card references run
in fresh processes, one a card, at once (``--one-card scale|feat|gs``: the
same CLIs in a process of its own on the rank's card, no process group):
rank 0 takes SCALE, rank 1 FEAT, rank 2 GS (round robin under 3 ranks).
Rank 0 holds the multi-card results to the bars and to the references and
prints ONE JSON line last, ``{"multicard": ..., "ok": ...}`` (also written
to ``multicard_<images>/summary.json`` under ``chip_smoke.OUT_DIR``, beside
each rank's record and the references' logs); the run exits 1 where a
check fails.  Needs two or more CUDA cards.
"""

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke as cs
from instantsfm_tpu_torch.cli import feat as cli_feat
from instantsfm_tpu_torch.cli import gs as cli_gs
from instantsfm_tpu_torch.cli import sfm as cli_sfm
from instantsfm_tpu_torch.eval import benchmark
from instantsfm_tpu_torch.features import handler
from instantsfm_tpu_torch.gs import composite as k23
from instantsfm_tpu_torch.parallel import multihost
from instantsfm_tpu_torch.pipeline import mapper
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.utils import bench, build, debug

SCALES = {2000: cs.SCALE_2K,
          500: dict(num_cams=500, num_pts=1_000_000, vis_angle=0.05,
                    window=12, scene_scale=1.0, max_matches_per_pair=0),
          200: dict(num_cams=200, num_pts=20_000)}
JOBS = ("scale", "feat", "gs")
GS_BATCH = 4
GS_PSNR_DB = 0.5           # val PSNR, four cards against one
REF_TIMEOUT_S = 1500
# the GS phase's Runner settings that cli.gs has no flag for
GS_CLI_FIELDS = ("test_every", "capacity_mult", "sh_degree",
                 "sh_degree_interval", "tile_capacity", "tiles_per_gauss",
                 "eval_steps", "save_steps")
# torchrun's variables, which a one-card reference must not see: it would
# join the group (and torchrun sets one CPU thread a process)
LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK", "GROUP_RANK", "ROLE_RANK", "LOCAL_WORLD_SIZE",
               "GROUP_WORLD_SIZE", "ROLE_WORLD_SIZE", "ISFM_COORDINATOR",
               "ISFM_NUM_PROCESSES", "ISFM_PROCESS_ID", "OMP_NUM_THREADS")


def reset_peak():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def peak_device_gb():
    return torch.cuda.max_memory_allocated() / 1e9


def quiet(*args, **kwargs):
    pass


# ------------------------------------------------------------ inputs

def prepare(job, work, images):
    """Write one path's input under ``work``; returns its record."""
    t0 = time.perf_counter()
    src = os.path.join(work, f"{job}_src")
    os.makedirs(src)
    if job == "scale":
        gt, pairs, matches = cs.write_ring_db(
            os.path.join(src, "database.db"), **SCALES[images])
        np.savez(os.path.join(src, "gt.npz"), **gt)
        cs.write_ring_gt_model(os.path.join(src, "sparse_gt"), gt)
        rec = dict(scene=SCALES[images], pairs=pairs, matches=matches)
    elif job == "feat":
        gt = cs.render_plane_scene(src, "cuda", n_cams=cs.FEAT_VIEWS,
                                   W=cs.FEAT_W, H=cs.FEAT_H,
                                   f=cs.FEAT_W * cs.PIX_F / cs.PIX_W)
        np.savez(os.path.join(src, "gt.npz"), **gt)
        rec = dict(views=cs.FEAT_VIEWS, width=cs.FEAT_W, height=cs.FEAT_H)
    else:
        cs.make_gs_scene(src, "cuda", cs.GS_POINTS, cs.GS_VIEWS, cs.GS_W,
                         cs.GS_H)
        rec = dict(points=cs.GS_POINTS, views=cs.GS_VIEWS, width=cs.GS_W,
                   height=cs.GS_H)
    rec["setup_s"] = time.perf_counter() - t0
    return rec


def load_gt(work, job):
    return dict(np.load(os.path.join(work, f"{job}_src", "gt.npz")))


def scene_copy(work, job, tag):
    """A scene directory of its own for one run of a CLI: the images
    copied, the database linked."""
    src, dst = os.path.join(work, f"{job}_src"), os.path.join(work, tag)
    os.makedirs(dst)
    if os.path.isdir(os.path.join(src, "images")):
        shutil.copytree(os.path.join(src, "images"),
                        os.path.join(dst, "images"))
    db = os.path.join(src, "database.db")
    if os.path.exists(db):
        os.link(db, os.path.join(dst, "database.db"))
    return dst


# ------------------------------------------------------------ the CLIs

def sfm_cli(data_path):
    """``cli.sfm --f32`` on ``data_path``, with K1's launches counted by
    stage and branch and its first GP and BA input kept.  Returns (record,
    the mapper's images, the first K1 inputs by stage)."""
    marks, first_input, launches, done, out = {}, {}, {}, set(), {}

    def hook(name, cameras, images, tracks):
        done.add(name)
        marks[name] = len(debug.STATS.get("pcg_iters", ()))

    solve = mapper.solve_global_mapper

    def solve_spy(*args, **kwargs):
        out["mapper"] = solve(*args, stage_hook=hook, **kwargs)
        return out["mapper"]

    debug.drain_stats()
    reset_peak()
    k1.schur_wchain.launches = k1.schur_wchain.plain_calls = 0
    mapper.solve_global_mapper = solve_spy
    t0 = time.perf_counter()
    try:
        with cs.k1_by_stage(done, first_input, launches):
            rc = cli_sfm.main(["--data_path", data_path, "--device", "cuda",
                               "--f32"])
            torch.cuda.synchronize()
    finally:
        mapper.solve_global_mapper = solve
    total_s = time.perf_counter() - t0
    stats = debug.drain_stats()
    pcg = stats.get("pcg_iters", [])
    gp = marks.get("global_positioning", 0)
    ba = marks.get("bundle_adjustment", len(pcg))
    _, images, tracks, timings = out["mapper"]
    rec = dict(rc=rc, total_s=total_s, stage_s=timings,
               registered=int(images.registered.sum()),
               images=len(images.registered), tracks=int(tracks.num_tracks),
               observations=int(tracks.num_observations),
               gp_lm_iters=stats.get("gp_lm_iters"),
               ba_lm_iters=stats.get("ba_lm_iters"),
               pcg_iters_gp=sum(pcg[:gp]), pcg_iters_ba=sum(pcg[gp:ba]),
               ra_syncs_total=sum(sum(d.values())
                                  for d in stats.get("ra_syncs", [])),
               k1_launches=launches,
               k1_launches_total=k1.schur_wchain.launches,
               k1_plain_calls=k1.schur_wchain.plain_calls,
               peak_device_gb=peak_device_gb(),
               peak_host_rss_gb=bench.peak_host_rss_gb())
    return rec, images, first_input


def score_ring(rec, images, gt):
    """The ring's rotation errors and ATE (as a share of the extent) into
    ``rec``."""
    reg = np.nonzero(images.registered)[0]
    rot, ate = cs.scale_errors(images.qvec[reg], images.centers()[reg], gt,
                               reg)
    rec.update(rot_err_deg_mean=float(rot.mean()),
               rot_err_deg_max=float(rot.max()),
               ate_rel_mean=float(ate.mean()), ate_rel_max=float(ate.max()))


def scale_result(data, gt):
    """``sfm_cli`` on the ring scene ``data``, scored; K1 held against its
    plain version on the first GP and BA input (launches made to compare
    are not counted)."""
    rec, images, first_input = sfm_cli(data)
    score_ring(rec, images, gt)
    dev = torch.device("cuda", torch.cuda.current_device())
    rec["k1"] = {stage: cs.k1_sfm_check(stage, args, dev)
                 for stage, args in first_input.items()}
    return rec


def scale_eval(rec, data, work):
    t0 = time.perf_counter()
    rec["eval"] = benchmark.evaluate_scene(
        os.path.join(work, "scale_src", "sparse_gt"),
        os.path.join(data, "sparse"), device="cuda")
    rec["eval_s"] = time.perf_counter() - t0


def feat_cli(data_path):
    """``cli.feat`` on ``data_path``; returns its record (the database's
    counts on the rank that wrote it, else None)."""
    kept, generate = [], handler.generate_database

    def keep(*args, **kwargs):
        kept.append(generate(*args, **kwargs))
        return kept[-1]

    reset_peak()
    handler.generate_database = keep
    t0 = time.perf_counter()
    try:
        rc = cli_feat.main(["--data_path", data_path, "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        handler.generate_database = generate
    return dict(rc=rc, seconds=time.perf_counter() - t0,
                database=kept[0] if kept else None,
                peak_device_gb=peak_device_gb())


def feat_sfm_score(rec, data, gt):
    n_reg, n_pts, rot, ate = cs.model_errors(
        os.path.join(data, "sparse", "0"), gt)
    rec.update(model_registered=n_reg, model_points=n_pts,
               rot_err_deg_max=float(rot.max()), ate_rel_max=float(ate.max()))


def gs_cli(root, result_dir, distributed):
    """``cli.gs`` on ``root`` for the GS phase's 40 steps at batch 4 (its
    Runner settings and refine schedule applied where cli.gs builds the
    Runner); returns its record."""
    ref_cfg = cs.gs_main_cfg(root, result_dir)
    made, runner_cls = {}, cli_gs.Runner

    def runner(cfg, **kwargs):
        cfg = dataclasses.replace(
            cfg, **{k: getattr(ref_cfg, k) for k in GS_CLI_FIELDS})
        r = runner_cls(cfg, log=quiet, **kwargs)
        cs.gs_refine_schedule(r)
        train, evaluate = r.train, r.eval
        r.train = lambda: made.setdefault("losses", train())
        r.eval = lambda step: made.setdefault("stats", evaluate(step))
        made["runner"] = r
        return r

    argv = ["--data_path", root, "--result_dir", result_dir, "--max_steps",
            str(cs.GS_STEPS), "--batch_size", str(GS_BATCH), "--device",
            "cuda"] + (["--distributed"] if distributed else [])
    reset_peak()
    k23.composite_fwd.launches = k23.composite_bwd.launches = 0
    cli_gs.Runner = runner
    t0 = time.perf_counter()
    try:
        rc = cli_gs.main(argv)
        torch.cuda.synchronize()
    finally:
        cli_gs.Runner = runner_cls
    seconds = time.perf_counter() - t0
    r, losses, stats = made["runner"], made["losses"], made["stats"]
    step_ms = [s * 1e3 for s in r.step_s]
    return dict(rc=rc, seconds=seconds, world=r.world,
                views_per_rank=GS_BATCH // r.world,
                first_step_ms=step_ms[0],
                median_later_step_ms=float(np.median(step_ms[1:])),
                loss_first=losses[0], loss_last=losses[-1], losses=losses,
                psnr=stats["psnr"], ssim=stats["ssim"],
                refines=r.refines, alive_final=stats["num_GS"],
                k2_launches=k23.composite_fwd.launches,
                k3_launches=k23.composite_bwd.launches,
                peak_device_gb=peak_device_gb())


def gs_checks(rec, tag):
    losses, reset = rec["losses"], cs.GS_RESET_EVERY
    return {
        f"{tag}: cli.gs exits 0": rec["rc"] == 0,
        f"{tag}: losses finite": bool(np.all(np.isfinite(losses))),
        f"{tag}: loss falls before the reset":
            np.mean(losses[reset - 5:reset]) < np.mean(losses[:5]),
        f"{tag}: loss falls after the reset":
            np.mean(losses[-5:]) < np.mean(losses[reset + 1:reset + 6]),
        f"{tag}: three refines, alive count changed":
            len(rec["refines"]) == 3 and any(
                r["alive_after"] != r["alive_before"] for r in rec["refines"]),
        f"{tag}: K3 once per view per step, K2 at least":
            rec["k3_launches"] == cs.GS_STEPS * rec["views_per_rank"]
            <= rec["k2_launches"],
        f"{tag}: val PSNR finite": math.isfinite(rec["psnr"]),
    }


# ------------------------------------------------------------ one card

def one_card(job, work, images):
    """One path's reference on one card, in this process, with no process
    group."""
    if job == "scale":
        data = scene_copy(work, "scale", "scale1")
        rec = scale_result(data, load_gt(work, "scale"))
        scale_eval(rec, data, work)
        # getrusage's peak survives exec: it would be the starting rank's
        rec["peak_host_rss_gb"] = None
        return rec
    if job == "feat":
        data = scene_copy(work, "feat", "feat1")
        rec = feat_cli(data)
        rec["sfm"], _, _ = sfm_cli(data)
        rec["sfm"]["peak_host_rss_gb"] = None
        feat_sfm_score(rec["sfm"], data, load_gt(work, "feat"))
        rec["data"] = data
        return rec
    return gs_cli(os.path.join(work, "gs_src"), os.path.join(work, "gs1"),
                  distributed=False)


def start_reference(job, work, args, log_path):
    """``--one-card job`` in a fresh process on this rank's card, without
    torchrun's variables."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    local = torch.cuda.current_device()
    env["CUDA_VISIBLE_DEVICES"] = (visible.split(",")[local] if visible
                                   else str(local))
    out = os.path.join(work, f"ref_{job}.json")
    cmd = [sys.executable, os.path.abspath(sys.argv[0]), "--one-card", job,
           "--work", work, "--images", str(args.images), "--out", out]
    with open(log_path, "w") as log:
        p = subprocess.run(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                           timeout=REF_TIMEOUT_S)
    if p.returncode != 0:
        with open(log_path) as f:
            raise RuntimeError(f"one-card {job} exited {p.returncode}:\n"
                               + f.read()[-4000:])
    with open(out) as f:
        return json.load(f)


# ------------------------------------------------------------ the group

def host_gather(obj):
    out = [None] * multihost.process_count()
    dist.all_gather_object(out, obj, group=multihost.host_group())
    return out


def worker(args):
    t0 = time.perf_counter()
    if not multihost.initialize(device="cuda"):
        raise SystemExit("multicard_torch: start it with torchrun, two or "
                         "more processes")
    rank, world = multihost.process_index(), multihost.process_count()
    idx = torch.cuda.current_device()
    rec = dict(rank=rank, world=world,
               local_rank=os.environ.get("LOCAL_RANK"),
               init_s=time.perf_counter() - t0, device=f"cuda:{idx}",
               name=torch.cuda.get_device_name(idx))
    t0 = time.perf_counter()
    build.load("schur_wchain")
    build.load("composite_tiles")
    rec["build_s"] = time.perf_counter() - t0
    rec["built"] = {n: dict(seconds=i["seconds"])
                    for n, i in build.BUILD_INFO.items()}
    work = host_gather(tempfile.mkdtemp(prefix="multicard_")
                       if rank == 0 else None)[0]
    prep = {job: prepare(job, work, args.images)
            for j, job in enumerate(JOBS) if j % world == rank}
    prep = {k: v for p in host_gather(prep) for k, v in p.items()}
    device = torch.device("cuda", idx)
    cs.first_jacfwd(device)

    # FEAT: cli.feat, then cli.sfm on its database
    data = os.path.join(work, "feat4")
    if rank == 0:
        scene_copy(work, "feat", "feat4")
    multihost.barrier()
    rec["feat"] = feat_cli(data)
    multihost.barrier()
    rec["feat"]["sfm"], _, _ = sfm_cli(data)
    multihost.barrier()
    if rank == 0:
        feat_sfm_score(rec["feat"]["sfm"], data, load_gt(work, "feat"))

    # GS: one step against one card, then cli.gs --distributed
    root = os.path.join(work, "gs_src")
    rec["gs_step"], rec["gs_step_checks"] = cs.dist_gs(
        device, root, os.path.join(work, f"gs_one{rank}"),
        GS_BATCH, rank, world)
    multihost.barrier()
    rec["gs"] = gs_cli(root, os.path.join(work, "gs4"), distributed=True)

    # SCALE: cli.sfm on the ring database
    data = os.path.join(work, "scale4")
    if rank == 0:
        scene_copy(work, "scale", "scale4")
    multihost.barrier()
    rec["scale"] = scale_result(data, load_gt(work, "scale"))
    if rank == 0:
        scale_eval(rec["scale"], data, work)
    multihost.barrier()
    rec["peak_host_rss_gb"] = bench.peak_host_rss_gb()
    ranks = host_gather(rec)
    out = os.path.join(cs.OUT_DIR, f"multicard_{args.images}")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    print("RANK " + json.dumps(rec), flush=True)

    # the one-card references, one a card, at once
    torch.cuda.empty_cache()
    refs = {job: start_reference(job, work, args,
                                 os.path.join(out, f"ref_{job}.log"))
            for j, job in enumerate(JOBS) if j % world == rank}
    refs = {k: v for r in host_gather(refs) for k, v in r.items()}
    multihost.shutdown()
    if rank != 0:
        return 0
    summary = compare(ranks, refs, prep, work, args)
    shutil.rmtree(work, ignore_errors=True)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f)
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


def compare(ranks, refs, prep, work, args):
    """Every check of the run: the multi-card results (``ranks``) against
    the bars and against the one-card references (``refs``)."""
    n = SCALES[args.images]["num_cams"]
    s4, s1 = ranks[0]["scale"], refs["scale"]
    checks = {"every rank on a card of its own":
              len({r["device"] for r in ranks}) == len(ranks)}
    for tag, s in (("four cards", s4), ("one card", s1)):
        checks.update({
            f"SCALE {tag}: cli.sfm exits 0": s["rc"] == 0,
            f"SCALE {tag}: {n}/{n} registered": s["registered"] == n,
            f"SCALE {tag}: mean rotation error <= {cs.SCALE_ROT_MEAN_DEG}":
                s["rot_err_deg_mean"] <= cs.SCALE_ROT_MEAN_DEG,
            f"SCALE {tag}: max rotation error <= {cs.SCALE_ROT_MAX_DEG}":
                s["rot_err_deg_max"] <= cs.SCALE_ROT_MAX_DEG,
            f"SCALE {tag}: max ATE < 1% of the extent":
                s["ate_rel_max"] < cs.SCALE_ATE_MAX,
            f"SCALE {tag}: evaluate_scene registers every image":
                s["eval"]["num_registered"] == n})
    checks[f"SCALE: four cards' mean rotation error within "
           f"{cs.DIST_BA_ROT_RATIO}x one card's"] = \
        s4["rot_err_deg_mean"] <= cs.DIST_BA_ROT_RATIO * s1["rot_err_deg_mean"]
    for r in ranks + [dict(rank="one card", scale=s1)]:
        launches, held = r["scale"]["k1_launches"], r["scale"]["k1"]
        for stage in ("global_positioning", "bundle_adjustment"):
            checks[f"SCALE rank {r['rank']}: K1 launched in {stage}"] = any(
                k.startswith(stage + "/") and v > 0
                for k, v in launches.items())
            checks[f"SCALE rank {r['rank']}: K1 held against its plain "
                   f"version on its first {stage} input"] = stage in held
        if args.images == 2000:
            checks[f"SCALE rank {r['rank']}: BA's first K1 input takes the "
                   "global-atomic branch"] = \
                held.get("bundle_adjustment", {}).get("branch") == "global"

    f4, f1 = ranks[0]["feat"], refs["feat"]
    db = cs.db_differences(os.path.join(f1["data"], "database.db"),
                           os.path.join(work, "feat4", "database.db"))
    f4["database_vs_one_card"] = db
    checks.update({
        "FEAT: cli.feat exits 0 on every rank and on one card":
            all(r["feat"]["rc"] == 0 for r in ranks) and f1["rc"] == 0,
        "FEAT: rank 0 alone wrote the database":
            all((r["feat"]["database"] is None) == (r["rank"] != 0)
                for r in ranks),
        "FEAT: one card's images and keypoint count per image":
            db["same_images"] and db["same_keypoint_counts"],
        "FEAT: one card's matched and verified pairs":
            db["same_matched_pairs"] and db["same_verified_pairs"],
        f"FEAT: at most {cs.DIST_MATCH_SHARE:.1%} of one card's matches "
        "differ": db["matches_differing"] <= cs.DIST_MATCH_SHARE * db["matches"],
        "FEAT: cli.sfm exits 0 on every rank":
            all(r["feat"]["sfm"]["rc"] == 0 for r in ranks),
        "FEAT: cli.sfm registers as many views on four cards as on one":
            f4["sfm"]["model_registered"] == f1["sfm"]["model_registered"],
        "FEAT: K1 launched on every rank in cli.sfm":
            all(r["feat"]["sfm"]["k1_launches_total"] > 0 for r in ranks)})

    g1 = refs["gs"]
    for r in ranks:
        checks.update({f"GS rank {r['rank']}: {k}": ok
                       for k, ok in r["gs_step_checks"].items()})
        checks.update(gs_checks(r["gs"], f"GS rank {r['rank']}"))
    checks.update(gs_checks(g1, "GS one card"))
    checks[f"GS: val PSNR within {GS_PSNR_DB} dB of one card's"] = \
        abs(ranks[0]["gs"]["psnr"] - g1["psnr"]) <= GS_PSNR_DB
    failed = [k for k, ok in checks.items() if not ok]
    return {"multicard": dict(
        world=len(ranks), cards=bench.card_line(), images=args.images,
        inputs=prep,
        ranks=[{k: r.get(k) for k in ("rank", "device", "name", "init_s",
                                      "build_s", "built",
                                      "peak_host_rss_gb")}
               for r in ranks],
        scale=dict(four=s4, one=s1,
                   four_by_rank=[{k: r["scale"][k] for k in (
                       "stage_s", "k1_launches", "k1", "peak_device_gb",
                       "peak_host_rss_gb", "rot_err_deg_mean")}
                       for r in ranks]),
        feat=dict(four=f4, one=f1,
                  four_sfm_k1=[r["feat"]["sfm"]["k1_launches_total"]
                               for r in ranks]),
        gs=dict(four=ranks[0]["gs"], one=g1,
                step=[r["gs_step"] for r in ranks],
                four_k2_k3=[(r["gs"]["k2_launches"], r["gs"]["k3_launches"])
                            for r in ranks]),
        failed=failed), "ok": not failed}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=2000, choices=sorted(SCALES))
    # a one-card reference's process: its path, the group's work directory
    # and where it writes its record
    ap.add_argument("--one-card", choices=JOBS, help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("multicard_torch: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.one_card:
        cs.first_jacfwd(torch.device("cuda"))
        rec = one_card(args.one_card, args.work, args.images)
        with open(args.out, "w") as f:
            json.dump(rec, f)
        return 0
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
