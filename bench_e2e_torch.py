"""End-to-end SfM benchmark of the port: images a second through the mapper.

The PyTorch/CUDA counterpart of ``bench_e2e.py``.  ``write_ring_db`` writes
``bench_e2e.py::build_scene_db``'s seeded COLMAP database (a ring of
SIMPLE_RADIAL cameras around a point volume, each image matched with the
next ``window``; keypoints within 1e-9 px, every other table equal) into
a temporary directory (setup, timed apart).  Each pass runs the production
path on the card in float32: ``read_colmap_database -> solve_global_mapper -> write_reconstruction``,
one cold pass, then the warm ones.  A pass records seconds per stage, the
host reads of the blocked loops (``ra_syncs`` of rotation averaging,
``vgc_syncs`` of view-graph calibration), the LM and PCG iterations and K1
launches of global positioning and bundle adjustment, peak device memory
(``torch.cuda.max_memory_allocated``) and peak host RSS; the last pass is
scored against the ground truth (registered images, rotation error
mean/max in degrees, ATE mean/max as a share of the extent).

Knobs (``bench_e2e.py``'s): ``BENCH_E2E_CAMS`` (200), ``BENCH_E2E_PTS``
(20000), ``BENCH_E2E_VIS_ANGLE`` (0.9), ``BENCH_E2E_WINDOW`` (12),
``BENCH_E2E_SCALE`` (1), ``BENCH_E2E_MAX_MATCHES`` (0: no cap),
``BENCH_E2E_REPEATS`` (1 warm pass), ``BENCH_E2E_WARM_ONLY`` (one pass
only), ``BENCH_E2E_OUT`` (also write the record there).  The 500- and
2,000-image configurations are ``CAMS=500 PTS=1000000 VIS_ANGLE=0.05`` and
``CAMS=2000 PTS=300000 VIS_ANGLE=0.06 WINDOW=10 SCALE=4.0
MAX_MATCHES=2000``.

    python3 bench_e2e_torch.py

Prints per-stage seconds on stderr and ONE JSON line last,
``images_per_sec_e2e`` of the best warm pass.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from instantsfm_tpu_torch.config import Config
from instantsfm_tpu_torch.eval import align
from instantsfm_tpu_torch.io.colmap_db import (ColmapDatabase,
                                               read_colmap_database)
from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper
from instantsfm_tpu_torch.pipeline.writer import write_reconstruction
from instantsfm_tpu_torch.scene import cameras as cm
from instantsfm_tpu_torch.scene.types import CONFIG_CALIBRATED
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.utils import bench, debug
from instantsfm_tpu_torch.utils.device import full_f32

RING_CAMERA = (cm.SIMPLE_RADIAL, 640, 480, (520.0, 320.0, 240.0, 0.01))


def ring_rotation(center):
    """World->camera rotation of a camera at ``center`` looking at the
    origin (rows x, y, z)."""
    z = -center / np.linalg.norm(center)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], 0)


def ring_image_name(i):
    return f"img{i:04d}.jpg"


def write_ring_db(dbpath, num_cams=200, num_pts=20_000, window=12, seed=0,
                  match_noise=0.4, outlier_frac=0.08, vis_angle=0.9,
                  scene_scale=1.0, max_matches_per_pair=0):
    """A seeded COLMAP database at the ETH3D-indoor scale (the scene of
    ``bench_e2e.py::build_scene_db``, in numpy, with its draws in its
    order, so a seed writes that function's database): ``num_cams``
    SIMPLE_RADIAL cameras (f 520, k1 0.01, 640x480) on a ring of radius
    8 * ``scene_scale`` looking at a cube of ``num_pts`` points within
    +-3 * ``scene_scale``, each camera seeing the points within
    ``vis_angle`` radians of its own bearing; keypoints are the projections
    plus ``match_noise`` px of noise; each camera is matched with the next
    ``window`` on the ring (pairs with < 30 shared points are skipped), at
    most ``max_matches_per_pair`` of a pair's shared points drawn when
    nonzero, with ``outlier_frac`` of every pair's matches redirected to
    random keypoints, all pairs CALIBRATED.  Returns the ground truth
    (world->cam xyzw qvec, tvec, centers) and the pair and match counts."""
    rng = np.random.default_rng(seed)
    model_id, width, height, (f_px, cx, cy, k1_) = RING_CAMERA
    angles = np.linspace(0, 2 * np.pi, num_cams, endpoint=False)
    radius = 8.0 * scene_scale
    centers = np.stack([radius * np.cos(angles), radius * np.sin(angles),
                        1.0 + 0.3 * rng.standard_normal(num_cams)], -1)
    points = rng.uniform(-3.0 * scene_scale, 3.0 * scene_scale, (num_pts, 3))
    pt_angle = np.arctan2(points[:, 1], points[:, 0])
    Rs = np.stack([ring_rotation(c) for c in centers])
    qvec = lie.matrix_to_quat(torch.as_tensor(Rs)).numpy()
    tvec = -np.einsum("cij,cj->ci", Rs, centers)

    kp, idx_of = [], []
    for i in range(num_cams):
        # the points near the camera's bearing by a cheap wrapped angle
        # (within 1e-15 rad of the exact test's), then the exact tests on
        # those alone: the same points at a fraction of the cost
        near = np.abs((pt_angle - angles[i] + np.pi) % (2 * np.pi) - np.pi)
        cand = np.nonzero(near < vis_angle + 1e-9)[0]
        xyz = points[cand] @ Rs[i].T + tvec[i]
        uv = xyz[:, :2] / (xyz[:, 2:3] + 1e-12)
        xy = uv * (1.0 + k1_ * np.sum(uv * uv, 1, keepdims=True)) * f_px \
            + np.array([cx, cy])
        dang = np.abs(np.angle(np.exp(1j * (pt_angle[cand] - angles[i]))))
        vis = ((xyz[:, 2] > 0.5) & (dang < vis_angle)
               & (xy[:, 0] > 0) & (xy[:, 0] < width)
               & (xy[:, 1] > 0) & (xy[:, 1] < height))
        idx = cand[vis]
        xy = xy[vis]
        kp.append(xy + match_noise * rng.standard_normal((len(idx), 2)))
        idx_of.append(idx.astype(np.int32))

    n_pairs = n_matches = 0
    with ColmapDatabase.connect(dbpath) as db:
        db.create_tables()
        cam_id = db.add_camera(model_id, width, height,
                               [f_px, cx, cy, k1_], prior_focal=True)
        img_ids = [db.add_image(ring_image_name(i), cam_id)
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
                if max_matches_per_pair and len(fi) > max_matches_per_pair:
                    keep = rng.choice(len(fi), max_matches_per_pair,
                                      replace=False)
                    fi, fj = fi[keep], fj[keep]
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


def accuracy_vs_gt(images, gt):
    """``bench_e2e.py::accuracy_vs_gt`` through the port's ``eval.align``:
    registered images, rotation error mean/max in degrees, and ATE mean/max
    as a share of the ground-truth extent after similarity alignment."""
    reg = np.nonzero(images.registered)[0]
    R_est = lie.quat_to_matrix(torch.as_tensor(images.qvec[reg],
                                               dtype=torch.float64)).numpy()
    R_gt = lie.quat_to_matrix(torch.as_tensor(gt["q"][reg])).numpy()
    rot = align.rotation_angles_deg(R_est, R_gt)
    c_gt = gt["centers"][reg]
    ate = align.absolute_translation_errors(images.centers()[reg], c_gt)
    extent = float(np.linalg.norm(c_gt.max(0) - c_gt.min(0)))
    return dict(registered=int(len(reg)), rot_err_deg_mean=float(rot.mean()),
                rot_err_deg_max=float(rot.max()),
                ate_rel_mean=float(ate.mean()) / extent,
                ate_rel_max=float(ate.max()) / extent)


def _split(marks, name, prev, values):
    """``values`` appended between the hooks of stage ``prev`` and ``name``."""
    lo = marks.get(prev, (0, 0))[1] if prev else 0
    hi = marks.get(name, (0, len(values)))[1]
    return values[lo:hi]


def run_pipeline(dbpath, out_dir, device, stage_hook=None, log=None):
    """One timed database -> sparse-model pass on ``device`` (float32);
    ``stage_hook(name, cameras, images, tracks)`` is passed on to the mapper.
    Returns (record, cameras, images, tracks); the model is written to
    ``out_dir``/0."""
    marks = {}

    def hook(name, cameras, images, tracks):
        marks[name] = (k1.schur_wchain.launches,
                       len(debug.STATS.get("pcg_iters", ())))
        if stage_hook is not None:
            stage_hook(name, cameras, images, tracks)

    cuda = torch.device(device).type == "cuda"
    debug.drain_stats()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    k1.schur_wchain.launches = k1.schur_wchain.plain_calls = 0
    t_start = time.perf_counter()
    view_graph, cameras, images, feature_name = read_colmap_database(dbpath)
    db_read_s = time.perf_counter() - t_start
    cameras, images, tracks, timings = solve_global_mapper(
        view_graph, cameras, images, Config(feature_name),
        dtype=torch.float32, log=log or (lambda *a: None), stage_hook=hook,
        device=device)
    t0 = time.perf_counter()
    write_reconstruction(out_dir, cameras, images, tracks)
    write_s = time.perf_counter() - t0
    total_s = time.perf_counter() - t_start
    stats = debug.drain_stats()
    pcg = stats.get("pcg_iters", [])
    gp, ba = "global_positioning", "bundle_adjustment"
    k1_gp = marks.get(gp, (0,))[0]
    ra_syncs = stats.get("ra_syncs", [])
    num_images = len(images.registered)
    rec = dict(
        images=num_images, images_per_sec=num_images / total_s,
        total_s=total_s, db_read_s=db_read_s, stage_s=timings,
        write_s=write_s, registered=int(images.registered.sum()),
        tracks=int(tracks.num_tracks),
        observations=int(tracks.num_observations),
        ra_syncs=ra_syncs,
        ra_syncs_total=sum(sum(d.values()) for d in ra_syncs),
        vgc_syncs=stats.get("vgc_syncs"),
        gp_lm_iters=stats.get("gp_lm_iters"),
        ba_lm_iters=stats.get("ba_lm_iters"),
        pcg_iters_gp=sum(_split(marks, gp, None, pcg)),
        pcg_iters_ba=sum(_split(marks, ba, gp, pcg)),
        pcg_iters_total=sum(pcg),
        k1_launches_gp=k1_gp,
        k1_launches_ba=marks.get(ba, (k1_gp,))[0] - k1_gp,
        k1_launches_total=k1.schur_wchain.launches,
        k1_plain_calls=k1.schur_wchain.plain_calls,
        peak_device_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                        if cuda else None),
        peak_host_rss_gb=bench.peak_host_rss_gb())
    return rec, cameras, images, tracks


def _stage_lines(rec):
    lines = [f"[stage] db_read               {rec['db_read_s']:7.2f}s"]
    lines += [f"[stage] {name:<22}{s:7.2f}s"
              for name, s in rec["stage_s"].items()]
    lines += [f"[stage] write                 {rec['write_s']:7.2f}s",
              f"[stage] TOTAL                 {rec['total_s']:7.2f}s  "
              f"({rec['registered']}/{rec['images']} registered, "
              f"{rec['tracks']} tracks)"]
    return "\n".join(lines)


def scene_from_env():
    """The scene's knobs, ``bench_e2e.py``'s environment variables."""
    env = os.environ.get
    return dict(num_cams=int(env("BENCH_E2E_CAMS", "200")),
                num_pts=int(env("BENCH_E2E_PTS", "20000")),
                vis_angle=float(env("BENCH_E2E_VIS_ANGLE", "0.9")),
                window=int(env("BENCH_E2E_WINDOW", "12")),
                scene_scale=float(env("BENCH_E2E_SCALE", "1")),
                max_matches_per_pair=int(env("BENCH_E2E_MAX_MATCHES", "0")))


def measure(scene, repeats, warm_only, device, root):
    """Setup, then the cold and warm passes in ``root``; the JSON record."""
    dbpath = os.path.join(root, "database.db")
    t0 = time.perf_counter()
    gt, n_pairs, n_matches = write_ring_db(dbpath, **scene)
    setup_s = time.perf_counter() - t0
    print(f"[setup] db written in {setup_s:.1f}s ({n_pairs} pairs, "
          f"{n_matches} matches)", file=sys.stderr, flush=True)
    out_dir = os.path.join(root, "sparse")
    passes = []
    for _ in range(1 if warm_only else 1 + repeats):
        rec, _, images, _ = run_pipeline(dbpath, out_dir, device)
        print(_stage_lines(rec), file=sys.stderr, flush=True)
        passes.append(rec)
    cold, warm_passes = passes[0], passes[0 if warm_only else 1:]
    warm = min(warm_passes, key=lambda r: r["total_s"])
    return {
        "metric": "images_per_sec_e2e",
        "value": warm["images_per_sec"],
        "unit": f"img/s warm-best-of-{len(warm_passes)} ({scene['num_cams']} "
                "images, ring pairs, db->sparse, float32 on the card)",
        "scene": scene, "pairs": n_pairs, "matches": n_matches,
        "setup_s": setup_s, "cold": cold, "warm": warm,
        "warm_spread_s": [r["total_s"] for r in warm_passes],
        "warm_stage_spread": {k: [r["stage_s"][k] for r in warm_passes]
                              for k in warm["stage_s"]},
        "accuracy_f32_vs_gt": accuracy_vs_gt(images, gt),
        "device": bench.device_record(),
    }


def main():
    device = bench.require_card()
    repeats = int(os.environ.get("BENCH_E2E_REPEATS", "1"))
    warm_only = bool(os.environ.get("BENCH_E2E_WARM_ONLY"))
    with full_f32(), tempfile.TemporaryDirectory(prefix="bench_e2e_") as root:
        rec = measure(scene_from_env(), repeats, warm_only, device, root)
    if os.environ.get("BENCH_E2E_OUT"):
        with open(os.environ["BENCH_E2E_OUT"], "w") as f:
            json.dump(rec, f, indent=1)
    print(f"card: {rec['device']['nvidia_smi']}", file=sys.stderr)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
