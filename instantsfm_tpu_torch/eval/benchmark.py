"""COLMAP-ecosystem benchmark harness (reference ``eval/colmap_eval/``).

Counterpart of ``instantsfm_tpu/eval/benchmark.py``: the relative poses and
camera centres are computed in torch on ``device`` (the card unless the
caller passes ``device="cpu"``, or ``--device cpu``), the rest in numpy.

Evaluates one or more reconstruction methods against ground-truth sparse
models with the reference's metrics:

* relative pose errors: max(rotation, translation-direction angle) over GT
  image pairs, 180° penalty for unregistered images
  (``evaluation/utils.py:597-680``);
* absolute errors: camera-center distance after similarity alignment (the
  native umeyama alignment substitutes for the ``colmap model_aligner``
  subprocess, ``utils.py:350-380``);
* recall -> AUC at the reference thresholds (rel {1,3,5,10}°,
  abs {0.02,0.05,0.2,0.5} m; ``utils.py:177-191,719-750``);
* side-by-side method folders ``sparse`` / ``sparse_colmap`` /
  ``sparse_glomap`` (``evaluate.py:55-59``), ASCII + CSV reports and a report
  diff tool.

Dataset registries (ETH3D / Tanks&Temples / DTU / BlendedMVS / IMC) carry the
scene lists and GT accuracies; downloading is separate (``download.py``), as
in the reference.
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Optional

import numpy as np
import torch

from instantsfm_tpu_torch.eval.align import (absolute_translation_errors, auc,
                                             relative_pose_errors_deg)
from instantsfm_tpu_torch.eval.datasets import LAYOUTS
from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.utils.device import resolve_device

REL_THRESHOLDS_DEG = (1.0, 3.0, 5.0, 10.0)
ABS_THRESHOLDS_M = (0.02, 0.05, 0.2, 0.5)

METHOD_FOLDERS = {"colmap": "sparse_colmap", "glomap": "sparse_glomap",
                  "instantsfm": "sparse"}


def _load_poses(sparse_dir: str):
    """-> dict name -> (qvec_xyzw, tvec) world->cam.

    A method folder may contain several numbered component sub-models
    (``sparse/0``, ``sparse/1``, ...): they are merged with first-occurrence-
    wins, matching the reference's merged-reconstruction scoring
    (``evaluation/utils.py:410-452``)."""
    roots = [sparse_dir]
    subs = sorted(d for d in (os.listdir(sparse_dir)
                              if os.path.isdir(sparse_dir) else [])
                  if os.path.isdir(os.path.join(sparse_dir, d)))
    if subs and not (os.path.exists(os.path.join(sparse_dir, "images.bin"))
                     or os.path.exists(os.path.join(sparse_dir,
                                                    "images.txt"))):
        roots = [os.path.join(sparse_dir, d) for d in subs]
    out = {}
    for root in roots:
        _, images, _ = cmio.read_model(root)
        for im in images.values():
            name = im.name.split("/")[-1]
            if name in out:
                continue
            w, x, y, z = im.qvec_wxyz
            out[name] = (np.array([x, y, z, w]), np.asarray(im.tvec))
    return out


def evaluate_scene(gt_sparse: str, est_sparse: str,
                   max_pairs: int = 500000,
                   gt_accuracy_m: float = 0.0, device="cuda") -> dict:
    """Pose AUC for one (GT model, estimated model) pair, with the
    reference's GT-accuracy handling: near-coincident GT centers score
    rotation-only relative error, and the recall curve is clamped below the
    GT's own accuracy (``evaluation/utils.py:457,522,538``)."""
    gt = _load_poses(gt_sparse)
    est = _load_poses(est_sparse)
    names = sorted(gt.keys())
    n = len(names)
    q_gt = np.stack([gt[k][0] for k in names])
    t_gt = np.stack([gt[k][1] for k in names])
    registered = np.array([k in est for k in names])
    q_est = np.stack([est[k][0] if k in est else np.array([0., 0, 0, 1])
                      for k in names])
    t_est = np.stack([est[k][1] if k in est else np.zeros(3) for k in names])

    dev = resolve_device(device)
    rel_err = relative_pose_errors_deg(q_est, t_est, q_gt, t_gt, registered,
                                       max_pairs=max_pairs,
                                       min_proj_center_dist=gt_accuracy_m,
                                       device=dev)
    rel_auc = auc(rel_err, REL_THRESHOLDS_DEG, min_error=gt_accuracy_m)

    # absolute errors on registered subset after similarity alignment
    on = lambda a: torch.as_tensor(a, device=dev)
    C_gt = lie.camera_center(on(q_gt), on(t_gt)).cpu().numpy()
    C_est = lie.camera_center(on(q_est), on(t_est)).cpu().numpy()
    if registered.sum() >= 3:
        ate = absolute_translation_errors(C_est[registered], C_gt[registered])
        abs_err = np.full(n, np.inf)
        abs_err[registered] = ate
    else:
        abs_err = np.full(n, np.inf)
    abs_auc = auc(abs_err, ABS_THRESHOLDS_M, min_error=gt_accuracy_m)

    return {
        "num_images": n,
        "num_registered": int(registered.sum()),
        # fractions in [0, 1]; multiply by align.REFERENCE_AUC_SCALE to
        # compare with reference-reported tables (its x100/1.1 display scale)
        "rel_auc": dict(zip([f"{t:g}deg" for t in REL_THRESHOLDS_DEG],
                            rel_auc)),
        "abs_auc": dict(zip([f"{t:g}m" for t in ABS_THRESHOLDS_M], abs_auc)),
        "median_rel_err_deg": float(np.median(rel_err)),
        "median_ate": float(np.median(abs_err[np.isfinite(abs_err)]))
        if np.isfinite(abs_err).any() else float("inf"),
    }


def process_scene(scene_dir: str, gt_subdir: str = "sparse_gt",
                  methods: Optional[List[str]] = None,
                  gt_accuracy_m: float = 0.0, device="cuda") -> dict:
    """Evaluate all present method folders of one scene against its GT."""
    methods = methods or list(METHOD_FOLDERS)
    gt_sparse = os.path.join(scene_dir, gt_subdir) \
        if not os.path.isabs(gt_subdir) else gt_subdir
    if os.path.exists(os.path.join(gt_sparse, "0")):
        gt_sparse = os.path.join(gt_sparse, "0")
    results = {}
    for m in methods:
        folder = os.path.join(scene_dir, METHOD_FOLDERS[m])
        if not os.path.exists(folder):
            continue
        results[m] = evaluate_scene(gt_sparse, folder,
                                    gt_accuracy_m=gt_accuracy_m,
                                    device=device)
    return results


def evaluate_dataset(root: str, dataset: str = "eth3d",
                     methods: Optional[List[str]] = None,
                     categories: Optional[List[str]] = None,
                     scenes: Optional[List[str]] = None, log=print,
                     device="cuda") -> dict:
    """Walk a real benchmark dataset directory (``root`` contains
    ``<dataset>/<category>/<scene>/...``, the layout the reference's
    downloader produces — see eval/datasets.py), building GT models from
    native formats where needed, and score every method folder."""
    layout = LAYOUTS[dataset]
    infos = layout.list_scenes(root, categories=categories, scenes=scenes)
    all_results = {}
    for info in infos:
        key = f"{info.category}/{info.scene}"
        try:
            layout.prepare_scene(info)
            all_results[key] = process_scene(
                info.scene_path, gt_subdir=info.sparse_gt_path,
                methods=methods, gt_accuracy_m=layout.position_accuracy_gt,
                device=device)
            log(f"{key}: {json.dumps(all_results[key])}")
        except FileNotFoundError as e:
            log(f"{key}: skipped ({e})")
    return all_results


def write_report(results: dict, out_csv: str, log=print) -> None:
    """Per-scene CSV + aggregate ASCII table (reference
    ``evaluation/utils.py:808-939``)."""
    rows = []
    for scene, methods in results.items():
        for m, r in methods.items():
            row = {"scene": scene, "method": m,
                   "registered": f"{r['num_registered']}/{r['num_images']}"}
            row.update({f"rel_auc@{k}": f"{v:.4f}"
                        for k, v in r["rel_auc"].items()})
            row.update({f"abs_auc@{k}": f"{v:.4f}"
                        for k, v in r["abs_auc"].items()})
            rows.append(row)
    if not rows:
        log("no results to report")
        return
    keys = list(rows[0].keys())
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, keys)
        w.writeheader()
        w.writerows(rows)
    # aggregate table
    methods = sorted({r["method"] for r in rows})
    log(f"{'method':12s} " + " ".join(f"{k:>14s}" for k in keys[3:]))
    for m in methods:
        sel = [r for r in rows if r["method"] == m]
        means = [np.mean([float(r[k]) for r in sel]) for k in keys[3:]]
        log(f"{m:12s} " + " ".join(f"{v:14.4f}" for v in means))


def compare_reports(csv_a: str, csv_b: str, log=print) -> dict:
    """Diff two report CSVs (reference ``compare.py``)."""
    def load(path):
        with open(path) as f:
            return {(r["scene"], r["method"]): r
                    for r in csv.DictReader(f)}

    a, b = load(csv_a), load(csv_b)
    diffs = {}
    for key in sorted(set(a) & set(b)):
        d = {}
        for col in a[key]:
            if col.startswith(("rel_auc", "abs_auc")):
                d[col] = float(b[key][col]) - float(a[key][col])
        diffs[key] = d
        log(f"{key}: " + " ".join(f"{k}:{v:+.4f}" for k, v in d.items()))
    return diffs


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True,
                        help="data dir containing <dataset>/<category>/<scene>")
    parser.add_argument("--dataset", default="eth3d", choices=list(LAYOUTS))
    parser.add_argument("--methods", nargs="*", default=None)
    parser.add_argument("--categories", nargs="*", default=None)
    parser.add_argument("--scenes", nargs="*", default=None)
    parser.add_argument("--out", default="report.csv")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    results = evaluate_dataset(args.root, args.dataset, args.methods,
                               categories=args.categories, scenes=args.scenes,
                               device=args.device)
    write_report(results, args.out)
    return 0


if __name__ == "__main__":
    main()
