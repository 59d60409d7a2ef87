"""Per-stage accuracy of the port's mapper against the ground truth.

The counterpart of ``tools/probe_accuracy.py``: ``bench_e2e_torch.py``'s
scene (its ``BENCH_E2E_*`` knobs; 500 images by default, as the JAX probe)
through ``bench_e2e_torch.run_pipeline`` on the card in float32, with a
stage hook that scores the registered poses after relative pose, rotation
averaging, global positioning and bundle adjustment: rotation error
mean/max in degrees (``eval.align``, after the global rotation), and after
GP and BA the ATE as a share of the extent.  It attributes the rotation error's
growth with the number of images to a stage.

Knobs: ``PROBE_GT_ROT=1`` puts the ground-truth rotations (in the
estimate's gauge) in place after rotation averaging, which isolates GP's
and BA's error from rotation averaging's; ``PROBE_OUT=path.npz`` saves
each stage's per-image rotation errors.

    python3 tools/probe_accuracy_torch.py

Prints one line a stage and ONE JSON line last.  Needs a CUDA card.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

import bench_e2e_torch
from instantsfm_tpu_torch.eval import align
from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.utils import bench
from instantsfm_tpu_torch.utils.device import full_f32


def rotations(q):
    return lie.quat_to_matrix(torch.as_tensor(q, dtype=torch.float64)).numpy()


def best_gauge(R_est, R_gt):
    """The global rotation G with R_gt G ~ R_est (chordal mean)."""
    U, _, Vt = np.linalg.svd(np.einsum("nji,njk->ik", R_gt, R_est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    return U @ S @ Vt


def stage_hook(gt, results, fields, gt_rot=False):
    """The mapper's stage hook: appends one record a scored stage."""
    def measure(name, cameras, images, tracks):
        if name not in ("relpose", "rotation_averaging", "global_positioning",
                        "bundle_adjustment"):
            return
        t0 = time.perf_counter()
        reg = np.nonzero(images.registered)[0]
        R_est, R_gt = rotations(images.qvec[reg]), rotations(gt["q"][reg])
        rot = align.rotation_angles_deg(R_est, R_gt)
        rec = dict(stage=name, registered=int(len(reg)),
                   rot_mean=float(rot.mean()), rot_max=float(rot.max()))
        if name in ("global_positioning", "bundle_adjustment"):
            c_gt = gt["centers"][reg]
            ate = align.absolute_translation_errors(images.centers()[reg],
                                                    c_gt)
            ext = float(np.linalg.norm(c_gt.max(0) - c_gt.min(0)))
            rec.update(ate_rel_mean=float(ate.mean()) / ext,
                       ate_rel_max=float(ate.max()) / ext)
        fields[name] = rot
        results.append(rec)
        print(f"[acc] {json.dumps(rec)}  ({time.perf_counter() - t0:.1f}s)",
              file=sys.stderr, flush=True)
        if name == "rotation_averaging" and gt_rot:
            R = rotations(gt["q"]) @ best_gauge(R_est, R_gt)
            images.qvec[:] = lie.matrix_to_quat(torch.as_tensor(R)).numpy()
            print("[acc] ground-truth rotations put in after rotation "
                  "averaging", file=sys.stderr)
    return measure


def probe(scene, device, root, gt_rot=False):
    """Writes the scene's database in ``root`` and runs the mapper with the
    accuracy hook; returns (record, per-stage rotation errors)."""
    dbpath = os.path.join(root, "database.db")
    gt, n_pairs, n_matches = bench_e2e_torch.write_ring_db(dbpath, **scene)
    results, fields = [], {}
    hook = stage_hook(gt, results, fields, gt_rot)
    pipe, _, _, _ = bench_e2e_torch.run_pipeline(
        dbpath, os.path.join(root, "sparse"), device, stage_hook=hook)
    return dict(metric="probe_accuracy", scene=scene, pairs=n_pairs,
                matches=n_matches, gt_rot_injected=gt_rot,
                total_s=pipe["total_s"], stage_s=pipe["stage_s"],
                ra_syncs=pipe["ra_syncs"],
                k1_launches_gp=pipe["k1_launches_gp"],
                k1_launches_ba=pipe["k1_launches_ba"],
                stage_accuracy=results), fields


def main():
    device = bench.require_card()
    scene = bench_e2e_torch.scene_from_env()
    scene["num_cams"] = int(os.environ.get("BENCH_E2E_CAMS", "500"))
    with full_f32(), tempfile.TemporaryDirectory(prefix="probe_acc_") as root:
        rec, fields = probe(scene, device, root,
                            bool(os.environ.get("PROBE_GT_ROT")))
    if os.environ.get("PROBE_OUT"):
        np.savez(os.environ["PROBE_OUT"], **fields)
    rec["device"] = bench.device_record()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
