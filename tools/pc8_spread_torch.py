"""Run-to-run spread of float64 bundle adjustment past PC = 8.

The scene of ``tests/test_torch_cuda.py::
test_bundle_adjustment_past_pc8_card_matches_cpu``: ``chip_smoke.make_scene``
at 20 cameras and 9,000 points with OPENCV cameras (camera block PC = 12, so
the PCG matvec runs K1's plain version), three rounds of
``pipeline.ba.bundle_adjustment_rounds`` of at most 10 LM iterations, float64.
One CPU run on the scene as drawn is the reference.  The card then runs the
same scene ``card_runs`` times, and the CPU and the card each run it once
more for each of ``seeds`` permutations of the observations (the tracks'
order and each track's observations shuffled), which changes the order of
every segment sum and nothing else.  For each run: the largest difference
of the quaternions and of the translations from the reference, and the LM
iterations of each round.

    python3 tools/pc8_spread_torch.py [card_runs (10)] [seeds (3)]

Prints one line a run and ONE JSON line last.  Needs a CUDA card.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import chip_smoke
from instantsfm_tpu_torch import config
from instantsfm_tpu_torch.pipeline import ba
from instantsfm_tpu_torch.scene import cameras as cm
from instantsfm_tpu_torch.scene.types import Tracks
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.utils import bench, debug


def permuted(tracks, seed):
    """``tracks`` with the tracks in a random order and each track's
    observations shuffled."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(tracks.num_tracks)
    pos = np.empty_like(order)
    pos[order] = np.arange(len(order))
    obs = np.lexsort((rng.random(tracks.num_observations),
                      pos[tracks.obs_track_idx()]))
    offset = np.zeros(tracks.num_tracks + 1, np.int64)
    np.cumsum(tracks.track_lengths()[order], out=offset[1:])
    return Tracks(tracks.xyz[order], tracks.color[order],
                  tracks.obs_image[obs], tracks.obs_feature[obs], offset,
                  tracks.track_id[order])


def run(device, seed=None):
    """(qvec, tvec, LM iterations per round, K1 plain-version calls) of the
    test's BA on ``device``, observations permuted by ``seed`` if given."""
    cameras, images, tracks, _ = chip_smoke.make_scene(num_cams=20,
                                                       num_pts=9000)
    cameras.model_ids[:] = cm.OPENCV
    cameras.params[0, :8] = [500.0, 500.0, 320.0, 240.0, 0.01, 0, 0, 0]
    if seed is not None:
        tracks = permuted(tracks, seed)
    opts = dict(config.BUNDLE_ADJUSTER_OPTIONS, max_num_iterations=10)
    debug.drain_stats()
    plain = k1.schur_wchain.plain_calls
    ba.bundle_adjustment_rounds(cameras, images, tracks, opts, 1e-2,
                                device=device)
    return (images.qvec.copy(), images.tvec.copy(),
            debug.drain_stats()["ba_lm_iters"],
            k1.schur_wchain.plain_calls - plain)


def main():
    bench.require_card()
    card_runs = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    t0 = time.perf_counter()
    q_ref, t_ref, it_ref, _ = run("cpu")
    print(f"cpu reference: LM iterations {it_ref} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    runs = []
    plan = ([("cuda", None)] * card_runs
            + [(d, s) for s in range(1, seeds + 1) for d in ("cpu", "cuda")])
    for device, seed in plan:
        t0 = time.perf_counter()
        q, t, iters, plain = run(device, seed)
        rec = dict(device=device, permutation_seed=seed,
                   max_abs_dq=float(np.abs(q - q_ref).max()),
                   max_abs_dt=float(np.abs(t - t_ref).max()),
                   lm_iters=iters, plain_calls=plain,
                   seconds=time.perf_counter() - t0)
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    card = [r for r in runs if r["device"] == "cuda"]
    print(json.dumps({
        "metric": "pc8_ba_pose_spread", "reference_lm_iters": it_ref,
        "max_abs_dt_card_same_order": max(
            [r["max_abs_dt"] for r in card if r["permutation_seed"] is None],
            default=None),
        "max_abs_dt_permuted": max(
            [r["max_abs_dt"] for r in runs if r["permutation_seed"]],
            default=None),
        "max_abs_dq_all": max(r["max_abs_dq"] for r in runs),
        "max_abs_dt_all": max(r["max_abs_dt"] for r in runs),
        "runs": runs, "device": bench.device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
