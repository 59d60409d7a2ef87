"""Relative-pose stage of the port alone on the card, cold and warm.

The counterpart of ``tools/bench_relpose.py``: ``bench_e2e_torch.py``'s
scene database (``write_ring_db``, ``num_cams`` images) in a temporary
directory, the pair preprocessing and undistortion, then
``pipeline.relpose.estimate_relative_pose`` (float32) timed on its own,
once cold and once more on a fresh read of the database.

    python3 tools/bench_relpose_torch.py [num_cams (200)]

Prints ONE JSON line last.  Needs a CUDA card.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from bench_e2e_torch import write_ring_db
from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
from instantsfm_tpu_torch.pipeline import preprocess, relpose
from instantsfm_tpu_torch.utils import bench
from instantsfm_tpu_torch.utils.device import full_f32


def load(dbpath, device):
    """The view graph, cameras and images as the mapper hands them to
    relative pose."""
    view_graph, cameras, images, _ = read_colmap_database(dbpath)
    preprocess.update_image_pairs_config(view_graph, cameras, images)
    preprocess.decompose_relpose(view_graph, cameras, images)
    relpose.undistort_images(cameras, images, device=device)
    return view_graph, cameras, images


def timed_pass(dbpath, device):
    """(seconds of ``estimate_relative_pose``, valid pairs after it)."""
    view_graph, cameras, images = load(dbpath, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    relpose.estimate_relative_pose(view_graph, cameras, images,
                                   dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, int(view_graph.valid.sum())


def main():
    device = bench.require_card()
    num_cams = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    with full_f32(), tempfile.TemporaryDirectory(prefix="relpose_") as root:
        dbpath = os.path.join(root, "database.db")
        _, n_pairs, n_matches = write_ring_db(dbpath, num_cams=num_cams)
        cold, _ = timed_pass(dbpath, device)
        warm, n_valid = timed_pass(dbpath, device)
    rec = {"metric": "relpose_pairs_per_sec", "value": n_pairs / warm,
           "unit": f"pairs/s warm ({num_cams} images, {n_pairs} pairs, "
                   f"{n_matches} matches, float32)",
           "warm_s": warm, "cold_s": cold, "pairs": n_pairs,
           "valid_pairs_after": n_valid, "device": bench.device_record()}
    print(f"card: {rec['device']['nvidia_smi']}", file=sys.stderr)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
