"""LightGlue matcher throughput of the port on the card (pairs a second).

The counterpart of ``tools/bench_lightglue.py``: ``n_images`` images of
``kps`` seeded random keypoints and unit descriptors (D = 256), exhaustive
pairs through ``features.lightglue.match_all_pairs`` in batches of
``batch`` pairs (one host read a batch), seeded random weights at the
published widths (the compute of a converted checkpoint), float32 without
TF32; a cold pass, then a warm one.  The warm pass is held to its FP32
bound, the pairs' FLOP as ``chip_smoke.lightglue_flop`` counts them over
67 TFLOP/s.

    python3 tools/bench_lightglue_torch.py [n_images (32)] [kps (1024)] [batch (8)]

Prints ONE JSON line last.  Needs a CUDA card.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from chip_smoke import PEAK_FLOPS, lightglue_flop
from instantsfm_tpu_torch import convert
from instantsfm_tpu_torch.features import lightglue as lg
from instantsfm_tpu_torch.utils import bench
from instantsfm_tpu_torch.utils.device import full_f32


def inputs(n, M, seed=0):
    """(kpts, descs, valids, sizes) of ``bench_lightglue.py``."""
    rng = np.random.default_rng(seed)
    kpts = rng.uniform(0, 640, (n, M, 2)).astype(np.float32)
    descs = rng.standard_normal((n, M, 256)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=-1, keepdims=True)
    return (kpts, descs, np.ones((n, M), bool),
            np.tile([640.0, 480.0], (n, 1)).astype(np.float32))


def measure(n, M, batch, device):
    net = convert.lightglue_from_numpy(
        lg.random_weights(torch.Generator().manual_seed(0)), device)
    data = inputs(n, M)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    cfg = lg.LightGlueConfig(max_matches=2048)
    secs = []
    for _ in range(2):                      # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lg.match_all_pairs(*data, net, pairs=pairs, cfg=cfg,
                                 batch=batch, device=device)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    cold, warm = secs
    flop = len(pairs) * lightglue_flop(M, M, 256)
    bound_s = flop / PEAK_FLOPS[torch.float32]
    return {"metric": "lightglue_pairs_per_sec", "value": len(pairs) / warm,
            "unit": f"pairs/s warm ({n} imgs, {M} kps, {lg.N_LAYERS} layers, "
                    f"batch {batch}, random weights, float32)",
            "warm_s": warm, "cold_s": cold, "n_pairs": len(pairs),
            "matches": int(sum(len(m) for m in out.values())),
            "tflop": flop / 1e12, "fp32_bound_s": bound_s,
            "share_of_fp32_bound": bound_s / warm,
            "device": bench.device_record()}


def main():
    device = bench.require_card()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    M = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    batch = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    with full_f32():
        rec = measure(n, M, batch, device)
    print(f"card: {rec['device']['nvidia_smi']}", file=sys.stderr)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
