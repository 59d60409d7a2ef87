"""Symmetric chamfer distance between sparse point clouds
(reference ``eval/chamfer_dis.py``: KD-tree queries -> mean of both directions).

Counterpart of ``instantsfm_tpu/eval/chamfer.py``: the KD-tree stays (scipy,
host-side), and ``chamfer_distance_device`` finds the nearest neighbours by
a blocked product on ``device`` for large clouds.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.utils.device import full_f32, resolve_device


def chamfer_distance_kdtree(p1: np.ndarray, p2: np.ndarray) -> float:
    from scipy.spatial import cKDTree

    d12 = cKDTree(p2).query(p1)[0]
    d21 = cKDTree(p1).query(p2)[0]
    return float(0.5 * (d12.mean() + d21.mean()))


def chamfer_distance_device(p1: np.ndarray, p2: np.ndarray,
                            chunk: int = 4096, device="cuda") -> float:
    """Blocked nearest-neighbor on device (for very large clouds), float32
    as JAX's; the product runs in full float32 (no TF32)."""
    dev = resolve_device(device)

    def one_way(a, b):
        bj = torch.as_tensor(b, dtype=torch.float32, device=dev)
        b_sq = torch.sum(bj * bj, -1)
        total, n = 0.0, 0
        for lo in range(0, len(a), chunk):
            q = torch.as_tensor(a[lo:lo + chunk], dtype=torch.float32,
                                device=dev)
            with full_f32():
                d2 = torch.sum(q * q, -1)[:, None] + b_sq[None, :] \
                    - 2 * q @ bj.T
            total += float(torch.sqrt(d2.min(dim=1).values.clamp_min(0))
                           .sum())
            n += len(q)
        return total / n

    return 0.5 * (one_way(p1, p2) + one_way(p2, p1))


def main(argv=None):
    import argparse

    from instantsfm_tpu_torch.io import colmap_model as cmio

    parser = argparse.ArgumentParser()
    parser.add_argument("model1")
    parser.add_argument("model2")
    args = parser.parse_args(argv)
    _, _, pts1 = cmio.read_model(args.model1)
    _, _, pts2 = cmio.read_model(args.model2)
    p1 = np.stack([p.xyz for p in pts1.values()])
    p2 = np.stack([p.xyz for p in pts2.values()])
    d = chamfer_distance_kdtree(p1, p2)
    print(f"chamfer distance: {d}")
    return 0


if __name__ == "__main__":
    main()
