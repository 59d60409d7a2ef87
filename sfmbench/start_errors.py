"""How far from the truth the mapper's bundle adjustment starts.

    python3 sfmbench/start_errors.py --seeds 11,12,13 [--cell ring-200.mapper]

For each seed: draws the ring scene of the cell's configuration, writes
its database, and runs one mapper pass with a stage hook that reads the
state global positioning hands bundle adjustment (after the angle filter
and the normalisation).  That state is aligned to the truth by the
similarity of the camera centres (Umeyama), and the RMS per axis of each
error is printed as one JSON line: rotation (degrees, the axis-angle of
R R_true^T), translation (the truth's units), the points whose whole track
sees one true point (the truth's units), and the focal length's error
relative to the truth.  The bundle-adjustment cell's traffic
(``traffic/ba.json``) perturbs its start by these amounts.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import tempfile
import time

from run import HERE, ROOT, fixed_caches


def start_errors(scene: dict, images, tracks, focal: float) -> dict:
    """The errors of the state (``images``, ``tracks``, the focal length)
    against the ring's truth."""
    import numpy as np
    import torch

    from yardstick import ba_reference as ref
    from yardstick import model as model_mod
    from yardstick import ring

    reg = np.nonzero(images.registered)[0]
    index = {ring.image_name(i): i for i in range(len(scene["seen"]))}
    ring_idx = np.array([index[images.names[i]] for i in reg])
    R = ref.quat_xyzw_to_matrix(torch.as_tensor(images.qvec[reg])).numpy()
    centers = -np.einsum("nji,nj->ni", R, images.tvec[reg])
    c_gt = scene["centers"][ring_idx]
    s, Ra, ta = model_mod.umeyama(centers, c_gt)
    R_al = np.einsum("nij,kj->nik", R, Ra)
    c_al = s * centers @ Ra.T + ta
    t_al = -np.einsum("nij,nj->ni", R_al, c_al)
    E = np.einsum("nij,nkj->nik", R_al, scene["R"][ring_idx])
    w = np.stack([E[:, 2, 1] - E[:, 1, 2], E[:, 0, 2] - E[:, 2, 0],
                  E[:, 1, 0] - E[:, 0, 1]], 1) / 2.0      # small angles
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))

    ring_of = np.full(images.num_images, -1, np.int64)
    ring_of[reg] = ring_idx
    oi = tracks.obs_image
    ok_img = ring_of[oi] >= 0
    true_id = np.full(len(oi), -1, np.int64)
    true_id[ok_img] = [scene["seen"][r][f] for r, f in
                       zip(ring_of[oi[ok_img]], tracks.obs_feature[ok_img])]
    trk = tracks.obs_track_idx()
    lo = np.full(tracks.num_tracks, np.iinfo(np.int64).max)
    hi = np.full(tracks.num_tracks, -2)
    np.minimum.at(lo, trk, np.where(true_id >= 0, true_id, -1))
    np.maximum.at(hi, trk, true_id)
    one = (lo == hi) & (lo >= 0)
    X_al = s * tracks.xyz[one] @ Ra.T + ta
    return dict(images=int(len(reg)), tracks=int(tracks.num_tracks),
                tracks_scored=int(one.sum()),
                rot_deg=float(np.degrees(rms(w))),
                trans=rms(t_al - scene["t"][ring_idx]),
                point=rms(X_al - scene["points"][lo[one]]),
                focal_rel=float(focal / scene["intr"][0] - 1.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cell", default="ring-200.mapper")
    args = ap.parse_args(argv)
    fixed_caches()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import torch

    import core
    from yardstick import ring
    if not torch.cuda.is_available():
        core.log("this needs a CUDA card")
        return 2
    from instantsfm_tpu_torch.config import Config
    from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
    from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper

    cfg = core.resolve_cell(core.load_json(ROOT / "BENCHMARK.json"),
                            args.cell)["config"]
    dtype = getattr(torch, cfg["mapper"]["dtype"])
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        scene = ring.make_scene(cfg["scene"], seed)
        got = {}

        def hook(name, cameras, images, tracks):
            if name == "global_positioning":
                got.update(start_errors(scene, images, tracks,
                                        float(cameras.params[0][0])))

        with tempfile.TemporaryDirectory(prefix="sfmbench_") as work:
            db = os.path.join(work, "database.db")
            ring.write_database(db, scene, cfg["scene"])
            vg, cams, imgs, feature_name = read_colmap_database(db)
            solve_global_mapper(vg, cams, imgs, Config(feature_name),
                                dtype=dtype, log=lambda *a: None,
                                stage_hook=hook, device="cuda")
        print(json.dumps(dict(seed=seed, seconds=time.perf_counter() - t0,
                              **got)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
