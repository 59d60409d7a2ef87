"""Feature handler: images -> COLMAP database.

Counterpart of ``instantsfm_tpu/features/handler.py`` for its hand-crafted
front-end (``sift_tpu``: ``features/sift.py`` with the exhaustive or
sequential matching of ``features/matching.py``) and the ``colmap`` binary
passthrough, in one process.  The database is laid out as JAX writes it:
one SIMPLE_PINHOLE camera with f = 1.2 * min(w, h) of the first image,
the keypoints of the valid slots, descriptors stored as ``desc * 512``
clipped to uint8, the raw matches remapped to the valid-compacted keypoint
indices, and a ``two_view_geometries`` row (config 2, CALIBRATED) for each
pair with at least ``min_num_matches`` matches; the mapper's own RANSAC
verifies them.  The feature name stays ``sift_tpu``, so either package
reads the other's database.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from instantsfm_tpu_torch.features import matching, sift
from instantsfm_tpu_torch.io.colmap_db import ColmapDatabase
from instantsfm_tpu_torch.io.image import imread, resize
from instantsfm_tpu_torch.scene import cameras as cam_models
from instantsfm_tpu_torch.scene.types import CONFIG_CALIBRATED
from instantsfm_tpu_torch.utils.device import resolve_device

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
_LEARNED = ("superpoint", "superpoint_tpu", "superpoint+lightglue", "disk",
            "disk+lightglue", "dedode")


def load_gray(path, max_size):
    """(grey float32 [h, w] in [0, 1], scale, (w, h) of the file): RGB to
    grey by (0.299, 0.587, 0.114); past ``max_size`` the 8-bit image is
    shrunk by ``io.image.resize`` (PIL's bilinear resize in JAX)."""
    img = np.asarray(imread(path))
    if img.ndim == 3:
        img = img[..., :3].astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                                         np.float32)
    else:
        img = img.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    h, w = img.shape[:2]
    scale = 1.0
    if max(h, w) > max_size:
        scale = max_size / max(h, w)
        img = resize((img * 255).astype(np.uint8), int(h * scale),
                     int(w * scale)).astype(np.float32) / 255.0
    return img, scale, (w, h)


def generate_database(image_path: str, database_path: str,
                      feature_name: str = "sift_tpu", config=None,
                      max_image_size: int = 1600, max_keypoints: int = 4096,
                      match_ratio: float = None, min_num_matches: int = None,
                      sequential_overlap: int = 0, log=print,
                      device="cuda"):
    """Extract, match and write the database.  ``sequential_overlap`` > 0
    matches each image with the next ``sequential_overlap`` only.  Returns
    the run's counts and host seconds (after a device sync) of extraction,
    matching and writing; ``None`` for the ``colmap`` passthrough."""
    if feature_name == "colmap":
        # passthrough to an installed COLMAP binary
        import shutil
        import subprocess
        if shutil.which("colmap") is None:
            raise RuntimeError(
                "feature_name='colmap' needs the COLMAP binary on PATH; "
                "use the native front-end (default 'sift_tpu') instead")
        subprocess.run(["colmap", "feature_extractor", "--image_path",
                        image_path, "--database_path", database_path,
                        "--ImageReader.camera_model", "SIMPLE_RADIAL"],
                       check=True)
        matcher = ("sequential_matcher" if sequential_overlap > 0
                   else "exhaustive_matcher")
        subprocess.run(["colmap", matcher, "--database_path", database_path],
                       check=True)
        return None
    if feature_name in _LEARNED or feature_name.endswith("+lightglue"):
        raise NotImplementedError(
            f"feature_name={feature_name!r}: the learned front-ends "
            "(SuperPoint, DISK, DeDoDe, LightGlue) are not ported yet "
            "(ROADMAP queue 1, item 7)")

    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    if min_num_matches is None:
        min_num_matches = (config.FEATURE_HANDLER_OPTIONS["min_num_matches"]
                           if config is not None else 30)
    names = sorted(n for n in os.listdir(image_path)
                   if n.lower().endswith(_IMG_EXTS))
    if not names:
        raise FileNotFoundError(f"no images under {image_path}")
    if match_ratio is None:
        match_ratio = 0.85

    t0 = time.time()
    cfg = sift.SiftConfig(max_keypoints=max_keypoints)
    kps, descs, valids, sizes = [], [], [], []
    for name in names:
        img, scale, size = load_gray(os.path.join(image_path, name),
                                     max_image_size)
        xy, _, _, d, v = sift.extract(img, cfg, device=dev)
        kps.append((xy / scale).astype(np.float32))
        descs.append(d)
        valids.append(v)
        sizes.append(size)
    sync()
    extract_s = time.time() - t0
    log(f"Feature extraction done in {extract_s:.1f}s ({len(names)} images)")

    n = len(names)
    if sequential_overlap > 0:
        pairs = [(i, j) for i in range(n)
                 for j in range(i + 1, min(i + 1 + sequential_overlap, n))]
    else:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    t1 = time.time()
    all_matches = matching.match_all_pairs(descs, valids, ratio=match_ratio,
                                           max_matches=2048, pairs=pairs,
                                           device=dev)
    sync()
    match_s = time.time() - t1
    log(f"Matching done in {match_s:.1f}s ({len(all_matches)} pairs)")

    t2 = time.time()
    w0, h0 = sizes[0]
    focal = 1.2 * min(w0, h0)
    if os.path.exists(database_path):
        os.remove(database_path)
    n_geom = n_matches = 0
    with ColmapDatabase.connect(database_path) as db:
        db.create_tables()
        cam_id = db.add_camera(cam_models.SIMPLE_PINHOLE, w0, h0,
                               [focal, w0 / 2, h0 / 2], prior_focal=False)
        img_ids = []
        for i, name in enumerate(names):
            iid = db.add_image(name, cam_id)
            img_ids.append(iid)
            v = valids[i]
            db.add_keypoints(iid, kps[i][v])
            # uint8 for storage only: matching ran on the float descriptors,
            # which lie in [0, ~0.5]
            db.add_descriptors(iid, np.clip(descs[i][v] * 512, 0, 255)
                               .astype(np.uint8))
        # valid-compacted keypoint indices
        remap = []
        for v in valids:
            r = -np.ones(len(v), np.int64)
            r[v] = np.arange(v.sum())
            remap.append(r)
        for (i, j), m in all_matches.items():
            if len(m) == 0:
                continue
            mm = np.stack([remap[i][m[:, 0]], remap[j][m[:, 1]]], 1)
            mm = mm[(mm >= 0).all(axis=1)]
            db.add_matches(img_ids[i], img_ids[j], mm)
            n_matches += len(mm)
            if len(mm) >= min_num_matches:
                db.add_two_view_geometry(img_ids[i], img_ids[j], mm,
                                         config=CONFIG_CALIBRATED)
                n_geom += 1
        db.set_feature_name(feature_name)
    write_s = time.time() - t2
    log(f"Database written to {database_path} "
        f"({n_geom} verified-candidate pairs)")
    return dict(images=n, pairs=len(pairs), keypoints=int(sum(
        v.sum() for v in valids)), matches=n_matches, verified_pairs=n_geom,
        extract_s=extract_s, match_s=match_s, write_s=write_s)
