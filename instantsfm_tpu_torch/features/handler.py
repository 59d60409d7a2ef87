"""Feature handler: images -> COLMAP database.

Counterpart of ``instantsfm_tpu/features/handler.py``, in one process:

* ``sift_tpu`` (default): ``features/sift.py`` with the mutual-NN ratio
  matching of ``features/matching.py``;
* the learned front-ends, weight-gated as in JAX (each raises
  ``RuntimeError`` naming its converter when its npz is absent):
  ``superpoint`` (also ``superpoint_tpu``) and ``dedode`` matched by the
  ratio matcher, ``disk`` likewise, and ``superpoint+lightglue`` /
  ``disk+lightglue`` matched by ``features/lightglue.py``; DISK and DeDoDe
  read RGB;
* ``colmap``: passthrough to the COLMAP binary.

Matching is exhaustive, or sequential with ``sequential_overlap`` > 0.
The database is laid out as JAX writes it: one SIMPLE_PINHOLE camera with
f = 1.2 * min(w, h) of the first image, the keypoints of the valid slots,
descriptors stored as uint8 of ``desc * 128 + 128`` (SuperPoint, DISK) or
``desc * 512`` (SIFT, DeDoDe: a DeDoDe entry below 0 clips to 0, as in
JAX), the raw matches remapped to the valid-compacted keypoint indices,
and a ``two_view_geometries`` row (config 2, CALIBRATED) for each pair with
at least ``min_num_matches`` matches; the mapper's own RANSAC verifies
them.  The feature name is written as given, so either package reads the
other's database.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from instantsfm_tpu_torch import convert
from instantsfm_tpu_torch.features import (dedode, disk, lightglue, matching,
                                           sift, superpoint)
from instantsfm_tpu_torch.io.colmap_db import ColmapDatabase
from instantsfm_tpu_torch.io.image import imread, resize
from instantsfm_tpu_torch.scene import cameras as cam_models
from instantsfm_tpu_torch.scene.types import CONFIG_CALIBRATED
from instantsfm_tpu_torch.utils.device import resolve_device

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
_SUPERPOINT = ("superpoint", "superpoint_tpu", "superpoint+lightglue")
_DISK = ("disk", "disk+lightglue")
_NO_EGRESS = "on a machine that has it (no egress here)"


def load_gray(path, max_size, rgb=False):
    """(float32 image in [0, 1], scale, (w, h) of the file): grey [h, w]
    by (0.299, 0.587, 0.114), or with ``rgb`` [h, w, 3] (a grey file
    stacked); past ``max_size`` the 8-bit image is shrunk by
    ``io.image.resize`` (PIL's bilinear resize in JAX)."""
    img = np.asarray(imread(path))
    if rgb:
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3].astype(np.float32)
    elif img.ndim == 3:
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


def _need(weights, feature_name, path, what, converter):
    if weights is None:
        raise RuntimeError(
            f"feature_name={feature_name!r} needs pretrained weights at "
            f"{path}: convert the public {what} once with "
            f"instantsfm_tpu_torch.features.{converter} {_NO_EGRESS}")
    return weights


def _front_end(feature_name, max_keypoints, dev):
    """(extract(img) -> (xy, score, desc, valid), rgb, LightGlue module or
    None) of a learned front-end, its weights loaded onto ``dev``; raises
    as JAX does where a weight file is absent or a name cannot take
    LightGlue."""
    use_lg = feature_name.endswith("+lightglue")
    use_disk, use_sp = feature_name in _DISK, feature_name in _SUPERPOINT
    if use_lg and not (use_sp or use_disk):
        raise RuntimeError(
            f"feature_name={feature_name!r}: learned front-ends are "
            "'superpoint[+lightglue]', 'disk[+lightglue]' and 'dedode' "
            "(descriptor-matched, like the reference)")
    lg_net = None
    if use_lg:
        kind = "disk" if use_disk else "superpoint"
        lg_net = convert.lightglue_from_numpy(_need(
            lightglue.try_load_default(kind), feature_name,
            lightglue.default_weights_path(kind), f"{kind}_lightglue.pth",
            "lightglue.convert_torch_checkpoint(pth)"), dev)
    if use_disk:
        net = convert.disk_from_numpy(_need(
            disk.try_load_default(), feature_name, disk.default_weights_path(),
            "DISK depth-save.pth", "disk.convert_torch_checkpoint(pth)"), dev)
        cfg = disk.DiskConfig(max_keypoints=max_keypoints)
        return lambda img: disk.extract(img, net, cfg, dev), True, lg_net
    if feature_name == "dedode":
        net = convert.dedode_from_numpy(_need(
            dedode.try_load_default(), feature_name,
            dedode.default_weights_path(),
            "DeDoDe detector-L + descriptor-B checkpoints",
            "dedode.convert_torch_checkpoint(det_pth, desc_pth)"), dev)
        cfg = dedode.DeDoDeConfig(max_keypoints=max_keypoints)
        return lambda img: dedode.extract(img, net, cfg, dev), True, None
    net = convert.superpoint_from_numpy(_need(
        superpoint.try_load_default(), feature_name,
        superpoint.default_weights_path(), "superpoint_v1.pth",
        "superpoint.convert_torch_checkpoint(pth)"), dev)
    cfg = superpoint.SuperPointConfig(max_keypoints=max_keypoints)
    return lambda img: superpoint.extract(img, net, cfg, dev), False, lg_net


def generate_database(image_path: str, database_path: str,
                      feature_name: str = "sift_tpu", config=None,
                      max_image_size: int = 1600, max_keypoints: int = 4096,
                      match_ratio: float = None, min_num_matches: int = None,
                      sequential_overlap: int = 0, log=print,
                      device="cuda"):
    """Extract with ``feature_name``'s front-end (module docstring), match
    and write the database.  ``sequential_overlap`` > 0 matches each image
    with the next ``sequential_overlap`` only.  Returns the run's counts
    and host seconds (after a device sync) of extraction, matching and
    writing; ``None`` for the ``colmap`` passthrough."""
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
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    learned = feature_name.endswith("+lightglue") or \
        feature_name in _SUPERPOINT + _DISK + ("dedode",)
    lg_net, rgb = None, False
    if learned:
        extract, rgb, lg_net = _front_end(feature_name, max_keypoints, dev)
    else:
        cfg = sift.SiftConfig(max_keypoints=max_keypoints)

        def extract(img):
            xy, _, _, d, v = sift.extract(img, cfg, device=dev)
            return xy, None, d, v
    if min_num_matches is None:
        min_num_matches = (config.FEATURE_HANDLER_OPTIONS["min_num_matches"]
                           if config is not None else 30)
    names = sorted(n for n in os.listdir(image_path)
                   if n.lower().endswith(_IMG_EXTS))
    if not names:
        raise FileNotFoundError(f"no images under {image_path}")
    if match_ratio is None:
        # DeDoDe is matched with ratio 0.92, SuperPoint and DISK near-MNN
        # at 0.95, SIFT at 0.85
        match_ratio = (0.92 if feature_name == "dedode" else
                       0.95 if learned else 0.85)

    t0 = time.time()
    kps, descs, valids, sizes = [], [], [], []
    for name in names:
        img, scale, size = load_gray(os.path.join(image_path, name),
                                     max_image_size, rgb=rgb)
        xy, _, d, v = extract(img)
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
    if lg_net is not None:
        # per-image sizes: each image's own keypoint normalization
        all_matches = lightglue.match_all_pairs(
            kps, descs, valids, np.asarray(sizes, np.float32), lg_net,
            pairs=pairs, cfg=lightglue.LightGlueConfig(max_matches=2048),
            device=dev)
    else:
        all_matches = matching.match_all_pairs(
            descs, valids, ratio=match_ratio, max_matches=2048, pairs=pairs,
            device=dev)
    sync()
    match_s = time.time() - t1
    log(f"Matching done in {match_s:.1f}s ({len(all_matches)} pairs)")

    t2 = time.time()
    w0, h0 = sizes[0]
    focal = 1.2 * min(w0, h0)
    if os.path.exists(database_path):
        os.remove(database_path)
    dense_u8 = feature_name in _SUPERPOINT + _DISK
    n_geom = n_matches = n_verified = 0
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
            # uint8 for storage only (matching ran on the floats): SIFT
            # lies in [0, ~0.5], SuperPoint and DISK in [-1, 1]; DeDoDe's
            # negative entries clip to 0, as in JAX
            d8 = descs[i][v] * 128 + 128 if dense_u8 else descs[i][v] * 512
            db.add_descriptors(iid, np.clip(d8, 0, 255).astype(np.uint8))
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
                n_verified += len(mm)
        db.set_feature_name(feature_name)
    write_s = time.time() - t2
    log(f"Database written to {database_path} "
        f"({n_geom} verified-candidate pairs)")
    return dict(images=n, pairs=len(pairs), keypoints=int(sum(
        v.sum() for v in valids)), matches=n_matches, verified_pairs=n_geom,
        verified_matches=n_verified,
        extract_s=extract_s, match_s=match_s, write_s=write_s)
