"""Reconstruction export: scene arrays -> COLMAP sparse model on disk.

Counterpart of ``instantsfm_tpu/pipeline/writer.py``: tracks with >= 2
observations on the exported images become points3D (tracks with >= 3 also
link the images' 2D points), per-cluster export, optional per-point color
from the source images (mean of bilinear samples).
"""

from __future__ import annotations

import os

import numpy as np

from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.io.image import imread
from instantsfm_tpu_torch.scene.types import Cameras, Images, Tracks


def _bilinear(img, xy):
    """[n, 3] bilinear samples of an HxWx3 image; -1 outside."""
    h, w = img.shape[:2]
    x, y = xy[:, 0], xy[:, 1]
    okb = (x >= 0) & (x < w - 1) & (y >= 0) & (y < h - 1)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    x0c, y0c = np.clip(x0, 0, w - 2), np.clip(y0, 0, h - 2)
    c = (img[y0c, x0c] * ((1 - fx) * (1 - fy))[:, None]
         + img[y0c, x0c + 1] * (fx * (1 - fy))[:, None]
         + img[y0c + 1, x0c] * ((1 - fx) * fy)[:, None]
         + img[y0c + 1, x0c + 1] * (fx * fy)[:, None])[:, :3]
    return np.where(okb[:, None], c, -1.0)


def extract_point_colors(images: Images, tracks: Tracks, image_path: str) -> None:
    """Mean bilinear color per track over its observations; images that are
    missing or unreadable are skipped."""
    sums = np.zeros((tracks.num_tracks, 3))
    counts = np.zeros(tracks.num_tracks)
    tr_idx = tracks.obs_track_idx()
    for i in range(images.num_images):
        sel = tracks.obs_image == i
        path = os.path.join(image_path, images.names[i])
        if not sel.any() or not os.path.exists(path):
            continue
        try:
            img = np.asarray(imread(path))
        except (OSError, ValueError, RuntimeError):
            continue
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        xy = images.kp_xy[images.kp_index(np.full(sel.sum(), i),
                                          tracks.obs_feature[sel])] - 0.5
        c = _bilinear(img[..., :3].astype(np.float64), xy)
        ok = c[:, 0] >= 0
        t_sel = tr_idx[sel]
        np.add.at(sums, t_sel[ok], c[ok])
        np.add.at(counts, t_sel[ok], 1.0)
    has = counts > 0
    tracks.color[has] = (sums[has] / counts[has, None]).astype(np.uint8)


def export_reconstruction(output_path: str, cameras: Cameras, images: Images,
                          tracks: Tracks, image_path: str = "",
                          cluster_id: int = -1, export_txt: bool = False) -> str:
    sel_img = images.registered.copy()
    if cluster_id != -1:
        sel_img &= images.cluster_id == cluster_id

    # points with >= 2 observations on selected images
    t = tracks.filter_observations(sel_img[tracks.obs_image])
    lengths = t.track_lengths()
    pt_keep = lengths >= 2
    # linkage gate: only tracks with >= 3 obs mark image 2D points
    link_ok = lengths >= 3

    if image_path:
        extract_point_colors(images, t, image_path)

    cams_out = [cmio.ModelCamera(
        id=c, model_id=int(cameras.model_ids[c]),
        width=int(cameras.widths[c]), height=int(cameras.heights[c]),
        params=cameras.active_params(c).copy())
        for c in range(cameras.num_cameras)]

    # per-image point3D ids (dense track index as the point3D id)
    kp_p3d = np.full(len(images.kp_xy), -1, np.int64)
    tr_idx = t.obs_track_idx()
    use = link_ok[tr_idx] & pt_keep[tr_idx]
    kp_p3d[images.kp_index(t.obs_image[use], t.obs_feature[use])] = tr_idx[use]

    cluster_path = os.path.join(output_path, "0" if cluster_id == -1
                                else str(cluster_id))
    os.makedirs(cluster_path, exist_ok=True)

    img_sel = np.nonzero(sel_img)[0]
    pt_sel = np.nonzero(pt_keep)[0]
    if not export_txt:
        # SoA path: serialize straight from the flat scene arrays
        cmio.write_cameras_binary(
            cams_out, os.path.join(cluster_path, "cameras.bin"))
        sub_off = np.concatenate(
            [[0], np.cumsum(np.diff(images.kp_offset)[img_sel])])
        take = np.concatenate(
            [np.arange(images.kp_offset[i], images.kp_offset[i + 1])
             for i in img_sel]) if len(img_sel) else np.zeros(0, np.int64)
        cmio.write_images_binary_soa(
            os.path.join(cluster_path, "images.bin"),
            ids=img_sel, qvec_wxyz=images.qvec[img_sel][:, [3, 0, 1, 2]],
            tvec=images.tvec[img_sel], camera_ids=images.cam_idx[img_sel],
            names=[images.names[i] for i in img_sel],
            kp_xy=images.kp_xy[take], kp_offset=sub_off,
            point3D_ids=kp_p3d[take])
        keep_obs2 = pt_keep[tr_idx]
        obs_off = np.concatenate([[0], np.cumsum(lengths[pt_sel])])
        cmio.write_points3D_binary_soa(
            os.path.join(cluster_path, "points3D.bin"),
            ids=pt_sel, xyz=t.xyz[pt_sel], rgb=t.color[pt_sel],
            errors=np.zeros(len(pt_sel)), obs_offset=obs_off,
            image_ids=t.obs_image[keep_obs2],
            point2D_idxs=t.obs_feature[keep_obs2])
        return cluster_path

    imgs_out = []
    for i in img_sel:
        sl = slice(images.kp_offset[i], images.kp_offset[i + 1])
        q = images.qvec[i]
        imgs_out.append(cmio.ModelImage(
            id=int(i), qvec_wxyz=np.array([q[3], q[0], q[1], q[2]]),
            tvec=images.tvec[i].copy(), camera_id=int(images.cam_idx[i]),
            name=images.names[i], xys=images.kp_xy[sl].copy(),
            point3D_ids=kp_p3d[sl].copy()))

    pts_out = []
    for p in pt_sel:
        sl = slice(t.obs_offset[p], t.obs_offset[p + 1])
        pts_out.append(cmio.ModelPoint3D(
            id=int(p), xyz=t.xyz[p].copy(), rgb=t.color[p].copy(),
            error=0.0, image_ids=t.obs_image[sl].astype(np.int64),
            point2D_idxs=t.obs_feature[sl].astype(np.int64)))

    cmio.write_model(cams_out, imgs_out, pts_out, cluster_path, binary=False)
    return cluster_path


def write_reconstruction(output_path: str, cameras: Cameras, images: Images,
                         tracks: Tracks, image_path: str = "",
                         export_txt: bool = False) -> None:
    """Per-cluster export when clusters were marked."""
    max_cluster = int(images.cluster_id.max()) if images.num_images else -1
    if max_cluster <= 0:
        export_reconstruction(output_path, cameras, images, tracks,
                              image_path, export_txt=export_txt)
    else:
        for c in range(max_cluster):
            export_reconstruction(f"{output_path}_{c}", cameras, images,
                                  tracks, image_path, cluster_id=c,
                                  export_txt=export_txt)
