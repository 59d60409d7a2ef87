"""Benchmark dataset layouts (reference ``eval/colmap_eval/evaluation/*.py``).

Counterpart of ``instantsfm_tpu/eval/datasets.py``, host numpy as there.

One class per dataset carries the reference's folder conventions, GT
position-accuracy constants, and GT-model preparation from the datasets'
native formats — so ``eval/benchmark.py`` can consume a real dataset
directory unmodified:

* ETH3D   (``evaluation/eth3d.py``): ``eth3d/<category>/<scene>/images`` +
  ``*_calibration_undistorted`` GT COLMAP model; accuracy 1 mm.
* T&T     (``evaluation/tt.py``): ``tt/<category>/<scene>/{images,cams_1}``;
  GT built from MVSNet ``XXXXXXXX_cam.txt`` files into ``sparse_gt``.
* DTU     (``evaluation/dtu.py``): same, camera dir ``cams``.
* BlendedMVS (``evaluation/blended_mvs.py``): same, camera dir ``cams``.
* IMC 2023/24 (``evaluation/imc.py``): ``imc<year>/<category>/<scene>/
  {images,sfm}``; GT = the ``sfm`` COLMAP model filtered to train images;
  accuracy 2 cm.

GT models are written with this framework's own COLMAP IO — no pycolmap.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.scene import cameras as cam_models


@dataclass
class SceneInfo:
    dataset: str
    category: str
    scene: str
    scene_path: str
    image_path: str
    sparse_gt_path: str


def _subdirs(path):
    if not os.path.isdir(path):
        return []
    return sorted(d for d in os.listdir(path)
                  if os.path.isdir(os.path.join(path, d)))


def _rotmat_to_qvec_wxyz(R):
    """3x3 rotation -> COLMAP wxyz quaternion."""
    t = np.trace(R)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 1e-12)) * 2
        q = np.zeros(3)
        q[i] = s / 4
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _write_gt_model(path, cams, imgs):
    os.makedirs(path, exist_ok=True)
    cmio.write_model(cams, imgs, [], path, binary=True)


def _image_size(path):
    """(w, h): PIL reads the header where it is installed; without it the
    port's image reader decodes the file (PNG without any package)."""
    try:
        from PIL import Image
    except ImportError:
        from instantsfm_tpu_torch.io.image import imread
        a = imread(path)
        return a.shape[1], a.shape[0]
    with Image.open(path) as im:
        return im.size            # (w, h)


def _prepare_mvsnet_gt(scene_path: str, cam_dir: str, sparse_gt_path: str,
                       image_ext: str = ".jpg") -> None:
    """Build a GT COLMAP model from MVSNet-style ``XXXXXXXX_cam.txt`` files
    (extrinsic rows 1-4 world->cam, intrinsic rows 7-10; reference
    ``evaluation/tt.py:100-145``)."""
    cam_path = os.path.join(scene_path, cam_dir)
    cams, imgs = [], []
    i = 0
    for fn in sorted(os.listdir(cam_path)):
        if not fn.endswith("_cam.txt"):
            continue
        image_name = fn[:8] + image_ext
        img_file = os.path.join(scene_path, "images", image_name)
        if not os.path.exists(img_file):
            continue
        w, h = _image_size(img_file)
        with open(os.path.join(cam_path, fn), encoding="ascii") as f:
            lines = [ln.strip() for ln in f.readlines()]
        ext = np.fromstring(" ".join(lines[1:4]), count=12,
                            sep=" ").reshape(3, 4)
        K = np.fromstring(" ".join(lines[7:10]), count=9,
                          sep=" ").reshape(3, 3)
        cams.append(cmio.ModelCamera(
            id=i, model_id=cam_models.PINHOLE, width=w, height=h,
            params=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])))
        imgs.append(cmio.ModelImage(
            id=i, qvec_wxyz=_rotmat_to_qvec_wxyz(ext[:, :3]),
            tvec=ext[:, 3].copy(), camera_id=i, name=image_name,
            xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64)))
        i += 1
    if not imgs:
        raise FileNotFoundError(f"no *_cam.txt files under {cam_path}")
    _write_gt_model(sparse_gt_path, cams, imgs)


class DatasetLayout:
    """Folder-convention walker + GT preparation for one benchmark dataset."""
    name = ""
    position_accuracy_gt = 0.001   # meters (reference per-dataset classes)

    def list_scenes(self, data_path: str,
                    categories: Optional[List[str]] = None,
                    scenes: Optional[List[str]] = None) -> List[SceneInfo]:
        root = os.path.join(data_path, self.name)
        infos = []
        for category in _subdirs(root):
            if categories and category not in categories:
                continue
            cat_path = os.path.join(root, category)
            for scene in _subdirs(cat_path):
                if scenes and scene not in scenes:
                    continue
                sp = os.path.join(cat_path, scene)
                infos.append(self._scene_info(category, scene, sp))
        return [i for i in infos if i is not None]

    def _scene_info(self, category, scene, scene_path) -> SceneInfo:
        return SceneInfo(
            dataset=self.name, category=category, scene=scene,
            scene_path=scene_path,
            image_path=os.path.join(scene_path, "images"),
            sparse_gt_path=os.path.join(scene_path, "sparse_gt"))

    def prepare_scene(self, info: SceneInfo) -> None:
        """Create ``sparse_gt`` from the dataset's native GT when missing."""


class ETH3D(DatasetLayout):
    name = "eth3d"
    position_accuracy_gt = 0.001          # reference eth3d.py:50-52

    def _scene_info(self, category, scene, scene_path):
        calib = [d for d in os.listdir(scene_path)
                 if d.endswith("_calibration_undistorted")
                 and os.path.isdir(os.path.join(scene_path, d))]
        if not calib:
            return None
        gt = os.path.join(scene_path, calib[0])
        # the archives nest <scene>/<calibration>/ — descend if needed
        for sub in ("", scene):
            cand = os.path.join(gt, sub) if sub else gt
            if os.path.exists(os.path.join(cand, "images.bin")) or \
               os.path.exists(os.path.join(cand, "images.txt")):
                gt = cand
                break
        return SceneInfo(dataset=self.name, category=category, scene=scene,
                         scene_path=scene_path,
                         image_path=os.path.join(scene_path, "images"),
                         sparse_gt_path=gt)


class TanksAndTemples(DatasetLayout):
    name = "tt"
    position_accuracy_gt = 0.001          # reference tt.py:56

    def prepare_scene(self, info):
        if os.path.exists(info.sparse_gt_path):
            return
        _prepare_mvsnet_gt(info.scene_path, "cams_1", info.sparse_gt_path)


class DTU(DatasetLayout):
    name = "dtu"
    position_accuracy_gt = 0.001          # reference dtu.py:56

    def prepare_scene(self, info):
        if os.path.exists(info.sparse_gt_path):
            return
        _prepare_mvsnet_gt(info.scene_path, "cams", info.sparse_gt_path)


class BlendedMVS(DatasetLayout):
    name = "blended_mvs"
    position_accuracy_gt = 0.001          # reference blended_mvs.py:56

    def prepare_scene(self, info):
        if os.path.exists(info.sparse_gt_path):
            return
        _prepare_mvsnet_gt(info.scene_path, "cams", info.sparse_gt_path)


class IMC(DatasetLayout):
    position_accuracy_gt = 0.02           # reference imc.py:54

    def __init__(self, year: int):
        self.year = year
        self.name = f"imc{year}"

    def _scene_info(self, category, scene, scene_path):
        if not os.path.isdir(os.path.join(scene_path, "sfm")):
            return None                   # GT reconstruction missing
        return super()._scene_info(category, scene, scene_path)

    def prepare_scene(self, info):
        if os.path.exists(info.sparse_gt_path):
            return
        # GT = the provided sfm model filtered to the train images
        train = set(os.listdir(info.image_path))
        cams_d, imgs_d, _ = cmio.read_model(os.path.join(info.scene_path,
                                                         "sfm"))
        imgs = [im for im in imgs_d.values() if im.name in train]
        used = {im.camera_id for im in imgs}
        cams = [c for cid, c in cams_d.items() if cid in used]
        for im in imgs:                    # strip 2D points (GT poses only)
            im.xys = np.zeros((0, 2))
            im.point3D_ids = np.zeros(0, np.int64)
        _write_gt_model(info.sparse_gt_path, cams, imgs)


LAYOUTS = {
    "eth3d": ETH3D(),
    "tt": TanksAndTemples(),
    "dtu": DTU(),
    "blended_mvs": BlendedMVS(),
    "imc2023": IMC(2023),
    "imc2024": IMC(2024),
}
