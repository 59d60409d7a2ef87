"""View-graph preprocessing (counterpart of
``instantsfm_tpu/pipeline/preprocess.py``), host numpy.

* ``update_image_pairs_config``: promote UNCALIBRATED pairs to CALIBRATED when
  both cameras have >=50% calibrated pairs (calib-ratio voting), vectorized
  with bincount.
* ``decompose_relpose``: promote PLANAR pairs with prior focals to CALIBRATED
  and report the pure-rotation pair count.
"""

from __future__ import annotations

import numpy as np

from instantsfm_tpu_torch.scene.types import (CONFIG_CALIBRATED, CONFIG_PLANAR,
                                              CONFIG_PLANAR_OR_PANORAMIC,
                                              CONFIG_UNCALIBRATED, Cameras,
                                              Images, ViewGraph)


def update_image_pairs_config(view_graph: ViewGraph, cameras: Cameras,
                              images: Images) -> None:
    cam1 = images.cam_idx[view_graph.pair_i]
    cam2 = images.cam_idx[view_graph.pair_j]
    prior = cameras.has_prior_focal
    counted = view_graph.valid & prior[cam1] & prior[cam2]

    C = cameras.num_cameras
    calib = counted & (view_graph.config == CONFIG_CALIBRATED)
    uncalib = counted & (view_graph.config == CONFIG_UNCALIBRATED)
    total = np.bincount(cam1[calib | uncalib], minlength=C) \
        + np.bincount(cam2[calib | uncalib], minlength=C)
    ncal = np.bincount(cam1[calib], minlength=C) \
        + np.bincount(cam2[calib], minlength=C)

    validity = (total > 0) & (ncal >= 0.5 * np.maximum(total, 1))
    promote = view_graph.valid & (view_graph.config == CONFIG_UNCALIBRATED) \
        & validity[cam1] & validity[cam2]
    view_graph.config[promote] = CONFIG_CALIBRATED


def decompose_relpose(view_graph: ViewGraph, cameras: Cameras,
                      images: Images) -> int:
    cam1 = images.cam_idx[view_graph.pair_i]
    cam2 = images.cam_idx[view_graph.pair_j]
    prior = cameras.has_prior_focal
    both_prior = view_graph.valid & prior[cam1] & prior[cam2]

    promote = both_prior & (view_graph.config == CONFIG_PLANAR)
    view_graph.config[promote] = CONFIG_CALIBRATED

    pure_rotation = both_prior & ~np.isin(
        view_graph.config, (CONFIG_CALIBRATED, CONFIG_PLANAR_OR_PANORAMIC))
    return int(pure_rotation.sum())
