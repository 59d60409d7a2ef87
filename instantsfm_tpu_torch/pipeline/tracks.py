"""Track establishment: match-graph connected components -> Tracks.

Counterpart of ``instantsfm_tpu/pipeline/tracks.py``:
* nodes are the global keypoint ids (kp_offset[img] + feat); every inlier
  match of a valid pair is an edge;
* each component is labelled by its LARGEST node id, the label the JAX
  package's native union-find gives (``native/src/native.cpp``: Rem's
  algorithm links every root under a larger node), so tracks come out in
  the same order; ``component_max_labels`` computes it on the device by
  max-label propagation and pointer jumping;
* per-node reference counts = number of inlier matches touching the node;
* tracks whose same-image observations spread more than
  ``thres_inconsistency`` pixels are discarded entirely;
* duplicate observations of one image keep the highest-count feature;
* length filter [min_num_view_per_track, max_num_view_per_track] restricted
  to registered images.
The rest is host numpy, as in the JAX package.  Spans: ``tracks.prepare``
(the match graph's edges), ``tracks.label`` (the components; its reads
``tracks.jump``, ``tracks.stable`` and ``tracks.labels``) and
``tracks.filter`` (the rest).
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.scene.types import Images, Tracks, ViewGraph
from instantsfm_tpu_torch.utils import debug
from instantsfm_tpu_torch.utils.device import resolve_device


@debug.traced("tracks.label")
def component_max_labels(e1: np.ndarray, e2: np.ndarray, n_nodes: int,
                         device="cuda") -> np.ndarray:
    """Label of each node = the largest node id of its connected component
    (edges e1[i] -- e2[i] over nodes 0..n_nodes-1).

    Each round takes, per edge, the larger label of its two ends into both
    (``scatter_reduce`` amax), then jumps every label to its label's label
    until that is stable; labels only grow, stay inside the component, and
    stop once every edge joins equal labels, when each equals its
    component's maximum.  One host read a round."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.ascontiguousarray(e1, np.int64), device=dev)
    b = torch.as_tensor(np.ascontiguousarray(e2, np.int64), device=dev)
    lab = torch.arange(n_nodes, dtype=torch.int64, device=dev)
    while True:
        m = torch.maximum(lab[a], lab[b])
        new = lab.scatter_reduce(0, a, m, "amax").scatter_reduce(0, b, m, "amax")
        while True:
            jumped = new[new]
            if debug.read("tracks.jump", torch.all(jumped == new)):
                break
            new = jumped
        if debug.read("tracks.stable", torch.all(new == lab)):
            return debug.read("tracks.labels", lab)
        lab = new


def establish_tracks(view_graph: ViewGraph, images: Images, opts: dict,
                     return_full: bool = False, device="cuda"):
    with debug.span("tracks.prepare"):
        mp = view_graph.match_pair_idx()
        inl = view_graph.inlier_mask & view_graph.valid[mp]
        if not inl.any():
            return (Tracks.empty(), Tracks.empty()) if return_full \
                else Tracks.empty()
        pi = view_graph.pair_i[mp[inl]].astype(np.int64)
        pj = view_graph.pair_j[mp[inl]].astype(np.int64)
        f1 = view_graph.matches[inl, 0].astype(np.int64)
        f2 = view_graph.matches[inl, 1].astype(np.int64)

        # nodes are the global keypoint ids, already a dense 0..V-1 space;
        # untouched keypoints become singleton components and are dropped
        # below
        e1 = images.kp_index(pi, f1)
        e2 = images.kp_index(pj, f2)
        V_all = int(images.kp_offset[-1])
    labels_all = component_max_labels(e1, e2, V_all, device)
    return _filter_tracks(labels_all, e1, e2, V_all, images, opts,
                          return_full)


@debug.traced("tracks.filter")
def _filter_tracks(labels_all, e1, e2, V_all, images, opts, return_full):
    """Tracks from the components' labels: the consistency test, one
    observation per (track, image) and the length filter."""
    counts_all = np.bincount(e1, minlength=V_all) \
        + np.bincount(e2, minlength=V_all)
    nodes = np.nonzero(counts_all)[0]              # touched keypoints only
    labels = labels_all[nodes]
    counts = counts_all[nodes]
    img = (np.searchsorted(images.kp_offset, nodes, side="right") - 1) \
        .astype(np.int32)
    feat = (nodes - images.kp_offset[img]).astype(np.int32)

    # ---- consistency: same-image spread within a track <= thres (bbox diag)
    # one packed-key argsort; keys are unique (feat ids are unique within an
    # image), so the order equals the JAX package's
    bi = max(int(images.num_images), 1).bit_length()
    bf = int(feat.max() + 1).bit_length()
    bl = int(labels.max() + 1).bit_length()
    if bl + bi + bf <= 63:
        key = ((labels.astype(np.int64) << (bi + bf))
               | (img.astype(np.int64) << bf) | feat.astype(np.int64))
        order = np.argsort(key)
    else:
        order = np.lexsort((feat, img, labels))
    labels_s, img_s, feat_s = labels[order], img[order], feat[order]
    counts_s = counts[order]
    xy = images.kp_xy[images.kp_index(img_s, feat_s)]

    grp_key = labels_s.astype(np.int64) * (images.num_images + 1) + img_s
    new_grp = np.empty(len(grp_key), bool)
    new_grp[0] = True
    new_grp[1:] = grp_key[1:] != grp_key[:-1]
    grp_id = np.cumsum(new_grp) - 1
    n_grp = grp_id[-1] + 1

    gmin_x = np.full(n_grp, np.inf)
    gmax_x = np.full(n_grp, -np.inf)
    gmin_y = np.full(n_grp, np.inf)
    gmax_y = np.full(n_grp, -np.inf)
    np.minimum.at(gmin_x, grp_id, xy[:, 0])
    np.maximum.at(gmax_x, grp_id, xy[:, 0])
    np.minimum.at(gmin_y, grp_id, xy[:, 1])
    np.maximum.at(gmax_y, grp_id, xy[:, 1])
    spread = np.hypot(gmax_x - gmin_x, gmax_y - gmin_y)
    bad_grp = spread > float(opts["thres_inconsistency"])
    bad_track = np.zeros(labels_s.max() + 1, bool)
    grp_track = labels_s[new_grp]  # track label of each group
    np.logical_or.at(bad_track, grp_track[bad_grp], True)

    # ---- dedup: one observation per (track, image): keep the max ref count
    # (ties to the lowest feature id); counts clamp to 15 bits in the packed
    # key (a keypoint touches <= 2 * window pairs, so real counts are tiny)
    bg = int(n_grp).bit_length()
    if bg + 15 + bf <= 63:
        cc = np.minimum(counts_s, 32767).astype(np.int64)
        key2 = ((grp_id << (15 + bf)) | ((32767 - cc) << bf)
                | feat_s.astype(np.int64))
        ord2 = np.argsort(key2)
    else:
        ord2 = np.lexsort((feat_s, -counts_s, grp_id))
    first_of_grp = np.empty(len(grp_key), bool)
    gid2 = grp_id[ord2]
    first_of_grp[0] = True
    first_of_grp[1:] = gid2[1:] != gid2[:-1]
    keep_rows = ord2[first_of_grp]

    keep_mask = np.zeros(len(labels_s), bool)
    keep_mask[keep_rows] = True
    keep_mask &= ~bad_track[labels_s]
    keep_mask &= images.registered[img_s]

    lab_k = labels_s[keep_mask]
    img_k = img_s[keep_mask]
    feat_k = feat_s[keep_mask]

    def _build(lab, img, feat):
        if len(lab) == 0:
            return Tracks.empty()
        # ``lab`` arrives sorted ascending, so dense track ids come from
        # adjacent diffs
        new_t = np.empty(len(lab), bool)
        new_t[0] = True
        np.not_equal(lab[1:], lab[:-1], out=new_t[1:])
        lab_dense = np.cumsum(new_t) - 1
        T = int(lab_dense[-1]) + 1
        uniq_labels = lab[new_t]
        lengths = np.bincount(lab_dense, minlength=T)
        offset = np.zeros(T + 1, np.int64)
        np.cumsum(lengths, out=offset[1:])
        return Tracks(
            xyz=np.zeros((T, 3)), color=np.zeros((T, 3), np.uint8),
            obs_image=img.astype(np.int32), obs_feature=feat.astype(np.int32),
            obs_offset=offset, track_id=uniq_labels.astype(np.int64))

    # ---- track length filter (the problem subset)
    tlen = np.bincount(lab_k, minlength=labels_s.max() + 1)
    good = (tlen[lab_k] >= int(opts["min_num_view_per_track"])) \
        & (tlen[lab_k] <= int(opts["max_num_view_per_track"]))
    tracks = _build(lab_k[good], img_k[good], feat_k[good])
    if return_full:
        return tracks, _build(lab_k, img_k, feat_k)
    return tracks
