"""Reconstruction pruning: strong clusters of the visibility graph.

Counterpart of ``instantsfm_tpu/pipeline/pruning.py``, host numpy and scipy
as there:
* the visibility count of an image pair is the number of tracks (with more
  than 2 observations) both images observe: the sparse Gram matrix AᵀA of
  the track/image incidence matrix;
* pairs with a count >= 5 form the visibility graph; the threshold is
  max(median - MAD, 20);
* ``establish_strong_clusters`` joins the pairs above the threshold, then
  merges two clusters joined by at least 2 pairs of >= 0.75 of the
  threshold, for at most 10 rounds; the components, ranked by size, become
  ``images.cluster_id`` (images outside the graph get -1).
"""

from __future__ import annotations

import numpy as np

from instantsfm_tpu_torch.scene.types import Images, Tracks


class _UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n)

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, x, y):
        rx, ry = self.find(x), self.find(y)
        if rx != ry:
            self.parent[rx] = ry


def _visibility_counts(images: Images, tracks: Tracks):
    """(pair_i, pair_j, count) of the tracks each image pair co-observes."""
    import scipy.sparse as sp

    track_idx = tracks.obs_track_idx()
    keep = tracks.track_lengths()[track_idx] > 2
    t, i = track_idx[keep], tracks.obs_image[keep]
    if len(t) == 0:
        return (np.zeros(0, np.int64),) * 3
    A = sp.coo_matrix((np.ones(len(t), np.int64), (t, i)),
                      shape=(tracks.num_tracks, images.num_images)).tocsr()
    G = (A.T @ A).tocoo()
    mask = (G.row < G.col) & (G.data > 0)
    return G.row[mask], G.col[mask], G.data[mask]


def establish_strong_clusters(pair_i, pair_j, weight, images: Images,
                              threshold: float, log=print) -> int:
    """Sets ``images.cluster_id``; returns the number of clusters."""
    n = images.num_images
    uf = _UnionFind(n)
    strong = weight > threshold
    for a, b in zip(pair_i[strong], pair_j[strong]):
        uf.union(int(a), int(b))

    weakish = weight >= 0.75 * threshold
    wi, wj = pair_i[weakish], pair_j[weakish]

    iteration = 0
    changed = True
    while changed and iteration < 10:
        changed = False
        iteration += 1
        roots1 = np.array([uf.find(int(a)) for a in wi])
        roots2 = np.array([uf.find(int(b)) for b in wj])
        diff = roots1 != roots2
        if not diff.any():
            break
        lo = np.minimum(roots1[diff], roots2[diff]).astype(np.int64)
        hi = np.maximum(roots1[diff], roots2[diff]).astype(np.int64)
        uniq, counts = np.unique(lo * n + hi, return_counts=True)
        for k in uniq[counts >= 2]:
            uf.union(int(k // n), int(k % n))
            changed = True

    labels = np.array([uf.find(i) for i in range(n)])
    # only the images of the visibility graph get clusters
    in_graph = np.zeros(n, bool)
    in_graph[pair_i] = True
    in_graph[pair_j] = True
    images.cluster_id = np.full(n, -1, np.int32)
    if in_graph.any():
        uniq, inv = np.unique(labels[in_graph], return_inverse=True)
        order = np.argsort(-np.bincount(inv))
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        images.cluster_id[in_graph] = rank[inv].astype(np.int32)
    num_comp = int(in_graph.any() and len(np.unique(labels[in_graph])))
    log(f"Clustering took {iteration} iterations. Images are grouped into "
        f"{num_comp} clusters after strong-clustering")
    return num_comp


def prune_weakly_connected_images(images: Images, tracks: Tracks,
                                  log=print) -> int:
    """Marks ``images.cluster_id``; returns the number of clusters."""
    pi, pj, counts = _visibility_counts(images, tracks)
    strong = counts >= 5
    pi, pj, counts = pi[strong], pj[strong], counts[strong]
    log(f"Established visibility graph with {len(pi)} pairs")
    if len(pi) == 0:
        return 0
    sorted_counts = np.sort(counts)
    median = sorted_counts[len(sorted_counts) // 2]
    mad = np.sort(np.abs(sorted_counts - median))[len(sorted_counts) // 2]
    threshold = max(median - mad, 20)
    log(f"Threshold for Strong Clustering: {median - mad}")
    return establish_strong_clusters(pi, pj, counts, images, threshold,
                                     log=log)
