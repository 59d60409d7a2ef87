"""COLMAP SQLite database layer (read + write) over the flat scene types.

Counterpart of ``instantsfm_tpu/io/colmap_db.py`` (the standard COLMAP
database schema): the writer ``ColmapDatabase`` and ``read_colmap_database``,
which decodes blobs straight into the CSR arrays of ``scene.types``.

External ids are re-indexed to dense 0..N-1 on read.
"""

from __future__ import annotations

import sqlite3
from typing import Tuple

import numpy as np

from instantsfm_tpu_torch.scene import cameras as cam_models
from instantsfm_tpu_torch.scene.types import (
    CONFIG_DEGENERATE, CONFIG_MULTIPLE, CONFIG_UNDEFINED, CONFIG_WATERMARK,
    Cameras, Images, ViewGraph, pair_id_to_ids, ids_to_pair_id)

MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
CREATE TABLE IF NOT EXISTS pose_priors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    position BLOB, coordinate_system INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS feature_name (
    feature_name TEXT PRIMARY KEY NOT NULL);
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
"""

_INVALID_CONFIGS = (CONFIG_UNDEFINED, CONFIG_DEGENERATE, CONFIG_WATERMARK,
                    CONFIG_MULTIPLE)


def array_to_blob(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def blob_to_array(blob, dtype, shape=(-1,)) -> np.ndarray:
    if blob is None:
        return np.zeros((0,) if shape == (-1,) else shape, dtype=dtype)
    return np.frombuffer(blob, dtype=dtype).reshape(*shape)


class ColmapDatabase:
    """Thin wrapper over sqlite3 with schema creation + batch add APIs."""

    def __init__(self, conn: sqlite3.Connection):
        self.conn = conn

    @classmethod
    def connect(cls, path) -> "ColmapDatabase":
        return cls(sqlite3.connect(str(path)))

    def create_tables(self) -> None:
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    def close(self) -> None:
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.conn.commit()
        self.conn.close()

    # ------------------------------------------------------------- writers

    def add_camera(self, model_id, width, height, params, prior_focal=False,
                   camera_id=None) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, int(model_id), int(width), int(height),
             array_to_blob(np.asarray(params, np.float64)), int(prior_focal)))
        return cur.lastrowid

    def add_image(self, name, camera_id, image_id=None) -> int:
        cur = self.conn.execute("INSERT INTO images VALUES (?, ?, ?)",
                                (image_id, name, int(camera_id)))
        return cur.lastrowid

    def add_keypoints(self, image_id, keypoints: np.ndarray) -> None:
        keypoints = np.asarray(keypoints, np.float32)
        self.conn.execute("INSERT INTO keypoints VALUES (?, ?, ?, ?)",
                          (int(image_id), keypoints.shape[0], keypoints.shape[1],
                           array_to_blob(keypoints)))

    def add_descriptors(self, image_id, descriptors: np.ndarray) -> None:
        descriptors = np.ascontiguousarray(descriptors, np.uint8)
        self.conn.execute("INSERT INTO descriptors VALUES (?, ?, ?, ?)",
                          (int(image_id), descriptors.shape[0], descriptors.shape[1],
                           array_to_blob(descriptors)))

    def add_matches(self, image_id1, image_id2, matches: np.ndarray) -> None:
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = ids_to_pair_id(np.int64(image_id1), np.int64(image_id2))
        matches = np.asarray(matches, np.uint32)
        self.conn.execute("INSERT INTO matches VALUES (?, ?, ?, ?)",
                          (int(pair_id), matches.shape[0], matches.shape[1],
                           array_to_blob(matches)))

    def add_two_view_geometry(self, image_id1, image_id2, matches, F=None, E=None,
                              H=None, qvec=None, tvec=None, config=2) -> None:
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = ids_to_pair_id(np.int64(image_id1), np.int64(image_id2))
        matches = np.asarray(matches, np.uint32)
        F = np.asarray(F if F is not None else np.eye(3), np.float64)
        E = np.asarray(E if E is not None else np.eye(3), np.float64)
        H = np.asarray(H if H is not None else np.eye(3), np.float64)
        qvec = np.asarray(qvec if qvec is not None else [1, 0, 0, 0], np.float64)
        tvec = np.asarray(tvec if tvec is not None else np.zeros(3), np.float64)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (int(pair_id), matches.shape[0], matches.shape[1], array_to_blob(matches),
             int(config), array_to_blob(F), array_to_blob(E), array_to_blob(H),
             array_to_blob(qvec), array_to_blob(tvec)))

    def set_feature_name(self, name: str) -> None:
        self.conn.execute("INSERT OR REPLACE INTO feature_name VALUES (?)", (name,))


def read_colmap_database(path) -> Tuple[ViewGraph, Cameras, Images, str]:
    """Load db -> (view_graph, cameras, images, feature_name), ids densified.

    Behavior parity with reference ``ReadColmapDatabase``
    (``controllers/data_reader.py:38-120``): invalid-config pairs dropped,
    out-of-range match indices dropped, dense re-indexing of camera/image ids.
    """
    db = sqlite3.connect(str(path))

    cam_rows = db.execute("SELECT camera_id, model, width, height, params, "
                          "prior_focal_length FROM cameras").fetchall()
    cam_rows.sort(key=lambda r: r[0])
    cam_id2idx = {r[0]: i for i, r in enumerate(cam_rows)}
    C = len(cam_rows)
    cameras = Cameras(
        model_ids=np.array([r[1] for r in cam_rows], np.int32),
        widths=np.array([r[2] for r in cam_rows], np.int64),
        heights=np.array([r[3] for r in cam_rows], np.int64),
        params=np.stack([cam_models.pad_params(blob_to_array(r[4], np.float64))
                         for r in cam_rows]) if C else np.zeros((0, 12)),
        has_prior_focal=np.array([r[5] > 0 for r in cam_rows], bool),
        has_refined_focal=np.zeros(C, bool),
    )

    img_rows = db.execute("SELECT image_id, name, camera_id FROM images").fetchall()
    img_rows.sort(key=lambda r: r[0])
    img_id2idx = {r[0]: i for i, r in enumerate(img_rows)}
    N = len(img_rows)

    kp_arrays = [np.zeros((0, 2), np.float64)] * N
    for image_id, cols, data in db.execute(
            "SELECT image_id, cols, data FROM keypoints"):
        if data is None or image_id not in img_id2idx:
            continue
        kp = blob_to_array(data, np.float32, (-1, cols))
        kp_arrays[img_id2idx[image_id]] = kp[:, :2].astype(np.float64)

    kp_offset = np.zeros(N + 1, np.int64)
    np.cumsum([len(a) for a in kp_arrays], out=kp_offset[1:])
    images = Images(
        cam_idx=np.array([cam_id2idx[r[2]] for r in img_rows], np.int32),
        names=[r[1] for r in img_rows],
        qvec=np.tile(np.array([0., 0., 0., 1.]), (N, 1)),
        tvec=np.zeros((N, 3)),
        registered=np.zeros(N, bool),
        cluster_id=np.full(N, -1, np.int32),
        kp_xy=np.concatenate(kp_arrays, axis=0) if N else np.zeros((0, 2)),
        kp_offset=kp_offset,
    )

    rows = db.execute(
        "SELECT m.pair_id, m.data, t.config, t.F, t.E, t.H FROM matches AS m "
        "INNER JOIN two_view_geometries AS t ON m.pair_id = t.pair_id").fetchall()

    pair_i, pair_j, configs, Fs, Es, Hs, match_arrays = [], [], [], [], [], [], []
    invalid = 0
    for pair_id, data, config, Fb, Eb, Hb in rows:
        if data is None or config in _INVALID_CONFIGS:
            invalid += 1
            continue
        id1, id2 = pair_id_to_ids(pair_id)
        if id1 not in img_id2idx or id2 not in img_id2idx:
            invalid += 1
            continue
        i, j = img_id2idx[id1], img_id2idx[id2]
        m = blob_to_array(data, np.uint32, (-1, 2)).astype(np.int64)
        n1 = images.num_keypoints(i)
        n2 = images.num_keypoints(j)
        ok = (m[:, 0] >= 0) & (m[:, 1] >= 0) & (m[:, 0] < n1) & (m[:, 1] < n2)
        m = m[ok]
        pair_i.append(min(i, j))
        pair_j.append(max(i, j))
        if i > j:  # dense re-index may reorder; keep (i<j, matches aligned)
            m = m[:, ::-1]
        configs.append(config)
        Fs.append(blob_to_array(Fb, np.float64, (3, 3)) if Fb else np.eye(3))
        Es.append(blob_to_array(Eb, np.float64, (3, 3)) if Eb else np.eye(3))
        Hs.append(blob_to_array(Hb, np.float64, (3, 3)) if Hb else np.eye(3))
        match_arrays.append(m.astype(np.int32))

    E_num = len(pair_i)
    match_offset = np.zeros(E_num + 1, np.int64)
    np.cumsum([len(m) for m in match_arrays], out=match_offset[1:])
    all_matches = (np.concatenate(match_arrays, axis=0)
                   if E_num else np.zeros((0, 2), np.int32))
    view_graph = ViewGraph(
        pair_i=np.array(pair_i, np.int32), pair_j=np.array(pair_j, np.int32),
        valid=np.ones(E_num, bool),
        config=np.array(configs, np.int8),
        E_mat=np.stack(Es) if E_num else np.zeros((0, 3, 3)),
        F_mat=np.stack(Fs) if E_num else np.zeros((0, 3, 3)),
        H_mat=np.stack(Hs) if E_num else np.zeros((0, 3, 3)),
        qvec=np.tile(np.array([0., 0., 0., 1.]), (E_num, 1)),
        tvec=np.zeros((E_num, 3)),
        matches=all_matches,
        match_offset=match_offset,
        inlier_mask=np.ones(len(all_matches), bool),
    )

    try:
        feature_name = db.execute(
            "SELECT feature_name FROM feature_name").fetchone()[0]
    except Exception:
        feature_name = "colmap"
    db.close()
    return view_graph, cameras, images, feature_name
