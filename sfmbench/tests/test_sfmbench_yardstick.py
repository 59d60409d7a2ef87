"""The frozen yardstick on small cases, on the CPU.

    python -m pytest sfmbench/tests -q
"""

import sqlite3
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from yardstick import ba_reference as ref  # noqa: E402
from yardstick import model, ring, roofline, trace  # noqa: E402

SMALL = dict(num_cams=16, num_pts=2000, width=640, height=480,
             intrinsics=[520.0, 320.0, 240.0, 0.01], vis_angle=0.9,
             window=4, match_noise=0.4, outlier_frac=0.08, scene_scale=1.0,
             max_matches_per_pair=0)


def test_lm_step_cost_by_hand():
    # one observation, camera, point and camera parameter, one CG step:
    # floats an observation 82 (build) + 17 (preconditioner) + 22 (CG)
    # + 29 (cost) = 150; small arrays (1 * 1 * 4 + 9 * 5) floats
    c = roofline.lm_step_cost(O=1, C=1, T=1, PC=1, cg_iters=1,
                              onehot_cam_reduce=False)
    assert c.hbm_bytes == 4 * 150 + 4 * 49
    # Jacobian chains 2 * 5 * 30, products 2 * 2 * 17, camera sums
    # 2 * 4, the CG matvecs 12 + 30
    assert c.flops == 300 + 68 + 8 + 42


def test_k1_cost_by_hand():
    # two observations of one point in one camera with two parameters:
    # W (6 floats) and two ids a row, V^-1 once, x and y once
    c = roofline.k1_cost(O=2, C=1, T=1, PC=2)
    assert c.hbm_bytes == 2 * (24 + 8) + 36 + 16
    assert c.flops == 2 * (12 + 3 + 12 + 2) + 15


def test_chip_spec_refuses_an_unknown_card():
    assert roofline.chip_spec("NVIDIA H100 80GB HBM3") is roofline.H100_SXM
    with pytest.raises(ValueError):
        roofline.chip_spec("cpu")


def test_bound_is_the_slowest_resource():
    spec = roofline.H100_SXM
    assert roofline.bound_s(67e12, 0.0, spec=spec) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 3.35e12, spec=spec) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 3.35e12, 1.0, spec=spec) == \
        pytest.approx(1.0)


def test_ring_database_is_a_colmap_database(tmp_path):
    scene = ring.make_scene(SMALL, 7)
    pairs, matches = ring.write_database(tmp_path / "db.db", scene, SMALL)
    conn = sqlite3.connect(tmp_path / "db.db")
    try:
        assert conn.execute("SELECT COUNT(*) FROM images").fetchone()[0] == 16
        assert conn.execute(
            "SELECT SUM(rows) FROM matches").fetchone()[0] == matches
        assert conn.execute(
            "SELECT COUNT(*) FROM two_view_geometries").fetchone()[0] == pairs
        rows, cols, blob = conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id = 3"
        ).fetchone()
    finally:
        conn.close()
    kp = np.frombuffer(blob, np.float32).reshape(rows, cols)
    np.testing.assert_allclose(kp, scene["kps"][2], atol=1e-4)
    # the keypoints are the true projections plus about 0.4 px of noise
    i = 5
    xy, _ = ring.project(np.broadcast_to(scene["R"][i], (len(scene["seen"][i]), 3, 3)),
                         np.broadcast_to(scene["t"][i], (len(scene["seen"][i]), 3)),
                         np.broadcast_to(scene["intr"], (len(scene["seen"][i]), 4)),
                         scene["points"][scene["seen"][i]])
    assert 0.3 < np.std(scene["kps"][i] - xy) < 0.5


def test_same_seed_same_inputs():
    a, b = ring.make_scene(SMALL, 3000000000), ring.make_scene(SMALL, 3000000000)
    np.testing.assert_array_equal(a["points"], b["points"])
    np.testing.assert_array_equal(a["kps"][4], b["kps"][4])


def test_quaternion_round_trip():
    R = np.stack([ring.look_at_origin(np.array([8 * np.cos(a), 8 * np.sin(a), 1.0]))
                  for a in np.linspace(0, 6, 9)])
    q = ring.matrix_to_quat_xyzw(R)
    back = ref.quat_xyzw_to_matrix(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(back, R, atol=1e-12)


def test_umeyama_recovers_a_similarity():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((50, 3))
    R = ref.rodrigues(torch.tensor([0.3, -0.2, 0.5], dtype=torch.float64)).numpy()
    dst = 2.5 * src @ R.T + np.array([1.0, -2.0, 0.5])
    s, Ra, t = model.umeyama(src, dst)
    assert s == pytest.approx(2.5)
    np.testing.assert_allclose(Ra, R, atol=1e-12)


def test_reference_adjuster_reaches_the_noise_floor():
    scene = ring.make_scene(SMALL, 11)
    obs = ring.ba_observations(scene)
    X = scene["points"][obs["point_ids"]]
    C = len(scene["R"])
    intr = np.tile(scene["intr"], (C, 1))
    rng = np.random.default_rng(1)
    x0 = (torch.as_tensor(scene["R"]), torch.as_tensor(scene["t"] + 0.05 * rng.standard_normal((C, 3))),
          torch.as_tensor(intr), torch.as_tensor(X + 0.05 * rng.standard_normal(X.shape)))
    prob = ref.Problem(obs["cam"], obs["pt"], obs["xy"], C, len(X), 1.0,
                       torch.float64, torch.device("cpu"))
    x, cost, _ = ref.solve(prob, x0, max_steps=40, rel_tol=1e-14)
    r, _ = prob.residuals(x)
    # at the optimum the residuals are the keypoint noise (0.4 px a axis)
    assert 0.3 < float(torch.sqrt(torch.mean(r * r))) < 0.45
    _, _, _, g_c, g_p = prob.normal_equations(x)
    g0 = prob.normal_equations(x0)[3]
    assert float(g_c.norm()) < 1e-6 * float(g0.norm())


def test_segments_label_the_innermost_scope():
    seg = trace._segments([(0, 100, "outer"), (10, 20, "inner"),
                           (30, 40, "other")])
    assert trace._label_at(seg, 5) == "outer"
    assert trace._label_at(seg, 15) == "inner"
    assert trace._label_at(seg, 25) == "outer"
    assert trace._label_at(seg, 35) == "other"
    assert trace._label_at(seg, 150) is None
