"""The closed-form BA build (``solve/ba_closed.py``) against the engine's
``vmap(jacfwd)`` build of the same residual, on the CPU in float64.

Both run on one bucketed layout (tracks of 2 to 40 rows, padded tracks
and invalid rows, pixel noise that puts residuals on both sides of the
Huber threshold): the autodiff side is the same problem with its declared
residual taken away (``reproj=None``), so it builds through ``jacfwd`` with
the same sums.  Every field of ``NormalSystem`` and the per-row loss agree
to rtol 1e-9 of each field's largest entry (the same float64 arithmetic in
another order).  The dispatch test holds the path choice: only a declared
reprojection residual of a covered model with Huber's kernel, on a
bucketed layout, takes the closed form, and the run counters count each
build.  The card check's bounds (``chip_smoke.build_compare``) are held
here on the plain version in float32: its rounding count bounds the
plain version's own error, and a fault in the small entries (the
distortion parameter's gradient, its column of U, one row's W or loss)
fails them."""

import numpy as np
import pytest
import torch

import chip_smoke
from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.scene import cameras as cm
from instantsfm_tpu_torch.solve import ba_closed
from instantsfm_tpu_torch.solve import block_lm as tbl
from instantsfm_tpu_torch.solve import problems, robust
from instantsfm_tpu_torch.solve.blocked import bucketize_problem
from instantsfm_tpu_torch.utils import debug

F64 = torch.float64
INTRINSICS = {cm.SIMPLE_PINHOLE: [520.0, 320.0, 240.0],
              cm.PINHOLE: [520.0, 505.0, 320.0, 240.0],
              cm.SIMPLE_RADIAL: [520.0, 320.0, 240.0, 0.04],
              cm.RADIAL: [520.0, 320.0, 240.0, 0.04, -0.015],
              cm.OPENCV: [520.0, 505.0, 320.0, 240.0, 0.04, -0.01, 1e-3,
                          -1e-3]}
HUBER = robust.huber(1.0)


def _scene(model_id, seed=0, C=7, T=90):
    """Bucketed (params, observations, buckets) of a random scene seen by
    C cameras, in float64."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, 41, T)
    pt = np.repeat(np.arange(T), lengths)
    O = len(pt)
    cam = rng.integers(0, C, O)
    X = rng.uniform(-1, 1, (T, 3))
    ang = rng.normal(0, 0.1, (C, 3))
    q = np.concatenate([np.sin(ang / 2), np.ones((C, 1))], 1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.c_[rng.normal(0, 0.2, (C, 2)), rng.uniform(4, 6, C)]
    intr = np.zeros((C, cm.MAX_CAM_PARAMS))
    base = INTRINSICS[model_id]
    intr[:, :len(base)] = base
    intr[:, 0] *= rng.uniform(0.95, 1.05, C)
    d = lambda a, dt=F64: torch.tensor(a, dtype=dt)
    params = tbl.Params(cam={"q": d(q), "t": d(t), "intr": d(intr)},
                        pts=d(X), scales=torch.zeros((O, 1), dtype=F64),
                        scales_free=torch.zeros(O, dtype=torch.bool))
    # keypoints: the true projection plus noise of about the Huber delta
    xyz = lie.quat_rotate(d(q)[cam], d(X)[pt]) + d(t)[cam]
    xy = cm.img_from_cam(model_id, d(intr)[cam], xyz) \
        + d(rng.normal(0, 1.2, (O, 2)))
    obs = tbl.Observations(d(cam, torch.int32), d(pt, torch.int32),
                           {"x": xy[:, 0], "y": xy[:, 1]},
                           d(rng.uniform(size=O) > 0.1, torch.bool))
    return bucketize_problem(params, obs, track_pad=8)[:3]


CASES = [(m, poses) for m in ba_closed.MODELS for poses in (True, False)]
IDS = [f"{cm.CAMERA_MODEL_INFO[m]['name']}-{'poses' if p else 'frozen'}"
       for m, p in CASES]


def _both(model_id, poses):
    problem = problems.make_ba_problem(model_id, optimize_poses=poses)
    return (problem, problem._replace(reproj=None), HUBER,
            *_scene(model_id, seed=model_id + 10 * poses))


def _close(got, want, name):
    w = want.numpy()
    np.testing.assert_allclose(got.numpy(), w, rtol=1e-9,
                               atol=1e-9 * max(np.abs(w).max(), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("model_id,poses", CASES, ids=IDS)
def test_closed_build_matches_autodiff(model_id, poses):
    problem, autodiff, kernel, params, obs, buckets = _both(model_id, poses)
    assert ba_closed.covers(problem, kernel, buckets)
    T = params.pts.shape[0]
    got = tbl.build_system(problem, params, obs, kernel, T, buckets=buckets)
    want = tbl.build_system(autodiff, params, obs, kernel, T, buckets=buckets)
    assert got.U.shape == (7, problem.cam_dim, problem.cam_dim)
    # the layout pads tracks and rows, and the noise straddles the threshold
    assert not obs.valid.all() and 0 < float(want.cost) < np.inf
    for field in want._fields:
        _close(getattr(got, field), getattr(want, field), field)


@pytest.mark.parametrize("model_id,poses", CASES, ids=IDS)
def test_closed_loss_matches_autodiff(model_id, poses):
    problem, autodiff, kernel, params, obs, buckets = _both(model_id, poses)
    # at a candidate: every parameter moved a little
    params = params._replace(
        cam={k: v * 1.001 for k, v in params.cam.items()},
        pts=params.pts + 0.01)
    got = tbl.compute_loss_vec(problem, params, obs, kernel, buckets=buckets)
    want = tbl.compute_loss_vec(autodiff, params, obs, kernel,
                                buckets=buckets)
    assert torch.all(got[~obs.valid] == 0)
    _close(got, want, "loss_vec")


def test_huber_residuals_straddle_the_threshold():
    _, _, kernel, params, obs, buckets = _both(cm.SIMPLE_RADIAL, True)
    problem = problems.make_ba_problem(cm.SIMPLE_RADIAL)
    loss = tbl.compute_loss_vec(problem, params, obs, kernel,
                                buckets=buckets)[obs.valid]
    inside = (loss <= 1.0).float().mean().item()
    assert 0.2 < inside < 0.8, inside


UNCOVERED_MODELS = {"pinhole": cm.PINHOLE, "radial": cm.RADIAL,
                    "opencv": cm.OPENCV}
OTHER_KERNELS = {"trivial": robust.trivial(), "cauchy": robust.cauchy(0.7),
                 "geman_mcclure": robust.geman_mcclure(1.0)}


@pytest.mark.parametrize("case", ["ba", "gp", *UNCOVERED_MODELS,
                                  "unbucketed", *OTHER_KERNELS])
def test_build_path_follows_declared_residual(case):
    """The closed form only for a declared reprojection residual of a
    covered model (SIMPLE_PINHOLE, SIMPLE_RADIAL) with Huber's kernel on a
    bucketed layout; each build counts once in ``lm_build_closed`` or
    ``lm_build_autodiff``."""
    model_id = UNCOVERED_MODELS.get(case, cm.SIMPLE_RADIAL)
    problem = problems.make_ba_problem(model_id)
    kernel = OTHER_KERNELS.get(case, HUBER)
    params, obs, buckets = _scene(model_id, seed=3)
    if case == "gp":
        problem = problems.make_gp_problem()
        O = obs.valid.shape[0]
        g = torch.Generator().manual_seed(0)
        params = params._replace(cam={"c": params.cam["t"]},
                                 scales=torch.ones((O, 1), dtype=F64),
                                 scales_free=obs.valid.clone())
        obs = obs._replace(data={k: torch.randn(O, generator=g, dtype=F64)
                                 for k in ("tx", "ty", "tz", "w")})
    elif case == "unbucketed":
        buckets = ()
    closed = case == "ba"
    assert ba_closed.covers(problem, kernel, buckets) == closed
    debug.drain_stats()
    for _ in range(2):
        tbl.build_system(problem, params, obs, kernel, params.pts.shape[0],
                         buckets=buckets)
    stats = debug.drain_stats()
    taken, other = (("lm_build_closed", "lm_build_autodiff") if closed
                    else ("lm_build_autodiff", "lm_build_closed"))
    assert stats[taken] == [1, 1] and other not in stats


def test_closed_build_holds_no_scale_products():
    """Without a scale block the closed form's scale outputs are zeros of
    the solve's shapes that take no memory a row."""
    problem, _, kernel, params, obs, buckets = _both(cm.SIMPLE_RADIAL, True)
    sys = tbl.build_system(problem, params, obs, kernel, params.pts.shape[0],
                           buckets=buckets)
    O, PC = obs.valid.shape[0], problem.cam_dim
    for name, shape in (("Hss", (O,)), ("Jc_s", (O, PC)), ("Jp_s", (O, 3)),
                        ("g_s", (O,))):
        a = getattr(sys, name)
        assert a.shape == shape and not a.any() and a.stride()[0] == 0, name


def _f32_check_inputs(model_id, poses):
    """A float32 problem of 30 cameras (``chip_smoke.build_inputs``), with
    the plain version in float32 and float64 and the rounding counts."""
    rng = np.random.default_rng(2)
    lengths = rng.choice([2, 3, 5, 8, 13, 30, 64], size=600,
                         p=[.25, .2, .2, .15, .1, .06, .04])
    problem, params, obs, buckets = chip_smoke.build_inputs(
        model_id, poses, 30, lengths, torch.float32, "cpu")
    want = chip_smoke.build_plain(problem, params, obs, HUBER, buckets,
                                  torch.float32)[0]
    ref, counts = chip_smoke.build_plain(problem, params, obs, HUBER,
                                         buckets, F64, counts=True)
    return problem, obs, want, ref, counts


@pytest.mark.parametrize("model_id,poses", CASES, ids=IDS)
def test_rounding_count_bounds_the_plain_float32_build(model_id, poses):
    """The rounding count bounds the float32 plain version's own error
    against float64 at each entry, with room: within a quarter of the
    card check's BUILD_ULPS unit roundoffs of it."""
    _, _, want, ref, counts = _f32_check_inputs(model_id, poses)
    u = torch.finfo(torch.float32).eps / 2
    for k in chip_smoke.BUILD_FIELDS:
        err = (want[k].double() - ref[k]).abs()
        assert torch.all(err <= chip_smoke.BUILD_ULPS / 4 * u * counts[k]), k


BUILD_FAULTS = ["sound", "g_cam_k", "U_k_column", "V_entry", "g_pt_entry",
                "W_row", "loss_row", "loss_mode_row"]


@pytest.mark.parametrize("fault", BUILD_FAULTS)
def test_build_check_rejects_a_faulty_float32_build(fault):
    """``chip_smoke.build_compare``'s float32 bound, entry by entry, passes
    the plain version and fails a build with one small part wrong: the
    gradient of SIMPLE_RADIAL's distortion parameter k (the last entry of
    g_cam) or k's row and column of U zeroed, one entry of V or g_pt, or
    one row's W or loss zeroed."""
    problem, obs, want, ref, counts = _f32_check_inputs(cm.SIMPLE_RADIAL,
                                                        True)
    got = {k: v.clone() for k, v in want.items()}
    got["loss_mode"] = want["loss_vec"].clone()
    row = int(torch.nonzero(want["loss_vec"] > 0.5)[0, 0])
    pt = int(torch.nonzero(want["V"][:, 2, 2])[0, 0])
    if fault == "g_cam_k":
        got["g_cam"][:, -1] = 0
    elif fault == "U_k_column":
        got["U"][:, -1, :] = 0
        got["U"][:, :, -1] = 0
    elif fault == "V_entry":
        got["V"][pt, 2, 2] = 0
    elif fault == "g_pt_entry":
        got["g_pt"][pt, 2] = 0
    elif fault == "W_row":
        got["W"][row] = 0
    elif fault == "loss_row":
        got["loss_vec"][row] = 0
    elif fault == "loss_mode_row":
        got["loss_mode"][row] = 0
    field = {"g_cam_k": "g_cam", "U_k_column": "U", "V_entry": "V",
             "g_pt_entry": "g_pt", "W_row": "W", "loss_row": "loss_vec",
             "loss_mode_row": "loss_mode"}.get(fault)
    if field is None:
        worst, _, _ = chip_smoke.build_compare("sound", got, want, ref,
                                               counts)
        assert worst <= 1.0
        return
    with pytest.raises(AssertionError, match=f": {field}: "):
        chip_smoke.build_compare(fault, got, want, ref, counts)
