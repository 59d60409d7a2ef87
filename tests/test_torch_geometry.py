"""Port parity: Lie ops and the 11 camera models, torch (float64, CPU)
against the JAX package (x64).

Tolerance: both sides evaluate the same formulas in float64; differences
come only from operation order (e.g. the tangential terms are summed in
another order), so 1e-12 relative on O(1)..O(1e3) values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsfm_tpu.math import lie as jlie
from instantsfm_tpu.scene import cameras as jcm
from instantsfm_tpu_torch.math import lie as tlie
from instantsfm_tpu_torch.scene import cameras as tcm
from tests.test_cameras import MODEL_PARAMS

RTOL, ATOL = 1e-12, 1e-12


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


LIE_CASES = {
    "quat_normalize": lambda m, r: (m.quat_normalize, [r.standard_normal((16, 4))]),
    "quat_mul": lambda m, r: (m.quat_mul, [_quats(r, 16), _quats(r, 16)]),
    "quat_rotate": lambda m, r: (m.quat_rotate, [_quats(r, 16),
                                                 r.standard_normal((16, 3))]),
    "quat_to_matrix": lambda m, r: (m.quat_to_matrix, [_quats(r, 16)]),
    "matrix_to_quat": lambda m, r: (
        m.matrix_to_quat,
        [np.asarray(jlie.quat_to_matrix(jnp.asarray(_quats(r, 16))))]),
    "so3_exp": lambda m, r: (m.so3_exp, [np.concatenate(
        [r.standard_normal((15, 3)), np.full((1, 3), 1e-6)])]),
    "se3_action": lambda m, r: (m.se3_action, [_quats(r, 16), r.standard_normal(
        (16, 3)), r.standard_normal((16, 3))]),
    "se3_retract": lambda m, r: (m.se3_retract, [
        _quats(r, 16), r.standard_normal((16, 3)),
        0.1 * r.standard_normal((16, 6))]),
    "quat_conj": lambda m, r: (m.quat_conj, [_quats(r, 16)]),
    "quat_rotate_inv": lambda m, r: (m.quat_rotate_inv, [
        _quats(r, 16), r.standard_normal((16, 3))]),
    # both hemispheres, and rotations below the Taylor switch
    "so3_log": lambda m, r: (m.so3_log, [np.concatenate(
        [_quats(r, 14), [[1e-7, -2e-7, 3e-8, 1.0], [-1e-7, 0, 0, -1.0]]])]),
    "camera_center": lambda m, r: (m.camera_center, [
        _quats(r, 16), r.standard_normal((16, 3))]),
    "rotation_geodesic_angle": lambda m, r: (m.rotation_geodesic_angle, [
        _quats(r, 16), _quats(r, 16)]),
    "rotvec_to_matrix": lambda m, r: (m.rotvec_to_matrix, [
        r.standard_normal((16, 3))]),
    "matrix_to_rotvec": lambda m, r: (
        m.matrix_to_rotvec,
        [np.asarray(jlie.quat_to_matrix(jnp.asarray(_quats(r, 16))))]),
}


@pytest.mark.parametrize("name", sorted(LIE_CASES))
def test_lie_matches_jax(name):
    jfn, args = LIE_CASES[name](jlie, np.random.default_rng(0))
    tfn, targs = LIE_CASES[name](tlie, np.random.default_rng(0))
    want = jfn(*[jnp.asarray(a) for a in args])
    got = tfn(*[_t(a) for a in targs])
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_se3_action_np_matches_jax(rng):
    q, t, p = _quats(rng, 32), rng.standard_normal((32, 3)), rng.standard_normal((32, 3))
    _close(tlie.se3_action_np(q, t, p),
           jlie.se3_action(jnp.asarray(q), jnp.asarray(t), jnp.asarray(p)))


CAMERA_FNS = ("distort", "undistort", "img_from_cam", "cam_from_img",
              "bearing_from_img")


def _camera_inputs(fn, rng):
    if fn in ("distort", "undistort"):
        return rng.uniform(-0.3, 0.3, (32, 2))
    if fn == "img_from_cam":
        uv = rng.uniform(-0.3, 0.3, (32, 2))
        return np.concatenate([uv, np.ones((32, 1))], -1) * rng.uniform(1, 5, (32, 1))
    return rng.uniform(100, 500, (32, 2))


@pytest.mark.parametrize("fn", CAMERA_FNS)
@pytest.mark.parametrize("model_id", sorted(MODEL_PARAMS))
def test_camera_fn_matches_jax(model_id, fn, rng):
    params = jcm.pad_params(MODEL_PARAMS[model_id])
    x = _camera_inputs(fn, rng)
    want = getattr(jcm, fn)(model_id, jnp.asarray(params), jnp.asarray(x))
    got = getattr(tcm, fn)(model_id, _t(params), _t(x))
    _close(got, want, rtol=1e-11, atol=1e-11)


def test_camera_fn_batched_params(rng):
    """Per-row params [N, 12] (the BA residual's layout) broadcast like JAX."""
    base = jcm.pad_params(MODEL_PARAMS[jcm.OPENCV])
    params = base[None] * (1 + 0.01 * rng.standard_normal((32, 12)))
    xyz = np.concatenate([rng.uniform(-0.3, 0.3, (32, 2)), np.ones((32, 1))], -1)
    want = jcm.img_from_cam(jcm.OPENCV, jnp.asarray(params), jnp.asarray(xyz))
    _close(tcm.img_from_cam(tcm.OPENCV, _t(params), _t(xyz)), want)


def test_model_info_and_pad_params_match():
    assert tcm.CAMERA_MODEL_INFO == jcm.CAMERA_MODEL_INFO
    np.testing.assert_array_equal(tcm.pad_params([1.0, 2.0]),
                                  jcm.pad_params([1.0, 2.0]))


def test_world2cam_matches_jax(rng):
    from instantsfm_tpu.scene import types as jtypes
    from instantsfm_tpu_torch.scene import types as ttypes
    fields = (np.zeros(4, np.int32), [f"{i}" for i in range(4)], _quats(rng, 4),
              rng.standard_normal((4, 3)), np.ones(4, bool),
              np.zeros(4, np.int32), np.zeros((0, 2)), np.zeros(5, np.int64))
    ji, ti = jtypes.Images(*fields), ttypes.Images(*fields)
    for i in range(4):
        _close(ti.world2cam(i), ji.world2cam(i))
