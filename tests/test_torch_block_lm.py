"""Port parity for the LM engine: robust kernels, PCG, build_system,
lm_step (BA PC=8 and GP PC=3, PCG and dense Schur) and optimize, torch
(float64, CPU) against the JAX package (x64); plus convergence to ground
truth mirroring tests/test_block_lm.py.

Tolerances: build_system runs the same float64 arithmetic (rtol 1e-9 of
each block's largest entry: sums in another order).  lm_step: cost rtol
1e-5, cameras rtol 1e-4 / atol 1e-5, as tests/test_camsort.py holds two
JAX paths to each other (PCG stops on a residual test, so summation order
moves the iterate slightly)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsfm_tpu.solve import block_lm as jbl
from instantsfm_tpu.solve import robust as jrobust
from instantsfm_tpu.solve.blocked import bucketize_problem
from instantsfm_tpu_torch import convert
from instantsfm_tpu_torch.solve import block_lm as tbl
from instantsfm_tpu_torch.solve import pcg as tpcg
from instantsfm_tpu_torch.solve import problems as tproblems
from instantsfm_tpu_torch.solve import robust as trobust
from instantsfm_tpu_torch.solve.pcg import pcg
from instantsfm_tpu_torch.utils import debug
from tests.synthetic import make_scene
from tests.test_block_lm import _ba_setup
from tests.test_sharded import _gp_setup

F64 = torch.float64


def _to_torch(params, obs, buckets=()):
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return convert.from_numpy(as_np(params), as_np(obs), buckets,
                              device="cpu", dtype=F64)


def _setup(kind, bucketed=True, noise=0.0):
    """(jax problem, torch problem, jax params/obs, torch params/obs, buckets)"""
    if kind == "ba":
        problem, params, obs = _ba_setup(make_scene(num_cams=12, num_pts=300,
                                                    seed=5, noise=noise))
        tproblem = tproblems.make_ba_problem(2)
    else:
        problem, params, obs = _gp_setup(seed=3)
        tproblem = tproblems.make_gp_problem()
    buckets = ()
    if bucketed:
        params, obs, buckets, _ = bucketize_problem(params, obs, track_pad=16)
    tparams, tobs, buckets = _to_torch(params, obs, buckets)
    return problem, tproblem, params, obs, tparams, tobs, buckets


def _tstate(params, lam):
    z = torch.zeros((), dtype=F64)
    return tbl.LMState(params, torch.tensor(lam, dtype=F64),
                       torch.tensor(float("inf"), dtype=F64), z, z)


def test_pcg_solves_spd_system(rng):
    n = 40
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)
    At = torch.tensor(A)
    x, res, iters = pcg(lambda v: At @ v, torch.tensor(b), max_iters=200,
                        tol=1e-10)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), atol=1e-6)
    assert isinstance(iters, int) and 0 < iters <= 200


def _blocked_pcg(matvec, b, precond, max_iters, tol, block):
    """The predicated iteration run eagerly in blocks of ``block``, as the
    CUDA graphs replay it: (x, iters, pcg.exit reads)."""
    st = tpcg.pcg_state(b)
    run = partial(tpcg.pcg_block, matvec, precond, st, max_iters, n=block)

    def first():
        tpcg.pcg_start(matvec, precond, b, st, max_iters, tol)
        run()

    with debug.span("test.pcg_blocks"):
        iters = tpcg.run_blocks(first, run, st.status)
    reads = debug.REGISTRY.roots("test.pcg_blocks")[-1]["reads"]["pcg.exit"]
    return st.x, iters, reads[0]


def _spd_case(n, dtype, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = torch.tensor(A @ A.T + np.eye(n), dtype=dtype)
    D_inv = torch.diag(1.0 / torch.diagonal(A))
    b = torch.tensor(rng.standard_normal(n), dtype=dtype)
    return (lambda v: A @ v), b, (lambda v: D_inv @ v)


def _schur_case(monkeypatch):
    """The Schur operator, preconditioner and right-hand side that a damped
    solve of a small bucketed BA problem hands its PCG (K1's plain
    version)."""
    _, tproblem, _, _, tparams, tobs, buckets = _setup("ba", noise=0.5)
    sys = tbl.build_system(tproblem, tparams, tobs, trobust.huber(1.0),
                           tparams.pts.shape[0], buckets=buckets)
    seen = {}

    def spy(matvec, b, precond, **kw):
        seen.update(matvec=matvec, b=b, precond=precond)
        return pcg(matvec, b, precond, **kw)

    monkeypatch.setattr(tbl, "pcg", spy)
    tbl.solve_damped(tproblem, sys, tobs, torch.tensor(1e-4, dtype=F64),
                     dense_schur=False, buckets=buckets)
    return seen["matvec"], seen["b"], seen["precond"]


@pytest.mark.parametrize("case,block,max_iters,tol,mid_block", [
    ("spd_f64", 4, 200, 1e-10, True),
    ("spd_f32", 4, 200, 1e-5, True),
    ("max_iters", 4, 10, 0.0, True),      # 10 is no multiple of 4
    ("zero_rhs", 4, 100, 1e-5, False),
    ("ba_schur", 4, 100, 1e-8, True),
    ("ba_schur_block8", 8, 100, 1e-8, True),
])
def test_pcg_blocks_match_loop(case, block, max_iters, tol, mid_block,
                               monkeypatch):
    """The predicated iteration in blocks (what the CUDA graphs record)
    against the eager loop: the same iteration count, x bit for bit, and
    one read a block."""
    if case.startswith("ba_schur"):
        matvec, b, precond = _schur_case(monkeypatch)
    else:
        dtype = torch.float32 if case == "spd_f32" else F64
        matvec, b, precond = _spd_case(40, dtype, seed=7)
        if case == "zero_rhs":
            b = torch.zeros_like(b)
    x_loop, _, it_loop = pcg(matvec, b, precond, max_iters=max_iters,
                             tol=tol)
    x, iters, reads = _blocked_pcg(matvec, b, precond, max_iters, tol, block)
    assert iters == it_loop
    assert (iters % block != 0) == mid_block, iters
    assert torch.equal(x, x_loop)
    assert reads == max(1, -(-iters // block))
    if case == "zero_rhs":
        assert iters == 0
    if case == "max_iters":
        assert iters == max_iters


def test_pcg_graph_path_only_on_one_cuda_device():
    """The reduced-camera PCG is captured only on a CUDA device with no
    process group; the CPU and the multi-process paths keep the loop."""
    assert tbl.pcg_on_graph(torch.device("cuda"))
    assert tbl.pcg_on_graph("cuda:1", None)
    assert not tbl.pcg_on_graph(torch.device("cpu"))
    assert not tbl.pcg_on_graph("cuda", group=object())


@pytest.mark.parametrize("name,arg", [("trivial", None), ("huber", 1.0),
                                      ("cauchy", 0.5),
                                      ("geman_mcclure", 2.0)])
def test_robust_kernels_match_jax(name, arg, rng):
    args = () if arg is None else (arg,)
    jk, tk = getattr(jrobust, name)(*args), getattr(trobust, name)(*args)
    s = rng.uniform(0, 10, 64)
    for fn in ("weight", "loss"):
        np.testing.assert_allclose(getattr(tk, fn)(torch.tensor(s)).numpy(),
                                   np.asarray(getattr(jk, fn)(jnp.asarray(s))),
                                   rtol=1e-13)


@pytest.mark.parametrize("kind,bucketed", [("ba", True), ("gp", True),
                                           ("ba", False)])
def test_build_system_matches_jax(kind, bucketed):
    problem, tproblem, params, obs, tparams, tobs, buckets = _setup(
        kind, bucketed)
    T = params.pts.shape[0]
    kernel = (jrobust.huber(1.0), trobust.huber(1.0))
    want = jbl.build_system(problem, params, obs, kernel[0], T,
                            buckets=buckets)
    got = tbl.build_system(tproblem, tparams, tobs, kernel[1], T,
                           buckets=buckets)
    for field in want._fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy().reshape(w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(w).max(), 1e-30),
                                   err_msg=field)


@pytest.mark.parametrize("solver", ["pcg", "dense"])
@pytest.mark.parametrize("kind", ["ba", "gp"])
def test_lm_step_matches_jax(kind, solver):
    problem, tproblem, params, obs, tparams, tobs, buckets = _setup(kind)
    cfg = dict(pcg_iters=20, pcg_tol=1e-6, max_rejects=4, solver=solver)
    kernel = (jrobust.huber(1.0), trobust.huber(1.0))
    want = jbl.lm_step(problem, kernel[0], jbl.LMConfig(**cfg),
                       jbl.LMState(params, jnp.asarray(1e-4),
                                   jnp.asarray(jnp.inf)), obs, buckets=buckets)
    got = tbl.lm_step(tproblem, kernel[1], tbl.LMConfig(**cfg),
                      _tstate(tparams, 1e-4), tobs, buckets=buckets,
                      device="cpu")
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.lam), float(want.lam), rtol=1e-12)
    for k in want.params.cam:
        np.testing.assert_allclose(got.params.cam[k].numpy(),
                                   np.asarray(want.params.cam[k]),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.params.pts.numpy(),
                               np.asarray(want.params.pts),
                               rtol=1e-4, atol=1e-5)


def test_optimize_history_matches_jax():
    """Same iteration count (the one-iteration readback lag included) and
    the same loss history, f64 on both sides.  Pixel noise keeps the final
    cost away from zero, where the two would differ only by rounding."""
    problem, tproblem, params, obs, tparams, tobs, buckets = _setup(
        "ba", noise=0.5)
    cfg = dict(max_iterations=15, pcg_iters=40, step_tol=1e-6)
    kernel = (jrobust.huber(1.0), trobust.huber(1.0))
    _, want = jbl.optimize(problem, kernel[0], jbl.LMConfig(**cfg), params,
                           obs, buckets=buckets)
    _, got = tbl.optimize(tproblem, kernel[1], tbl.LMConfig(**cfg), tparams,
                          tobs, buckets=buckets, device="cpu")
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _ba_torch(scene, **noise):
    _, params, obs = _ba_setup(scene, **noise)
    tparams, tobs, _ = _to_torch(params, obs)
    return tproblems.make_ba_problem(scene.model_id), tparams, tobs


def test_ba_converges_to_ground_truth():
    scene = make_scene(num_cams=10, num_pts=120, noise=0.0)
    problem, params, obs = _ba_torch(scene)
    cfg = tbl.LMConfig(max_iterations=30, function_tolerance=1e-12,
                       pcg_iters=60)
    _, history = tbl.optimize(problem, trobust.trivial(), cfg, params, obs,
                              device="cpu")
    rms = np.sqrt(history[-1] / len(scene.obs_cam))
    assert rms < 1e-3, f"final RMS reprojection {rms}"
    assert history[-1] < history[0] * 1e-6


def test_ba_huber_converges():
    scene = make_scene(num_cams=8, num_pts=100, noise=0.5)
    problem, params, obs = _ba_torch(scene, q_noise=0.02, t_noise=0.1,
                                     p_noise=0.1)
    cfg = tbl.LMConfig(max_iterations=25, function_tolerance=1e-10,
                       pcg_iters=60)
    _, history = tbl.optimize(problem, trobust.huber(1.0), cfg, params, obs,
                              device="cpu")
    assert np.sqrt(history[-1] / len(scene.obs_cam)) < 1.0


def test_ba_frozen_poses():
    scene = make_scene(num_cams=6, num_pts=80)
    rng = np.random.default_rng(3)
    C, T, O = len(scene.qvec), len(scene.points), len(scene.obs_cam)
    params = tbl.Params(
        cam={"q": torch.tensor(scene.qvec), "t": torch.tensor(scene.tvec),
             "intr": torch.tensor(np.tile(scene.params, (C, 1)))},
        pts=torch.tensor(scene.points + rng.standard_normal((T, 3)) * 0.2),
        scales=torch.zeros((O, 1), dtype=F64),
        scales_free=torch.zeros(O, dtype=torch.bool))
    obs = tbl.Observations(torch.tensor(scene.obs_cam),
                           torch.tensor(scene.obs_pt),
                           {"x": torch.tensor(scene.obs_xy[:, 0]),
                            "y": torch.tensor(scene.obs_xy[:, 1])},
                           torch.ones(O, dtype=torch.bool))
    problem = tproblems.make_ba_problem(scene.model_id, optimize_poses=False)
    cfg = tbl.LMConfig(max_iterations=20, function_tolerance=1e-12,
                       pcg_iters=50)
    state, _ = tbl.optimize(problem, trobust.trivial(), cfg, params, obs,
                            device="cpu")
    np.testing.assert_allclose(state.params.cam["q"].numpy(), scene.qvec)
    np.testing.assert_allclose(state.params.cam["t"].numpy(), scene.tvec)
    np.testing.assert_allclose(state.params.pts.numpy(), scene.points,
                               atol=1e-4)


def test_gp_converges():
    _, params, obs = _gp_setup(seed=5)
    tparams, tobs, _ = _to_torch(params, obs)
    cfg = tbl.LMConfig(max_iterations=60, function_tolerance=1e-12,
                       pcg_iters=80, radius_init=1e3, radius_max=1e8)
    _, history = tbl.optimize(tproblems.make_gp_problem(), trobust.huber(0.1),
                              cfg, tparams, tobs, device="cpu")
    assert history[-1] < 1e-6 * max(history[0], 1.0), \
        f"GP did not converge: {history[0]} -> {history[-1]}"


def test_lm_step_rejects_bad_steps():
    """Tiny damping: the first proposal may be bad; the reject loop must
    still end with a non-increasing cost."""
    problem, params, obs = _ba_torch(make_scene(num_cams=6, num_pts=60),
                                     q_noise=0.3, t_noise=1.0, p_noise=1.0)
    kernel = trobust.trivial()
    cfg = tbl.LMConfig(max_iterations=1, radius_init=1e12, pcg_iters=40)
    c0 = tbl.compute_cost(problem, params, obs, kernel)
    state = tbl.lm_step(problem, kernel, cfg, _tstate(params, 1e-12), obs,
                        device="cpu")
    assert float(state.cost) <= float(c0) * (1 + 1e-12)


def test_dense_solve_of_indefinite_system_is_nan_like_jax():
    """A damped reduced camera system that is not positive definite (forced
    here by a damping of -2, which negates the camera blocks): JAX's
    Cholesky gives NaN, so its step is NaN and ``lm_step`` rejects it and
    damps further; the port's dense solve gives NaN as well, where
    ``torch.linalg.cholesky`` would raise.  On the card a float32 BA of a
    small scene meets such a system."""
    problem, tproblem, params, obs, tparams, tobs, buckets = _setup("ba")
    T = params.pts.shape[0]
    kernel = (jrobust.huber(1.0), trobust.huber(1.0))
    jsys = jbl.build_system(problem, params, obs, kernel[0], T,
                            buckets=buckets)
    tsys = tbl.build_system(tproblem, tparams, tobs, kernel[1], T,
                            buckets=buckets)
    for lam, finite in ((1e-4, True), (-2.0, False)):
        want = jbl.solve_damped(problem, jsys, obs, jnp.asarray(lam),
                                dense_schur=True, buckets=buckets)[0]
        got = tbl.solve_damped(tproblem, tsys, tobs, torch.tensor(lam, dtype=F64),
                               dense_schur=True, buckets=buckets)[0]
        assert np.isfinite(np.asarray(want)).all() == finite
        assert torch.isfinite(got).all().item() == finite
        if finite:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)
        else:
            assert np.isnan(np.asarray(want)).all()
            assert torch.isnan(got).all()
