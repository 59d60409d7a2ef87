"""The damped solve's per-row passes (``solve/schur_setup.py``) on the CPU.

Their plain versions, ``setup_reference`` and ``backsub_reference``, are
what ``block_lm.solve_damped`` runs wherever the kernels do not (the CPU,
no buckets, PC > 8): on the inputs the solve hands them (BA, GP with its
scales eliminated, and frozen-pose BA, bucketed and not, float64) they
equal the solve's torch lines before the kernels bit for bit.  The solve
takes the kernels only where ``covers`` holds (CUDA, buckets, PC <= 8) and
counts one ``lm_solve_kernel`` or ``lm_solve_torch`` a damped solve on the
PCG path, none on the dense one.  The kernels themselves are held on the
card (``tests/test_torch_cuda.py``).

    python -m pytest tests/test_torch_schur_setup.py -q
"""

from types import SimpleNamespace

import pytest
import torch

from instantsfm_tpu_torch.solve import block_lm as tbl
from instantsfm_tpu_torch.solve import problems as tproblems
from instantsfm_tpu_torch.solve import robust as trobust
from instantsfm_tpu_torch.solve import schur_setup
from instantsfm_tpu_torch.solve.blocked import gather_pt, seg_by_pt
from instantsfm_tpu_torch.utils import debug
from tests.test_torch_block_lm import F64, _setup


def _parent_setup(V, g_pt, W, lam, eps, cam_idx, pt_idx, buckets, C):
    """``solve_damped``'s set-up lines before the kernels, as they were."""
    gather = (lambda a: gather_pt(a, buckets, W.shape[0])) if buckets \
        else (lambda a: a[pt_idx])
    PC = W.shape[1]
    d = torch.diagonal(V, dim1=-2, dim2=-1)
    V_d = V + torch.eye(3, dtype=V.dtype) * (lam * d + eps)[..., :, None]
    a, b, c = V_d[..., 0, 0], V_d[..., 0, 1], V_d[..., 0, 2]
    d, e, f = V_d[..., 1, 0], V_d[..., 1, 1], V_d[..., 1, 2]
    g, h, i = V_d[..., 2, 0], V_d[..., 2, 1], V_d[..., 2, 2]
    A, B, Cf = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * Cf
    inv_det = torch.where(torch.abs(det) < 1e-30, torch.zeros_like(det),
                          1.0 / det)
    V_inv = torch.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g), -(a * f - c * d),
        Cf, -(a * h - b * g), (a * e - b * d),
    ], dim=-1).reshape(V_d.shape) * inv_det[..., None, None]
    O = W.shape[0]
    mv = lambda M, v: torch.sum(M * v[..., None, :], dim=-1)
    rhs_o = mv(W, gather(mv(V_inv, g_pt)))
    Vg = gather(V_inv)
    WVi = torch.sum(W[:, :, :, None] * Vg[:, None, :, :], dim=2)
    D_corr = torch.sum(WVi[:, :, None, :] * W[:, None, :, :], -1)
    rows = torch.cat([D_corr.reshape(O, PC * PC), rhs_o], 1)
    return V_inv, rows.new_zeros((C, rows.shape[1])).index_add_(0, cam_idx,
                                                                rows)


def _parent_backsub(W, V_inv, g_pt, d_cam, cam_idx, pt_idx, buckets):
    """``solve_damped``'s back-substitution before the kernels."""
    T = V_inv.shape[0]
    t = torch.sum(W * d_cam[cam_idx][..., :, None], dim=-2)
    wtd = seg_by_pt(t, buckets, T) if buckets else \
        t.new_zeros((T, 3)).index_add_(0, pt_idx, t)
    return torch.sum(V_inv * (g_pt - wtd)[..., None, :], dim=-1)


def _system(kind, bucketed):
    """(problem, system, observations, buckets) in float64 on the CPU: BA,
    GP (per-row scales) or frozen-pose BA (PC = 2) of ``tests/synthetic.py``
    scenes."""
    _, tproblem, _, _, params, obs, buckets = _setup(
        "gp" if kind == "gp" else "ba", bucketed=bucketed, noise=0.5)
    kernel = trobust.huber(0.1 if kind == "gp" else 1.0)
    if kind == "frozen":
        tproblem = tproblems.make_ba_problem(2, optimize_poses=False)
    sys = tbl.build_system(tproblem, params, obs, kernel,
                           params.pts.shape[0], buckets=buckets)
    return tproblem, sys, obs, buckets


def _spied(monkeypatch):
    """Record each call of ``schur_setup.setup`` and ``backsub`` made by the
    solve, with its arguments and result."""
    calls = {"setup": [], "backsub": []}
    for name in calls:
        real = getattr(schur_setup, name)

        def spy(*args, _real=real, _name=name):
            out = _real(*args)
            calls[_name].append((args, out))
            return out
        monkeypatch.setattr(schur_setup, name, spy)
    return calls


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("kind", ["ba", "gp", "frozen"])
def test_plain_versions_are_the_solves_torch_lines(kind, bucketed,
                                                   monkeypatch):
    """On the inputs a damped PCG solve hands them, the plain versions give
    what the solve's own torch lines gave before the kernels, bit for bit;
    one set-up and one back-substitution a solve."""
    problem, sys, obs, buckets = _system(kind, bucketed)
    assert problem.cam_dim == {"ba": 8, "gp": 3, "frozen": 2}[kind]
    calls = _spied(monkeypatch)
    lam = torch.tensor(1e-3, dtype=F64)
    d_cam, d_pt, _, iters = tbl.solve_damped(problem, sys, obs, lam,
                                             dense_schur=False,
                                             buckets=buckets)
    assert iters > 0
    (args, (V_inv, dc)), = calls["setup"]
    assert args[3] is lam and args[4] == 1e-8
    want_V_inv, want_dc = _parent_setup(*args)
    assert torch.equal(V_inv, want_V_inv) and torch.equal(dc, want_dc)
    (args, got), = calls["backsub"]
    assert args[1] is V_inv and args[3] is d_cam and got is d_pt
    assert torch.equal(got, _parent_backsub(*args))
    assert torch.isfinite(d_pt).all() and torch.isfinite(dc).all()


@pytest.mark.parametrize("dense", [False, True])
def test_damped_solve_counts_its_path(dense, monkeypatch):
    """One ``lm_solve_torch`` a damped solve on the PCG path on the CPU, and
    no set-up, back-substitution or count on the dense one."""
    problem, sys, obs, buckets = _system("ba", True)
    calls = _spied(monkeypatch)
    debug.drain_stats()
    tbl.solve_damped(problem, sys, obs, torch.tensor(1e-3, dtype=F64),
                     dense_schur=dense, buckets=buckets)
    stats = debug.drain_stats()
    assert "lm_solve_kernel" not in stats
    if dense:
        assert "lm_solve_torch" not in stats
        assert calls == {"setup": [], "backsub": []}
    else:
        assert stats["lm_solve_torch"] == [1]
        assert len(calls["setup"]) == len(calls["backsub"]) == 1


def test_lm_steps_count_a_solve_a_try():
    """Three LM steps of the bucketed BA problem: one count a damped try."""
    problem, _, obs, buckets = _system("ba", True)
    _, _, _, _, params, _, _ = _setup("ba", bucketed=True, noise=0.5)
    cfg = tbl.LMConfig(solver="pcg")
    z = torch.zeros((), dtype=F64)
    state = tbl.LMState(params, z + 1e-4, z + float("inf"), z, z)
    debug.drain_stats()
    for _ in range(3):
        state = tbl.lm_step(problem, trobust.huber(1.0), cfg, state, obs,
                            buckets=buckets, device="cpu")
    stats = debug.drain_stats()
    assert len(stats["lm_solve_torch"]) == sum(stats["lm_tries"]) >= 3


def _fake(device, PC, dtype=torch.float32):
    """A stand-in for W with the attributes ``covers`` reads."""
    return SimpleNamespace(device=torch.device(device), shape=(64, PC, 3),
                           dtype=dtype)


@pytest.mark.parametrize("device,PC,dtype,bucketed,want", [
    ("cuda", 8, torch.float32, True, True),
    ("cuda", 3, torch.float64, True, True),
    ("cuda", 2, torch.float32, True, True),
    ("cuda", 1, torch.float32, True, True),
    ("cuda", 9, torch.float32, True, False),
    ("cuda", 8, torch.float32, False, False),
    ("cuda", 8, torch.float16, True, False),
    ("cpu", 8, torch.float32, True, False),
    ("cpu", 3, torch.float64, True, False),
])
def test_kernels_cover_cuda_with_buckets_and_pc_up_to_8(device, PC, dtype,
                                                        bucketed, want):
    buckets = ((0, 0, 32, 2),) if bucketed else ()
    assert schur_setup.covers(_fake(device, PC, dtype), buckets) is want


def test_solve_takes_the_kernels_where_they_cover(monkeypatch):
    """With ``covers`` made to hold and the launchers replaced by their
    plain versions, the solve routes both passes through the launchers,
    counts ``lm_solve_kernel`` and returns the same step."""
    problem, sys, obs, buckets = _system("ba", True)
    lam = torch.tensor(1e-3, dtype=F64)
    want = tbl.solve_damped(problem, sys, obs, lam, dense_schur=False,
                            buckets=buckets)
    launched = []

    def setup(V, g_pt, W, lam_, eps, cam_idx, buckets_, C):
        launched.append("setup")
        return schur_setup.setup_reference(V, g_pt, W, lam_, eps, cam_idx,
                                           None, buckets_, C)

    def backsub(W, V_inv, g_pt, d_cam, cam_idx, buckets_):
        launched.append("backsub")
        return schur_setup.backsub_reference(W, V_inv, g_pt, d_cam, cam_idx,
                                             None, buckets_)

    monkeypatch.setattr(schur_setup, "covers", lambda W, b: bool(b))
    monkeypatch.setattr(schur_setup, "_launch_setup", setup)
    monkeypatch.setattr(schur_setup, "_launch_backsub", backsub)
    debug.drain_stats()
    got = tbl.solve_damped(problem, sys, obs, lam, dense_schur=False,
                           buckets=buckets)
    stats = debug.drain_stats()
    assert launched == ["setup", "backsub"]
    assert stats["lm_solve_kernel"] == [1] and "lm_solve_torch" not in stats
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert got[3] == want[3]


def test_shared_memory_edges():
    """The set-up's shared table and the back-substitution's copy of d_cam
    at the most cameras each keeps in shared memory (K1's 96 KB)."""
    edge = lambda fn, PC, dt: max(C for C in range(1, 20_000)
                                  if fn(C, PC, dt))
    assert edge(schur_setup.shared_table, 8, torch.float32) == 558
    assert edge(schur_setup.shared_table, 8, torch.float64) == 279
    assert edge(schur_setup.shared_table, 3, torch.float32) == 2048
    assert edge(schur_setup.backsub_shared, 8, torch.float32) == 3069
    assert edge(schur_setup.backsub_shared, 2, torch.float64) == 6132


def test_launch_layout_rejects_bad_inputs():
    """The launchers' checks, which run before any launch: int64 camera
    indices, buckets that miss rows, point slots the buckets do not tile,
    W of another width."""
    problem, sys, obs, buckets = _system("ba", True)
    W, T = sys.W, sys.V.shape[0]
    assert len(schur_setup._layout(W, obs.cam_idx, buckets, T)) == 5
    with pytest.raises(TypeError):
        schur_setup._layout(W, obs.cam_idx.long(), buckets, T)
    with pytest.raises(ValueError):
        schur_setup._layout(W, obs.cam_idx, buckets[:-1], T)
    with pytest.raises(ValueError):
        schur_setup._layout(W, obs.cam_idx, buckets, T + 1)
    with pytest.raises(ValueError):
        schur_setup._layout(W.new_zeros((W.shape[0], 9, 3)), obs.cam_idx,
                            buckets, T)


def _check_inputs():
    """A seeded 20-camera BA problem's set-up and back-substitution
    arguments in float32 on the CPU (``chip_smoke.solve_inputs``)."""
    import chip_smoke
    from instantsfm_tpu_torch.scene import cameras as cm
    lengths = [2, 3, 5, 8, 30, 300] * 40
    return chip_smoke.solve_inputs(*chip_smoke.build_inputs(
        cm.SIMPLE_RADIAL, True, 20, lengths, torch.float32, "cpu"))


def _reordered(setup_args, backsub_args, drop=None, move=None, V_inv=None):
    """The float32 plain version with the camera sums and the track sums
    added in reverse order, as a kernel's other order would; ``drop`` a
    row's terms, or ``move`` a row to the next camera; the camera sums
    taken from ``V_inv`` where given."""
    V, g_pt, W, lam, eps, cam_idx, pt_idx, buckets, C = setup_args
    if V_inv is None:
        V_inv = schur_setup._inv3x3(schur_setup._damped(V, lam, eps))
    Vg, gg = V_inv[pt_idx.long()], g_pt[pt_idx.long()]
    rows = torch.cat([(W @ Vg @ W.transpose(1, 2)).flatten(1),
                      (W @ (Vg @ gg[..., None]))[..., 0]], 1)
    cam = cam_idx.long().clone()
    if drop is not None:
        rows[drop] = 0
    if move is not None:
        cam[move] = (cam[move] + 1) % C
    dc = rows.new_zeros((C, rows.shape[1])).index_add_(0, cam.flip(0),
                                                       rows.flip(0))
    Wb, Vib, gb, d_cam, ci, pi, _ = backsub_args
    t_o = torch.sum(Wb * d_cam[ci.long()][..., :, None], dim=-2)
    if drop is not None:
        t_o[drop] = 0
    t = t_o.new_zeros(gb.shape).index_add_(0, pi.long().flip(0), t_o.flip(0))
    import chip_smoke
    return chip_smoke.solve_fields(
        V_inv, dc, torch.sum(Vib * (gb - t)[..., None, :], dim=-1),
        W.shape[1])


def test_solve_check_holds_other_orders_and_rejects_faults():
    """``chip_smoke.solve_verdict``'s float32 bound, the card checks' bar:
    the plain version summed in another order holds; a row dropped from
    both passes, a row moved to another camera, and one entry of V_inv off
    by 1e-4 of itself each fail."""
    import chip_smoke
    setup_args, backsub_args = _check_inputs()
    check = lambda got: chip_smoke.solve_verdict("cpu", got, setup_args,
                                                 backsub_args)
    worst, _, by_field, unbounded = check(_reordered(setup_args,
                                                     backsub_args))
    assert worst <= 1.0 and set(by_field) == set(chip_smoke.SOLVE_FIELDS)
    assert unbounded == 0
    valid = torch.nonzero(setup_args[2].flatten(1).any(1))[:, 0]
    for fault in (dict(drop=int(valid[7])), dict(move=int(valid[11]))):
        with pytest.raises(AssertionError):
            check(_reordered(setup_args, backsub_args, **fault))
    got = _reordered(setup_args, backsub_args)
    got["V_inv"] = got["V_inv"].clone()
    p = int(setup_args[6][valid[3]])
    got["V_inv"][p, 1, 1] *= 1 + 1e-4
    with pytest.raises(AssertionError):
        check(got)


def test_solve_check_leaves_an_inverse_float32_cannot_determine():
    """At the damping of a late LM step (1e-10), a point whose V is of rank
    two off the axes (condition about 1e10) has a damped V singular to
    float32: its V_inv has no bound and is counted, one more than the
    problem's own such points, while the camera sums, evaluated from the
    kernel's own V_inv, still hold.  A V_inv that is off on a
    well-conditioned point still fails."""
    import chip_smoke
    setup_args, backsub_args = _check_inputs()
    setup_args = (*setup_args[:3], setup_args[3] * 1e-6, *setup_args[4:])
    pts = setup_args[6][setup_args[2].flatten(1).any(1)].unique()
    V = setup_args[0]
    inverse = lambda V: schur_setup._inv3x3(schur_setup._damped(
        V, setup_args[3], setup_args[4]))
    verdict = lambda args, V_inv: chip_smoke.solve_verdict(
        "cpu", _reordered(args, backsub_args, V_inv=V_inv), args,
        backsub_args)
    unbounded_before = verdict(setup_args, inverse(V))[3]
    weak = next(int(p) for p in pts if torch.linalg.cond(V[p]) < 1e3)
    n = torch.ones(3) / 3 ** 0.5
    V = V.clone()
    V[weak] = 1e4 * (torch.eye(3) - torch.outer(n, n))
    args = (V, *setup_args[1:])
    V_inv = inverse(V)
    V_inv[weak] *= 2.0
    worst, _, _, unbounded = verdict(args, V_inv)
    assert worst <= 1.0 and unbounded == unbounded_before + 1
    sound = next(int(p) for p in pts
                 if p != weak and torch.linalg.cond(V[p]) < 1e3)
    V_inv[sound, 0, 0] *= 1 + 1e-4
    with pytest.raises(AssertionError):
        verdict(args, V_inv)


def test_row_op_probe_finds_the_plain_versions_ops():
    """The card test's probe for per-row torch work
    (``test_torch_cuda.RowOps``) on one damped solve on the CPU, where the
    plain versions run: it finds their products, sums, ``index_add_`` and
    ``cat`` over the rows, and nothing in a probe of another row count."""
    from tests.test_torch_cuda import RowOps
    problem, sys, obs, buckets = _system("ba", True)
    solve = lambda: tbl.solve_damped(problem, sys, obs,
                                     torch.tensor(1e-3, dtype=F64),
                                     dense_schur=False, buckets=buckets)
    with RowOps(sys.W.shape[0]) as probe:
        solve()
    assert {"mul", "sum", "index_add_", "cat"} <= probe.found, probe.found
    with RowOps(sys.W.shape[0] + 1) as probe:
        solve()
    assert probe.found == set()
