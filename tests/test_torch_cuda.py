"""Card-only tests of the port: the CUDA kernels against their plain torch
versions, and the BA stage, the SfM mapper and the 3DGS render and
training path on the card against the same code on the CPU.

This file imports neither JAX nor the JAX package, so on the card machine
(which has no JAX) it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Without a card each test skips.  K1's tolerance is per camera entry
(``chip_smoke.k1_check``), not per max|y|, because a camera's sum of u and
a track's sum of W^T x cancel: the smaller of tol * SUM_{o: cam_o = c}
|W_o| |V_inv_p| SUM_k |W_k|^T |x[cam_k]| (the camera sum of the absolute
chain; tol 1e-5 in float32, 1e-10 in float64) and 32 times the rounding
count of the chain's sums (each row's levels of sums times its absolute
chain and the camera sum's partial sums, in quadrature, times the unit
roundoff): the kernel sums tracks by a butterfly and cameras with atomics
in an order that changes from run to run, the plain version by
reshape-sums and index_add_, sums of up to 2048 track rows and thousands
of camera rows in other orders.  K2/K3 (float32 only): rel 1e-5 of each
output's max and 1e-4 of each gradient column's max (sums in other orders,
FMA contraction)."""

import numpy as np
import pytest
import torch

from instantsfm_tpu_torch.gs import composite as k23
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.solve.blocked import bucketize


def mixed_layout(lengths, C, PC, seed, track_pad=4):
    """Bucketized layout with the given track lengths, plus random W (zero
    on padded rows, which sit on camera 0), SPD V_inv and x, as numpy
    arrays."""
    rng = np.random.default_rng(seed)
    pt = np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)
    O = len(pt)
    cam = rng.integers(0, C, O).astype(np.int32)
    bp = bucketize(cam, pt, {}, np.ones(O, bool), np.zeros((O, 1)),
                   np.zeros(O, bool), len(lengths), track_pad=track_pad)
    Op, T = len(bp.cam_idx), bp.num_slots
    W = rng.standard_normal((Op, PC, 3)) * bp.valid[:, None, None]
    A = rng.standard_normal((T, 3, 3))
    V_inv = A @ A.transpose(0, 2, 1) + np.eye(3)
    x = rng.standard_normal((C, PC))
    return W, V_inv, x, bp.cam_idx, bp.pt_idx, bp.buckets


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")


def _k1_on_card(layout, dt):
    W, V_inv, x, cam_idx, pt_idx, buckets = layout
    args = [torch.tensor(a, device="cuda", dtype=dt) for a in (W, V_inv, x)]
    idx = [torch.tensor(a, device="cuda") for a in (cam_idx, pt_idx)]
    return args, idx, buckets


def _k1_holds(layout, dt):
    """The kernel against its plain version on one layout; one launch."""
    import chip_smoke
    args, idx, buckets = _k1_on_card(layout, dt)
    want = k1.schur_wchain_reference(*args, *idx, buckets)
    before = k1.schur_wchain.launches
    got = k1.schur_wchain(*args, *idx, buckets)
    torch.cuda.synchronize()
    assert k1.schur_wchain.launches == before + 1
    assert got.shape == want.shape == args[2].shape
    chip_smoke.k1_check("card test", got, want,
                        chip_smoke.k1_scales(*args, *idx, buckets))


@pytest.mark.cuda
@pytest.mark.parametrize("PC", [3, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_schur_wchain_kernel_matches_reference(PC, dtype):
    _need_card()
    lengths = [2, 8, 32, 64, 512, 2048, 3, 17, 100, 1000] * 20
    _k1_holds(mixed_layout(lengths, 50, PC, 1), getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["many_cams", "unaligned", "mostly_pad",
                                    "table_edge"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_schur_wchain_kernel_layouts(layout, dtype):
    """The global-atomic branch (4,000 cameras, past the shared table);
    bucket spans that do not start on 16 bytes (track_pad=1, PC=3: 36-byte
    rows); a bucket whose rows are mostly padding (10 tracks padded to 256,
    all padded rows on camera 0); PC = 1 and 8 at the most cameras the
    shared table takes and at one more, with tracks of 2 rows, whose work
    items stage the most V_inv slots (float64 at PC = 8 then needs
    225,536 B of the card's 232,448 B a block); PC = 2 is the width of
    retriangulation's frozen-pose BA on SIMPLE_RADIAL cameras."""
    _need_card()
    dt = getattr(torch, dtype)
    if layout == "table_edge":
        for PC in (1, 2, 8):
            C = next(c for c in range(1, 10_000)
                     if not k1.shared_table(c, PC, dt))
            for cams in (C - 1, C):
                _k1_holds(mixed_layout([8] * 5000 + [2] * 64, cams, PC, 6),
                          dt)
        return
    if layout == "many_cams":
        lay = mixed_layout([8] * 5000 + [3, 40, 300], 4000, 8, 3)
        assert not k1.shared_table(4000, 8, dt)
    elif layout == "unaligned":
        lay = mixed_layout([2, 3, 5, 9, 17, 33, 100, 300] * 7, 30, 3, 4,
                           track_pad=1)
        assert any(os_ % 4 for (os_, _, _, _) in lay[-1])
    else:
        lay = mixed_layout([8] * 10 + [2] * 3, 20, 8, 5, track_pad=256)
        assert np.mean(np.all(lay[0] == 0, axis=(1, 2))) > 0.9
    _k1_holds(lay, dt)


@pytest.mark.cuda
def test_schur_wchain_kernel_rejects_bad_inputs():
    _need_card()
    W, V_inv, x, cam_idx, pt_idx, buckets = mixed_layout([4] * 64, 5, 8, 2)
    args = [torch.tensor(a, device="cuda", dtype=torch.float32)
            for a in (W, V_inv, x)]
    idx = [torch.tensor(a, device="cuda") for a in (cam_idx, pt_idx)]
    with pytest.raises(ValueError):
        k1.schur_wchain(*args, *idx, ())              # no bucketed layout
    with pytest.raises(TypeError):
        k1.schur_wchain(*args, idx[0].long(), idx[1], buckets)
    with pytest.raises(TypeError):
        k1.schur_wchain(args[0].double(), *args[1:], *idx, buckets)
    with pytest.raises(ValueError):                   # W not on 16 bytes
        flat = torch.zeros(args[0].numel() + 1, device="cuda")
        W_off = flat[1:].view(args[0].shape)
        k1.schur_wchain(W_off, *args[1:], *idx, buckets)
    with pytest.raises(ValueError):                   # x of another width
        k1.schur_wchain(*args[:2], args[2][:, :3], *idx, buckets)


@pytest.mark.cuda
def test_bundle_adjustment_rounds_card_matches_cpu():
    """The whole BA stage in float64 on the card (K1 in every PCG matvec,
    index_add_ atomics) against the same stage on the CPU: poses agree to
    1e-6, the LM iteration count of each round within one."""
    _need_card()
    import chip_smoke
    from instantsfm_tpu_torch import config
    from instantsfm_tpu_torch.pipeline import ba
    from instantsfm_tpu_torch.utils import debug

    opts = dict(config.BUNDLE_ADJUSTER_OPTIONS, max_num_iterations=10)
    out = {}
    for device in ("cpu", "cuda"):
        cameras, images, tracks, _ = chip_smoke.make_scene(num_cams=20,
                                                           num_pts=9000)
        debug.drain_stats()
        launches = k1.schur_wchain.launches
        ba.bundle_adjustment_rounds(cameras, images, tracks, opts, 1e-2,
                                    device=device)
        out[device] = (images, debug.drain_stats()["ba_lm_iters"],
                       k1.schur_wchain.launches - launches)
    (img_c, it_c, _), (img_g, it_g, n_launch) = out["cpu"], out["cuda"]
    assert n_launch > 0
    assert all(abs(a - b) <= 1 for a, b in zip(it_c, it_g)), (it_c, it_g)
    np.testing.assert_allclose(img_g.qvec, img_c.qvec, atol=1e-6)
    np.testing.assert_allclose(img_g.tvec, img_c.tvec, atol=1e-6)


@pytest.mark.cuda
def test_bundle_adjustment_past_pc8_card_matches_cpu():
    """BA on OPENCV cameras (camera block PC = 12) past the dense Schur
    limit (9,000 point slots > 8,192, so the PCG path) in float64 on the
    card against the CPU: K1 takes PC <= 8, so the PCG matvec runs its
    plain version on the card, counted in ``schur_wchain.plain_calls``, and
    K1's launch counter does not move.  Quaternions agree to 1e-6,
    translations to 4e-6, the LM iteration count of each round within one.
    The translations' bound is the order of the sums: the card's
    ``index_add_`` adds in a new order each run, and on the CPU a mere
    reordering of the observations moves a translation by up to 1.07e-6;
    ten card runs came within 5.8e-7-1.19e-6 of the CPU, and one earlier
    run 1.95e-6 (``tools/pc8_spread_torch.py``).  4e-6 is twice the largest
    of these."""
    _need_card()
    import chip_smoke
    from instantsfm_tpu_torch import config
    from instantsfm_tpu_torch.pipeline import ba
    from instantsfm_tpu_torch.scene import cameras as cm
    from instantsfm_tpu_torch.utils import debug

    opts = dict(config.BUNDLE_ADJUSTER_OPTIONS, max_num_iterations=10)
    out = {}
    for device in ("cpu", "cuda"):
        cameras, images, tracks, _ = chip_smoke.make_scene(num_cams=20,
                                                           num_pts=9000)
        # the scene's SIMPLE_RADIAL projection as OPENCV parameters
        cameras.model_ids[:] = cm.OPENCV
        cameras.params[0, :8] = [500.0, 500.0, 320.0, 240.0, 0.01, 0, 0, 0]
        debug.drain_stats()
        launches = k1.schur_wchain.launches
        plain = k1.schur_wchain.plain_calls
        ba.bundle_adjustment_rounds(cameras, images, tracks, opts, 1e-2,
                                    device=device)
        out[device] = (images, debug.drain_stats()["ba_lm_iters"],
                       k1.schur_wchain.launches - launches,
                       k1.schur_wchain.plain_calls - plain)
    (img_c, it_c, _, plain_c), (img_g, it_g, n_launch, n_plain) = (
        out["cpu"], out["cuda"])
    assert plain_c == 0 and n_plain > 0 and n_launch == 0
    assert all(abs(a - b) <= 1 for a, b in zip(it_c, it_g)), (it_c, it_g)
    np.testing.assert_allclose(img_g.qvec, img_c.qvec, atol=1e-6)
    np.testing.assert_allclose(img_g.tvec, img_c.tvec, atol=4e-6)


def _damped_inputs(kind, dtype):
    """(problem, system, observations, buckets) of a bucketed problem on
    the card: BA on a 20-camera, 9,000-point scene (K1 at PC = 8) or GP
    with its scales (K1 at PC = 3), 40 cameras and 3,000 tracks of 6."""
    from instantsfm_tpu_torch.solve import block_lm, robust
    from instantsfm_tpu_torch.solve.blocked import bucketize_problem
    from instantsfm_tpu_torch.solve.problems import (make_ba_problem,
                                                     make_gp_problem)
    if kind == "ba":
        import chip_smoke
        cameras, images, tracks, _ = chip_smoke.make_scene(num_cams=20,
                                                           num_pts=9000)
        params, obs = chip_smoke.scene_problem(cameras, images, tracks,
                                               dtype, "cuda")
        problem = make_ba_problem(cameras.uniform_model_id)
        kernel = robust.huber(1.0)
    else:
        rng = np.random.default_rng(0)
        C, T, per = 40, 3000, 6
        O = T * per
        d = rng.standard_normal((O, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = lambda a: torch.as_tensor(np.asarray(a), device="cuda").to(dtype)
        params = block_lm.Params(
            cam={"c": t(rng.uniform(-1, 1, (C, 3)))},
            pts=t(rng.uniform(-1, 1, (T, 3))), scales=t(np.ones((O, 1))),
            scales_free=torch.ones(O, dtype=torch.bool, device="cuda"))
        obs = block_lm.Observations(
            torch.as_tensor(rng.integers(0, C, O).astype(np.int32),
                            device="cuda"),
            torch.as_tensor(np.repeat(np.arange(T, dtype=np.int32), per),
                            device="cuda"),
            {"tx": t(d[:, 0]), "ty": t(d[:, 1]), "tz": t(d[:, 2]),
             "w": t(np.ones(O))},
            torch.ones(O, dtype=torch.bool, device="cuda"))
        problem, kernel = make_gp_problem(), robust.huber(0.1)
    params, obs, buckets, _ = bucketize_problem(params, obs)
    system = block_lm.build_system(problem, params, obs, kernel,
                                   params.pts.shape[0], buckets=buckets)
    return problem, system, obs, buckets


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ba", "gp"])
def test_pcg_graph_matches_eager_loop(kind, monkeypatch):
    """The damped solve's PCG on CUDA graphs against the eager loop on the
    operator and right-hand side it was handed, float64: the iteration
    counts within one (K1's atomics sum in an order that changes from run
    to run), d_cam within 1e-6, K1 launched.  The tolerance 1e-10 keeps an
    iteration more or less far under 1e-6."""
    _need_card()
    from instantsfm_tpu_torch.solve import block_lm, pcg

    problem, system, obs, buckets = _damped_inputs(kind, torch.float64)
    seen = {}

    def spy(make_ops, layout, operands, b, **kw):
        seen.update(ops=make_ops(layout, *operands), b=b, kw=kw)
        return pcg.graph_pcg(make_ops, layout, operands, b, **kw)

    monkeypatch.setattr(block_lm, "graph_pcg", spy)
    launches = k1.schur_wchain.launches
    lam = torch.tensor(1e-4, dtype=torch.float64, device="cuda")
    d_cam, _, _, iters = block_lm.solve_damped(
        problem, system, obs, lam, pcg_iters=200, pcg_tol=1e-10,
        dense_schur=False, buckets=buckets)
    assert k1.schur_wchain.launches > launches and seen
    matvec, precond, _ = seen["ops"]
    x, _, loop_iters = pcg.pcg(matvec, seen["b"], precond, **seen["kw"])
    assert iters > pcg.BLOCK and abs(iters - loop_iters) <= 1
    np.testing.assert_allclose(d_cam.cpu().numpy(), x.cpu().numpy(),
                               atol=1e-6)


@pytest.mark.cuda
def test_pcg_graph_captures_once_and_counts_k1_replays():
    """Two damped solves of one shape: the first captures (its warm-up runs
    K1 twice), the second replays only; one read a replay, and K1's
    counter grows by the set-up's launch and ``BLOCK`` a replay."""
    _need_card()
    from instantsfm_tpu_torch.solve import block_lm, pcg
    from instantsfm_tpu_torch.utils import debug

    problem, system, obs, buckets = _damped_inputs("ba", torch.float32)
    lam = torch.tensor(1e-4, dtype=torch.float32, device="cuda")
    pcg._GRAPHS.clear()

    def solve():
        before = k1.schur_wchain.launches
        with debug.span("test.solve"):
            iters = block_lm.solve_damped(problem, system, obs, lam,
                                          dense_schur=False,
                                          buckets=buckets)[3]
        rec = debug.REGISTRY.roots("test.solve")[-1]
        return iters, rec["spans"], rec["reads"], \
            k1.schur_wchain.launches - before

    it1, spans1, reads1, n1 = solve()
    it2, spans2, reads2, n2 = solve()
    assert spans1["pcg.capture"][0] == 1 and "pcg.capture" not in spans2
    assert spans1["pcg.graph"][0] == spans2["pcg.graph"][0] == 1
    for it, spans, reads, n, warm in ((it1, spans1, reads1, n1, 2),
                                      (it2, spans2, reads2, n2, 0)):
        replays = spans["pcg.replay"][0]
        assert reads["pcg.exit"][0] == replays == max(1, -(-it // pcg.BLOCK))
        assert n == warm + 1 + pcg.BLOCK * replays
    assert "pcg.iter" not in spans2


def _rel_close(got, want, rel):
    scale = max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=0, atol=rel * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("K,cases", [
    pytest.param(128, "composite_branch_cases", id="128"),
    pytest.param(512, "composite_branch_cases", id="512"),
    pytest.param(128, "composite_cull_cases", id="cull-128"),
    pytest.param(512, "composite_cull_cases", id="cull-512")])
def test_composite_kernels_match_reference(K, cases):
    """K2 and K3 against their plain versions on tiles that reach every
    branch (empty, early exit, all chunks, sigma <= 0, clipped alpha) and on
    tiles whose gaussians sit on the edges of the kernels' cull; those are
    held tile by tile (a tile of far gaussians has conic gradients ~1e11)."""
    _need_card()
    import chip_smoke
    branches = cases == "composite_branch_cases"
    A, nch, ntx = getattr(chip_smoke, cases)(K)
    attrs = torch.tensor(A, device="cuda")
    nchunks = torch.tensor(nch, device="cuda")
    gout = torch.randn((A.shape[0], 8, 256), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
    want_out, want_logt = k23.composite_fwd_reference(attrs, nchunks, ntx)
    f0, b0 = k23.composite_fwd.launches, k23.composite_bwd.launches
    got_out, got_logt = k23.composite_fwd(attrs, nchunks, ntx)
    got_g = k23.composite_bwd(attrs, got_logt, gout, ntx)
    torch.cuda.synchronize()
    assert (k23.composite_fwd.launches, k23.composite_bwd.launches) == (
        f0 + 1, b0 + 1)
    ent = want_logt.amax(2) > -1e29
    assert torch.equal(got_logt.amax(2) > -1e29, ent)
    if branches:
        assert ent[1].sum() == (1 if K > 128 else K // 128)  # early exit
    for rows in (slice(0, 3), slice(3, 4), slice(4, 5)):
        chip_smoke._assert_rel("K2", got_out[:, rows], want_out[:, rows],
                               1e-5, per_tile=not branches)
    _rel_close(got_logt[ent], want_logt[ent], 1e-5)
    assert (got_out[:, 5:] == 0).all()
    if branches:
        assert (got_out[0, :3] == 0).all()
    want_g = k23.composite_bwd_reference(attrs, want_logt, gout, ntx)
    for c in range(10):
        chip_smoke._assert_rel(f"K3 column {c}", got_g[..., c],
                               want_g[..., c], 1e-4, per_tile=not branches)
    assert (got_g[..., 10:] == 0).all()
    assert (got_g[~ent.repeat_interleave(128, dim=1)] == 0).all()


@pytest.mark.cuda
def test_composite_kernels_reject_bad_inputs():
    _need_card()
    import chip_smoke
    A, nch, ntx = chip_smoke.composite_branch_cases(128)
    attrs = torch.tensor(A, device="cuda")
    nchunks = torch.tensor(nch, device="cuda")
    with pytest.raises(TypeError):
        k23.composite_fwd(attrs.double(), nchunks, ntx)
    with pytest.raises(ValueError):
        k23.composite_fwd(attrs[:, :100], nchunks, ntx)
    with pytest.raises(TypeError):
        k23.composite_fwd(attrs, nchunks.long(), ntx)
    _, logt = k23.composite_fwd(attrs, nchunks, ntx)
    with pytest.raises(TypeError):
        k23.composite_bwd(attrs, logt, torch.zeros((6, 5, 256),
                                                   device="cuda"), ntx)


@pytest.mark.cuda
def test_rasterize_card_matches_cpu():
    """The whole render and its gradients (float32): K2/K3 and the CUDA
    sort/gather on the card against the plain path on the CPU."""
    _need_card()
    from instantsfm_tpu_torch.gs import rasterize

    rng = np.random.default_rng(0)
    G, W, H = 300, 128, 96
    means = rng.uniform([-1, -1, 3], [1, 1, 6], (G, 3))
    quats = rng.standard_normal((G, 4))
    scales = rng.uniform(0.02, 0.12, (G, 3))
    opac = rng.uniform(0.3, 0.95, G)
    sh = rng.standard_normal((G, 16, 3)) * 0.3
    K = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]])
    out = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        args = [t(a).requires_grad_(True) for a in (means, scales, opac, sh)]
        r = rasterize.rasterize(args[0], t(quats), args[1], args[2], args[3],
                                t(np.eye(4)), t(K), width=W, height=H,
                                sh_degree=3)
        (r.rgb.square().mean() + r.alpha.mean() + 0.1 * r.depth.mean()
         ).backward()
        out[dev] = [r.rgb, r.alpha, r.depth] + [a.grad for a in args]
    for c, g in zip(out["cpu"], out["cuda"]):
        _rel_close(g.cpu(), c, 1e-4)


@pytest.mark.cuda
def test_gs_runner_card_matches_cpu(tmp_path):
    """Three training steps of Runner on the card against the CPU, on a
    small scene: per-step losses within rel 1e-4."""
    _need_card()
    import chip_smoke
    from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner

    chip_smoke.make_gs_scene(str(tmp_path), "cpu", 600, 6, 96, 72)
    losses = {}
    for dev in ("cpu", "cuda"):
        cfg = GSConfig(data_dir=str(tmp_path),
                       result_dir=str(tmp_path / f"out_{dev}"), max_steps=3,
                       test_every=3, sh_degree=1, sh_degree_interval=1,
                       tile_capacity=128, eval_steps=(), save_steps=(),
                       capacity_mult=2.0)
        f0 = k23.composite_fwd.launches
        losses[dev] = Runner(cfg, log=lambda *a: None, device=dev).train()
        launched = k23.composite_fwd.launches - f0
    assert launched == 3
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_gs_options_runner_card_matches_cpu(tmp_path):
    """Ten Runner steps with pose_opt, app_opt, the bilateral grid, the
    depth loss, selective Adam and pose noise on the card against the CPU,
    on a small scene: ``chip_smoke.gs_opts_card_vs_cpu``'s bounds (losses
    within rel 1e-4, pose deltas within 0.05 lr, grids 99.5% within
    0.05 lr and all within 2 lr a step)."""
    _need_card()
    import chip_smoke

    rec, checks = chip_smoke.gs_opts_card_vs_cpu(str(tmp_path))
    assert all(checks.values()), (checks, rec)


@pytest.mark.cuda
def test_depth_loss_k3_card_matches_cpu(tmp_path, monkeypatch):
    """One view's loss with the depth term on the card and on the CPU: K3's
    gradient on the card's own inputs (a gout with nonzero alpha and depth
    rows) within 1e-4 of each column's max of its plain version, the loss
    within rel 1e-5 and the splat gradients within 1e-4 of each field's
    max (the quaternions' are float noise on isotropic gaussians and are
    left out)."""
    _need_card()
    import chip_smoke
    from instantsfm_tpu_torch.gs import splats as gs_splats
    from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner

    chip_smoke.make_gs_scene(str(tmp_path), "cpu", 600, 6, 96, 72)
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    res = {}
    for dev in ("cpu", "cuda"):
        cfg = GSConfig(data_dir=str(tmp_path),
                       result_dir=str(tmp_path / f"out_{dev}"), max_steps=1,
                       test_every=3, sh_degree=1, sh_degree_interval=1,
                       tile_capacity=128, eval_steps=(), save_steps=(),
                       capacity_mult=2.0, init_opa=0.5, depth_loss=True)
        r = Runner(cfg, log=lambda *a: None, device=dev)
        loss, _ = r._loss(r.splats, r._prepare(r.trainset[1]), None, 1)
        loss.backward()
        res[dev] = (loss.item(), {
            f: getattr(r.splats, f).grad for f in gs_splats.FLOAT_FIELDS})
        if dev == "cpu":          # the card's K3 inputs, kept at its launcher
            launch = k23._launch_bwd
            kept = []
            monkeypatch.setattr(k23, "_launch_bwd",
                                lambda *a: kept.append(a) or launch(*a))
    attrs, logt, gout, ntx = kept[0]
    assert gout[:, 3].abs().max() > 0 and gout[:, 4].abs().max() > 0
    got = k23.composite_bwd(attrs, logt, gout, ntx).cpu()
    want = k23.composite_bwd_reference(attrs.cpu(), logt.cpu(), gout.cpu(),
                                       ntx)
    for c in range(10):
        _rel_close(got[..., c], want[..., c], 1e-4)
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 1e-5 * abs(res["cpu"][0])
    for f, g in res["cuda"][1].items():
        if f != "quats":
            _rel_close(g.cpu(), res["cpu"][1][f], 1e-4)


@pytest.mark.cuda
def test_selective_adam_card_keeps_unseen_rows():
    """Three selective Adam steps on the card: the unseen rows keep their
    parameters and both moments bit for bit; the parameters match the CPU
    within 1e-4 of the lr (a few float32 ulps of parameters near 1, as
    ``tests/test_torch_gs_train.py`` holds Adam against optax) and the
    first moments within 1e-6 of their max."""
    _need_card()
    from instantsfm_tpu_torch.gs import optim as gs_optim

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4096, 15, 3)).astype(np.float32)
    grads = rng.standard_normal((3,) + p0.shape).astype(np.float32)
    masks = rng.uniform(size=(3, 4096)) < 0.5
    out = {}
    for dev in ("cpu", "cuda"):
        p = torch.tensor(p0, device=dev, requires_grad=True)
        opt = torch.optim.Adam([p], lr=1e-2, eps=1e-15)
        for g, m in zip(grads, masks):
            vis = torch.tensor(m, device=dev)
            st = opt.state.get(p, {})
            before = [p.detach().clone()] + [
                st[k].clone() if k in st else torch.zeros_like(p)
                for k in gs_optim.MOMENTS]
            p.grad = torch.tensor(g, device=dev)
            gs_optim.selective_step(opt, vis)
            after = [p.detach()] + [opt.state[p][k] for k in gs_optim.MOMENTS]
            for b, a in zip(before, after):
                assert torch.equal(a[~vis], b[~vis])
        out[dev] = (p.detach().cpu(), opt.state[p]["exp_avg"].cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-4 * 1e-2)
    _rel_close(out["cuda"][1], out["cpu"][1], 1e-6)


@pytest.mark.cuda
def test_lpips_card_matches_cpu():
    """LPIPS with seeded random weights on an 800x608 pair: the card (full
    float32, no TF32) within rel 1e-4 of the CPU."""
    _need_card()
    from instantsfm_tpu_torch import convert
    from instantsfm_tpu_torch.gs import lpips
    from instantsfm_tpu_torch.utils.device import full_f32

    w = lpips.random_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (608, 800, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1) \
        .astype(np.float32)
    vals = {}
    for dev in ("cpu", "cuda"):
        net = convert.lpips_from_numpy(w, dev)
        with torch.no_grad(), full_f32():
            vals[dev] = float(net(torch.tensor(a, device=dev),
                                  torch.tensor(b, device=dev)))
    assert vals["cpu"] > 0
    assert abs(vals["cuda"] - vals["cpu"]) <= 1e-4 * vals["cpu"], vals


@pytest.mark.cuda
def test_mapper_card_matches_cpu(tmp_path):
    """The global mapper on a 14-image ring database
    (``chip_smoke.write_ring_db``: 600 points, each image matched with the
    next 6) on the card against the CPU, both float64, the RANSAC draws from
    seeded CPU generators (one a chunk and model) moved to the card: the
    same registered images and tracks, poses and points within 1e-6
    (quaternions up to sign; centers and points relative to the
    scene extent: sums in other orders).  At this size global positioning
    and bundle adjustment take the dense Schur solve (C * PC <= 2048 and
    T <= 8192, as in the JAX package), so K1 does not run here; it runs in
    ``chip_smoke.py``'s SfM phase."""
    _need_card()
    import chip_smoke
    from instantsfm_tpu_torch.config import Config
    from instantsfm_tpu_torch.io.colmap_db import read_colmap_database
    from instantsfm_tpu_torch.pipeline.mapper import solve_global_mapper

    db = str(tmp_path / "database.db")
    chip_smoke.write_ring_db(db, num_cams=14, num_pts=600, window=6)
    out = {}
    for dev in ("cpu", "cuda"):
        vg, cams, imgs, name = read_colmap_database(db)
        out[dev] = solve_global_mapper(vg, cams, imgs, Config(name),
                                       log=lambda *a: None, device=dev)
    _, ic, tc, _ = out["cpu"]
    _, ig, tg, _ = out["cuda"]
    assert ic.registered.sum() == 14
    assert np.array_equal(ig.registered, ic.registered)
    assert tg.num_tracks == tc.num_tracks > 100
    assert np.array_equal(tg.obs_image, tc.obs_image)
    dq = np.minimum(np.abs(ig.qvec - ic.qvec).max(1),
                    np.abs(ig.qvec + ic.qvec).max(1))
    assert np.max(dq) < 1e-6
    extent = np.linalg.norm(ic.centers().max(0) - ic.centers().min(0))
    assert np.max(np.abs(ig.centers() - ic.centers())) < 1e-6 * extent
    assert np.max(np.abs(tg.xyz - tc.xyz)) < 1e-6 * extent


@pytest.mark.cuda
def test_sift_and_matching_card_match_cpu(tmp_path):
    """SIFT and matching on the card against the CPU, on three views of
    ``tests/test_pixels_e2e.py``'s scene at 480x360 (rendered on the card),
    with TF32 turned on for cuDNN and cuBLAS around the card's calls: the
    blur and the similarity product must keep full float32 all the same.
    Extraction: the valid keypoint sets agree to all but 1% (float32 sums
    in another order can flip an extremum at a threshold); the common
    keypoints' xy agree exactly, their descriptors to 1e-5 where their
    orientations agree (the card's histograms sum with atomics), and the
    orientations differ for at most 1% of them.  Matching, on the same
    descriptors: each pair's matches agree to all but 1%.  The views are
    the first three of the 16 (10 degrees apart)."""
    _need_card()
    import chip_smoke
    from instantsfm_tpu_torch.features import matching, sift
    from instantsfm_tpu_torch.features.handler import load_gray

    chip_smoke.render_plane_scene(str(tmp_path), "cuda")
    cfg = sift.SiftConfig(max_keypoints=3000)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    descs, valids = [], []
    for i in range(3):
        img, _, _ = load_gray(str(tmp_path / "images" / f"v{i:03d}.png"), 1600)
        cpu = sift.extract(img, cfg, device="cpu")
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            card = sift.extract(img, cfg, device="cuda")
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
        key = lambda out: {(float(x), float(y), float(s)): k for k, ((x, y), s, v)
                           in enumerate(zip(out[0], out[1], out[4])) if v}
        kc, kg = key(cpu), key(card)
        assert len(kc) > 500
        assert len(set(kc) ^ set(kg)) <= 0.01 * len(kc)
        common = sorted(set(kc) & set(kg))
        ic = np.array([kc[c] for c in common])
        ig = np.array([kg[c] for c in common])
        np.testing.assert_array_equal(card[0][ig], cpu[0][ic])
        same_ori = np.abs(card[2][ig] - cpu[2][ic]) <= 1e-5
        assert same_ori.mean() >= 0.99
        np.testing.assert_allclose(card[3][ig][same_ori], cpu[3][ic][same_ori],
                                   atol=1e-5)
        descs.append(cpu[3])
        valids.append(cpu[4])
    out = {}
    for dev in ("cpu", "cuda"):
        torch.backends.cuda.matmul.allow_tf32 = dev == "cuda"
        try:
            out[dev] = matching.match_all_pairs(descs, valids, ratio=0.9,
                                                device=dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32[1]
    for pair, m in out["cpu"].items():
        got = {tuple(r) for r in out["cuda"][pair].tolist()}
        want = {tuple(r) for r in m.tolist()}
        assert len(want) > 50
        assert len(got ^ want) <= 0.01 * len(want), pair


def _learned_nets(device, seed=0):
    """The learned front-ends' modules from ``chip_smoke.learned_weights``
    (seeded random, SuperPoint, DISK and LightGlue at their published
    widths) on ``device``."""
    import chip_smoke
    from instantsfm_tpu_torch import convert

    w = chip_smoke.learned_weights(seed)
    nets = {name: build(w[name], device)
            for name, (_, _, build) in chip_smoke.EXTRACTORS.items()}
    nets["lightglue"] = convert.lightglue_from_numpy(
        w["superpoint_lightglue"], device)
    return w, nets


@pytest.mark.cuda
def test_learned_extractors_and_lightglue_card_match_cpu(tmp_path):
    """SuperPoint, DISK and DeDoDe (2,048 keypoints) on two views of the
    plane scene at 480x360, on the card with TF32 turned on around the
    calls (the extractors must keep full float32) against the CPU: the
    same valid keypoints but for 1%, scores within 1e-4 of the largest, in
    the same slots up to score ties, descriptors within 1e-4
    (``chip_smoke.keypoints_agree``).  LightGlue on SuperPoint's two
    views: log-scores over the valid entries within 1e-4, at least 99% of
    the mutual-argmax matches (threshold 0; random weights leave few
    between two views) equal."""
    _need_card()
    import chip_smoke
    from instantsfm_tpu_torch.features import lightglue
    from instantsfm_tpu_torch.features.handler import load_gray
    from instantsfm_tpu_torch.utils.device import full_f32

    chip_smoke.render_plane_scene(str(tmp_path), "cuda")
    _, card = _learned_nets("cuda")
    _, cpu = _learned_nets("cpu")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    feats = []
    for i in range(2):
        path = str(tmp_path / "images" / f"v{i:03d}.png")
        for name, (mod, cfg, _) in chip_smoke.EXTRACTORS.items():
            img, _, (w, h) = load_gray(path, 1600, rgb=name != "superpoint")
            cfg = cfg(max_keypoints=2048)
            want = mod.extract(img, cpu[name], cfg, device="cpu")
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                got = mod.extract(img, card[name], cfg, device="cuda")
            finally:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = tf32
            assert want[3].sum() > 500
            agree = chip_smoke.keypoints_agree(want, got, desc_tol=1e-4)
            assert agree["failures"] == [], (name, agree)
            if name == "superpoint":
                feats.append((want[0], want[2], want[3],
                              np.array([w, h], np.float32)))
    res = {}
    for dev, net in (("cpu", cpu["lightglue"]), ("cuda", card["lightglue"])):
        (k0, d0, m0, s0), (k1, d1, m1, s1) = [
            [torch.as_tensor(a, device=dev)[None] for a in f] for f in feats]
        torch.backends.cuda.matmul.allow_tf32 = dev == "cuda"
        try:
            with torch.inference_mode(), full_f32():
                scores = net(k0, d0, m0, k1, d1, m1, s0, s1)
                m, c, _ = lightglue.filter_matches(scores, m0, m1, 0.0, 2048)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32[1]
        mask = (m0[0, :, None] & m1[0, None, :]).cpu()
        res[dev] = (scores[0].cpu()[mask], {tuple(r) for r in
                                            m[0, :int(c[0])].tolist()})
    assert float((res["cuda"][0] - res["cpu"][0]).abs().max()) <= 1e-4
    want, got = res["cpu"][1], res["cuda"][1]
    assert len(got ^ want) <= 0.01 * len(want)


@pytest.mark.cuda
def test_generate_database_superpoint_lightglue_on_card(tmp_path,
                                                        monkeypatch):
    """``generate_database("superpoint+lightglue")`` on the card, on four
    views of the plane scene with seeded random weights written as npz
    files: the database holds every image, the keypoints the CPU run
    writes (in count) and all 6 pairs matched; read back by
    ``read_colmap_database``."""
    _need_card()
    import chip_smoke
    from instantsfm_tpu_torch.features.handler import generate_database
    from instantsfm_tpu_torch.io.colmap_db import read_colmap_database

    chip_smoke.render_plane_scene(str(tmp_path / "scene"), "cuda", n_cams=4)
    weights, _ = _learned_nets("cpu")
    for key, env in (("superpoint", "INSTANTSFM_SUPERPOINT_WEIGHTS"),
                     ("superpoint_lightglue", "INSTANTSFM_LIGHTGLUE_WEIGHTS")):
        np.savez(tmp_path / f"{key}.npz", **weights[key])
        monkeypatch.setenv(env, str(tmp_path / f"{key}.npz"))
    stats = {}
    for dev in ("cpu", "cuda"):
        stats[dev] = generate_database(
            str(tmp_path / "scene" / "images"), str(tmp_path / f"{dev}.db"),
            feature_name="superpoint+lightglue", max_keypoints=2048,
            log=lambda *a: None, device=dev)
    st = stats["cuda"]
    assert st["images"] == 4 and st["pairs"] == 6
    assert st["keypoints"] == stats["cpu"]["keypoints"] > 4 * 500
    vg, _, images, name = read_colmap_database(str(tmp_path / "cuda.db"))
    assert name == "superpoint+lightglue" and images.num_images == 4
    assert len(images.kp_xy) == st["keypoints"]
    assert len(vg.matches) == st["verified_matches"]


@pytest.mark.cuda
def test_svd3x3_large_batch_card_matches_cpu():
    """``math/epipolar.py::svd3x3`` on 40,000 matrices on the card, the
    batch of view-graph calibration at 20,000 image pairs: cuSOLVER's
    batched eigensolver refuses such a batch in one call, so the
    eigensolves run ``EIGH_BATCH`` matrices at a time.  In float32 the two
    largest singular values agree with the CPU's to 1e-5 of the largest;
    the smallest comes from an eigenvalue of MᵀM, which float32 sums in
    another order know to eps * s_max², so to 1e-3 of the largest."""
    _need_card()
    from instantsfm_tpu_torch.math import epipolar

    M = torch.randn((2, 20_000, 3, 3), generator=torch.Generator()
                    .manual_seed(0))
    _, s_cpu, _ = epipolar.svd3x3(M)
    U, s, V = epipolar.svd3x3(M.cuda())
    torch.cuda.synchronize()
    rel = (s.cpu() - s_cpu).abs() / s_cpu[..., :1]
    assert rel[..., :2].max().item() < 1e-5
    assert rel[..., 2].max().item() < 1e-3
    rec = U @ torch.diag_embed(s) @ V.transpose(-1, -2)
    assert (rec.cpu() - M).abs().max().item() < 1e-3


@pytest.mark.cuda
def test_svd3x3_double_singular_value_on_card():
    """EᵀE of an essential matrix has a double eigenvalue; on this one (an
    essential matrix of relative pose, scaled to unit norm, its bits kept
    as found) cuSOLVER's batched float32 eigensolver failed to converge,
    so ``svd3x3`` solves in float64: the card's factors agree with the
    CPU's, singular values to 1e-6."""
    _need_card()
    from instantsfm_tpu_torch.math import epipolar

    MtM = np.frombuffer(bytes.fromhex(
        "7fa4133ea16d2a3e55511d3ea16d2a3e1324d83ec72b93bd55511d3ec72b93bd"
        "ab09de3e"), np.float32).reshape(1, 3, 3)
    w, v = np.linalg.eigh(MtM[0].astype(np.float64))
    # a matrix M with that MᵀM: M = diag(sqrt(w)) vᵀ
    M = torch.tensor(np.sqrt(np.clip(w, 0, None))[:, None] * v.T,
                     dtype=torch.float32)[None].repeat(64, 1, 1)
    _, s_cpu, _ = epipolar.svd3x3(M)
    _, s, _ = epipolar.svd3x3(M.cuda())
    torch.cuda.synchronize()
    np.testing.assert_allclose(s.cpu().numpy(), s_cpu.numpy(), atol=1e-6)
    W, _ = torch.linalg.eigh(torch.tensor(MtM, device="cuda").double())
    np.testing.assert_allclose(W.cpu().numpy()[0], w, atol=1e-7)


@pytest.fixture
def nccl_world1():
    """A process group of one rank over NCCL (the card takes one rank)."""
    _need_card()
    import socket

    from instantsfm_tpu_torch.parallel import multihost
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.initialize(coordinator=f"localhost:{port}", num_processes=1,
                         process_id=0, device="cuda", timeout_s=60)
    try:
        assert torch.distributed.get_backend() == "nccl"
        yield
    finally:
        multihost.shutdown()


@pytest.mark.cuda
def test_sharded_ba_nccl_matches_single_device(nccl_world1):
    """``optimize_sharded`` (what ``optimize_auto`` runs above one rank: the
    point-local partition, the all-reduces, K1 on the rank's buckets) over
    the NCCL group against the single-device bucketed ``optimize``, both
    float64 PCG, 8 LM iterations at most: poses within 1e-6 (atomics sum
    in other orders), the same iteration count within one, K1 launched."""
    import dataclasses

    import chip_smoke
    from instantsfm_tpu_torch import config
    from instantsfm_tpu_torch.parallel import sharded
    from instantsfm_tpu_torch.pipeline import ba
    from instantsfm_tpu_torch.scene import cameras as cm
    from instantsfm_tpu_torch.solve import robust
    from instantsfm_tpu_torch.solve.problems import make_ba_problem

    cameras, images, tracks, _ = chip_smoke.make_scene(num_cams=20,
                                                       num_pts=9000)
    params, obs = chip_smoke.scene_problem(cameras, images, tracks,
                                           torch.float64, "cuda")
    opts = dict(config.BUNDLE_ADJUSTER_OPTIONS, max_num_iterations=8)
    cfg = dataclasses.replace(ba._lm_config(opts), solver="pcg")
    problem, kernel = make_ba_problem(cm.SIMPLE_RADIAL), robust.huber(1.0)
    cam1, pts1, h1 = sharded.optimize_auto(problem, kernel, cfg, params, obs,
                                           device="cuda")
    launches = k1.schur_wchain.launches
    cam2, pts2, h2 = sharded.optimize_sharded(problem, kernel, cfg, params,
                                              obs, device="cuda")
    assert k1.schur_wchain.launches > launches
    assert abs(len(h1) - len(h2)) <= 1
    for k in ("q", "t"):
        np.testing.assert_allclose(cam2[k].cpu(), cam1[k].cpu(), atol=1e-6)
    extent = float((pts1.max(0).values - pts1.min(0).values).norm())
    assert float((pts2 - pts1).abs().max()) < 1e-6 * extent


@pytest.mark.cuda
def test_distributed_gs_step_nccl_matches_single_device(nccl_world1,
                                                        tmp_path):
    """The gaussian-sharded 3DGS loss and gradients over the NCCL group
    (the all-to-all exchange, K2/K3 on the rank's views) against the
    Runner's single-device loss on a small scene (its initial scales
    perturbed per axis), float32: loss within 1e-5, gradients within 1e-4
    of each field's largest; K2 and K3 launch once a view."""
    import chip_smoke
    from instantsfm_tpu_torch.gs import distributed as gd
    from instantsfm_tpu_torch.gs.splats import FLOAT_FIELDS
    from instantsfm_tpu_torch.gs.trainer import GSConfig, Runner

    chip_smoke.make_gs_scene(str(tmp_path), "cpu", 600, 6, 96, 72)
    runner = Runner(GSConfig(data_dir=str(tmp_path), result_dir=str(
        tmp_path / "out"), batch_size=2, sh_degree=1, tile_capacity=128,
        eval_steps=(), save_steps=()), log=lambda *a: None, device="cuda")
    views = runner._views(np.random.default_rng(0))
    pool = runner.splats
    with torch.no_grad():
        # anisotropic: isotropic gaussians' quaternion gradients are float
        # noise, whose sum order on the card no bar can hold
        pool.scales.add_(0.3 * torch.randn(
            pool.scales.shape, generator=torch.Generator().manual_seed(0)
        ).cuda())
    offset = torch.zeros((pool.means.shape[0], 2), device="cuda",
                         requires_grad=True)
    loss1 = torch.stack([runner._loss(pool, v, offset, 1)[0]
                         for v in views]).mean()
    loss1.backward()
    sp = gd.shard_splats(gd.pad_splats(pool, 1), 0, 1)
    for f in FLOAT_FIELDS:
        getattr(sp, f).requires_grad_(True)
    offset2 = torch.zeros_like(offset, requires_grad=True)
    batch = {"camtoworld": torch.stack([v["camtoworld"] for v in views]),
             "K": torch.stack([v["K"] for v in views]),
             "image": torch.stack([v["image"] for v in views])}
    f0, b0 = k23.composite_fwd.launches, k23.composite_bwd.launches
    objective, loss2, _, _, _ = gd.distributed_loss(
        sp, offset2, batch, 96, 72, 1, tile_capacity=128)
    objective.backward()
    assert k23.composite_fwd.launches - f0 == 2
    assert k23.composite_bwd.launches - b0 == 2
    assert abs(loss2.item() - loss1.item()) <= 1e-5 * loss1.item()
    for f in FLOAT_FIELDS:
        _rel_close(getattr(sp, f).grad.cpu(), getattr(pool, f).grad.cpu(),
                   1e-4)
    _rel_close(offset2.grad.cpu(), offset.grad.cpu(), 1e-4)


@pytest.mark.cuda
def test_nccl_world_matches_one_card(tmp_path):
    """Where the machine has two or more cards: a group of min(cards, 4)
    processes, one a card, formed through torchrun's variables over NCCL
    (``tests/torch_dist.py``'s "world" scenario), against this process on
    one card.  ``optimize_sharded`` of a 20-image float64 BA solve (PCG,
    K1 on each rank's buckets) against the single-device bucketed
    ``optimize_auto``: the same LM iterations within one, poses within
    1e-6 and points within 1e-6 of the extent (as
    ``test_sharded_ba_nccl_matches_single_device``); the gaussian-sharded
    3DGS loss of one view a rank and its gathered gradients against each
    rank's own loss on its card (``chip_smoke.gs_shard_check``) within
    1e-5 and 1e-4 of each field's largest, K2 and K3 once on each
    rank."""
    _need_card()
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two or more cards, the machine has {cards}")
    import chip_smoke
    from instantsfm_tpu_torch.parallel import sharded
    # pytest puts this directory on the path (an installed package named
    # "tests" may shadow it as a package)
    from torch_dist import lm_problem, run_group, to_device

    world = min(cards, 4)
    cameras, images, tracks, _ = chip_smoke.make_scene(num_cams=20,
                                                       num_pts=9000)
    params, obs = chip_smoke.scene_problem(cameras, images, tracks,
                                           torch.float64, "cpu")
    scene = str(tmp_path / "gs")
    chip_smoke.make_gs_scene(scene, "cpu", 600, 6, 96, 72)
    ranks = run_group(world, "world", dict(
        device="cuda", pairs=11, lm={"ba": (params, obs, 0)},
        gs=dict(scene=scene, sh_degree=1, tile_capacity=128)),
        str(tmp_path / "group"), launcher="torchrun")
    assert [r["device"] for r in ranks] == [f"cuda:{r}" for r in range(world)]
    assert all(r["backend"] == "nccl" for r in ranks)

    problem, kernel, cfg = lm_problem("ba")
    cam1, pts1, h1 = sharded.optimize_auto(
        problem, kernel, cfg, to_device(params, "cuda"),
        to_device(obs, "cuda"), device="cuda")
    got = ranks[0]["ba_sharded"]
    assert all(r["ba_sharded"]["k1_launches"] > 0 for r in ranks)
    assert abs(len(got["history"]) - len(h1)) <= 1
    for k in ("q", "t"):
        np.testing.assert_allclose(got["cam"][k], cam1[k].cpu(), atol=1e-6)
    pts1 = pts1.cpu().numpy()
    extent = float(np.linalg.norm(pts1.max(0) - pts1.min(0)))
    assert float(np.abs(got["pts"] - pts1).max()) < 1e-6 * extent

    for r in ranks:
        gs = r["gs"]
        assert abs(gs["loss_dist"] - gs["loss_single"]) \
            <= 1e-5 * gs["loss_single"]
        assert gs["k2_launches"] == gs["k3_launches"] == 1
        for f, g in gs["grads_single"].items():
            _rel_close(torch.as_tensor(gs["grads_dist"][f]),
                       torch.as_tensor(g), 1e-4)


@pytest.mark.cuda
def test_relative_pose_errors_card_matches_cpu():
    """``eval.align.relative_pose_errors_deg`` on the card against the CPU
    (float64 on both), 300 images, 50,000 of the 89,700 ordered pairs
    sampled: the same unregistered penalties, errors within 1e-6 degree."""
    _need_card()
    from instantsfm_tpu_torch.eval import align

    rng = np.random.default_rng(0)
    q = rng.standard_normal((300, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.standard_normal((300, 3))
    q_est = q + 0.02 * rng.standard_normal(q.shape)
    q_est /= np.linalg.norm(q_est, axis=1, keepdims=True)
    t_est = t + 0.05 * rng.standard_normal(t.shape)
    registered = rng.uniform(size=300) > 0.05
    errs = {dev: align.relative_pose_errors_deg(
        q_est, t_est, q, t, registered, max_pairs=50_000, device=dev)
        for dev in ("cpu", "cuda")}
    assert errs["cuda"].shape == (50_000,)
    fin = np.isfinite(errs["cpu"])
    assert np.array_equal(fin, np.isfinite(errs["cuda"])) and not fin.all()
    np.testing.assert_allclose(errs["cuda"][fin], errs["cpu"][fin], rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
def test_chamfer_distance_card_matches_cpu():
    """The blocked nearest neighbour on the card against the CPU, float32,
    full-precision products: within 1e-5 relative."""
    _need_card()
    from instantsfm_tpu_torch.eval import chamfer

    rng = np.random.default_rng(0)
    p1 = rng.uniform(-0.5, 0.5, (20_000, 3))
    p2 = rng.uniform(-0.5, 0.5, (15_000, 3))
    card = chamfer.chamfer_distance_device(p1, p2, device="cuda")
    cpu = chamfer.chamfer_distance_device(p1, p2, device="cpu")
    assert abs(card - cpu) <= 1e-5 * cpu
    assert abs(card - chamfer.chamfer_distance_kdtree(p1, p2)) <= 1e-3 * cpu


def _two_view_pair(config):
    """Two SIMPLE_RADIAL views of 150 points (20% outliers) with the pair's
    model set to the ground truth for ``config`` (E's pose, F or the plane
    z = 6's homography), in the port's types."""
    from scipy.spatial.transform import Rotation as Rot

    from instantsfm_tpu_torch.scene import cameras as cm
    from instantsfm_tpu_torch.scene import types as st

    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (150, 3)) + np.array([0, 0, 6.0])
    R2 = Rot.from_rotvec([0.05, 0.4, 0.02]).as_matrix()
    t2 = -R2 @ np.array([2.0, 0.2, 0.5])
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    proj = lambda Rm, t: (pts @ Rm.T + t) @ K.T
    xy1, xy2 = (p[:, :2] / p[:, 2:] for p in (proj(np.eye(3), 0), proj(R2, t2)))
    xy1 = xy1 + 0.1 * rng.standard_normal(xy1.shape)
    xy2 = xy2 + 0.1 * rng.standard_normal(xy2.shape)
    out = rng.choice(150, 30, replace=False)
    xy2[out] = rng.uniform(0, 640, (30, 2))
    n = 150
    cameras = st.Cameras(
        model_ids=np.array([cm.SIMPLE_RADIAL], np.int32),
        widths=np.array([640]), heights=np.array([480]),
        params=cm.pad_params([500.0, 320.0, 240.0, 0.0])[None],
        has_prior_focal=np.array([True]), has_refined_focal=np.array([False]))
    images = st.Images(
        cam_idx=np.zeros(2, np.int32), names=["a", "b"],
        qvec=np.tile([0., 0, 0, 1], (2, 1)), tvec=np.zeros((2, 3)),
        registered=np.ones(2, bool), cluster_id=np.full(2, -1, np.int32),
        kp_xy=np.concatenate([xy1, xy2]),
        kp_offset=np.array([0, n, 2 * n], np.int64))
    tx = np.array([[0, -t2[2], t2[1]], [t2[2], 0, -t2[0]],
                   [-t2[1], t2[0], 0]])
    Ki = np.linalg.inv(K)
    vg = st.ViewGraph(
        pair_i=np.array([0], np.int32), pair_j=np.array([1], np.int32),
        valid=np.ones(1, bool), config=np.array([config], np.int8),
        E_mat=np.eye(3)[None].copy(), F_mat=(Ki.T @ tx @ R2 @ Ki)[None],
        H_mat=(K @ (R2 + np.outer(t2, [0, 0, 1 / 6.0])) @ Ki)[None],
        qvec=Rot.from_matrix(R2).as_quat()[None],
        tvec=(t2 / np.linalg.norm(t2))[None],
        matches=np.stack([np.arange(n), np.arange(n)], 1).astype(np.int32),
        match_offset=np.array([0, n], np.int64), inlier_mask=np.ones(n, bool))
    return vg, cameras, images


@pytest.mark.cuda
@pytest.mark.parametrize("config", [2, 3, 4],
                         ids=["calibrated", "uncalibrated", "planar"])
def test_pair_inliers_card_matches_cpu(config):
    """``pipeline.pair_inliers.image_pair_inliers_count`` on the card
    against the CPU (float64): the same inlier masks."""
    _need_card()
    from instantsfm_tpu_torch.pipeline import pair_inliers
    from instantsfm_tpu_torch.pipeline.relpose import undistort_images

    opts = dict(max_epipolar_error_E=1.0, max_epipolar_error_F=4.0,
                max_epipolar_error_H=4.0)
    masks = {}
    for dev in ("cpu", "cuda"):
        vg, cameras, images = _two_view_pair(config)
        undistort_images(cameras, images, device=dev)
        pair_inliers.image_pair_inliers_count(vg, cameras, images, opts,
                                              device=dev)
        masks[dev] = vg.inlier_mask
    assert 0 < masks["cpu"].sum() < len(masks["cpu"])
    np.testing.assert_array_equal(masks["cuda"], masks["cpu"])


@pytest.mark.cuda
def test_fisheye_undistorter_card_matches_cpu(tmp_path):
    """``undistort_fisheye_images`` on an OPENCV_FISHEYE model, the remap
    grid on the card against the CPU (float64): grids within 1e-9 px,
    images within one level, the same ``geo_locs.txt``."""
    _need_card()
    from instantsfm_tpu_torch.io import colmap_model as cmio
    from instantsfm_tpu_torch.io.image import imwrite
    from instantsfm_tpu_torch.pipeline import fisheye_undistorter as fe
    from instantsfm_tpu_torch.scene import cameras as cm

    rng = np.random.default_rng(0)
    W, H = 640, 480
    params = np.array([300., 300, W / 2, H / 2, 0.05, -0.01, 0.001, 0.0])
    cmio.write_model(
        [cmio.ModelCamera(1, cm.OPENCV_FISHEYE, W, H, params)],
        [cmio.ModelImage(i + 1, np.array([1., 0, 0, 0]),
                         rng.standard_normal(3), 1, f"{i}.png",
                         np.zeros((0, 2)), np.zeros(0, np.int64))
         for i in range(2)], [], str(tmp_path / "sparse"))
    (tmp_path / "images").mkdir()
    for i in range(2):
        imwrite(str(tmp_path / "images" / f"{i}.png"),
                rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    grids = [fe.remap_grid(cm.OPENCV_FISHEYE, cm.pad_params(params), W, H,
                           device=dev) for dev in ("cpu", "cuda")]
    np.testing.assert_allclose(grids[1], grids[0], rtol=0, atol=1e-9)
    outs = {}
    for dev in ("cpu", "cuda"):
        outs[dev] = fe.undistort_fisheye_images(
            str(tmp_path / "sparse"), str(tmp_path / "images"),
            str(tmp_path / dev / "undist"), log=lambda *a: None, device=dev)
    assert sorted(outs["cuda"]) == sorted(outs["cpu"]) == [1, 2]
    for i in (1, 2):
        diff = np.abs(outs["cuda"][i].astype(int) - outs["cpu"][i].astype(int))
        assert diff.max() <= 1
    assert (tmp_path / "cuda" / "geo_locs.txt").read_bytes() == \
        (tmp_path / "cpu" / "geo_locs.txt").read_bytes()
