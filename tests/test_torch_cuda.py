"""Card-only tests of the port: the CUDA kernels against their plain torch
versions, and the BA stage and the 3DGS render and training path on the
card against the same code on the CPU.

This file imports neither JAX nor the JAX package, so on the card machine
(which has no JAX) it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Without a card each test skips.  K1's tolerance is per camera entry,
|y - y_plain| <= tol * SUM_{o: cam_o = c} |u_o| (``chip_smoke.k1_check``),
not per max|y|, because a camera's sum of u cancels: tol 1e-5 in float32
(the kernel sums tracks by a butterfly and cameras with atomics in an order
that changes from run to run, the plain version by reshape-sums and
index_add_: sums of up to 2048 track rows and ~2000 camera rows in other
orders), 1e-10 in float64.  K2/K3 (float32 only): rel 1e-5 of each
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
                        chip_smoke.k1_abs_sums(*args, *idx, buckets))


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
    225,536 B of the card's 232,448 B a block)."""
    _need_card()
    dt = getattr(torch, dtype)
    if layout == "table_edge":
        for PC in (1, 8):
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
