"""K1 (the Schur chain and its camera sum): the port's plain versions
against the JAX package's Pallas kernel in interpret mode (per row, and
summed by camera with ``cam_reduce`` as the JAX matvec does), against a
numpy brute force, and the kernel's launch geometry (the CUDA kernel itself
is held against the plain version on a card in tests/test_torch_cuda.py).

CPU tolerance: both sides sum the same float64 products, in another order
(reshape-sum vs lane butterfly; index_add_ vs a one-hot product), so rtol
1e-12 with atol 1e-12 * max|u| per row and 1e-12 * max|y| per camera."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsfm_tpu.solve import pallas_schur as ps
from instantsfm_tpu.solve.block_lm import cam_reduce
from instantsfm_tpu.solve.blocked import bucketize_problem, gather_pt
from instantsfm_tpu_torch.solve import schur_wchain as k1
from instantsfm_tpu_torch.solve.blocked import bucketize
from tests.synthetic import make_scene
from tests.test_torch_cuda import mixed_layout as _mixed_layout
from tests.test_block_lm import _ba_setup
from tests.test_sharded import _gp_setup

TILE = 128
MIXED = [2, 8, 32, 64, 512, 2048, 3, 17, 100, 1000]   # track lengths


def _inputs(setup, PC, seed):
    """Bucketized (tile-aligned) layout + random W, V_inv, x; W is zero on
    padded rows, as build_system leaves it."""
    problem, params, obs = setup()
    params, obs, buckets, _ = bucketize_problem(params, obs, track_pad=16,
                                                span_align=TILE)
    rng = np.random.default_rng(seed)
    O, T = obs.valid.shape[0], params.pts.shape[0]
    C = jax.tree_util.tree_leaves(params.cam)[0].shape[0]
    W = rng.standard_normal((O, PC, 3)) * np.asarray(obs.valid)[:, None, None]
    A = rng.standard_normal((T, 3, 3))
    V_inv = A @ A.transpose(0, 2, 1) + np.eye(3)
    x = rng.standard_normal((C, PC))
    return (W, V_inv, x, np.asarray(obs.cam_idx, np.int32),
            np.asarray(obs.pt_idx, np.int32), buckets)


def _jax_u(W, V_inv, x, cam_idx, buckets, PC):
    O = W.shape[0]
    Vg = gather_pt(jnp.asarray(V_inv), buckets, O)
    WVt = ps.pack_wvt(jnp.asarray(W), Vg, PC)
    xg = ps.pack_xg(jnp.asarray(x), jnp.asarray(cam_idx))
    logL = jnp.asarray(ps.tile_logL(buckets, TILE))
    u = ps.schur_wchain(WVt, xg, logL, tile=TILE, interpret=True)
    return np.asarray(u)[:, :PC]


def _torch_u(W, V_inv, x, cam_idx, pt_idx, buckets):
    return k1.schur_wchain_rows_reference(
        torch.tensor(W), torch.tensor(V_inv), torch.tensor(x),
        torch.tensor(cam_idx), torch.tensor(pt_idx), buckets).numpy()


def _torch_y(W, V_inv, x, cam_idx, pt_idx, buckets):
    """The wrapper on CPU tensors: the fused plain version, y [C, PC]."""
    return k1.schur_wchain(torch.tensor(W), torch.tensor(V_inv),
                           torch.tensor(x), torch.tensor(cam_idx),
                           torch.tensor(pt_idx), buckets).numpy()


def _case_inputs(case):
    if case == "ba_pc8":
        setup = lambda: _ba_setup(make_scene(num_cams=12, num_pts=300, seed=7))
        PC = 8
    else:
        setup = lambda: _gp_setup(seed=3)
        PC = 3
    return _inputs(setup, PC, seed=1), PC


@pytest.mark.parametrize("case", ["ba_pc8", "gp_pc3"])
def test_reference_matches_pallas_interpret(case):
    (W, V_inv, x, cam_idx, pt_idx, buckets), PC = _case_inputs(case)
    want = _jax_u(W, V_inv, x, cam_idx, buckets, PC)
    got = _torch_u(W, V_inv, x, cam_idx, pt_idx, buckets)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    # padded rows give exact zeros
    assert np.all(got[np.all(W == 0, axis=(1, 2))] == 0)


@pytest.mark.parametrize("case", ["ba_pc8", "gp_pc3"])
def test_fused_reference_matches_pallas_cam_reduce(case):
    """y = cam_reduce(Pallas u) as the JAX matvec forms it, against the
    port's fused plain version (what the CUDA kernel computes)."""
    (W, V_inv, x, cam_idx, pt_idx, buckets), PC = _case_inputs(case)
    C = x.shape[0]
    u = _jax_u(W, V_inv, x, cam_idx, buckets, PC)
    want = np.asarray(cam_reduce(jnp.asarray(u), jnp.asarray(cam_idx), C))
    got = _torch_y(W, V_inv, x, cam_idx, pt_idx, buckets)
    assert got.shape == (C, PC)
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(want)))


def _brute_force(W, V_inv, x, cam_idx, pt_idx):
    t = np.einsum("opk,op->ok", W, x[cam_idx])
    s = np.zeros((V_inv.shape[0], 3))
    np.add.at(s, pt_idx, t)
    z = np.einsum("tij,tj->ti", V_inv, s)
    return np.einsum("opk,ok->op", W, z[pt_idx])


@pytest.mark.parametrize("PC", [3, 8])
def test_reference_mixed_lengths_matches_brute_force(PC):
    W, V_inv, x, cam_idx, pt_idx, buckets = _mixed_layout(MIXED, 20, PC, 0)
    assert {b[3] for b in buckets} >= {2, 8, 32, 64, 512, 2048}
    got = _torch_u(W, V_inv, x, cam_idx, pt_idx, buckets)
    want = _brute_force(W, V_inv, x, cam_idx, pt_idx)
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-12 * np.max(np.abs(want)))
    # the segment-sum branch (no buckets) agrees too
    unbucketed = _torch_u(W, V_inv, x, cam_idx, pt_idx, ())
    np.testing.assert_allclose(unbucketed, want, rtol=1e-11,
                               atol=1e-12 * np.max(np.abs(want)))


@pytest.mark.parametrize("track_pad", [4, 1])
@pytest.mark.parametrize("PC", [3, 8])
def test_fused_reference_matches_brute_force(PC, track_pad):
    """Mixed track lengths (every reduction path of the kernel), with
    padded rows on camera 0; track_pad=1 starts buckets at rows that are
    not multiples of 4, so cam_idx spans (and W spans at PC=3) do not start
    on 16 bytes."""
    W, V_inv, x, cam_idx, pt_idx, buckets = _mixed_layout(
        MIXED, 20, PC, 0, track_pad=track_pad)
    pad = np.all(W == 0, axis=(1, 2))
    assert pad.any() and np.all(cam_idx[pad] == 0)
    if track_pad == 1:
        assert any(os_ % 4 for (os_, _, _, _) in buckets)
    u = _brute_force(W, V_inv, x, cam_idx, pt_idx)
    want = np.zeros_like(x)
    np.add.at(want, cam_idx, u)
    got = _torch_y(W, V_inv, x, cam_idx, pt_idx, buckets)
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-12 * np.max(np.abs(want)))


def _ba_layout():
    problem, params, obs = _ba_setup(make_scene(num_cams=12, num_pts=300,
                                                seed=7))
    O = obs.valid.shape[0]
    bp = bucketize(np.asarray(obs.cam_idx), np.asarray(obs.pt_idx), {},
                   np.asarray(obs.valid), np.zeros((O, 1)), np.zeros(O, bool),
                   params.pts.shape[0])
    return bp.pt_idx, bp.buckets


@pytest.mark.parametrize("layout", ["mixed_pad4", "mixed_pad1", "ba_scene"])
def test_point_slot_is_arithmetic_in_buckets(layout):
    """The kernel does not read pt_idx: row o of bucket (os, ps, Tb, L)
    belongs to point slot ps + (o - os) // L."""
    if layout == "ba_scene":
        pt_idx, buckets = _ba_layout()
    else:
        *_, pt_idx, buckets = _mixed_layout(MIXED, 20, 8, 0,
                                            track_pad=int(layout[-1]))
    assert sum(Tb * L for (_, _, Tb, L) in buckets) == len(pt_idx)
    for (os_, ps_, Tb, L) in buckets:
        o = np.arange(os_, os_ + Tb * L)
        np.testing.assert_array_equal(ps_ + (o - os_) // L, pt_idx[o])


def test_shared_table_branch():
    """The shape rule of the kernel's camera sum: a shared-memory table (the
    accumulator padded to 16-byte words, and x) up to 96 KB (C <= 1,536 at
    PC = 8 in float32, 768 in float64; 4,915 at PC = 1 in float32), global
    atomics above; chip_smoke.py's many_cams case (4,000 cameras) takes the
    global branch, the BA and GP shapes (200 cameras) the shared one."""
    assert k1.shared_table(200, 8, torch.float32)
    assert k1.shared_table(200, 3, torch.float64)
    assert k1.shared_table(1536, 8, torch.float32)
    assert not k1.shared_table(1537, 8, torch.float32)
    assert k1.shared_table(768, 8, torch.float64)
    assert not k1.shared_table(769, 8, torch.float64)
    assert not k1.shared_table(4000, 8, torch.float32)
    assert k1.shared_table(4915, 1, torch.float32)
    assert not k1.shared_table(4916, 1, torch.float32)
    assert k1.shared_table(3510, 3, torch.float32)
    assert not k1.shared_table(3511, 3, torch.float32)


def test_launch_table_covers_every_row_once():
    *_, buckets = _mixed_layout(MIXED, 20, 8, 0)
    row_start, rows, pt_start, log_l, item_off = k1.launch_table(buckets)
    covered = np.zeros(sum(Tb * L for (_, _, Tb, L) in buckets), int)
    for i, (os_, ps_, Tb, L) in enumerate(buckets):
        assert row_start[i] == os_ and rows[i] == Tb * L and 2 ** log_l[i] == L
        assert pt_start[i] == ps_
        per_block = max(k1.BLOCK, L)
        for b in range(item_off[i], item_off[i + 1]):
            lo = os_ + (b - item_off[i]) * per_block
            hi = min(lo + per_block, os_ + Tb * L)
            covered[lo:hi] += 1
            # a block never splits a group
            assert (lo - os_) % L == 0 and (hi - os_) % L == 0
    assert np.all(covered == 1)


def test_launch_table_rejects_bad_layouts():
    with pytest.raises(ValueError):
        k1.launch_table(())
    with pytest.raises(ValueError):
        k1.launch_table(((0, 0, 4, 3),))
    with pytest.raises(ValueError):
        k1.launch_table(((0, 0, 4, 1),))
    with pytest.raises(ValueError):
        k1.launch_table(tuple((i, i, 1, 2) for i in range(k1.MAX_BUCKETS + 1)))


def test_calls_recorded_into_a_graph_count_at_each_replay(monkeypatch):
    """A call made while a CUDA graph records counts once a replay of the
    graph runs it (``recorded`` around the capture, its ``replayed`` after
    each replay), not at the capture; an eager call counts at once."""
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(k1.schur_wchain, "launches", 0)
    monkeypatch.setattr(k1.schur_wchain, "plain_calls", 0)
    k1._count("launches")
    with k1.recorded() as replayed:
        capturing[0] = True
        for _ in range(3):
            k1._count("launches")
        k1._count("plain_calls")
        capturing[0] = False
    with k1.recorded() as replayed_other:
        pass
    assert (k1.schur_wchain.launches, k1.schur_wchain.plain_calls) == (1, 0)
    replayed()
    replayed()
    replayed_other()
    assert (k1.schur_wchain.launches, k1.schur_wchain.plain_calls) == (7, 2)
