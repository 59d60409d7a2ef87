"""K1 (the Schur chain): the port's plain version against the JAX package's
Pallas kernel in interpret mode, and its launch geometry (the CUDA kernel
itself is held against the plain version on a card in
tests/test_torch_cuda.py).

CPU tolerance: both sides sum the same float64 products, in another order
(reshape-sum vs lane butterfly), so rtol 1e-12 with atol 1e-12 * max|u|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsfm_tpu.solve import pallas_schur as ps
from instantsfm_tpu.solve.blocked import bucketize_problem, gather_pt
from instantsfm_tpu_torch.solve import schur_wchain as k1
from tests.synthetic import make_scene
from tests.test_torch_cuda import mixed_layout as _mixed_layout
from tests.test_block_lm import _ba_setup
from tests.test_sharded import _gp_setup

TILE = 128


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
    return k1.schur_wchain(torch.tensor(W), torch.tensor(V_inv),
                           torch.tensor(x), torch.tensor(cam_idx),
                           torch.tensor(pt_idx), buckets).numpy()


@pytest.mark.parametrize("case", ["ba_pc8", "gp_pc3"])
def test_reference_matches_pallas_interpret(case):
    if case == "ba_pc8":
        setup = lambda: _ba_setup(make_scene(num_cams=12, num_pts=300, seed=7))
        PC = 8
    else:
        setup = lambda: _gp_setup(seed=3)
        PC = 3
    W, V_inv, x, cam_idx, pt_idx, buckets = _inputs(setup, PC, seed=1)
    want = _jax_u(W, V_inv, x, cam_idx, buckets, PC)
    got = _torch_u(W, V_inv, x, cam_idx, pt_idx, buckets)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)
    # padded rows give exact zeros
    assert np.all(got[np.all(W == 0, axis=(1, 2))] == 0)


def _brute_force(W, V_inv, x, cam_idx, pt_idx):
    t = np.einsum("opk,op->ok", W, x[cam_idx])
    s = np.zeros((V_inv.shape[0], 3))
    np.add.at(s, pt_idx, t)
    z = np.einsum("tij,tj->ti", V_inv, s)
    return np.einsum("opk,ok->op", W, z[pt_idx])


@pytest.mark.parametrize("PC", [3, 8])
def test_reference_mixed_lengths_matches_brute_force(PC):
    lengths = [2, 8, 32, 64, 512, 2048, 3, 17, 100, 1000]
    W, V_inv, x, cam_idx, pt_idx, buckets = _mixed_layout(lengths, 20, PC, 0)
    assert {b[3] for b in buckets} >= {2, 8, 32, 64, 512, 2048}
    got = _torch_u(W, V_inv, x, cam_idx, pt_idx, buckets)
    want = _brute_force(W, V_inv, x, cam_idx, pt_idx)
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-12 * np.max(np.abs(want)))
    # the segment-sum branch (no buckets) agrees too
    unbucketed = _torch_u(W, V_inv, x, cam_idx, pt_idx, ())
    np.testing.assert_allclose(unbucketed, want, rtol=1e-11,
                               atol=1e-12 * np.max(np.abs(want)))


def test_launch_table_covers_every_row_once():
    lengths = [2, 8, 32, 64, 512, 2048, 3, 17, 100, 1000]
    *_, buckets = _mixed_layout(lengths, 20, 8, 0)
    row_start, rows, log_l, blk_off = k1.launch_table(buckets)
    covered = np.zeros(sum(Tb * L for (_, _, Tb, L) in buckets), int)
    for i, (os_, ps_, Tb, L) in enumerate(buckets):
        assert row_start[i] == os_ and rows[i] == Tb * L and 2 ** log_l[i] == L
        per_block = max(k1.BLOCK, L)
        for b in range(blk_off[i], blk_off[i + 1]):
            lo = os_ + (b - blk_off[i]) * per_block
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
        k1.launch_table(tuple((i, i, 1, 2) for i in range(k1.MAX_BUCKETS + 1)))
