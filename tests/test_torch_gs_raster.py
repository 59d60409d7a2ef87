"""Port parity for the 3DGS render path: SH colour, EWA projection, the
attribute packing, tile compositing (K2 forward, K3 backward) and the whole
rasterizer with its gradients, torch (CPU) against the JAX package.

The compositing runs in float32 on both sides (``pack_attrs`` casts), and
JAX runs its Pallas kernels in interpret mode, so both sides compute the
same chunked function, early exit included; they differ only in summation
order (the TPU kernel's triangular matmuls against the port's sequential
prefix sums).  Tolerances say so where they are stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import composite_branch_cases, composite_cull_cases
from instantsfm_tpu.gs import pallas_raster as jpr
from instantsfm_tpu.gs import projection as jproj
from instantsfm_tpu.gs import rasterize as jras
from instantsfm_tpu.gs import sh as jsh
from instantsfm_tpu_torch.gs import composite as tcomp
from instantsfm_tpu_torch.gs import projection as tproj
from instantsfm_tpu_torch.gs import rasterize as tras
from instantsfm_tpu_torch.gs import sh as tsh


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rel, name="", per_tile=False):
    """|got - want| <= rel * max|want| elementwise, the max over the whole
    array or, with ``per_tile``, over each tile (dim 0) apart."""
    got, want = _np(got), _np(want)
    if per_tile:
        for t, (g, w) in enumerate(zip(got, want)):
            _close(g, w, rel, f"{name} tile {t}")
        return
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


# ------------------------------------------------------------------ SH

@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_matches_jax(deg):
    """float64 on both sides: the same terms in the same order."""
    rng = np.random.default_rng(deg)
    dirs = rng.standard_normal((64, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = rng.standard_normal((64, (deg + 1) ** 2, 3))
    _close(tsh.eval_sh(deg, _t(coeffs), _t(dirs)),
           jsh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)), 1e-14)
    _close(tsh.sh_basis(deg, _t(dirs)), jsh.sh_basis(deg, jnp.asarray(dirs)),
           1e-14)
    rgb = rng.uniform(0, 1, (8, 3))
    _close(tsh.sh_to_rgb(tsh.rgb_to_sh(_t(rgb))),
           jsh.sh_to_rgb(jsh.rgb_to_sh(jnp.asarray(rgb))), 1e-14)


# ---------------------------------------------------------- projection

def _gaussians(rng, G=64):
    means = rng.uniform([-1.5, -1.2, 1.0], [1.5, 1.2, 6.0], (G, 3))
    quats = rng.standard_normal((G, 4))
    scales = rng.uniform(0.02, 0.3, (G, 3))
    return means, quats, scales


@pytest.mark.parametrize("camera_model", ["pinhole", "ortho", "fisheye"])
def test_projection_matches_jax(camera_model):
    """float64: the port's [G,3,3] algebra against the JAX scalar-component
    form; rounding differs in the last digits only (rel 1e-10)."""
    rng = np.random.default_rng(1)
    means, quats, scales = _gaussians(rng)
    ang = rng.standard_normal(3) * 0.2
    from scipy.spatial.transform import Rotation
    view = np.eye(4)
    view[:3, :3] = Rotation.from_rotvec(ang).as_matrix()
    view[:3, 3] = [0.1, -0.2, 0.3]
    K = np.array([[150.0, 0, 80], [0, 140.0, 60], [0, 0, 1]])
    W, H = 160, 120
    j = jproj.project(jnp.asarray(means), jnp.asarray(quats),
                      jnp.asarray(scales), jnp.asarray(view), jnp.asarray(K),
                      W, H, camera_model=camera_model)
    t = tproj.project(_t(means), _t(quats), _t(scales), _t(view), _t(K), W, H,
                      camera_model=camera_model)
    assert np.array_equal(_np(t.valid), _np(j.valid))
    assert 0 < _np(t.valid).sum() < len(means)
    v = _np(j.valid)
    _close(_np(t.means2d)[v], _np(j.means2d)[v], 1e-10, "means2d")
    _close(_np(t.conics)[v], _np(j.conics)[v], 1e-10, "conics")
    _close(t.depths, j.depths, 1e-12, "depths")
    np.testing.assert_array_equal(_np(t.radii), _np(j.radii))
    _close(tproj.quat_scale_to_cov(_t(quats), _t(scales)),
           jproj.quat_scale_to_cov(jnp.asarray(quats), jnp.asarray(scales)),
           1e-12)


def test_pack_attrs_matches_jax():
    rng = np.random.default_rng(2)
    G = 10
    parts = [rng.standard_normal((G, 2)), rng.standard_normal((G, 3)),
             rng.uniform(0, 1, (G, 3)), rng.uniform(0, 1, G),
             rng.uniform(1, 5, G)]
    got = tcomp.pack_attrs(*[_t(p) for p in parts])
    want = jpr.pack_attrs(*[jnp.asarray(p) for p in parts])
    assert got.dtype == torch.float32 and got.shape == (G + 1, tcomp.ATTR)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert (tcomp.MX, tcomp.CA, tcomp.CR, tcomp.OP, tcomp.DE) == (
        jpr._MX, jpr._CA, jpr._CR, jpr._OP, jpr._DE)


# ---------------------------------------------------- K2 / K3 compositing

@pytest.mark.parametrize("K,cases", [
    pytest.param(128, composite_branch_cases, id="128"),
    pytest.param(512, composite_branch_cases, id="512"),
    pytest.param(128, composite_cull_cases, id="cull-128"),
    pytest.param(512, composite_cull_cases, id="cull-512")])
def test_composite_tiles_matches_pallas(K, cases):
    """Forward outputs, the entered-chunk pattern and the VJP of the port's
    plain K2/K3 against the Pallas kernels in interpret mode, on tiles that
    reach every branch (``chip_smoke.composite_branch_cases``) and on tiles
    whose gaussians sit on the edges of the CUDA kernels' cull
    (``chip_smoke.composite_cull_cases``).  float32 both sides; summation
    order differs (triangular matmul vs prefix sums): rel 5e-6 of each
    output's max, 1e-5 for the gradients (sums of 256 pixel terms of mixed
    sign); measured at most 7e-7."""
    A, nch, ntx = cases(K)
    rng = np.random.default_rng(K)
    n = A.shape[0]
    g_rgb = rng.standard_normal((n, 3, 256)).astype(np.float32)
    g_alp = rng.standard_normal((n, 256)).astype(np.float32)
    g_dep = rng.standard_normal((n, 256)).astype(np.float32)

    j_out, j_logt = jpr._composite_fwd_raw(jnp.asarray(A), jnp.asarray(nch),
                                           ntx, True)
    t_out, t_logt = tcomp.composite_fwd(torch.tensor(A), torch.tensor(nch), ntx)
    j_entered = _np(j_logt).max(-1) > -1e29
    assert np.array_equal(_np(t_logt).max(-1) > -1e29, j_entered)
    if cases is composite_branch_cases:
        # every branch is reached: empty, early exit, all chunks entered
        assert j_entered[0].sum() == 0
        assert j_entered[2].sum() == K // 128
        if K > 128:
            assert 0 < j_entered[1].sum() < nch[1]
    else:
        # the walk enters every populated chunk of the cull tiles
        assert np.array_equal(j_entered.sum(-1), nch)
    _close(np.where(j_entered[..., None], _np(t_logt), 0),
           np.where(j_entered[..., None], _np(j_logt), 0), 5e-6, "logt")
    # the cull tiles are held tile by tile: a tile of far gaussians has
    # conic gradients ~1e11, which would hide the other tiles' errors
    per_tile = cases is composite_cull_cases
    for r, name in ((slice(0, 3), "rgb"), (3, "alpha"), (4, "depth")):
        _close(_np(t_out)[:, r], _np(j_out)[:, r], 5e-6, name, per_tile)
    if cases is composite_branch_cases:
        assert np.all(_np(t_out)[0] == 0)

    _, vjp = jax.vjp(lambda a: jpr.composite_tiles(a, jnp.asarray(nch), ntx,
                                                   True), jnp.asarray(A))
    (j_g,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_alp), jnp.asarray(g_dep)))
    attrs = torch.tensor(A, requires_grad=True)
    rgb, alpha, dep = tcomp.composite_tiles(attrs, torch.tensor(nch), ntx)
    (t_g,) = torch.autograd.grad((rgb, alpha, dep), attrs,
                                 (torch.tensor(g_rgb), torch.tensor(g_alp),
                                  torch.tensor(g_dep)))
    j_g, t_g = _np(j_g), _np(t_g)
    assert np.all(t_g[:, :, 10:] == 0)
    if cases is composite_branch_cases:
        assert np.all(t_g[0] == 0)
    for c in range(10):
        _close(t_g[..., c], j_g[..., c], 1e-5, f"g_attrs[..., {c}]", per_tile)


def test_composite_wrappers_count_only_kernel_launches():
    """On the CPU the wrappers run the plain versions and count nothing."""
    A, nch, ntx = composite_branch_cases(128)
    f0, b0 = tcomp.composite_fwd.launches, tcomp.composite_bwd.launches
    attrs = torch.tensor(A, requires_grad=True)
    rgb, _, _ = tcomp.composite_tiles(attrs, torch.tensor(nch), ntx)
    rgb.sum().backward()
    assert (tcomp.composite_fwd.launches, tcomp.composite_bwd.launches) == (
        f0, b0)


# ---------------------------------------------------------- rasterizer

def _scene(rng, G=40):
    means = rng.uniform([-1, -1, 3], [1, 1, 6], (G, 3))
    quats = rng.standard_normal((G, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = rng.uniform(0.02, 0.12, (G, 3))
    opac = rng.uniform(0.3, 0.95, G)
    sh = rng.standard_normal((G, 4, 3)) * 0.3
    viewmat = np.eye(4)
    K = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]])
    return means, quats, scales, opac, sh, viewmat, K


def test_rasterize_and_gradients_match_jax_pallas():
    """End to end (float64 inputs, float32 compositing on both sides) with
    gradients w.r.t. means, scales, opacities, SH and the means2d probe,
    against JAX's rasterize(use_pallas=True) in interpret mode: rel 2e-6
    on the images, 5e-6 on the gradients (float32 summation order; measured
    at most 3.1e-7)."""
    rng = np.random.default_rng(3)
    W, H = 96, 64
    means, quats, scales, opac, sh, viewmat, K = _scene(rng)
    target = rng.uniform(0, 1, (H, W, 3))
    G = len(means)
    kw = dict(width=W, height=H, sh_degree=1, tiles_per_gauss=36,
              tile_capacity=128)

    def jloss(means, scales, opac, sh, offset):
        out = jras.rasterize(means, jnp.asarray(quats), scales, opac, sh,
                             jnp.asarray(viewmat), jnp.asarray(K),
                             means2d_offset=offset, use_pallas=True, **kw)
        loss = (jnp.mean((out.rgb - target) ** 2) + 0.1 * jnp.mean(out.alpha)
                + 0.01 * jnp.mean(out.depth))
        return loss, out

    jargs = [jnp.asarray(a) for a in (means, scales, opac, sh,
                                      np.zeros((G, 2)))]
    (jl, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(*jargs)

    targs = [_t(a).requires_grad_(True) for a in (means, scales, opac, sh,
                                                  np.zeros((G, 2)))]
    tout = tras.rasterize(targs[0], _t(quats), targs[1], targs[2], targs[3],
                          _t(viewmat), _t(K), means2d_offset=targs[4], **kw)
    tl = (torch.mean((tout.rgb - _t(target)) ** 2) + 0.1 * tout.alpha.mean()
          + 0.01 * tout.depth.mean())
    tl.backward()

    assert tout.rgb.shape == (H, W, 3) and tout.rgb.dtype == torch.float64
    np.testing.assert_array_equal(_np(tout.valid), _np(jout.valid))
    for name in ("rgb", "alpha", "depth"):
        _close(getattr(tout, name), getattr(jout, name), 2e-6, name)
    assert abs(tl.item() - float(jl)) <= 1e-6 * abs(float(jl))
    for t, j, name in zip(targs, jg, ["means", "scales", "opac", "sh",
                                      "offset"]):
        assert np.abs(_np(j)).max() > 0, name
        _close(t.grad, j, 5e-6, name)
