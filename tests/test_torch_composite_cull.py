"""The cull record of the K2/K3 kernels, in its plain mirror, skips no live
(gaussian, pixel) pair.

The kernels (csrc/composite_tiles.cu ``cull_box``) skip a row for a warp of
16x2 pixels when the row's box misses the warp's pixel centres;
``composite.cull_boxes`` computes the same record with the same formula and
margins.  These tests hold it against the float32 ``alpha_terms`` that the
kernels and the plain versions evaluate: no pair with alpha > 0 lies
outside its row's box, on random rows and on the cull's edges (contours
through the pixel, thin conics with |b| near sqrt(ac), opacities at 1/255
and at the 0.999 clip, conics that are not positive definite, means far
away, sigma = 0 at the pixel).  CPU only: they probe the mirror, not the
kernels, which ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold by
output parity on the card."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from chip_smoke import composite_branch_cases, composite_cull_cases
from instantsfm_tpu_torch.gs import composite as k23

F32 = np.float32
KMIN = F32(1 / 255)
SETTINGS = settings(max_examples=300, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=[HealthCheck.too_slow])


def f32s(lo, hi):
    return st.floats(float(F32(lo)), float(F32(hi)), width=32,
                     allow_nan=False, allow_infinity=False)


def _row(mx, my, a, b, c, op):
    r = np.zeros(k23.ATTR, np.float32)
    r[[k23.MX, k23.MY, k23.CA, k23.CB, k23.CC, k23.OP]] = mx, my, a, b, c, op
    return torch.tensor(r)


def _alpha(row, px, py):
    """alpha of one row at pixel centres px, py [m] (float32)."""
    return k23.alpha_terms(row[None, None], torch.tensor(px)[None, None],
                           torch.tensor(py)[None, None])[0][0, 0]


def _outside(box, px, py):
    """The kernels' skip test for a one-pixel rectangle."""
    px, py = torch.tensor(px), torch.tensor(py)
    return (box[1] < px) | (box[0] > px) | (box[3] < py) | (box[2] > py)


def _contour_offsets(a, b, c, op, t):
    """Offsets d (float64 [m, 2]) with d^T C d = t^2 s, s = 2 ln(255 op):
    points on (t = 1) and around the alpha = 1/255 contour of a positive
    definite conic, at 64 angles and at the contour's four extreme points
    in x and y (where the box's edges touch it)."""
    s = 2 * np.log(255 * float(op))
    C = np.array([[a, b], [b, c]], np.float64)
    L = np.linalg.cholesky(C)
    th = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    u = (np.stack([np.cos(th), np.sin(th)], 1) * np.sqrt(s)
         * np.asarray(t)[:, None])
    det = a * c - b * b
    hx, hy = np.sqrt(s * c / det), np.sqrt(s * a / det)
    ext = np.array([[hx, -b / c * hx], [-b / a * hy, hy]])
    ext = np.concatenate([ext, -ext])[None] * np.asarray(t)[:, None, None]
    return np.concatenate([np.linalg.solve(L.T, u.T).T, ext.reshape(-1, 2)])


opacities = st.one_of(
    f32s(0.0, 1.0),
    st.sampled_from([KMIN, np.nextafter(KMIN, F32(1)), KMIN * F32(1 + 1e-6),
                     KMIN * F32(1 + 1e-3), np.nextafter(F32(0.999), F32(0)),
                     F32(0.999), np.nextafter(F32(0.999), F32(1)), F32(1.0)]),
    f32s(KMIN, KMIN * 1.01))
means = st.one_of(f32s(-64.0, 1024.0), f32s(-2e4, 2e4),
                  st.sampled_from([F32(0.5), F32(7.5), F32(1e6)]))
rhos = st.one_of(
    f32s(-0.999, 0.999),
    st.sampled_from([s * (1 - e) for s in (-1, 1)
                     for e in (1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 0.0)]))


@SETTINGS
@given(mx=means, my=means, a=f32s(1e-4, 1e3), c=f32s(1e-4, 1e3), rho=rhos,
       op=opacities, spread=st.sampled_from([1e-6, 1e-3, 0.02, 0.3]))
def test_no_live_pair_outside_its_box(mx, my, a, c, rho, op, spread):
    """Pixels on, just inside and just outside the alpha = 1/255 contour of
    a positive definite (possibly very thin) conic, and on the box's own
    edges and one float step beyond them."""
    b = F32(rho * np.sqrt(float(a) * float(c)))
    row = _row(mx, my, a, b, c, op)
    box = k23.cull_boxes(row)
    det = float(a) * float(c) - float(b) * float(b)
    pts = []
    if op > KMIN and det > 0:
        t = np.repeat(1 + spread * np.array([-1.0, 0.0, 1.0]), 64 // 3 + 1)[:64]
        d = _contour_offsets(float(a), float(b), float(c), op, t)
        pts.append(np.stack([float(mx) - d[:, 0], float(my) - d[:, 1]], 1))
    if torch.isfinite(box).all():
        lo_x, hi_x, lo_y, hi_y = box.tolist()
        xs = [lo_x, hi_x, np.nextafter(F32(lo_x), F32(-np.inf)),
              np.nextafter(F32(hi_x), F32(np.inf)), float(mx)]
        ys = [lo_y, hi_y, np.nextafter(F32(lo_y), F32(-np.inf)),
              np.nextafter(F32(hi_y), F32(np.inf)), float(my)]
        pts.append(np.array([(x, y) for x in xs for y in ys]))
    if not pts:
        return
    p = np.concatenate(pts).astype(np.float32)
    px, py = p[:, 0].copy(), p[:, 1].copy()
    alive = _alpha(row, px, py) > 0
    assert not (alive & _outside(box, px, py)).any()


@SETTINGS
@given(mx=f32s(-40.0, 40.0), my=f32s(-40.0, 40.0), a=f32s(-10.0, 10.0),
       b=f32s(-10.0, 10.0), c=f32s(-10.0, 10.0), op=opacities)
def test_rules_for_dead_and_unbounded_rows(mx, my, a, b, c, op):
    """op <= 1/255: an empty box and alpha = 0 at every pixel; a conic that
    is not positive definite: the row is always evaluated.  Either way no
    live pair lies outside the box, on a 48x48 grid of pixel centres."""
    row = _row(mx, my, a, b, c, op)
    box = k23.cull_boxes(row)
    g = np.arange(-24, 24, dtype=np.float32) + F32(0.5)
    px, py = (v.ravel().copy() for v in np.meshgrid(g, g))
    alive = _alpha(row, px, py) > 0
    assert not (alive & _outside(box, px, py)).any()
    if op <= KMIN:
        assert box[0] > box[1] and box[2] > box[3] and not alive.any()
    elif not (a > 0 and float(a) * float(c) - float(b) * float(b) > 0):
        assert box.tolist() == [-np.inf, np.inf, -np.inf, np.inf]


def test_box_is_the_contour_with_its_margin():
    """The cull is not vacuous: for a round gaussian of 2 px the box's
    half-width is the contour's radius 2 sqrt(2 ln(255 op)), widened by at
    most the stated margins (1% from s, 0.1% + 1e-3 px + 1e-6 |mean|)."""
    for op in (0.01, 0.5, 0.999):
        r = 2 * np.sqrt(2 * np.log(255 * op))
        box = k23.cull_boxes(_row(100.0, -30.0, 0.25, 0.0, 0.25, op))
        hx, hy = (box[1] - box[0]).item() / 2, (box[3] - box[2]).item() / 2
        for h, m in ((hx, 100.0), (hy, 30.0)):
            assert r < h < r * np.sqrt(1.02 + 0.02 / r ** 2 * 4) * 1.001 \
                + 1e-3 + 1e-6 * m + 1e-4


@pytest.mark.parametrize("cases", [composite_branch_cases,
                                   composite_cull_cases])
@pytest.mark.parametrize("K", [128, 512])
def test_hand_built_tiles_lose_no_live_pair(cases, K):
    """On the hand-built tiles the (row, warp) pairs the kernels walk
    (``cull_rows``) hold every live pair, and the cull skips some rows."""
    A, nch, ntx = cases(K)
    attrs = torch.tensor(A)
    kept = k23.cull_rows(attrs, ntx)                     # [n, K, NWARP]
    px, py = k23.pixel_coords(A.shape[0], ntx, "cpu")
    alive = k23.alpha_terms(attrs, px, py)[0] > 0       # [n, K, P]
    alive_w = alive.view(A.shape[0], K, k23.NWARP, 32).any(dim=-1)
    assert not (alive_w & ~kept).any()
    assert alive_w.any() and (~kept).any()
