"""Batched Nistér 5-point minimal essential-matrix solver on torch tensors.

Counterpart of ``instantsfm_tpu/math/fivepoint.py``, step for step and at
the same fixed counts:

1. 4-dim nullspace of the 5x9 epipolar constraint matrix by 5 unrolled
   Householder reflections;
2. the ten cubic constraints (det(E) = 0 and 2 E Eᵀ E - tr(E Eᵀ) E = 0)
   assembled with precomputed 0/1 monomial multiplication tables;
3. Gauss-Jordan with partial pivoting reduces the 10x20 system, whose rows
   regroup into the 3x3 polynomial matrix B(z); det B(z) is the degree-10
   polynomial n(z);
4. real roots of n(z): a 512-point sign sweep of the homogenized polynomial
   over z = tan(t), 40 bisections and 2 Newton steps per sign change, plus
   4 same-sign dips polished by 24 clipped Newton steps
   (``NUM_ROOT_SLOTS = 14`` candidate slots);
5. [x, y, 1] from the best-conditioned cross product of two rows of B(z).

Every step has a static shape over the leading (pairs x hypotheses) dims.
The solver serves relative pose, and its spans (``utils/debug``) nest in
that stage's ``relpose.fivepoint``: ``relpose.fivepoint.nullspace`` (1),
``relpose.fivepoint.eliminate`` (2-3), ``relpose.fivepoint.roots`` (4) and
``relpose.fivepoint.recover`` (5 and the matrices).
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.utils.debug import span

_EPS = 1e-12

# ------------------------------------------------------- monomial machinery
# Polynomials in (x, y, z) up to degree 3, plus univariate polys in z.

_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]       # x, y, z, 1

_DEG2 = [(i, j, k) for i in range(3) for j in range(3) for k in range(3)
         if i + j + k <= 2]                                  # 10 monomials

# Nistér column order: the first ten eliminate to the identity, the tail ten
# group as x*poly(z), y*poly(z), poly(z).
_DEG3 = [(3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
         (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
         (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
         (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0)]


def _mul_table(basis_a, basis_b, basis_out):
    out_index = {m: i for i, m in enumerate(basis_out)}
    T = np.zeros((len(basis_a), len(basis_b), len(basis_out)), np.float32)
    for i, ma in enumerate(basis_a):
        for j, mb in enumerate(basis_b):
            m = (ma[0] + mb[0], ma[1] + mb[1], ma[2] + mb[2])
            T[i, j, out_index[m]] = 1.0
    return T


_T11 = _mul_table(_DEG1, _DEG1, _DEG2)       # deg1 * deg1 -> deg2
_T21 = _mul_table(_DEG2, _DEG1, _DEG3)       # deg2 * deg1 -> deg3


def _table_mul(a, b, T):
    """sum_ij a_i b_j T[i,j,k] as an outer-product flatten and one matmul."""
    ab = (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (-1,))
    Tf = torch.as_tensor(T.reshape(-1, T.shape[-1]), dtype=a.dtype,
                         device=a.device)
    return ab @ Tf


def _mul11(a, b):
    return _table_mul(a, b, _T11)


def _mul21(a, b):
    return _table_mul(a, b, _T21)


def _polymul_table(na, nb):
    T = np.zeros((na, nb, na + nb - 1), np.float32)
    for i in range(na):
        for j in range(nb):
            T[i, j, i + j] = 1.0
    return T


def _polymul(a, b):
    """Univariate poly product, descending-degree coefficient vectors."""
    return _table_mul(a, b, _polymul_table(a.shape[-1], b.shape[-1]))


# ------------------------------------------------------------ core pipeline

def _nullspace4(x1, x2):
    """Orthonormal basis of the 4-dim nullspace of the 5x9 constraint
    matrix, via 5 Householder reflections (QR of the transpose).

    x1, x2: [..., 5, 2] normalized image coords.  Returns basis
    [..., 4, 3, 3] so that E = xs*B0 + ys*B1 + zs*B2 + B3."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    rows = torch.stack([u2 * u1, u2 * v1, u2,
                        v2 * u1, v2 * v1, v2,
                        u1, v1, one], dim=-1)                # [..., 5, 9]
    A = rows.transpose(-1, -2)                               # [..., 9, 5]
    dtype, dev = A.dtype, A.device
    eps = 1e-30
    idx = torch.arange(9, device=dev)

    vs = []
    for k in range(5):
        ek = (idx == k).to(dtype)
        x = torch.where(idx >= k, A[..., :, k], torch.zeros((), dtype=dtype,
                                                            device=dev))
        xk = x[..., k]
        norm = torch.sqrt(torch.sum(x * x, dim=-1) + eps)
        alpha = -torch.sign(torch.where(xk == 0, torch.ones_like(xk), xk)) * norm
        v = x - alpha[..., None] * ek
        vn = torch.sqrt(torch.sum(v * v, dim=-1) + eps)
        # degenerate column (already zero): identity reflector
        v = torch.where((norm > 1e-12)[..., None], v / vn[..., None], ek)
        vs.append(v)
        A = A - 2.0 * v[..., :, None] * torch.sum(
            v[..., :, None] * A, dim=-2, keepdim=True)

    # nullspace columns: q_j = H0 H1 H2 H3 H4 e_{5+j}
    cols = []
    for j in range(4):
        q = torch.broadcast_to((idx == 5 + j).to(dtype), A.shape[:-2] + (9,))
        for v in reversed(vs):
            q = q - 2.0 * v * torch.sum(v * q, dim=-1, keepdim=True)
        cols.append(q)
    basis = torch.stack(cols, dim=-2)                        # [..., 4, 9]
    return basis.reshape(basis.shape[:-1] + (3, 3))


def _constraint_matrix(basis):
    """Ten cubic constraints as a [..., 10, 20] coefficient matrix over the
    _DEG3 monomials.  basis: [..., 4, 3, 3]."""
    Ep = torch.movedim(basis, -3, -1)                        # [..., 3, 3, 4]

    def e(i, j):
        return Ep[..., i, j, :]

    def minor(a, b, c, d):
        return _mul11(e(*a), e(*b)) - _mul11(e(*c), e(*d))

    det = (_mul21(minor((1, 1), (2, 2), (1, 2), (2, 1)), e(0, 0))
           + _mul21(minor((1, 2), (2, 0), (1, 0), (2, 2)), e(0, 1))
           + _mul21(minor((1, 0), (2, 1), (1, 1), (2, 0)), e(0, 2)))

    # 2*E*Et*E - tr(E*Et)*E = 0   (nine equations)
    M = [[None] * 3 for _ in range(3)]                       # E Et, deg2
    for i in range(3):
        for j in range(3):
            M[i][j] = sum(_mul11(e(i, k), e(j, k)) for k in range(3))
    tr = M[0][0] + M[1][1] + M[2][2]
    eqs = [det]
    for i in range(3):
        for j in range(3):
            Cij = [2.0 * M[i][k] - (tr if k == i else 0.0) for k in range(3)]
            eqs.append(sum(_mul21(Cij[k], e(k, j)) for k in range(3)))
    return torch.stack(eqs, dim=-2)                          # [..., 10, 20]


def _gauss_jordan10(A):
    """Reduce [..., 10, 20] to [I | G] over the first ten columns with
    partial pivoting (ties to the first row).  Returns (G [..., 10, 10],
    ok [...])."""
    n = 10
    ok = torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
    rowidx = torch.arange(n, device=A.device)
    tiny = 1e3 * torch.finfo(A.dtype).tiny
    for i in range(n):
        col = torch.abs(A[..., :, i])
        col = torch.where(rowidx < i, torch.full_like(col, -float("inf")), col)
        p = torch.argmax(col, dim=-1)                        # [...]
        pv = torch.take_along_dim(col, p[..., None], dim=-1)[..., 0]
        ok = ok & (pv > tiny)
        # swap rows i <-> p
        Ap = torch.take_along_dim(A, p[..., None, None], dim=-2)  # [..., 1, 20]
        Ai = A[..., i:i + 1, :]
        mask_i = (rowidx == i)[:, None]
        mask_p = (rowidx == p[..., None])[..., None]
        A = torch.where(mask_i, Ap, torch.where(mask_p, Ai, A))
        piv = A[..., i, :]
        pi = piv[..., i:i + 1]
        piv = piv / torch.where(torch.abs(pi) < _EPS, torch.ones_like(pi), pi)
        fac = A[..., :, i:i + 1]
        A = A - fac * piv[..., None, :]
        A = torch.where((rowidx == i)[:, None], piv[..., None, :], A)
    return A[..., 10:], ok


def _klm_rows(G):
    """The 3x3 polynomial matrix B(z) rows from the reduced tail G:
    k = <row4> - z<row5>, l = <row6> - z<row7>, m = <row8> - z<row9>.
    Returns (bx [..., 3, 4], by [..., 3, 4], b1 [..., 3, 5]) stacked over
    (k, l, m); coefficients descending in z."""
    def combine(a, b):
        cx = torch.stack([-b[..., 0], a[..., 0] - b[..., 1],
                          a[..., 1] - b[..., 2], a[..., 2]], dim=-1)
        cy = torch.stack([-b[..., 3], a[..., 3] - b[..., 4],
                          a[..., 4] - b[..., 5], a[..., 5]], dim=-1)
        c1 = torch.stack([-b[..., 6], a[..., 6] - b[..., 7],
                          a[..., 7] - b[..., 8], a[..., 8] - b[..., 9],
                          a[..., 9]], dim=-1)
        return cx, cy, c1

    kx, ky, k1 = combine(G[..., 4, :], G[..., 5, :])
    lx, ly, l1 = combine(G[..., 6, :], G[..., 7, :])
    mx, my, m1 = combine(G[..., 8, :], G[..., 9, :])
    return (torch.stack([kx, lx, mx], dim=-2), torch.stack([ky, ly, my], dim=-2),
            torch.stack([k1, l1, m1], dim=-2))


def _det_poly(bx, by, b1):
    """Degree-10 polynomial det B(z), coefficients descending: [..., 11]."""
    kx, lx, mx = bx[..., 0, :], bx[..., 1, :], bx[..., 2, :]
    ky, ly, my = by[..., 0, :], by[..., 1, :], by[..., 2, :]
    k1, l1, m1 = b1[..., 0, :], b1[..., 1, :], b1[..., 2, :]
    t1 = _polymul(ly, m1) - _polymul(l1, my)                 # [..., 8]
    t2 = _polymul(lx, m1) - _polymul(l1, mx)                 # [..., 8]
    t3 = _polymul(lx, my) - _polymul(ly, mx)                 # [..., 7]
    return _polymul(kx, t1) - _polymul(ky, t2) + _polymul(k1, t3)


def _eval_homog(coef, s, c):
    """sum_i coef[i] * s^(n-i) * c^i (descending coeffs): the homogenized
    polynomial at z = s/c, scaled by c^n; bounded for all angles."""
    n = coef.shape[-1] - 1
    acc = coef[..., 0:1] * torch.ones_like(s)
    cp = torch.ones_like(c)
    for i in range(1, n + 1):
        cp = cp * c
        acc = acc * s + coef[..., i:i + 1] * cp
    return acc


def _horner(c, x):
    acc = torch.broadcast_to(c[..., :1], x.shape)
    for i in range(1, c.shape[-1]):
        acc = acc * x + c[..., i:i + 1]
    return acc


NUM_ROOT_SLOTS = 14         # 10 sign-change isolations + 4 dip-Newton seeds


def _real_roots10(coef, grid=512, bisect_iters=40, newton_iters=2,
                  n_dips=4, dip_newton_iters=24):
    """Real roots of a degree-10 polynomial (descending coeffs).

    Returns (roots [..., 14], valid [..., 14]).  Odd-multiplicity roots are
    isolated by sign changes of the homogenized polynomial on a fixed angle
    grid (z = tan t) and refined by bisection + Newton; the ``n_dips``
    deepest same-sign local minima of |f| seed plain Newton iterations,
    accepted under a backward-error test |n(z)| <= tol * sum_i |a_i z^i|.
    The dips are ranked by a stable descending sort (ties to the lowest
    index, as ``lax.top_k``)."""
    dtype, dev = coef.dtype, coef.device
    scale = torch.amax(torch.abs(coef), dim=-1, keepdim=True)
    coef = coef / scale.clamp_min(_EPS)

    half = np.pi / 2 - 1e-4
    theta = torch.linspace(-half, half, grid, dtype=dtype, device=dev)
    f = _eval_homog(coef, torch.sin(theta), torch.cos(theta))     # [..., G]
    sgn = torch.sign(f)
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    change = sgn[..., :-1] * sgn[..., 1:] < 0                     # [..., G-1]
    cum = torch.cumsum(change.to(torch.int32), dim=-1)
    slot = torch.arange(1, 11, dtype=cum.dtype, device=dev)       # [10]
    sel = change[..., None, :] & (cum[..., None, :] == slot[:, None])
    valid = torch.any(sel, dim=-1)                                # [..., 10]
    g = torch.argmax(sel.to(torch.uint8), dim=-1)                 # [..., 10]

    lo = theta[g]
    hi = theta[g + 1]
    flo = torch.take_along_dim(f, g, dim=-1)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        fm = _eval_homog(coef, torch.sin(mid), torch.cos(mid))
        left = flo * fm < 0
        lo, hi = torch.where(left, lo, mid), torch.where(left, mid, hi)
    z = torch.tan(0.5 * (lo + hi))

    dcoef = coef[..., :-1] * torch.arange(10, 0, -1, dtype=dtype, device=dev)

    # Newton polish of the bisection roots
    for _ in range(newton_iters):
        fz = _horner(coef, z)
        fpz = _horner(dcoef, z)
        step = fz / torch.where(torch.abs(fpz) < _EPS, torch.ones_like(fpz), fpz)
        znew = z - step
        use = (torch.abs(fpz) > _EPS) & (torch.abs(z) < 1e4) \
            & (torch.abs(_horner(coef, znew)) < torch.abs(fz))
        z = torch.where(use, znew, z)

    # dip candidates: interior local minima of |f| with no adjacent sign flip
    af = torch.abs(f)
    interior = af[..., 1:-1]
    is_dip = (interior < af[..., :-2]) & (interior <= af[..., 2:]) \
        & ~change[..., :-1] & ~change[..., 1:]
    dip_score = torch.where(is_dip, -interior,
                            torch.full_like(interior, -float("inf")))
    dip_idx = torch.sort(dip_score, dim=-1, descending=True,
                         stable=True)[1][..., :n_dips]            # [..., n_dips]
    dip_ok = torch.take_along_dim(is_dip, dip_idx, dim=-1)
    zd = torch.tan(theta[dip_idx + 1])

    for _ in range(dip_newton_iters):
        fz = _horner(coef, zd)
        fpz = _horner(dcoef, zd)
        step = fz / torch.where(torch.abs(fpz) < _EPS, torch.sign(fpz) + 0.5, fpz)
        zd = zd - torch.clamp(step, -1.0, 1.0)
    # backward-error acceptance: |n(z)| small relative to sum |a_i||z|^i
    nval = torch.abs(_horner(coef, zd))
    nabs = _horner(torch.abs(coef), torch.abs(zd))
    tol = 1e4 * torch.finfo(dtype).eps
    dip_ok = dip_ok & (nval <= tol * nabs.clamp_min(_EPS)) & torch.isfinite(zd)

    return torch.cat([z, zd], dim=-1), torch.cat([valid, dip_ok], dim=-1)


def _mono20(x, y, z):
    """The 20 _DEG3 monomials at (x, y, z); inputs broadcastable."""
    return torch.stack([x ** i * y ** j * z ** k for i, j, k in _DEG3], dim=-1)


def _gn_polish(A, xs, ys, zs, iters=4):
    """Gauss-Newton on the 10 cubic constraints over (x, y, z), accepting
    only improving steps.  A: [..., 10, 20]; xs/ys/zs: [..., R]."""
    def dmono(x, y, z, axis):
        terms = []
        for i, j, k in _DEG3:
            e = (i, j, k)[axis]
            if e == 0:
                terms.append(torch.zeros_like(x))
                continue
            p = [i, j, k]
            p[axis] -= 1
            terms.append(float(e) * x ** p[0] * y ** p[1] * z ** p[2])
        return torch.stack(terms, dim=-1)

    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    x, y, z = xs, ys, zs
    for _ in range(iters):
        m = _mono20(x, y, z)                                   # [..., R, 20]
        dm = torch.stack([dmono(x, y, z, 0), dmono(x, y, z, 1),
                          dmono(x, y, z, 2)], dim=-1)          # [..., R, 20, 3]
        r = torch.einsum("...ec,...rc->...re", A, m)           # [..., R, 10]
        J = torch.einsum("...ec,...rcd->...red", A, dm)        # [..., R, 10, 3]
        JtJ = torch.einsum("...red,...ref->...rdf", J, J)
        Jtr = torch.einsum("...red,...re->...rd", J, r)
        lam = 1e-8 * torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1)[..., None, None] \
            + torch.finfo(A.dtype).tiny
        delta = torch.linalg.solve(JtJ + lam * eye, Jtr[..., None])[..., 0]
        mn = _mono20(x - delta[..., 0], y - delta[..., 1], z - delta[..., 2])
        rn = torch.einsum("...ec,...rc->...re", A, mn)
        better = torch.sum(rn * rn, -1) < torch.sum(r * r, -1)
        x = torch.where(better, x - delta[..., 0], x)
        y = torch.where(better, y - delta[..., 1], y)
        z = torch.where(better, z - delta[..., 2], z)
    return x, y, z


def five_point(x1, x2, polish: bool = True):
    """Candidate essential matrices from five correspondences.

    x1, x2: [..., 5, 2] normalized (z=1) coords, convention x2^T E x1 = 0.
    Returns (E [..., NUM_ROOT_SLOTS, 3, 3] Frobenius-normalized,
    valid [..., NUM_ROOT_SLOTS]); invalid slots hold identity placeholders.
    ``polish=False`` skips the Gauss-Newton constraint polish (RANSAC scores
    raw candidates and its LO re-estimation refines the winner)."""
    with span("relpose.fivepoint.nullspace"):
        basis = _nullspace4(x1, x2)                          # [..., 4, 3, 3]
    with span("relpose.fivepoint.eliminate"):
        A = _constraint_matrix(basis)
        G, ok = _gauss_jordan10(A)
        bx, by, b1 = _klm_rows(G)
        n = _det_poly(bx, by, b1)                            # [..., 11]
    with span("relpose.fivepoint.roots"):
        z, valid = _real_roots10(n)
    with span("relpose.fivepoint.recover"):
        return _recover(basis, A, bx, by, b1, z, valid & ok[..., None],
                        polish)


def _recover(basis, A, bx, by, b1, z, valid, polish):
    """[x, y, 1] of every root from the best cross product of two rows of
    B(z), then the Frobenius-normalized candidates (see ``five_point``)."""
    # evaluate B(z) rows and recover [x, y, 1] from the best cross product
    def polyval(c, zz):                                      # c [..., 3, n]
        acc = torch.broadcast_to(c[..., :1], c.shape[:-1] + (zz.shape[-1],))
        for i in range(1, c.shape[-1]):
            acc = acc * zz[..., None, :] + c[..., i:i + 1]
        return acc                                           # [..., 3, S]

    B = torch.stack([polyval(bx, z), polyval(by, z), polyval(b1, z)],
                    dim=-2)                                  # [..., 3row, 3col, S]
    B = torch.movedim(B, -1, -3)                             # [..., S, 3row, 3col]
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    cands = torch.stack([cross(r0, r1), cross(r0, r2), cross(r1, r2)],
                        dim=-2)                              # [..., S, 3, 3]
    best = torch.argmax(torch.abs(cands[..., 2]), dim=-1)    # weight by |w|
    v = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    w = v[..., 2]
    valid = valid & (torch.abs(w) > 1e-10)
    wsafe = torch.where(torch.abs(w) < _EPS, torch.ones_like(w), w)
    xs = v[..., 0] / wsafe
    ys = v[..., 1] / wsafe
    if polish:
        xs, ys, z = _gn_polish(A, xs, ys, z)

    coeff = torch.stack([xs, ys, z, torch.ones_like(z)], dim=-1)  # [..., S, 4]
    E = torch.einsum("...rc,...cij->...rij", coeff, basis)        # [..., S, 3, 3]
    fro = torch.sqrt(torch.sum(E.reshape(E.shape[:-2] + (9,)) ** 2, dim=-1))
    E = E / fro[..., None, None].clamp_min(_EPS)
    eye = torch.broadcast_to(torch.eye(3, dtype=E.dtype, device=E.device),
                             E.shape)
    E = torch.where(valid[..., None, None], E, eye)
    return E, valid
