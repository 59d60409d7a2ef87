"""A plain bundle adjuster: the reference of the bundle-adjustment cell.

Levenberg-Marquardt on the Huber cost sum_o rho(|r_o|^2) of SIMPLE_RADIAL
reprojections, with each camera's pose (a left rotation increment and a
translation increment), focal length and radial coefficient free, the
principal point fixed, and every point free.  The normal equations are
solved exactly: the points are eliminated block by block and the reduced
camera system, a dense matrix, by Cholesky.  Analytic Jacobians, IRLS
weights rho'(s).  Written from the problem's definition alone, in plain
torch; it shares nothing with the program.

With ``tf32`` every matrix product rounds its float32 operands to TF32
(10 explicit mantissa bits, round to nearest) and accumulates in float32,
as the card's tensor cores do: the reference computed one precision below
the float32 the configuration states, whatever cuBLAS would pick for each
product's shape.
"""

from __future__ import annotations

import torch


def to_tf32(x):
    """``x`` with its float32 mantissa rounded to TF32's 10 bits."""
    if x.dtype != torch.float32:
        raise ValueError("TF32 rounds float32 operands")
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def huber(s, delta):
    d2 = delta * delta
    root = torch.sqrt(s.clamp_min(1e-30))
    return (torch.where(s <= d2, s, 2.0 * delta * root - d2),
            torch.where(s <= d2, torch.ones_like(s), delta / root))


def quat_xyzw_to_matrix(q):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def rodrigues(w):
    th = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    small = th < 1e-12
    th_s = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(th_s) / th_s)
    b = torch.where(small, 0.5 * torch.ones_like(th),
                    (1 - torch.cos(th_s)) / (th_s * th_s))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


class Problem:
    """Observations (camera and point of each row, pixels) on ``device`` in
    ``dtype``."""

    def __init__(self, cam, pt, xy, num_cams, num_pts, delta, dtype, device,
                 tf32: bool = False):
        as_t = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
        self.r = to_tf32 if tf32 else (lambda v: v)
        self.cam = as_t(cam, torch.int64)
        self.pt = as_t(pt, torch.int64)
        self.xy = as_t(xy, dtype)
        self.C, self.T = int(num_cams), int(num_pts)
        self.delta = float(delta)
        self.dtype, self.device = dtype, device

    def residuals(self, x):
        R, t, intr, X = x
        c = self.cam
        Xc = torch.einsum("oij,oj->oi", self.r(R[c]), self.r(X[self.pt])) \
            + t[c]
        u = Xc[:, :2] / Xc[:, 2:3]
        r2 = torch.sum(u * u, 1, keepdim=True)
        f, k = intr[c, 0:1], intr[c, 3:4]
        d = 1.0 + k * r2
        return f * d * u + intr[c, 1:3] - self.xy, (Xc, u, r2, d, f, k)

    def cost(self, x):
        r, _ = self.residuals(x)
        return torch.sum(huber(torch.sum(r * r, 1), self.delta)[0])

    def normal_equations(self, x):
        """(U [C, 8, 8], V [T, 3, 3], W [O, 8, 3], g_c [C, 8], g_p [T, 3]) of
        the IRLS-weighted Gauss-Newton system."""
        R, t, intr, X = x
        r, (Xc, u, r2, d, f, k) = self.residuals(x)
        _, w = huber(torch.sum(r * r, 1), self.delta)
        O = len(self.cam)
        eye2 = torch.eye(2, dtype=self.dtype, device=self.device)
        dp_du = f[:, :, None] * (d[:, :, None] * eye2
                                 + 2.0 * k[:, :, None] * u[:, :, None]
                                 * u[:, None, :])
        z = Xc[:, 2]
        du = torch.zeros((O, 2, 3), dtype=self.dtype, device=self.device)
        du[:, 0, 0] = du[:, 1, 1] = 1.0 / z
        du[:, 0, 2] = -u[:, 0] / z
        du[:, 1, 2] = -u[:, 1] / z
        mm = lambda a, b: self.r(a) @ self.r(b)
        A = mm(dp_du, du)
        skew = torch.zeros((O, 3, 3), dtype=self.dtype, device=self.device)
        skew[:, 0, 1], skew[:, 0, 2] = -Xc[:, 2], Xc[:, 1]
        skew[:, 1, 0], skew[:, 1, 2] = Xc[:, 2], -Xc[:, 0]
        skew[:, 2, 0], skew[:, 2, 1] = -Xc[:, 1], Xc[:, 0]
        Jc = torch.cat([-mm(A, skew), A, (d * u)[:, :, None],
                        (f * r2 * u)[:, :, None]], 2)          # [O, 2, 8]
        Jp = mm(A, R[self.cam])                                # [O, 2, 3]
        wJc = w[:, None, None] * Jc
        wJp = w[:, None, None] * Jp
        U = torch.zeros((self.C, 8, 8), dtype=self.dtype, device=self.device)
        U.index_add_(0, self.cam, mm(wJc.transpose(1, 2), Jc))
        V = torch.zeros((self.T, 3, 3), dtype=self.dtype, device=self.device)
        V.index_add_(0, self.pt, mm(wJp.transpose(1, 2), Jp))
        W = mm(wJc.transpose(1, 2), Jp)
        wr = (w[:, None] * r)[:, :, None]
        g_c = torch.zeros((self.C, 8), dtype=self.dtype, device=self.device)
        g_c.index_add_(0, self.cam, mm(Jc.transpose(1, 2), wr)[..., 0])
        g_p = torch.zeros((self.T, 3), dtype=self.dtype, device=self.device)
        g_p.index_add_(0, self.pt, mm(Jp.transpose(1, 2), wr)[..., 0])
        return U, V, W, g_c, g_p

    def solve(self, system, lam):
        """The camera and point increments of the damped system, or None
        where the reduced system is not positive definite."""
        U, V, W, g_c, g_p = system
        C, T = self.C, self.T
        damp = lambda M: M + lam * torch.diag_embed(
            torch.diagonal(M, dim1=-2, dim2=-1))
        V_inv = torch.linalg.inv(damp(V))
        dense = torch.zeros((C, T, 8, 3), dtype=self.dtype, device=self.device)
        dense.index_put_((self.cam, self.pt), W, accumulate=True)
        Wm = dense.permute(0, 2, 1, 3).reshape(C * 8, T * 3)
        r = self.r
        Bm = torch.einsum("ctij,tjk->citk", r(dense), r(V_inv)).reshape(
            C * 8, T * 3)
        del dense
        S = torch.block_diag(*damp(U)) - r(Bm) @ r(Wm).T
        rhs = -g_c.reshape(-1) + r(Bm) @ r(g_p.reshape(-1))
        L, info = torch.linalg.cholesky_ex(S)
        if int(info) != 0:
            return None
        d_cam = torch.cholesky_solve(rhs[:, None], L)[:, 0]
        wt = (r(Wm).T @ r(d_cam)).reshape(T, 3)
        d_pt = -torch.einsum("tij,tj->ti", r(V_inv), r(g_p + wt))
        return d_cam.reshape(C, 8), d_pt

    @staticmethod
    def apply(x, d_cam, d_pt):
        R, t, intr, X = x
        E = rodrigues(d_cam[:, :3])
        intr = intr.clone()
        intr[:, 0] += d_cam[:, 6]
        intr[:, 3] += d_cam[:, 7]
        return (E @ R, torch.einsum("cij,cj->ci", E, t) + d_cam[:, 3:6],
                intr, X + d_pt)


def solve(problem: Problem, x, max_steps: int, max_tries: int = 30,
          rel_tol: float = 0.0, lam: float = 1e-4):
    """``max_steps`` LM steps from ``x`` (R, t, intr [C, 4], X), each a
    system build and damped solves with ten times the damping until the
    cost falls (at most ``max_tries``); stops early once an accepted step
    lowers the cost by less than ``rel_tol`` of it.  Returns (x, cost,
    steps taken)."""
    cost = problem.cost(x)
    for step in range(max_steps):
        system = problem.normal_equations(x)
        for _ in range(max_tries):
            sol = problem.solve(system, lam)
            if sol is not None:
                cand = problem.apply(x, *sol)
                new = problem.cost(cand)
                if bool(torch.isfinite(new)) and bool(new < cost):
                    break
            lam *= 10.0
        else:
            return x, cost, step + 1
        drop = float((cost - new) / cost)
        x, cost, lam = cand, new, max(lam / 10.0, 1e-12)
        if drop < rel_tol:
            return x, cost, step + 1
    return x, cost, max_steps
