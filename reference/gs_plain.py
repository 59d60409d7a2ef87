"""A plain reference of one 3D Gaussian Splatting training step, as
gsplat's default trainer takes it (``examples/simple_trainer.py``'s
``Config`` with ``DefaultStrategy``; Kerbl et al., SIGGRAPH 2023,
arXiv:2308.04079).

It imports torch and numpy only, and every function that computes runs
with TF32 off.  Each piece is written from the method, not from any
program's code:

* ``project``: EWA splatting of 3-D gaussians through a pinhole camera,
  the Jacobian's camera-space point clamped to 1.3 times the half field
  of view past each image edge (gsplat's ``persp_proj``), ``eps2d`` = 0.3
  added to the 2-D covariance's diagonal, a 3-sigma radius from its larger
  eigenvalue, culled by depth (near 0.01, far 1e10), a positive
  determinant, a positive radius and the image's bounds;
* ``sh_colors``: real spherical harmonics of degrees 0-3 with gsplat's
  constants (its formulation in ``spherical_harmonics``), colour = SH +
  0.5 clamped at 0;
* ``render``: each 16 x 16 tile holds the gaussians whose 3-sigma box
  meets it (tiles ``floor((x - r) / 16)`` up to, not including,
  ``ceil((x + r) / 16)``), depth-sorted; every pixel composites them front
  to back, alpha = min(0.999, o exp(-sigma)), pairs with sigma < 0 or
  alpha < 1/255 skipped, stopping before the gaussian that would take the
  transmittance to 1e-4 or below; dense per block of tiles, with no cap on
  a tile's gaussians;
* ``loss``: 0.8 L1 + 0.2 (1 - SSIM), SSIM with an 11 x 11 gaussian window
  of sigma 1.5 and 'valid' padding;
* ``step``: the gradients of every leaf by autograd, including a
  screen-space probe added to the projected means (gsplat's
  ``means2d.grad``), and one Adam step of them (``adam_updates``: betas
  0.9, 0.999, eps 1e-15, at the trainer's learning rates in use at that
  update, the means' decaying to 1% over ``max_steps``);
* ``accumulate``: the DefaultStrategy's statistics, the probe's gradient
  times (W / 2, H / 2), its norm summed and the view counted where the
  radius is positive;
* ``refine_decisions``: the DefaultStrategy's grow, split and prune rule;
* ``refine_writes``: the pool those decisions leave: a duplicated
  gaussian's child copies it, a split's child is moved by R (s * z) for
  standard normals z and both halves shrink by 1.6, the pruned are
  dropped, and the children and the pruned restart their Adam moments.

The parameters are those a trainer holds: means, log-scales, quaternions
(x, y, z, w), opacity logits, SH coefficients [N, 16, 3] (DC first).
Deliberate departures copied from the program under test, each because the
program keeps its gaussians in a pool of fixed capacity:

* the pool: rows with ``alive`` false are not rendered (gsplat has no
  such rows) and take no part in the strategy;
* placement: growers take the pool's dead slots in row order, the k-th
  grower the k-th dead slot; growers past the last dead slot are dropped
  and stay as they were (gsplat's pool grows without bound);
* a split keeps its original row, shrunk by 1.6, and writes one child
  into a dead slot (gsplat removes the original and appends two, both
  moved); the child's standard normals are handed in (the program's
  draws, row i's for row i's child), since no other random stream can
  match them.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
T_MIN = 1e-4
SSIM_LAMBDA = 0.2
# simple_trainer.py's learning rates (the means' times the scene scale)
LRS = dict(means=1.6e-4, scales=5e-3, quats=1e-3, opacities=5e-2,
           sh0=2.5e-3, shN=2.5e-3 / 20)
BETAS, ADAM_EPS = (0.9, 0.999), 1e-15
# DefaultStrategy's defaults
GROW_GRAD2D, GROW_SCALE3D = 2e-4, 0.01
PRUNE_OPA, PRUNE_SCALE3D = 0.005, 0.1
SPLIT_SHRINK = 1.6
LEAVES = ("means", "scales", "quats", "opacities", "sh0", "shN")


@contextlib.contextmanager
def no_tf32():
    b = torch.backends
    old = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old


def to_tf32(x):
    """``x`` (float32) with its mantissa rounded to TF32's 10 bits; the
    gradient passes the rounding unchanged."""
    i = x.detach().contiguous().view(torch.int32)
    return x + (((i + 0x1000) & -0x2000).view(torch.float32) - x.detach())


class Precision(NamedTuple):
    dtype: torch.dtype = torch.float64
    tf32: bool = False      # round the operands of every product to TF32

    def mm(self, a, b):
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return a @ b


F64 = Precision()


def quat_to_rotmat(q):
    """Unit quaternions (x, y, z, w) [N, 4] -> rotations [N, 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


class Projection(NamedTuple):
    means2d: torch.Tensor   # [N, 2]
    conics: torch.Tensor    # [N, 3] the inverse 2-D covariance (a, b, c)
    depths: torch.Tensor    # [N]
    radii: torch.Tensor     # [N] pixels, 0 where culled
    valid: torch.Tensor     # [N] bool


def project(means, quats, scales, viewmat, K, width: int, height: int,
            eps2d: float = 0.3, near: float = 0.01, far: float = 1e10,
            prec: Precision = F64) -> Projection:
    """means [N, 3], quats [N, 4] (x, y, z, w), scales [N, 3] (linear),
    viewmat [4, 4] world to camera, K [3, 3]."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    p = prec.mm(means, R.T) + t
    x, y, z = p.unbind(-1)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    tan_x, tan_y = 0.5 * width / fx, 0.5 * height / fy
    lim_xp, lim_xn = (width - cx) / fx + 0.3 * tan_x, cx / fx + 0.3 * tan_x
    lim_yp, lim_yn = (height - cy) / fy + 0.3 * tan_y, cy / fy + 0.3 * tan_y
    tx = z * torch.minimum(torch.maximum(x / z, -lim_xn), lim_xp)
    ty = z * torch.minimum(torch.maximum(y / z, -lim_yn), lim_yp)
    zero = torch.zeros_like(z)
    J = torch.stack([fx / z, zero, -fx * tx / (z * z),
                     zero, fy / z, -fy * ty / (z * z)], -1).reshape(-1, 2, 3)
    M = prec.mm(R, quat_to_rotmat(quats)) * scales[:, None, :]
    cov_c = prec.mm(M, M.transpose(1, 2))
    JM = prec.mm(J, cov_c)
    cov2d = prec.mm(JM, J.transpose(1, 2))
    a = cov2d[:, 0, 0] + eps2d
    b = cov2d[:, 0, 1]
    c = cov2d[:, 1, 1] + eps2d
    det = a * c - b * b
    ok_det = det > 0
    det_s = torch.where(ok_det, det, torch.ones_like(det))
    conics = torch.stack([c / det_s, -b / det_s, a / det_s], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radii = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    u = fx * x / z + cx
    v = fy * y / z + cy
    valid = ((z >= near) & (z <= far) & ok_det & (radii > 0)
             & (u + radii > 0) & (u - radii < width)
             & (v + radii > 0) & (v - radii < height)).detach()
    radii = torch.where(valid, radii, torch.zeros_like(radii))
    return Projection(torch.stack([u, v], -1), conics, z, radii, valid)


def sh_colors(degree: int, coeffs, means, campos):
    """coeffs [N, 16, 3]; the colour of each gaussian seen from campos."""
    d = means - campos
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    x, y, z = (d[:, i:i + 1] for i in range(3))
    c = coeffs
    out = 0.2820947917738781 * c[:, 0]
    if degree >= 1:
        out = out + 0.48860251190292 * (-y * c[:, 1] + z * c[:, 2]
                                        - x * c[:, 3])
    if degree >= 2:
        z2 = z * z
        t0 = -1.092548430592079 * z
        fc1, fs1 = x * x - y * y, 2.0 * x * y
        out = out + (0.5462742152960395 * fs1 * c[:, 4] + t0 * y * c[:, 5]
                     + (0.9461746957575601 * z2 - 0.3153915652525201)
                     * c[:, 6]
                     + t0 * x * c[:, 7]
                     + 0.5462742152960395 * fc1 * c[:, 8])
    if degree >= 3:
        t0c = -2.285228997322329 * z2 + 0.4570457994644658
        t1b = 1.445305721320277 * z
        fc2 = x * fc1 - y * fs1
        fs2 = x * fs1 + y * fc1
        out = out + (-0.5900435899266435 * fs2 * c[:, 9]
                     + t1b * fs1 * c[:, 10] + t0c * y * c[:, 11]
                     + z * (1.865881662950577 * z2 - 1.119528997770346)
                     * c[:, 12]
                     + t0c * x * c[:, 13] + t1b * fc1 * c[:, 14]
                     - 0.5900435899266435 * fc2 * c[:, 15])
    return torch.clamp(out + 0.5, min=0.0)


def tile_lists(proj: Projection, width: int, height: int):
    """The tiles' depth-sorted gaussians: (gaussian ids [n_pairs] grouped
    by tile, pairs of each tile [n_tiles]), row-major tiles."""
    tw, th = -(-width // TILE), -(-height // TILE)
    with torch.no_grad():
        m, r = proj.means2d.detach(), proj.radii
        x0 = torch.clamp(torch.floor((m[:, 0] - r) / TILE), 0, tw).long()
        x1 = torch.clamp(torch.ceil((m[:, 0] + r) / TILE), 0, tw).long()
        y0 = torch.clamp(torch.floor((m[:, 1] - r) / TILE), 0, th).long()
        y1 = torch.clamp(torch.ceil((m[:, 1] + r) / TILE), 0, th).long()
        nx = torch.where(proj.valid, x1 - x0, torch.zeros_like(x0))
        ny = torch.where(proj.valid, y1 - y0, torch.zeros_like(y0))
        n = nx * ny
        ids = torch.repeat_interleave(torch.arange(len(n), device=n.device),
                                      n)
        k = torch.arange(len(ids), device=n.device) - \
            (torch.cumsum(n, 0) - n)[ids]
        tiles = (y0[ids] + k // nx[ids]) * tw + x0[ids] + k % nx[ids]
        # depth order, then a stable sort by tile keeps it in each tile
        by_depth = torch.argsort(proj.depths.detach()[ids], stable=True)
        by_tile = torch.argsort(tiles[by_depth], stable=True)
        order = by_depth[by_tile]
        counts = torch.bincount(tiles, minlength=tw * th)
    return ids[order], counts


def _composite_block(mx, my, ca, cb, cc, op, col, px, py):
    """[B, M] gaussians in depth order over [B, 1, P] pixels -> [B, P, 3]."""
    dx = mx[..., None] - px
    dy = my[..., None] - py
    sigma = 0.5 * (ca[..., None] * dx * dx + cc[..., None] * dy * dy) \
        + cb[..., None] * dx * dy
    alpha = torch.clamp(op[..., None] * torch.exp(-sigma), max=ALPHA_MAX)
    live = (sigma >= 0) & (alpha >= ALPHA_MIN)
    lom = torch.where(live, torch.log1p(-alpha), torch.zeros_like(alpha))
    after = torch.cumsum(lom, dim=1)
    keep = live & (torch.exp(after.detach()) > T_MIN)
    w = torch.where(keep, alpha * torch.exp(after - lom),
                    torch.zeros_like(alpha))
    return torch.einsum("bmp,bmc->bpc", w, col)


def render(proj: Projection, colors, opacities, width: int, height: int,
           block_pixels: int = 1 << 24):
    """The image [H, W, 3] (black background) of projected gaussians.
    Tiles of similar length are composited together, padded with
    transparent gaussians, each block under activation checkpointing so
    the backward pass recomputes it."""
    from torch.utils.checkpoint import checkpoint

    tw, th = -(-width // TILE), -(-height // TILE)
    ids, counts = tile_lists(proj, width, height)
    dev, dt = colors.device, colors.dtype
    attrs = torch.cat([proj.means2d, proj.conics, opacities[:, None],
                       colors], dim=1)
    attrs = torch.cat([attrs, attrs.new_zeros((1, attrs.shape[1]))])
    pad = attrs.shape[0] - 1                         # the transparent row
    starts = torch.cumsum(counts, 0) - counts
    counts_h = counts.tolist()
    order = [t for t in sorted(range(tw * th), key=lambda t: counts_h[t])
             if counts_h[t]]
    lin = torch.arange(TILE * TILE, device=dev)
    out = torch.zeros((th * TILE, tw * TILE, 3), dtype=dt, device=dev)
    pieces, i = [], 0
    while i < len(order):
        # ascending lengths: a block ends where its last tile's length
        # times its tiles would pass the budget
        j = i + 1
        while j < len(order) and \
                (j - i + 1) * counts_h[order[j]] * TILE * TILE <= block_pixels:
            j += 1
        tt = torch.tensor(order[i:j], device=dev)
        M = counts_h[order[j - 1]]
        k = torch.arange(M, device=dev)
        inside = k[None, :] < counts[tt][:, None]
        at = torch.clamp(starts[tt][:, None] + k[None, :], max=len(ids) - 1)
        rows = torch.where(inside, ids[at], torch.full_like(at, pad))
        px = ((tt % tw) * TILE).to(dt)[:, None, None] + \
            (lin % TILE).to(dt)[None, None, :] + 0.5
        py = ((tt // tw) * TILE).to(dt)[:, None, None] + \
            (lin // TILE).to(dt)[None, None, :] + 0.5
        a = attrs[rows]                               # [B, M, 9]
        rgb = checkpoint(_composite_block, a[..., 0], a[..., 1], a[..., 2],
                         a[..., 3], a[..., 4], a[..., 5], a[..., 6:9], px, py,
                         use_reentrant=False)
        pieces.append((tt, rgb))
        i = j
    tiles_out = out.view(th, TILE, tw, TILE, 3).permute(0, 2, 1, 3, 4) \
        .reshape(th * tw, TILE * TILE, 3)
    if pieces:
        tt = torch.cat([p[0] for p in pieces])
        rgb = torch.cat([p[1] for p in pieces])
        tiles_out = tiles_out.index_copy(0, tt, rgb)
    img = tiles_out.view(th, tw, TILE, TILE, 3).permute(0, 2, 1, 3, 4) \
        .reshape(th * TILE, tw * TILE, 3)
    return img[:height, :width]


def ssim(img, gt, prec: Precision = F64, size: int = 11, sigma: float = 1.5):
    """Mean SSIM of [H, W, 3] images, 'valid' padding."""
    x = torch.arange(size, dtype=img.dtype, device=img.device) - size // 2
    g = torch.exp(-x * x / (2 * sigma * sigma))
    g = g / g.sum()
    win = (g[:, None] * g[None, :]).expand(3, 1, size, size)
    a = img.permute(2, 0, 1)[None]
    b = gt.permute(2, 0, 1)[None]
    maps = torch.cat([a, b, a * a, b * b, a * b], dim=1)
    w = win.repeat(5, 1, 1, 1)
    if prec.tf32:
        maps, w = to_tf32(maps), to_tf32(w)
    mu_a, mu_b, e_aa, e_bb, e_ab = F.conv2d(maps, w, groups=15).chunk(5, 1)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s_aa, s_bb, s_ab = e_aa - mu_a * mu_a, e_bb - mu_b * mu_b, \
        e_ab - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * s_ab + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (s_aa + s_bb + c2)
    return (num / den).mean()


def loss(img, gt, prec: Precision = F64):
    l1 = torch.abs(img - gt).mean()
    return (1 - SSIM_LAMBDA) * l1 + SSIM_LAMBDA * (1 - ssim(img, gt, prec))


class StepResult(NamedTuple):
    image: torch.Tensor      # [H, W, 3]
    loss: float
    grads: dict              # leaf -> gradient (rows of the pool)
    updates: dict            # leaf -> Adam's change of the leaf
    accum: torch.Tensor      # [N] the step's addition to the summed norms
    seen: torch.Tensor       # [N] bool: the rows the step counted


def step(params: dict, alive, adam: dict, n_updates: int, scene_scale: float,
         max_steps: int, viewmat, K, gt, sh_degree: int,
         prec: Precision = F64) -> StepResult:
    """One training step of one view.  ``params``: the leaves (pool rows);
    ``adam``: leaf -> dict(exp_avg, exp_avg_sq, step) before the update;
    ``n_updates`` updates made before it (the means' learning-rate
    schedule).  Everything is computed in ``prec.dtype``."""
    with no_tf32():
        dt, dev = prec.dtype, params["means"].device
        rows = torch.nonzero(alive)[:, 0]
        leaves = {k: params[k][rows].detach().to(dt).requires_grad_(True)
                  for k in LEAVES}
        probe = torch.zeros((len(rows), 2), dtype=dt, device=dev,
                            requires_grad=True)
        view = viewmat.to(dt)
        Kd = K.to(dt)
        H, W = gt.shape[:2]
        proj = project(leaves["means"], leaves["quats"],
                       torch.exp(leaves["scales"]), view, Kd, W, H, prec=prec)
        proj = proj._replace(means2d=proj.means2d + probe)
        campos = -view[:3, :3].T @ view[:3, 3]
        coeffs = torch.cat([leaves["sh0"], leaves["shN"]], dim=1)
        colors = sh_colors(sh_degree, coeffs, leaves["means"], campos)
        opac = torch.sigmoid(leaves["opacities"])
        img = render(proj, colors, opac, W, H)
        value = loss(img, gt.to(dt), prec)
        grads = torch.autograd.grad(value, [leaves[k] for k in LEAVES]
                                    + [probe])
        N = alive.shape[0]

        def full(g, like):
            out = torch.zeros((N,) + tuple(like.shape[1:]), dtype=dt,
                              device=dev)
            out[rows] = g
            return out

        g = {k: full(gk, params[k]) for k, gk in zip(LEAVES, grads)}
        seen = torch.zeros(N, dtype=torch.bool, device=dev)
        seen[rows] = proj.radii > 0
        scale = torch.tensor([W / 2.0, H / 2.0], dtype=dt, device=dev)
        accum = full(torch.where(proj.radii > 0,
                                 torch.linalg.norm(grads[-1] * scale, dim=-1),
                                 torch.zeros_like(proj.radii)),
                     params["opacities"])
        updates = adam_updates(g, adam, n_updates, scene_scale, max_steps)
        return StepResult(img.detach(), float(value.detach()), g, updates,
                          accum, seen)


def adam_updates(grads: dict, adam: dict, n_updates: int, scene_scale: float,
                 max_steps: int) -> dict:
    """Adam's change of each leaf (torch's Adam: bias corrections at the
    leaf's step count, eps added to the corrected root) for ``grads``, at
    the trainer's learning rates of update ``n_updates``, in the
    gradients' dtype."""
    lr_means = LRS["means"] * scene_scale * 0.01 ** (n_updates / max_steps)
    out = {}
    for k, g in grads.items():
        st = adam[k]
        t = float(st["step"]) + 1.0
        m = BETAS[0] * st["exp_avg"].to(g.dtype) + (1 - BETAS[0]) * g
        v = BETAS[1] * st["exp_avg_sq"].to(g.dtype) + (1 - BETAS[1]) * g * g
        lr = lr_means if k == "means" else LRS[k]
        denom = torch.sqrt(v) / math.sqrt(1 - BETAS[1] ** t) + ADAM_EPS
        out[k] = -lr / (1 - BETAS[0] ** t) * m / denom
    return out


def refine_decisions(scales, opacities, alive, grad2d, count, scene_scale,
                     prune_too_big: bool) -> dict:
    """The DefaultStrategy's refine on the pool before it: per row
    [N] bool ``dupli``, ``split``, ``grown`` (a dead slot found) and
    ``prune`` (over the pool after the growth, children included), and
    ``margin`` [N]: each row's smallest relative distance from a threshold
    its decisions read (its parent's for a child)."""
    dt = torch.float64
    s = torch.exp(scales.to(dt)).amax(-1)
    o = torch.sigmoid(opacities.to(dt))
    avg = grad2d.to(dt) / torch.clamp(count.to(dt), min=1.0)
    hot = alive & (avg > GROW_GRAD2D)
    small = s <= GROW_SCALE3D * scene_scale
    dupli, split = hot & small, hot & ~small
    grow = dupli | split
    rank = torch.cumsum(grow.long(), 0) - 1
    dead = torch.nonzero(~alive)[:, 0]
    grown = grow & (rank < len(dead))
    src = torch.nonzero(grown)[:, 0]
    dst = dead[rank[src]]
    # after the growth: split originals and their children shrink
    s_after = torch.where(split & grown, s / SPLIT_SHRINK, s)
    o_after = o.clone()
    s_after[dst] = s_after[src]
    o_after[dst] = o[src]
    alive_after = alive.clone()
    alive_after[dst] = True
    prune = alive_after & ((o_after < PRUNE_OPA) | (
        prune_too_big & (s_after > PRUNE_SCALE3D * scene_scale)))

    def rel(a, th):
        return torch.abs(a - th) / th

    margin = torch.minimum(rel(avg, GROW_GRAD2D),
                           rel(s, GROW_SCALE3D * scene_scale))
    m_prune = torch.minimum(rel(o_after, PRUNE_OPA),
                            rel(s_after, PRUNE_SCALE3D * scene_scale)
                            if prune_too_big else torch.full_like(s, np.inf))
    margin = torch.minimum(margin, m_prune)
    margin[dst] = torch.minimum(margin[src], m_prune[dst])
    return dict(dupli=dupli, split=split, grown=grown, prune=prune,
                margin=margin)


def refine_writes(params: dict, alive, split, grown, prune, noise):
    """The pool after the refine, from the pool before it (``params``, the
    leaves, and ``alive``), the rows that grew (``grown``, the splits among
    them in ``split``), the rows pruned after the growth (``prune``), and
    the standard normals ``noise`` [N, 3] of each row's split child.  The
    k-th grower's child takes the k-th dead slot.  Returns (leaves after,
    alive after, ``zeroed`` [N] bool: the rows whose Adam moments restart,
    the children's and the pruned), float64."""
    dt = torch.float64
    out = {k: params[k].to(dt).clone() for k in LEAVES}
    src = torch.nonzero(grown)[:, 0]
    dst = torch.nonzero(~alive)[:, 0][:len(src)]
    sp = split[src][:, None]
    scales = out["scales"][src]
    jitter = torch.einsum("nij,nj->ni", quat_to_rotmat(out["quats"][src]),
                          noise[src].to(dt) * torch.exp(scales))
    for k in LEAVES:
        out[k][dst] = out[k][src]
    shrink = math.log(SPLIT_SHRINK)
    out["means"][dst] = torch.where(sp, out["means"][src] + jitter,
                                    out["means"][src])
    out["scales"][dst] = torch.where(sp, scales - shrink, scales)
    out["scales"][src] = torch.where(sp, scales - shrink, scales)
    alive_after = alive.clone()
    alive_after[dst] = True
    alive_after &= ~prune
    zeroed = prune.clone()
    zeroed[dst] = True
    return out, alive_after, zeroed
