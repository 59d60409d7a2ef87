"""Tile-based differentiable 3DGS rasterizer.

Counterpart of ``instantsfm_tpu/gs/rasterize.py`` (its default route):

1. project every gaussian (``projection.project``) and evaluate its SH
   colour, then expand it into the 16x16 tiles it covers, with a fixed
   budget of ``tiles_per_gauss`` tiles;
2. one stable sort of the (tile, depth) key, packed as
   ``tile << 32 | float32 bits of max(depth, 0)``, and a searchsorted for
   the per-tile ranges;
3. per-tile windows of ``tile_capacity`` gaussians gathered from the packed
   attribute table (empty slots hit the all-zero sentinel row), composited
   by kernels K2/K3 (``gs/composite.py``); autograd's transpose of the
   gather (``index_add_``) routes K3's per-slot gradients back to the
   gaussians.

Densification statistics come from the gradient w.r.t. an explicit
screen-space offset probe (``means2d_offset``), gsplat's ``means2d.grad``.

Each part runs under a span (``utils/debug.span``: ``gs:projection``,
``gs:sh``, ``gs:tile_sort``, ``gs:gather``, ``gs:composite``), a
``record_function`` scope under a profiler, by which a profile of a step
assigns device time to the parts
``utils/roofline.py::gs_step_cost`` counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instantsfm_tpu_torch.gs import composite, projection, sh as sh_mod
from instantsfm_tpu_torch.utils.debug import span

TILE = 16


class RasterOut(NamedTuple):
    rgb: torch.Tensor      # [H, W, 3]
    alpha: torch.Tensor    # [H, W]
    depth: torch.Tensor    # [H, W] accumulated expected depth (unnormalized)
    radii: torch.Tensor    # [G]
    valid: torch.Tensor    # [G]


class Projected2D(NamedTuple):
    """Per-view screen-space gaussians."""
    means2d: torch.Tensor   # [G, 2]
    conics: torch.Tensor    # [G, 3]
    depths: torch.Tensor    # [G]
    radii: torch.Tensor     # [G]
    valid: torch.Tensor     # [G] bool
    colors: torch.Tensor    # [G, 3] SH-evaluated view-dependent colour
    opac: torch.Tensor      # [G]


def project_view(means, quats, scales, opacities, sh_coeffs, viewmat, Kmat,
                 width: int, height: int, sh_degree: int = 3,
                 eps2d: float = 0.3, means2d_offset=None,
                 camera_model: str = "pinhole") -> Projected2D:
    """EWA projection and SH colour for one view."""
    with span("gs:projection"):
        proj = projection.project(means, quats, scales, viewmat, Kmat,
                                  width, height, eps2d=eps2d,
                                  camera_model=camera_model)
        means2d = proj.means2d
        if means2d_offset is not None:
            means2d = means2d + means2d_offset

    with span("gs:sh"):
        cam_pos = -viewmat[:3, :3].T @ viewmat[:3, 3]
        dirs = means - cam_pos
        dirs = dirs / torch.clamp(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
        colors = torch.clamp(
            sh_mod.eval_sh(sh_degree, sh_coeffs, dirs) + 0.5, min=0.0)
    return Projected2D(means2d=means2d, conics=proj.conics,
                       depths=proj.depths, radii=proj.radii,
                       valid=proj.valid, colors=colors, opac=opacities)


def rasterize(means, quats, scales, opacities, sh_coeffs, viewmat, Kmat,
              width: int, height: int, sh_degree: int = 3,
              tiles_per_gauss: int = 16, tile_capacity: int = 512,
              background=None, means2d_offset=None, eps2d: float = 0.3,
              camera_model: str = "pinhole") -> RasterOut:
    """Full differentiable forward render of one view.

    means [G,3], quats [G,4] xyzw, scales [G,3] (linear), opacities [G]
    (post-sigmoid), sh_coeffs [G,K,3]; viewmat [4,4] world->cam, Kmat [3,3].
    ``means2d_offset`` ([G,2], zeros) is a probe whose gradient equals the
    screen-space positional gradient used by densification.
    """
    p = project_view(means, quats, scales, opacities, sh_coeffs, viewmat,
                     Kmat, width, height, sh_degree, eps2d, means2d_offset,
                     camera_model=camera_model)
    return rasterize_projected(p, width, height,
                               tiles_per_gauss=tiles_per_gauss,
                               tile_capacity=tile_capacity,
                               background=background)


def tile_windows(means2d, radii, valid, depths, width: int, height: int,
                 tiles_per_gauss: int, tile_capacity: int):
    """Tile expansion, (tile, depth) sort and per-tile windows.

    Returns (tile_gauss [n_tiles, tile_capacity] int64 gaussian ids, G for
    empty slots; counts [n_tiles] gaussians that cover each tile, before
    the capacity cut)."""
    G = means2d.shape[0]
    dev = means2d.device
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    n_tiles = ntx * nty
    side = max(int(tiles_per_gauss ** 0.5), 1)

    with torch.no_grad():
        def tile_of(x, n):
            return torch.clamp(torch.floor(x / TILE).to(torch.int64), 0, n - 1)

        mx, my = means2d[:, 0], means2d[:, 1]
        tx0, tx1 = tile_of(mx - radii, ntx), tile_of(mx + radii, ntx)
        ty0, ty1 = tile_of(my - radii, nty), tile_of(my + radii, nty)
        di = torch.arange(side, device=dev)
        dy, dx = torch.meshgrid(di, di, indexing="ij")
        gtx = tx0[:, None] + dx.reshape(1, -1)
        gty = ty0[:, None] + dy.reshape(1, -1)
        cover = (gtx <= tx1[:, None]) & (gty <= ty1[:, None]) & valid[:, None]
        tile_ids = torch.where(cover, gty * ntx + gtx,
                               torch.full_like(gtx, n_tiles))   # sentinel tile

        # one stable sort of the packed (tile, depth) key: depth as the
        # float32 bit pattern of max(depth, 0), which orders like the value
        bits = torch.clamp(depths.detach(), min=0.0).to(torch.float32) \
            .view(torch.int32).to(torch.int64)
        key = (tile_ids << 32) | bits[:, None]
        sorted_key, order = torch.sort(key.reshape(-1), stable=True)
        sorted_tiles = sorted_key >> 32
        sorted_gauss = order // (side * side)

        starts = torch.searchsorted(sorted_tiles,
                                    torch.arange(n_tiles + 1, device=dev))
        counts = starts[1:] - starts[:-1]
        k = torch.arange(tile_capacity, device=dev)
        k_ok = k[None, :] < counts[:, None]
        sg_pad = torch.cat([sorted_gauss,
                            torch.full((tile_capacity,), G, device=dev,
                                       dtype=sorted_gauss.dtype)])
        tile_gauss = torch.where(k_ok, sg_pad[starts[:-1, None] + k[None, :]],
                                 torch.full_like(k_ok, G, dtype=torch.int64))
    return tile_gauss, counts


def tile_attrs(p: Projected2D, width: int, height: int,
               tiles_per_gauss: int = 16, tile_capacity: int = 512):
    """The compositing kernels' inputs for one view: (attrs [n_tiles, K,
    ATTR] float32 with K = tile_capacity rounded up to a whole chunk,
    nchunks [n_tiles] int32, ntx).  Differentiable in the packed
    attributes."""
    n_tiles_x = (width + TILE - 1) // TILE
    with span("gs:tile_sort"):
        tile_gauss, counts = tile_windows(p.means2d, p.radii, p.valid,
                                          p.depths, width, height,
                                          tiles_per_gauss, tile_capacity)
    with span("gs:gather"):
        table = composite.pack_attrs(p.means2d, p.conics, p.colors, p.opac,
                                     p.depths)
        # index_select, not table[tile_gauss]: its transpose is index_add_
        # (atomics), where advanced indexing's sorts the ~10^6 slot indices
        # and serializes the runs of repeated ones (the sentinel row's
        # above all)
        attrs = torch.index_select(table, 0, tile_gauss.reshape(-1)).reshape(
            tile_gauss.shape + (composite.ATTR,))       # [n_tiles, K, ATTR]
        K_pad = -(-tile_capacity // composite.CHUNK) * composite.CHUNK
        if K_pad != tile_capacity:
            attrs = torch.cat([attrs, attrs.new_zeros(
                (attrs.shape[0], K_pad - tile_capacity, composite.ATTR))],
                dim=1)
        nchunks = (-(-torch.clamp(counts, max=tile_capacity)
                     // composite.CHUNK)).to(torch.int32)
    return attrs, nchunks, n_tiles_x


def rasterize_projected(p: Projected2D, width: int, height: int,
                        tiles_per_gauss: int = 16, tile_capacity: int = 512,
                        background=None) -> RasterOut:
    """Tile expansion, (tile, depth) sort and compositing of projected
    gaussians."""
    dtype = p.means2d.dtype
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    attrs, nchunks, _ = tile_attrs(p, width, height, tiles_per_gauss,
                                   tile_capacity)
    with span("gs:composite"):
        rgb, alpha, dep = composite.composite_tiles(attrs, nchunks, ntx)
    rgb = rgb.transpose(1, 2).to(dtype)                 # [n_tiles, P, 3]
    T = (1.0 - alpha).to(dtype)
    dep = dep.to(dtype)
    if background is not None:
        rgb = rgb + T[..., None] * background[None, None, :]

    def untile(a, ch):
        a = a.reshape(nty, ntx, TILE, TILE, ch)
        a = a.permute(0, 2, 1, 3, 4).reshape(nty * TILE, ntx * TILE, ch)
        return a[:height, :width]

    return RasterOut(rgb=untile(rgb, 3),
                     alpha=untile((1.0 - T)[..., None], 1)[..., 0],
                     depth=untile(dep[..., None], 1)[..., 0],
                     radii=p.radii, valid=p.valid)
