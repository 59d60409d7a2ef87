"""Tile-based differentiable 3DGS rasterizer.

Counterpart of ``instantsfm_tpu/gs/rasterize.py`` (its default route):

1. project every gaussian (``projection.project``) and evaluate its SH
   colour, then expand it into the 16x16 tiles its 3-sigma box covers;
2. one stable sort of the (tile, depth) key, packed as
   ``tile << 32 | float32 bits of max(depth, 0)``, and each tile's range
   from the per-tile counts;
3. per-tile windows of depth-sorted gaussians scattered from the packed
   attribute table, composited by kernels K2/K3 (``gs/composite.py``);
   autograd's transposes (a gather of the slots, ``index_add_`` over the
   pairs) route K3's per-slot gradients back to the gaussians.

The expansion and the windows are sized from the view's own counts, so
no pair is cut (``tile_windows``).  This departs from the JAX package,
whose static shapes fix ``tiles_per_gauss`` tiles a gaussian and
``tile_capacity`` gaussians a tile; given those budgets, the port cuts as
JAX does and counts what it cut.

Densification statistics come from the gradient w.r.t. an explicit
screen-space offset probe (``means2d_offset``), gsplat's ``means2d.grad``.

Each part runs under a span (``utils/debug.span``: ``gs.projection``,
``gs.sh``, ``gs.tile_sort``, ``gs.gather``, ``gs.composite``), a
``record_function`` scope under a profiler, by which a profile of a step
assigns device time to the parts the benchmark's
``sfmbench/yardstick/gs_roofline.py::gs_step_cost`` counts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instantsfm_tpu_torch.gs import composite, projection, sh as sh_mod
from instantsfm_tpu_torch.gs.composite import CHUNK
from instantsfm_tpu_torch.utils.debug import read, span, stat_add

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
    with span("gs.projection"):
        proj = projection.project(means, quats, scales, viewmat, Kmat,
                                  width, height, eps2d=eps2d,
                                  camera_model=camera_model)
        means2d = proj.means2d
        if means2d_offset is not None:
            means2d = means2d + means2d_offset

    with span("gs.sh"):
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
              tiles_per_gauss=None, tile_capacity=None,
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


class Windows(NamedTuple):
    """A view's gaussian-tile pairs laid out for the compositing kernels."""
    slots: torch.Tensor    # [n] int64: tile * K + the pair's rank in its tile
    gauss: torch.Tensor    # [n] int64: the gaussian of each slot
    counts: torch.Tensor   # [n_tiles] int64: pairs of each tile, before the
    #                        capacity cut
    K: int                 # slots a tile, a whole number of chunks
    cut: bool              # some pairs fell past the capacity (their slot
    #                        is the dump slot n_tiles * K)


def tile_windows(means2d, radii, valid, depths, width: int, height: int,
                 tiles_per_gauss=None, tile_capacity=None) -> Windows:
    """Tile expansion, (tile, depth) sort and per-tile windows.

    A gaussian covers the tiles of its 3-sigma box.  By default every
    pair is kept: the expansion is sized by the view's pair count and the
    windows by its fullest tile, both read to the host in one read
    (``gs.sizes``), as gsplat sizes its intersections.  ``tiles_per_gauss``
    (a square window of tiles from the box's corner) and ``tile_capacity``
    (the nearest gaussians of a tile) are the JAX package's fixed budgets;
    the pairs they cut are counted (``gs_pairs_cut``, beside ``gs_pairs``
    and the windows' chunks ``gs_chunks``)."""
    G = means2d.shape[0]
    dev = means2d.device
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    n_tiles = ntx * nty

    with torch.no_grad():
        def tile_of(x, n):
            return torch.clamp(torch.floor(x / TILE).to(torch.int64), 0, n - 1)

        mx, my = means2d[:, 0], means2d[:, 1]
        tx0, tx1 = tile_of(mx - radii, ntx), tile_of(mx + radii, ntx)
        ty0, ty1 = tile_of(my - radii, nty), tile_of(my + radii, nty)
        zero = torch.zeros_like(tx0)
        w = torch.where(valid, tx1 - tx0 + 1, zero)
        h = torch.where(valid, ty1 - ty0 + 1, zero)
        ww, hh = w, h
        if tiles_per_gauss is not None:
            side = max(int(tiles_per_gauss ** 0.5), 1)
            ww, hh = w.clamp(max=side), h.clamp(max=side)
        n_g = ww * hh

        # each tile's pairs: a 2-D difference array of the expanded boxes
        diff = torch.zeros((nty + 1) * (ntx + 1), dtype=torch.int64,
                           device=dev)
        one = torch.ones_like(tx0)
        for y, x, sign in ((ty0, tx0, 1), (ty0, tx0 + ww, -1),
                           (ty0 + hh, tx0, -1), (ty0 + hh, tx0 + ww, 1)):
            diff.index_add_(0, y * (ntx + 1) + x, sign * one)
        counts = diff.view(nty + 1, ntx + 1).cumsum(0).cumsum(1)[
            :nty, :ntx].reshape(-1)
        kept_t = counts if tile_capacity is None else \
            counts.clamp(max=tile_capacity)
        sizes = torch.stack([(w * h).sum(), n_g.sum(), kept_t.sum(),
                             counts.max(),
                             ((kept_t + CHUNK - 1) // CHUNK).sum()])
        pairs, expanded, kept, most, chunks = (
            int(v) for v in read("gs.sizes", sizes))
        stat_add("gs_pairs", pairs)
        stat_add("gs_pairs_cut", pairs - kept)
        stat_add("gs_chunks", chunks)
        K = max(most, 1) if tile_capacity is None else tile_capacity
        K = -(-K // CHUNK) * CHUNK

        # the expansion, gaussian by gaussian, each box row-major
        gid = torch.repeat_interleave(torch.arange(G, device=dev), n_g,
                                      output_size=expanded)
        local = torch.arange(expanded, device=dev) - (
            torch.cumsum(n_g, 0) - n_g)[gid]
        wg = ww[gid]
        tile = (ty0[gid] + local // wg) * ntx + tx0[gid] + local % wg

        # one stable sort of the packed (tile, depth) key: depth as the
        # float32 bit pattern of max(depth, 0), which orders like the value
        bits = torch.clamp(depths.detach(), min=0.0).to(torch.float32) \
            .view(torch.int32).to(torch.int64)
        sorted_key, order = torch.sort((tile << 32) | bits[gid], stable=True)
        sorted_tiles = sorted_key >> 32
        rank = torch.arange(expanded, device=dev) - (
            torch.cumsum(counts, 0) - counts)[sorted_tiles]
        slots = sorted_tiles * K + rank
        cut = kept < expanded
        if cut:
            slots = torch.where(rank < K, slots,
                                torch.full_like(slots, n_tiles * K))
    return Windows(slots=slots, gauss=gid[order], counts=counts, K=K,
                   cut=cut)


def tile_attrs(p: Projected2D, width: int, height: int,
               tiles_per_gauss=None, tile_capacity=None):
    """The compositing kernels' inputs for one view: (attrs [n_tiles, K,
    ATTR] float32, the tiles' windows of depth-sorted rows, empty slots
    zero; nchunks [n_tiles] int32; ntx).  Differentiable in the packed
    attributes."""
    n_tiles_x = (width + TILE - 1) // TILE
    with span("gs.tile_sort"):
        # a gaussian of opacity at most 1/255 is composited nowhere (the
        # pool's dead rows among them): it takes no tile
        valid = p.valid & (p.opac > composite.MIN_ALPHA)
        win = tile_windows(p.means2d, p.radii, valid, p.depths, width,
                           height, tiles_per_gauss, tile_capacity)
    with span("gs.gather"):
        table = composite.pack_attrs(p.means2d, p.conics, p.colors, p.opac,
                                     p.depths)
        n_tiles = win.counts.shape[0]
        # each pair's row into its slot: the transposes are a gather of
        # the slots and an index_add_ over the pairs' gaussians (no slot
        # is empty-filled from a shared row, whose atomics would queue)
        rows = torch.index_select(table, 0, win.gauss)
        attrs = table.new_zeros((n_tiles * win.K + int(win.cut),
                                 composite.ATTR)).index_copy(0, win.slots,
                                                             rows)
        attrs = attrs[:n_tiles * win.K].view(n_tiles, win.K, composite.ATTR)
        nchunks = (-(-torch.clamp(win.counts, max=win.K)
                     // composite.CHUNK)).to(torch.int32)
    return attrs, nchunks, n_tiles_x


def rasterize_projected(p: Projected2D, width: int, height: int,
                        tiles_per_gauss=None, tile_capacity=None,
                        background=None) -> RasterOut:
    """Tile expansion, (tile, depth) sort and compositing of projected
    gaussians."""
    dtype = p.means2d.dtype
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    attrs, nchunks, _ = tile_attrs(p, width, height, tiles_per_gauss,
                                   tile_capacity)
    with span("gs.composite"):
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
