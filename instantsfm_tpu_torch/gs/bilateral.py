"""Learned bilateral-grid colour correction and its total-variation loss.

Counterpart of ``instantsfm_tpu/gs/bilateral.py`` (reference
``vis/utils/lib_bilagrid.py``): a per-image grid [gh, gw, gg, 12] of 3x4
affine colour transforms, sliced trilinearly at each pixel by (y, x,
luminance) and applied to the pixel's RGB; a TV regulariser on the grids.

The eight corners are gathered with ``index_select`` on the image's
flattened grid, whose transpose is ``index_add_``: advanced indexing sorts
its indices in the backward pass and is far slower on the card at
800x608 pixels.  The clip of the luminance fraction is ``minimum`` of
``maximum``, as JAX's ``clip`` is, so at a tie (a black or white pixel,
or a luminance on a grid plane) the gradient is halved as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_IDENTITY = (1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0)


class BilateralGrid(nn.Module):
    """``grids`` [num_images, gh, gw, gg, 12], identity transforms (JAX's
    ``init_bilateral_grid``)."""

    def __init__(self, num_images: int, grid_w: int = 16, grid_h: int = 16,
                 grid_g: int = 8, device="cpu"):
        super().__init__()
        ident = torch.tensor(_IDENTITY, dtype=torch.float32, device=device)
        self.grids = nn.Parameter(
            ident.repeat(num_images, grid_h, grid_w, grid_g, 1))

    def forward(self, image_id: int, rgb):
        return slice_grid(self.grids, image_id, rgb)


def _luminance(rgb):
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _linspace(stop: int, n: int, like):
    """``linspace(0, stop, n)`` computed in float64 as i * stop / (n - 1),
    then cast to ``like``'s dtype."""
    i = torch.arange(n, dtype=torch.float64, device=like.device)
    return (i * (stop / max(n - 1, 1))).to(like.dtype)


def slice_grid(grids, image_id: int, rgb):
    """Apply image ``image_id``'s grid of ``grids`` [N, gh, gw, gg, 12] to
    rgb [H, W, 3] -> corrected rgb [H, W, 3]."""
    grid = grids[image_id]
    gh, gw, gg, ch = grid.shape
    H, W = rgb.shape[:2]
    gy = _linspace(gh - 1, H, rgb)[:, None].expand(H, W)
    gx = _linspace(gw - 1, W, rgb)[None, :].expand(H, W)
    gz = _luminance(rgb) * (gg - 1)

    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, gh - 2)
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, gw - 2)
    z0 = torch.clamp(torch.floor(gz.detach()).to(torch.int64), 0, gg - 2)
    fy = (gy - y0)[..., None]
    fx = (gx - x0)[..., None]
    fz = torch.minimum(torch.maximum(gz - z0, torch.zeros_like(gz)),
                       torch.ones_like(gz))[..., None]

    flat = grid.reshape(-1, ch)
    base = ((y0 * gw + x0) * gg + z0).reshape(-1)

    def g(dy, dx, dz):
        idx = base + (dy * gw + dx) * gg + dz
        return torch.index_select(flat, 0, idx).reshape(H, W, ch)

    A = ((g(0, 0, 0) * (1 - fz) + g(0, 0, 1) * fz) * (1 - fx)
         + (g(0, 1, 0) * (1 - fz) + g(0, 1, 1) * fz) * fx) * (1 - fy) \
        + ((g(1, 0, 0) * (1 - fz) + g(1, 0, 1) * fz) * (1 - fx)
           + (g(1, 1, 0) * (1 - fz) + g(1, 1, 1) * fz) * fx) * fy
    A = A.reshape(H, W, 3, 4)
    return torch.einsum("hwij,hwj->hwi", A[..., :3], rgb) + A[..., 3]


def total_variation_loss(grids):
    """Mean squared difference along each of the three grid axes, summed
    (reference ``lib_bilagrid.total_variation_loss``)."""
    tv = 0.0
    for ax in (1, 2, 3):
        d = torch.diff(grids, dim=ax)
        tv = tv + torch.mean(d * d)
    return tv
