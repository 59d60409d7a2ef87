"""SSIM (11x11 gaussian window, sigma 1.5) and PSNR on torch tensors.

Counterpart of ``instantsfm_tpu/gs/ssim.py``: the separable blur is two
contractions with banded matrices ('valid' correlation), as in the JAX
code.  ``torch.matmul`` keeps full float32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set, which this module never
does; TF32 (about three decimal digits) would move SSIM visibly.
"""

from __future__ import annotations

import torch


def _gauss_window(size, sigma, dtype, device):
    x = torch.arange(size, dtype=dtype, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _band_matrix(n: int, win):
    """[n, n-size+1] banded blur matrix: column j holds win over rows
    j..j+size-1 (a product with it is 'valid' correlation with win)."""
    size = win.shape[0]
    i = torch.arange(n, device=win.device)[:, None]
    j = torch.arange(n - size + 1, device=win.device)[None, :]
    d = i - j
    vals = win[torch.clamp(d, 0, size - 1)]
    return torch.where((d >= 0) & (d < size), vals, torch.zeros_like(vals))


def _filter2d(img, win):
    """img [N, C, H, W] -> separable blur, valid padding [N, C, H', W']."""
    H, W = img.shape[-2:]
    hi = img @ _band_matrix(W, win)                       # [N, C, H, W']
    return _band_matrix(H, win).T @ hi                    # [N, C, H', W']


def ssim(img1, img2, size: int = 11, sigma: float = 1.5,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2):
    """img1/2: [H, W, C] or [N, H, W, C] in [0, 1]; returns the mean SSIM."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    dt = torch.promote_types(img1.dtype, img2.dtype)
    x = img1.to(dt).permute(0, 3, 1, 2)
    y = img2.to(dt).permute(0, 3, 1, 2)
    win = _gauss_window(size, sigma, dt, x.device)

    stacked = torch.cat([x, y, x * x, y * y, x * y], dim=1)
    mu_x, mu_y, e_xx, e_yy, e_xy = torch.chunk(_filter2d(stacked, win), 5,
                                               dim=1)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = e_xx - mu_xx
    sigma_y = e_yy - mu_yy
    sigma_xy = e_xy - mu_xy
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)


def psnr(img1, img2):
    mse = torch.mean((img1 - img2) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
