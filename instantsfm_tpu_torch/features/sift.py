"""DoG SIFT: detector and oriented 128-d descriptors in torch.

Counterpart of ``instantsfm_tpu/features/sift.py``, with the same
arithmetic:
* the Gaussian pyramid is separable blurs, two ``F.conv2d`` calls with
  zero padding each, in full float32 (``utils.device.full_f32``: cuDNN
  would otherwise take TF32 on the card);
* the DoG extrema (3x3x3, ``torch.roll`` with its wrap-around as
  ``jnp.roll``, 8-pixel border), the contrast and the edge-ratio tests are
  whole-image tensor ops;
* a fixed budget of keypoints per octave: the top ``max_keypoints //
  num_octaves`` responses, by a stable descending sort (``lax.top_k``
  gives equal responses, the zeros of the invalid slots among them, in
  index order);
* orientation and descriptor are batched over an octave's keypoints: the
  [K, 17, 17] and [K, 16, 16] windows are gathered by flat index, the
  36-bin orientation histogram and the trilinear 4x4x8 descriptor
  histogram (with its overflow slot 128) are ``scatter_add_`` over flat
  bins, then normalize, clip at 0.2 and renormalize.

The image and its pyramid are float32, as in JAX.  The keypoint scale and
coordinates, the orientation window and the descriptor's sample geometry
are float64, which is what the JAX package computes under x64 (Python
floats meet integer arrays there); the descriptor histogram sums in
float32, as JAX's scatter into its float32 array does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from instantsfm_tpu_torch.utils.device import full_f32, resolve_device

_F64 = torch.float64


class SiftConfig(NamedTuple):
    num_octaves: int = 4
    scales_per_octave: int = 3
    sigma0: float = 1.6
    contrast_thresh: float = 0.006
    edge_thresh: float = 10.0
    max_keypoints: int = 4096
    descriptor_width: float = 3.0   # bin width in units of keypoint scale


def _gauss_kernel1d(sigma, radius, device):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur(img, sigma):
    """[H, W] float32 -> [H, W]: horizontal then vertical pass."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    k = _gauss_kernel1d(sigma, radius, img.device)
    with full_f32():
        out = F.conv2d(img[None, None], k.view(1, 1, 1, -1),
                       padding=(0, radius))
        out = F.conv2d(out, k.view(1, 1, -1, 1), padding=(radius, 0))
    return out[0, 0]


def _local_extrema(dog, contrast_thresh):
    """dog [S+2, h, w] -> bool [S, h, w]: 3x3x3 extrema of the inner
    scales above the contrast threshold, 8 pixels off the border."""
    def shift2(a, dy, dx):
        return torch.roll(torch.roll(a, dy, dims=-2), dx, dims=-1)

    center = dog[1:-1]
    is_max = torch.ones_like(center, dtype=torch.bool)
    is_min = torch.ones_like(center, dtype=torch.bool)
    for ds in (-1, 0, 1):
        nb_plane = dog[1 + ds: dog.shape[0] - 1 + ds]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                nb = shift2(nb_plane, dy, dx)
                is_max &= center > nb
                is_min &= center < nb
    mask = (is_max | is_min) & (torch.abs(center) > contrast_thresh)
    mask[:, :8, :] = False
    mask[:, -8:, :] = False
    mask[:, :, :8] = False
    mask[:, :, -8:] = False
    return mask


def _edge_response_ok(dog, edge_thresh):
    """2x2 spatial Hessian ratio test per pixel of the inner scales."""
    d = dog[1:-1]
    roll = torch.roll
    dxx = roll(d, -1, -1) + roll(d, 1, -1) - 2 * d
    dyy = roll(d, -1, -2) + roll(d, 1, -2) - 2 * d
    dxy = (roll(roll(d, -1, -1), -1, -2) - roll(roll(d, 1, -1), -1, -2)
           - roll(roll(d, -1, -1), 1, -2) + roll(roll(d, 1, -1), 1, -2)) / 4.0
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    return (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)


def _orient_and_describe(mag, ang, s_idx, y_idx, x_idx, sigma, cfg):
    """mag/ang [S+3, h, w] float32; the octave's K keypoints as (scale
    index, y, x) int64 [K] and sigma float64 [K].  One dominant orientation
    each and a 4x4x8 descriptor: (ori float32 [K], desc float32 [K, 128])."""
    h, w = mag.shape[1:]
    dev = mag.device
    K = s_idx.shape[0]
    m_flat, a_flat = mag.reshape(-1), ang.reshape(-1)
    plane = ((s_idx + 1) * (h * w))[:, None, None]
    y = y_idx[:, None, None]
    x = x_idx[:, None, None]
    sig = sigma[:, None, None]

    # orientation: 36-bin histogram over a gaussian window
    R = 8
    dy, dx = torch.meshgrid(torch.arange(-R, R + 1, device=dev),
                            torch.arange(-R, R + 1, device=dev),
                            indexing="ij")
    yy = torch.clamp(y + dy, 0, h - 1)
    xx = torch.clamp(x + dx, 0, w - 1)
    wgt = torch.exp((-(dy * dy + dx * dx)).to(_F64)
                    / (2 * (1.5 * sig) ** 2))
    idx = plane + yy * w + xx
    m = m_flat[idx].to(_F64) * wgt
    a = a_flat[idx]
    bins = torch.floor((a + math.pi) / (2 * math.pi) * 36).long() % 36
    hist = torch.zeros((K, 36), dtype=_F64, device=dev).scatter_add_(
        1, bins.reshape(K, -1), m.reshape(K, -1))
    hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    ori = (torch.argmax(hist, dim=1).to(_F64) + 0.5) / 36 * 2 * math.pi \
        - math.pi

    # descriptor: 16x16 samples rotated by ori
    G = 16
    g = torch.arange(G, device=dev, dtype=_F64) - G / 2 + 0.5
    gy_, gx_ = torch.meshgrid(g, g, indexing="ij")
    step = cfg.descriptor_width * sig / 4.0
    o = ori[:, None, None]
    cos_o, sin_o = torch.cos(o), torch.sin(o)
    sx = (cos_o * gx_ - sin_o * gy_) * step
    sy = (sin_o * gx_ + cos_o * gy_) * step
    yy2 = torch.clamp(torch.round(y + sy).long(), 0, h - 1)
    xx2 = torch.clamp(torch.round(x + sx).long(), 0, w - 1)
    idx2 = plane + yy2 * w + xx2
    m2 = m_flat[idx2].to(_F64) * torch.exp(-(gx_ ** 2 + gy_ ** 2)
                                           / (2 * (G / 2) ** 2))
    a2 = a_flat[idx2].to(_F64) - o

    # trilinear soft-binning into 4x4 spatial x 8 orientation bins; the
    # samples that fall off the 4x4 grid go to slot 128
    row_bin = (gy_ + G / 2 - 0.5) / (G / 4) - 0.5    # in [-0.5, 3.5]
    col_bin = (gx_ + G / 2 - 0.5) / (G / 4) - 0.5
    ori_bin = torch.remainder((a2 + math.pi) / (2 * math.pi) * 8, 8)
    r0 = torch.floor(row_bin).long()
    c0 = torch.floor(col_bin).long()
    o0 = torch.floor(ori_bin).long()
    fr, fc, fo = row_bin - r0, col_bin - c0, ori_bin - o0
    desc = torch.zeros((K, 129), dtype=torch.float32, device=dev)
    for drr in (0, 1):
        for dcc in (0, 1):
            for doo in (0, 1):
                wgt2 = ((fr if drr else 1 - fr) * (fc if dcc else 1 - fc)
                        * (fo if doo else 1 - fo)) * m2
                rr, cc = r0 + drr, c0 + dcc
                ok = (rr >= 0) & (rr < 4) & (cc >= 0) & (cc < 4)
                bin_ = torch.where(ok, rr * 32 + cc * 8 + (o0 + doo) % 8, 128)
                desc.scatter_add_(
                    1, bin_.reshape(K, -1),
                    torch.where(ok, wgt2, 0.0).to(torch.float32).reshape(K, -1))
    d = desc[:, :128]
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=1, keepdim=True), 1e-8)
    d = torch.clamp_max(d, 0.2)
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=1, keepdim=True), 1e-8)
    return ori.to(torch.float32), d


def extract_tensors(img: torch.Tensor, cfg: SiftConfig = SiftConfig()):
    """img [H, W] float32 in [0, 1] on any device -> (xy float64 [K, 2],
    scale float64 [K], ori float32 [K], desc float32 [K, 128], valid bool
    [K]) on the same device, K = ``cfg.max_keypoints``; xy are full-image
    pixel coordinates of pixel centres."""
    S = cfg.scales_per_octave
    k_per_oct = cfg.max_keypoints // cfg.num_octaves
    img = img.to(torch.float32)

    xy, scale, resp, ori, desc = [], [], [], [], []
    base = _blur(img, cfg.sigma0)
    for o in range(cfg.num_octaves):
        h, w = base.shape
        gauss = [base]
        sig_prev = cfg.sigma0
        for s in range(1, S + 3):
            sig_total = cfg.sigma0 * (2.0 ** (s / S))
            sig_extra = math.sqrt(max(sig_total ** 2 - sig_prev ** 2, 1e-6))
            gauss.append(_blur(gauss[-1], sig_extra))
            sig_prev = sig_total
        gauss = torch.stack(gauss)                       # [S+3, h, w]
        dog = gauss[1:] - gauss[:-1]                     # [S+2, h, w]
        mask = _local_extrema(dog, cfg.contrast_thresh)
        mask &= _edge_response_ok(dog, cfg.edge_thresh)
        flat = torch.where(mask, torch.abs(dog[1:-1]), 0.0).reshape(-1)
        top_resp, top_idx = torch.sort(flat, descending=True, stable=True)
        top_resp, top_idx = top_resp[:k_per_oct], top_idx[:k_per_oct]
        s_idx = top_idx // (h * w)
        y_idx = (top_idx % (h * w)) // w
        x_idx = top_idx % w
        scale_img = 2.0 ** o
        sigma_kp = cfg.sigma0 * torch.pow(2.0, (s_idx.to(_F64) + 1.0) / S) \
            * scale_img
        xy.append(torch.stack([x_idx.to(_F64) * scale_img,
                               y_idx.to(_F64) * scale_img], -1))
        scale.append(sigma_kp)
        resp.append(top_resp)

        # gradients of the gaussian levels for orientation and descriptor
        gx = (torch.roll(gauss, -1, -1) - torch.roll(gauss, 1, -1)) / 2.0
        gy = (torch.roll(gauss, -1, -2) - torch.roll(gauss, 1, -2)) / 2.0
        ori_o, desc_o = _orient_and_describe(
            torch.sqrt(gx * gx + gy * gy), torch.atan2(gy, gx), s_idx, y_idx,
            x_idx, sigma_kp / scale_img, cfg)
        ori.append(ori_o)
        desc.append(desc_o)
        base = gauss[S][::2, ::2]

    return (torch.cat(xy) + 0.5, torch.cat(scale), torch.cat(ori),
            torch.cat(desc), torch.cat(resp) > 0)


def extract(img_gray: np.ndarray, cfg: SiftConfig = SiftConfig(),
            device="cuda"):
    """Host API: grayscale [H, W] in [0, 1] -> (xy, scale, ori, desc, valid)
    numpy arrays with K = ``cfg.max_keypoints`` rows, computed on
    ``device``."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(img_gray, np.float32), device=dev)
    return tuple(a.cpu().numpy() for a in extract_tensors(img, cfg))
