"""SuperPoint detector and descriptor in torch (weight-gated learned
front-end).

Counterpart of ``instantsfm_tpu/features/superpoint.py``: the shared VGG
encoder (8 3x3 ReLU convs, a 2x max-pool before the 3rd, 5th and 7th), the
65-channel detector head (softmax, dustbin dropped, depth-to-space 8x8) and
the L2-normalized 256-d descriptor head, as ``F.conv2d`` in NCHW.  The
module's parameter names are those of MagicLeap's ``superpoint_v1.pth``.

Weights live in the npz that JAX's converter writes (HWIO convolutions, at
``INSTANTSFM_SUPERPOINT_WEIGHTS`` or the shared cache path), so one file
serves both packages; ``convert.superpoint_from_numpy`` builds the module
from it.  Keypoints are the top ``max_keypoints`` of the NMS'd heatmap by a
stable descending sort: ``lax.top_k`` puts the lower index first among
equal scores, and the NMS leaves many tied zeros.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from instantsfm_tpu_torch.utils.device import full_f32, resolve_device

# encoder: (out_channels, maxpool_before), all 3x3 stride-1 ReLU convs
_ENC = [(64, False), (64, False), (64, True), (64, False),
        (128, True), (128, False), (128, True), (128, False)]
_TORCH_ENC_NAMES = ["conv1a", "conv1b", "conv2a", "conv2b",
                    "conv3a", "conv3b", "conv4a", "conv4b"]
_HEADS = {"convPa": (3, 128, 256), "convPb": (1, 256, 65),
          "convDa": (3, 128, 256), "convDb": (1, 256, 256)}
CELL = 8                 # detector output stride
DESC_DIM = 256


class SuperPointConfig(NamedTuple):
    max_keypoints: int = 2048
    nms_radius: int = 4
    score_threshold: float = 0.005


class SuperPoint(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 1
        for name, (cout, _) in zip(_TORCH_ENC_NAMES, _ENC):
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout
        for name, (k, ci, co) in _HEADS.items():
            setattr(self, name, nn.Conv2d(ci, co, k, padding=k // 2))

    def forward(self, img):
        """img [H, W] grey in [0, 1], H and W multiples of 8 -> (heatmap
        [H, W], desc_grid [H/8, W/8, 256] L2-normalized)."""
        x = img[None, None]
        for name, (_, pool) in zip(_TORCH_ENC_NAMES, _ENC):
            if pool:
                x = F.max_pool2d(x, 2)
            x = F.relu(getattr(self, name)(x))
        semi = self.convPb(F.relu(self.convPa(x)))[0]          # [65, hc, wc]
        prob = torch.softmax(semi, dim=0)[:64]                  # drop dustbin
        hc, wc = prob.shape[1:]
        heat = prob.permute(1, 2, 0).reshape(hc, wc, CELL, CELL) \
            .permute(0, 2, 1, 3).reshape(hc * CELL, wc * CELL)
        desc = self.convDb(F.relu(self.convDa(x)))[0].permute(1, 2, 0)
        return heat, desc / torch.clamp_min(
            torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-8)


def _nms(heat, radius: int):
    """Keep the maxima of each (2r+1) window (ties kept), 0 elsewhere."""
    m = F.max_pool2d(heat[None, None], 2 * radius + 1, stride=1,
                     padding=radius)[0, 0]
    return torch.where(heat >= m, heat, 0.0)


def _bilinear_desc(desc_grid, xy):
    """Sample [Hc, Wc, D] descriptors at pixel coords xy [K, 2] (x, y)."""
    hc, wc, _ = desc_grid.shape
    # cell-grid coordinates of the sample (cell centres at (i+0.5)*CELL)
    gx = torch.clamp(xy[:, 0] / CELL - 0.5, 0.0, wc - 1.0)
    gy = torch.clamp(xy[:, 1] / CELL - 0.5, 0.0, hc - 1.0)
    x0 = torch.clamp(torch.floor(gx).long(), 0, wc - 2)
    y0 = torch.clamp(torch.floor(gy).long(), 0, hc - 2)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    d = (desc_grid[y0, x0] * (1 - fx) * (1 - fy)
         + desc_grid[y0, x0 + 1] * fx * (1 - fy)
         + desc_grid[y0 + 1, x0] * (1 - fx) * fy
         + desc_grid[y0 + 1, x0 + 1] * fx * fy)
    return d / torch.clamp_min(
        torch.linalg.vector_norm(d, dim=-1, keepdim=True), 1e-8)


def top_k(flat, k: int):
    """(values, indices) of the ``k`` largest, equal values in index order
    (``lax.top_k``'s slots): a stable descending sort."""
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:k], idx[:k]


def extract_tensors(img, net: SuperPoint, cfg: SuperPointConfig):
    """img [H, W] float32 on the net's device, H and W multiples of 8 ->
    (xy [K, 2], score [K], desc [K, 256], valid [K]) on that device."""
    with torch.inference_mode(), full_f32():
        heat, desc_grid = net(img)
        heat = _nms(heat, cfg.nms_radius)
        W = heat.shape[1]
        score, idx = top_k(heat.reshape(-1), cfg.max_keypoints)
        xy = torch.stack([idx % W, idx // W], -1).to(torch.float32)
        return xy, score, _bilinear_desc(desc_grid, xy), \
            score > cfg.score_threshold


def extract(img: np.ndarray, net: SuperPoint, cfg: SuperPointConfig = None,
            device="cuda"):
    """img [H, W] float grey in [0, 1] (any size; zero-padded to /8) ->
    (xy [K, 2], score [K], desc [K, 256], valid [K]) numpy, detections in
    the pad dropped; ``net`` is moved to ``device``."""
    cfg = cfg or SuperPointConfig()
    dev = resolve_device(device)
    h, w = img.shape
    img = np.pad(np.asarray(img, np.float32), ((0, (-h) % CELL),
                                               (0, (-w) % CELL)))
    xy, score, d, valid = (a.cpu().numpy() for a in extract_tensors(
        torch.as_tensor(img, device=dev), net.to(dev), cfg))
    valid &= (xy[:, 0] < w) & (xy[:, 1] < h)
    return xy, score, d, valid


# ------------------------------------------------------------------ weights

def default_weights_path() -> str:
    return os.environ.get(
        "INSTANTSFM_SUPERPOINT_WEIGHTS",
        os.path.join(os.path.expanduser("~"), ".cache", "instantsfm_tpu",
                     "superpoint_v1.npz"))


def load_weights(path: str) -> dict:
    """The npz's arrays (JAX's layout: HWIO convolutions)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def try_load_default():
    path = default_weights_path()
    return load_weights(path) if os.path.exists(path) else None


def random_weights(generator: torch.Generator = None,
                   dtype=np.float32) -> dict:
    """Architecture-shaped random weights in the npz layout (He-scaled
    normal convolutions, zero biases; tests and smoke runs only)."""
    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, dtype=torch.float64)
                * (2.0 / fan_in) ** 0.5).numpy().astype(dtype)

    w = {}
    cin = 1
    for name, (cout, _) in zip(_TORCH_ENC_NAMES, _ENC):
        w[f"{name}_w"] = normal((3, 3, cin, cout), 9 * cin)
        w[f"{name}_b"] = np.zeros(cout, dtype)
        cin = cout
    for name, (k, ci, co) in _HEADS.items():
        w[f"{name}_w"] = normal((k, k, ci, co), k * k * ci)
        w[f"{name}_b"] = np.zeros(co, dtype)
    return w


def convert_torch_checkpoint(pth_path: str, out_path: str = None) -> str:
    """One-time converter: public ``superpoint_v1.pth`` (MagicLeap) -> the
    npz both packages read (HWIO convolutions)."""
    sd = torch.load(pth_path, map_location="cpu")
    out = {}
    for n in _TORCH_ENC_NAMES + list(_HEADS):
        out[f"{n}_w"] = sd[f"{n}.weight"].numpy().transpose(2, 3, 1, 0)
        out[f"{n}_b"] = sd[f"{n}.bias"].numpy()
    out_path = out_path or default_weights_path()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez(out_path, **out)
    return out_path
