"""DISK detector and descriptor in torch (weight-gated learned front-end).

Counterpart of ``instantsfm_tpu/features/disk.py``: the thin U-Net of the
official DISK release, as ``F.conv2d`` in NCHW:

  down channels [16, 32, 64, 64, 64]   (block 0 at full resolution, a 2x
                                        average pool before each other)
  up   channels [64, 64, 64, 129]      (nearest 2x upsample, concat skip,
                                        one conv block each)
  conv block = instance norm (biased variance, eps 1e-5, no affine) ->
  PReLU -> 5x5 conv; the input block applies the conv alone.

Output channels [:128] are the dense descriptors (L2-normalized at the
sample points), channel 128 the heatmap.  Keypoints are the window-NMS
local maxima (others set to -inf), top-k by a stable descending sort, as
``lax.top_k`` orders the tied -inf slots.  Weights come from the npz JAX's
converter writes (``INSTANTSFM_DISK_WEIGHTS``); ``convert.disk_from_numpy``
builds the module.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from instantsfm_tpu_torch.features.superpoint import top_k
from instantsfm_tpu_torch.utils.device import full_f32, resolve_device

DESC_DIM = 128
_DOWN = [16, 32, 64, 64, 64]
_UP = [64, 64, 64, DESC_DIM + 1]
_KSIZE = 5


class DiskConfig(NamedTuple):
    max_keypoints: int = 2048
    nms_window: int = 5          # kornia inference default
    score_threshold: float = 0.0


def _block_names():
    return [f"down{i}" for i in range(len(_DOWN))] + \
           [f"up{i}" for i in range(len(_UP))]


def _block_widths():
    """(cin, cout) of each block, in ``_block_names`` order."""
    cins = [3] + _DOWN[:-1]
    skips = _DOWN[-2::-1]
    ups_in = [_DOWN[-1] + skips[0]] + [_UP[i - 1] + skips[i]
                                       for i in range(1, len(_UP))]
    return list(zip(cins + ups_in, _DOWN + _UP))


class _Block(nn.Module):
    """Pre-activation conv block: norm -> PReLU -> 5x5 conv; without a
    gate (the input block) the conv alone."""

    def __init__(self, cin, cout, gated):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, _KSIZE, padding=_KSIZE // 2)
        self.prelu = nn.Parameter(torch.full((cin,), 0.25)) if gated else None

    def forward(self, x):
        if self.prelu is not None:
            mu = x.mean(dim=(2, 3), keepdim=True)
            var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
            x = (x - mu) * torch.rsqrt(var + 1e-5)
            x = torch.where(x >= 0, x, self.prelu.reshape(1, -1, 1, 1) * x)
        return self.conv(x)


class Disk(nn.Module):
    """``gated``: the blocks with a PReLU gate (all but the input block,
    unless a checkpoint gates it too)."""

    def __init__(self, gated=None):
        super().__init__()
        names = _block_names()
        gated = set(names[1:] if gated is None else gated)
        self.blocks = nn.ModuleDict({
            name: _Block(cin, cout, name in gated)
            for name, (cin, cout) in zip(names, _block_widths())})

    def forward(self, img):
        """img [H, W, 3] in [0, 1], H and W multiples of 16 -> (heatmap
        [H, W], desc_grid [H, W, 128] unnormalized)."""
        x = img.permute(2, 0, 1)[None]
        skips = []
        for i in range(len(_DOWN)):
            if i > 0:
                x = F.avg_pool2d(x, 2)
            x = self.blocks[f"down{i}"](x)
            skips.append(x)
        for i in range(len(_UP)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = torch.cat([x, skips[len(_DOWN) - 2 - i]], dim=1)
            x = self.blocks[f"up{i}"](x)
        out = x[0]
        return out[DESC_DIM], out[:DESC_DIM].permute(1, 2, 0)


def _nms(heat, window: int):
    r = window // 2
    m = F.max_pool2d(heat[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
    return torch.where(heat >= m, heat, -torch.inf)


def extract_tensors(img, net: Disk, cfg: DiskConfig):
    """img [H, W, 3] float32 on the net's device, H and W multiples of 16
    -> (xy [K, 2], score [K], desc [K, 128], valid [K]) on that device."""
    with torch.inference_mode(), full_f32():
        heat, desc_grid = net(img)
        heat = _nms(heat, cfg.nms_window)
        W = heat.shape[1]
        score, idx = top_k(heat.reshape(-1), cfg.max_keypoints)
        xy = torch.stack([idx % W, idx // W], -1).to(torch.float32)
        d = desc_grid.reshape(-1, DESC_DIM)[idx]
        d = d / torch.clamp_min(
            torch.linalg.vector_norm(d, dim=-1, keepdim=True), 1e-8)
        return xy, score, d, score > cfg.score_threshold


def extract(img: np.ndarray, net: Disk, cfg: DiskConfig = None,
            device="cuda"):
    """img [H, W, 3] (or [H, W] grey, stacked) float in [0, 1], zero-padded
    to /16 -> (xy [K, 2], score [K], desc [K, 128], valid [K]) numpy,
    detections in the pad dropped; ``net`` is moved to ``device``."""
    cfg = cfg or DiskConfig()
    dev = resolve_device(device)
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    h, w = img.shape[:2]
    img = np.pad(img, ((0, (-h) % 16), (0, (-w) % 16), (0, 0)))
    xy, score, d, valid = (a.cpu().numpy() for a in extract_tensors(
        torch.as_tensor(img, device=dev), net.to(dev), cfg))
    valid &= (xy[:, 0] < w) & (xy[:, 1] < h)
    return xy, score, d, valid


# ------------------------------------------------------------------ weights

def default_weights_path() -> str:
    return os.environ.get(
        "INSTANTSFM_DISK_WEIGHTS",
        os.path.join(os.path.expanduser("~"), ".cache", "instantsfm_tpu",
                     "disk_depth.npz"))


def load_weights(path: str) -> dict:
    """The npz's arrays (JAX's layout: HWIO convolutions)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def try_load_default():
    path = default_weights_path()
    return load_weights(path) if os.path.exists(path) else None


def random_weights(generator: torch.Generator = None,
                   dtype=np.float32) -> dict:
    """Architecture-shaped random weights in the npz layout (tests and
    smoke runs only): He-scaled normal 5x5 convolutions, zero biases, PReLU
    gates of 0.25."""
    w = {}
    for name, (cin, cout) in zip(_block_names(), _block_widths()):
        fan_in = _KSIZE * _KSIZE * cin
        w[f"{name}_w"] = (torch.randn((_KSIZE, _KSIZE, cin, cout),
                                      generator=generator,
                                      dtype=torch.float64)
                          * (2.0 / fan_in) ** 0.5).numpy().astype(dtype)
        w[f"{name}_b"] = np.zeros(cout, dtype)
        if name != "down0":
            w[f"{name}_prelu"] = np.full(cin, 0.25, dtype)
    return w


def convert_torch_checkpoint(pth_path: str, out_path: str = None) -> str:
    """One-time converter: public DISK checkpoint (official
    ``depth-save.pth`` / kornia hub export) -> the npz both packages read.
    Maps by position: the 9 convs and their PReLU gates appear in
    definition order in either export's state dict."""
    sd = torch.load(pth_path, map_location="cpu")
    for k in ("extractor", "state_dict", "model"):
        if isinstance(sd, dict) and k in sd:
            sd = sd[k]
    convs = [(k, v) for k, v in sd.items()
             if k.endswith("weight") and v.ndim == 4]
    prelus = [v for k, v in sd.items()
              if k.endswith("weight") and v.ndim <= 1]
    names = _block_names()
    if len(convs) != len(names):
        raise ValueError(f"expected {len(names)} conv layers, found "
                         f"{len(convs)}: {[k for k, _ in convs]}")
    if len(prelus) not in (len(names), len(names) - 1):
        raise ValueError(f"expected {len(names)-1} or {len(names)} PReLU "
                         f"gates, found {len(prelus)}")
    out = {}
    for name, (k, v) in zip(names, convs):
        out[f"{name}_w"] = v.numpy().transpose(2, 3, 1, 0)    # OIHW -> HWIO
        b = sd.get(k[:-len("weight")] + "bias")
        out[f"{name}_b"] = (b.numpy() if b is not None
                            else np.zeros(v.shape[0], np.float32))
    gated = names[1:] if len(prelus) == len(names) - 1 else names
    for name, v in zip(gated, prelus):
        out[f"{name}_prelu"] = v.numpy().reshape(-1).astype(np.float32)
    out_path = out_path or default_weights_path()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez(out_path, **out)
    return out_path
