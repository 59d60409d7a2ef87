"""LPIPS perceptual metric (AlexNet variant) in torch.

Counterpart of ``instantsfm_tpu/gs/lpips.py`` (the reference's eval metric,
``LearnedPerceptualImagePatchSimilarity(net_type="alex")``): the input is
scaled to [-1, 1] and normalised by LPIPS's shift and scale, passed
through the AlexNet convolution trunk (a VALID 3x3 stride-2 max-pool after
the first two convolutions); at each of the 5 ReLU taps the features are
unit-normalised over channels, their squared differences weighted by a
non-negative 1x1 linear head, averaged over space and summed over taps.

Weights are weight-gated as in the JAX package: the npz at
``INSTANTSFM_LPIPS_WEIGHTS`` or ``~/.cache/instantsfm_tpu/lpips_alex.npz``
(JAX's layout, HWIO convolutions), which either package's
``convert_torch_checkpoint`` writes; ``convert.lpips_from_numpy`` builds
the module.  Without the file the metric is absent; a file that is present
and does not load raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# AlexNet trunk: (out_ch, kernel, stride, pad, maxpool_after)
_ALEX = [
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """Parameters ``conv{i}.weight`` (OIHW), ``conv{i}.bias`` and
    ``lin{i}`` [C] for the 5 stages."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (cout, k, s, p, _) in enumerate(_ALEX):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, k, stride=s,
                                                padding=p))
            self.register_parameter(f"lin{i}", nn.Parameter(torch.zeros(cout)))
            cin = cout

    def features(self, x):
        """x [N, 3, H, W] in [-1, 1] -> the 5 tap activations (NCHW)."""
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        x = (x - shift[:, None, None]) / scale[:, None, None]
        taps = []
        for i, (*_, pool) in enumerate(_ALEX):
            x = F.relu(getattr(self, f"conv{i}")(x))
            taps.append(x)
            if pool:
                x = F.max_pool2d(x, 3, 2)
        return taps

    def forward(self, img0, img1):
        """LPIPS distance of images in [0, 1], [H, W, 3] or [N, H, W, 3];
        the mean over the batch."""
        if img0.dim() == 3:
            img0, img1 = img0[None], img1[None]
        nchw = lambda a: a.permute(0, 3, 1, 2) * 2.0 - 1.0
        total = 0.0
        for i, (f0, f1) in enumerate(zip(self.features(nchw(img0)),
                                         self.features(nchw(img1)))):
            n0 = f0 / torch.sqrt(torch.sum(f0 * f0, 1, keepdim=True) + 1e-10)
            n1 = f1 / torch.sqrt(torch.sum(f1 * f1, 1, keepdim=True) + 1e-10)
            lin = torch.clamp(getattr(self, f"lin{i}"), min=0.0)
            d = torch.sum((n0 - n1) ** 2 * lin[:, None, None], dim=1)
            total = total + torch.mean(d, dim=(1, 2))
        return torch.mean(total)


def default_weights_path() -> str:
    return os.environ.get(
        "INSTANTSFM_LPIPS_WEIGHTS",
        os.path.join(os.path.expanduser("~"), ".cache", "instantsfm_tpu",
                     "lpips_alex.npz"))


def load_weights(path: str) -> dict:
    """The npz's arrays (JAX's layout: HWIO convolutions)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def try_load_default():
    path = default_weights_path()
    return load_weights(path) if os.path.exists(path) else None


def random_weights(generator: torch.Generator = None) -> dict:
    """Architecture-shaped random weights in the npz layout (He-scaled
    normal convolutions, zero biases, uniform heads; tests and smoke runs
    only)."""
    w = {}
    cin = 3
    for i, (cout, k, *_) in enumerate(_ALEX):
        conv = torch.randn((k, k, cin, cout), generator=generator,
                           dtype=torch.float64) * (2.0 / (k * k * cin)) ** 0.5
        w[f"conv{i}_w"] = conv.numpy().astype(np.float32)
        w[f"conv{i}_b"] = np.zeros(cout, np.float32)
        w[f"lin{i}_w"] = torch.rand(
            cout, generator=generator,
            dtype=torch.float64).numpy().astype(np.float32)
        cin = cout
    return w


def convert_torch_checkpoint(pth_path: str, out_path: str = None) -> str:
    """One-time converter: the ``lpips`` package's AlexNet checkpoint (the
    trunk from torchvision's alexnet and the LPIPS linear heads) -> the npz
    both packages read (HWIO convolutions)."""
    sd = torch.load(pth_path, map_location="cpu")
    out = {}
    conv_ids = [0, 3, 6, 8, 10]      # torchvision alexnet .features indices
    for i, ci in enumerate(conv_ids):
        for k in (f"net.slice{i + 1}.{ci}.weight", f"features.{ci}.weight"):
            if k in sd:
                out[f"conv{i}_w"] = sd[k].numpy().transpose(2, 3, 1, 0)
                out[f"conv{i}_b"] = sd[k.replace("weight", "bias")].numpy()
    for i in range(5):
        for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if k in sd:
                out[f"lin{i}_w"] = sd[k].numpy().reshape(-1)
    missing = [i for i in range(5)
               if f"conv{i}_w" not in out or f"lin{i}_w" not in out]
    if missing:
        raise ValueError(f"could not map weights for stages {missing}; "
                         f"keys present: {sorted(sd)[:10]}...")
    out_path = out_path or default_weights_path()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez(out_path, **out)
    return out_path
