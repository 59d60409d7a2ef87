"""Pose refinement and appearance modules for 3DGS training.

Counterpart of ``instantsfm_tpu/gs/camera_opt.py`` (reference
``vis/utils/misc.py``): ``CameraOptModule`` holds a per-image 9-DoF pose
delta (3 translation + a 6D rotation delta) and ``AppearanceOptModule`` a
per-image embedding with a 2-layer MLP that maps (embedding, per-gaussian
features, SH basis of the view direction) to a colour offset.  Parameter
names are those of the JAX package's parameter dicts, so
``convert.gs_aux_from_numpy`` loads either from the other.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from instantsfm_tpu_torch.gs import sh as sh_mod


def rotation_6d_to_matrix(d6):
    """[..., 6] -> [..., 3, 3] by Gram-Schmidt on the two 3-vectors; the
    rows of the result are b1, b2, b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=1e-8)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True),
                           min=1e-8)
    b3 = torch.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


class CameraOptModule(nn.Module):
    """Residual pose embedding: ``pose_deltas`` [num_images, 9], zeros."""

    def __init__(self, num_images: int, device="cpu"):
        super().__init__()
        self.pose_deltas = nn.Parameter(
            torch.zeros((num_images, 9), device=device))

    def forward(self, camtoworld, image_id: int):
        """camtoworld [4, 4] -> camtoworld @ T, T the image's delta."""
        delta = self.pose_deltas[image_id]
        id6 = torch.tensor([1.0, 0, 0, 0, 1.0, 0], dtype=delta.dtype,
                           device=delta.device)
        R = rotation_6d_to_matrix(delta[3:] + id6)
        top = torch.cat([R, delta[:3, None]], dim=1)
        bottom = torch.tensor([[0.0, 0, 0, 1.0]], dtype=delta.dtype,
                              device=delta.device)
        return camtoworld @ torch.cat([top, bottom], dim=0)


class AppearanceOptModule(nn.Module):
    """Per-image embedding + 2-layer MLP -> per-gaussian colour offset.
    ``w1`` and ``w2`` are normal draws scaled by 1/sqrt(fan_in) from
    ``generator``; the embeddings and biases start at zero."""

    def __init__(self, num_images: int, feature_dim: int = 32,
                 embed_dim: int = 16, sh_degree: int = 3,
                 mlp_width: int = 64, generator=None, device="cpu"):
        super().__init__()
        in_dim = embed_dim + feature_dim + (sh_degree + 1) ** 2

        def normal(shape, fan_in):
            return torch.randn(shape, generator=generator) * fan_in ** -0.5

        self.embeds = nn.Parameter(torch.zeros((num_images, embed_dim)))
        self.w1 = nn.Parameter(normal((in_dim, mlp_width), in_dim))
        self.b1 = nn.Parameter(torch.zeros(mlp_width))
        self.w2 = nn.Parameter(normal((mlp_width, 3), mlp_width))
        self.b2 = nn.Parameter(torch.zeros(3))
        self.to(device)

    def forward(self, features, image_id: int, dirs, sh_degree: int):
        """features [N, F] per gaussian, dirs [N, 3] view directions ->
        colour offsets [N, 3]."""
        N = features.shape[0]
        basis = sh_mod.sh_basis(sh_degree, dirs)
        h = torch.cat([self.embeds[image_id][None].expand(N, -1), features,
                       basis], dim=-1)
        h = torch.relu(h @ self.w1 + self.b1)
        return h @ self.w2 + self.b2
