"""Carry a problem across from the JAX package's numpy form, and back.

``from_numpy`` turns ``Params``/``Observations`` of ``instantsfm_tpu`` given
as numpy arrays (any object with the same field names, e.g. the JAX
NamedTuples after ``np.asarray`` on every leaf) into this port's tensors on
``device``; ``to_numpy`` maps the port's tensors back to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.solve.block_lm import Observations, Params
from instantsfm_tpu_torch.utils.device import resolve_device


def _float(a, device, dtype):
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def from_numpy(params_np, obs_np, buckets=(), device="cuda",
               dtype=torch.float64):
    """-> (Params, Observations, buckets) on ``device``; floats in
    ``dtype``, indices int32, masks bool."""
    dev = resolve_device(device)
    params = Params(
        cam={k: _float(v, dev, dtype) for k, v in params_np.cam.items()},
        pts=_float(params_np.pts, dev, dtype),
        scales=_float(params_np.scales, dev, dtype),
        scales_free=torch.tensor(np.asarray(params_np.scales_free, bool),
                                 device=dev))
    obs = Observations(
        cam_idx=torch.tensor(np.asarray(obs_np.cam_idx, np.int32), device=dev),
        pt_idx=torch.tensor(np.asarray(obs_np.pt_idx, np.int32), device=dev),
        data={k: _float(v, dev, dtype) for k, v in obs_np.data.items()},
        valid=torch.tensor(np.asarray(obs_np.valid, bool), device=dev))
    buckets = tuple(tuple(int(v) for v in b) for b in buckets)
    return params, obs, buckets


def to_numpy(tree):
    """Tensors -> numpy arrays through NamedTuples, dicts, lists, tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
