"""Carry a problem across from the JAX package's numpy form, and back.

``from_numpy`` turns ``Params``/``Observations`` of ``instantsfm_tpu`` given
as numpy arrays (any object with the same field names, e.g. the JAX
NamedTuples after ``np.asarray`` on every leaf) into this port's tensors on
``device``; ``to_numpy`` maps the port's tensors back to numpy.
``splats_from_numpy``/``splats_to_numpy`` do the same for the 3DGS
``Splats``.  ``superpoint_from_numpy``, ``disk_from_numpy``,
``lightglue_from_numpy`` and ``dedode_from_numpy`` build the learned
front-ends' modules from a weight dict in the npz layout both packages
share (JAX's ``random_weights`` after ``np.asarray``, or ``load_weights``
of a converted checkpoint): HWIO convolutions become OIHW;
``lpips_from_numpy`` does so for the LPIPS AlexNet.  ``gs_aux_from_numpy``
builds the 3DGS trainer's pose, appearance and bilateral-grid modules from
the JAX ``Runner.aux_params`` dict.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.features import dedode, disk, lightglue, superpoint
from instantsfm_tpu_torch.gs import bilateral, camera_opt, lpips
from instantsfm_tpu_torch.gs.splats import FIELDS, Splats
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


def splats_from_numpy(splats_np, device="cuda") -> Splats:
    """Any object with the ``Splats`` field names (e.g. the JAX ``Splats``
    after ``np.asarray`` on every leaf) -> the port's ``Splats`` on
    ``device``: float fields float32, ``alive`` bool."""
    dev = resolve_device(device)
    get = (splats_np.get if isinstance(splats_np, dict)
           else lambda f: getattr(splats_np, f))
    return Splats(**{
        f: torch.tensor(np.asarray(get(f), bool if f == "alive" else np.float32),
                        device=dev) for f in FIELDS})


def splats_to_numpy(splats: Splats) -> dict:
    """The port's ``Splats`` -> {field: numpy array}."""
    return {f: getattr(splats, f).detach().cpu().numpy() for f in FIELDS}


def _weights(weights, device, dtype):
    """{name: array} -> {name: tensor on ``device``}; 4-d arrays (HWIO
    convolutions) transposed to OIHW; 0-d entries dropped."""
    dev = resolve_device(device)
    out = {}
    for k, v in weights.items():
        a = np.asarray(v)
        if a.ndim == 0:
            continue
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[k] = torch.tensor(np.ascontiguousarray(a), device=dev, dtype=dtype)
    return out


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval().requires_grad_(False)


def superpoint_from_numpy(weights, device="cuda", dtype=torch.float32):
    """SuperPoint npz dict -> ``features.superpoint.SuperPoint``."""
    w = _weights(weights, device, dtype)
    state = {f"{k[:-2]}.{'weight' if k.endswith('_w') else 'bias'}": v
             for k, v in w.items()}
    return _load(superpoint.SuperPoint().to(device=w["conv1a_w"].device,
                                            dtype=dtype), state)


def disk_from_numpy(weights, device="cuda", dtype=torch.float32):
    """DISK npz dict -> ``features.disk.Disk`` (gated where the dict has a
    ``_prelu`` entry, with its shape)."""
    w = _weights(weights, device, dtype)
    gated = [k[:-len("_prelu")] for k in w if k.endswith("_prelu")]
    net = disk.Disk(gated).to(device=w["down0_w"].device, dtype=dtype)
    state = {}
    for k, v in w.items():
        block, kind = k.rsplit("_", 1)
        if kind == "prelu":
            net.blocks[block].prelu = torch.nn.Parameter(v.clone())
        state[f"blocks.{block}." + {"w": "conv.weight", "b": "conv.bias",
                                    "prelu": "prelu"}[kind]] = v
    return _load(net, state)


def lightglue_from_numpy(weights, device="cuda", dtype=torch.float32):
    """LightGlue npz dict -> ``features.lightglue.LightGlue``; the input
    width (256 for SuperPoint, 128 for DISK) comes from ``input_proj_w``."""
    w = _weights(weights, device, dtype)
    net = lightglue.LightGlue(input_dim=w["input_proj_w"].shape[1]).to(
        device=w["input_proj_w"].device, dtype=dtype)
    state = {"posenc_Wr": w.pop("posenc_Wr")}
    for k, v in w.items():
        stem, wb = k[:-2], "weight" if k.endswith("_w") else "bias"
        if stem.startswith("l") and stem[1].isdigit():
            layer, kind, name = stem[1:].split("_", 2)
            stem = f"{kind}_blocks.{layer}.{name}"
        state[f"{stem}.{wb}"] = v
    return _load(net, state)


def dedode_from_numpy(weights, device="cuda", dtype=torch.float32):
    """DeDoDe npz dict -> ``features.dedode.DeDoDe`` (every array kept under
    its npz name)."""
    return dedode.DeDoDe(_weights(weights, device, dtype)).eval() \
        .requires_grad_(False)


def lpips_from_numpy(weights, device="cuda"):
    """LPIPS npz dict (``conv{i}_w`` HWIO, ``conv{i}_b``, ``lin{i}_w``) ->
    ``gs.lpips.LPIPS`` in float32."""
    w = _weights(weights, device, torch.float32)
    state = {}
    for k, v in w.items():
        stem, kind = k.rsplit("_", 1)
        state[stem if stem.startswith("lin")
              else f"{stem}.{'weight' if kind == 'w' else 'bias'}"] = v
    return _load(lpips.LPIPS().to(w["conv0_w"].device), state)


def gs_aux_from_numpy(aux_np, device="cuda") -> dict:
    """The JAX trainer's ``aux_params`` ({"pose": {"pose_deltas"}, "app":
    {"embeds", "w1", "b1", "w2", "b2"}, "bilgrid": {"grids"}}, any subset,
    numpy leaves) -> {name: the port's module} on ``device`` in float32,
    trainable: ``CameraOptModule``, ``AppearanceOptModule`` and
    ``BilateralGrid``.  Load one into a ``Runner`` with
    ``runner.aux[name].load_state_dict(module.state_dict())``, which keeps
    the runner's optimizer on its parameters."""
    dev = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    out = {}
    if "pose" in aux_np:
        d = f32(aux_np["pose"]["pose_deltas"])
        out["pose"] = camera_opt.CameraOptModule(d.shape[0], device=dev)
        out["pose"].load_state_dict({"pose_deltas": d})
    if "app" in aux_np:
        a = {k: f32(v) for k, v in aux_np["app"].items()}
        n_imgs, embed_dim = a["embeds"].shape
        in_dim, width = a["w1"].shape
        basis = in_dim - embed_dim - 32          # default feature_dim = 32
        m = camera_opt.AppearanceOptModule(
            n_imgs, embed_dim=embed_dim, sh_degree=round(basis ** 0.5) - 1,
            mlp_width=width, generator=torch.Generator(), device=dev)
        m.load_state_dict(a)
        out["app"] = m
    if "bilgrid" in aux_np:
        g = f32(aux_np["bilgrid"]["grids"])
        n_imgs, gh, gw, gg, _ = g.shape
        m = bilateral.BilateralGrid(n_imgs, grid_w=gw, grid_h=gh, grid_g=gg,
                                    device=dev)
        m.load_state_dict({"grids": g})
        out["bilgrid"] = m
    return out
