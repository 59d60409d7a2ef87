"""LightGlue learned matcher in torch (weight-gated).

Counterpart of ``instantsfm_tpu/features/lightglue.py`` (Lindenberger et
al., ICCV 2023), batched over pairs with a leading axis and masked so one
code path serves every pair:

* keypoint normalization and the learnable Fourier rotary encoding
  (interleaved cos/sin pairs, on q and k of the self blocks only);
* 9 layers, each a masked 4-head self-attention block on each image and a
  bidirectional cross-attention block (shared qk projection), with the
  concat-FFN residual update;
* the log double-softmax assignment with matchability; mutual-argmax
  matches above the threshold, compacted to ``max_matches`` by a stable
  sort.

The attention is written as JAX writes it: product, masked logits filled
with -1e30, softmax, product.  A row whose keys are all masked (an image
without a valid keypoint) gets uniform weights there, where
``F.scaled_dot_product_attention`` with a boolean mask returns zeros.
Like JAX, the matcher always runs all 9 layers on all keypoints (no
adaptive depth or width).  Weights come from the npz JAX's converter
writes (``INSTANTSFM_LIGHTGLUE_WEIGHTS`` or
``~/.cache/instantsfm_tpu/{features}_lightglue.npz``);
``convert.lightglue_from_numpy`` builds the module.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from instantsfm_tpu_torch.utils.device import full_f32, resolve_device

DIM = 256
HEADS = 4
HEAD_DIM = DIM // HEADS
N_LAYERS = 9
_NEG = -1e30


class LightGlueConfig(NamedTuple):
    filter_threshold: float = 0.1    # kornia/official default
    max_matches: int = 2048


class _Block(nn.Module):
    """Self block (``Wqkv``, ``out``) or cross block (``qk``, ``v``,
    ``out``), with the FFN ``ffn0`` -> LayerNorm ``ffn_ln`` -> GELU ->
    ``ffn3`` on [x | message]."""

    def __init__(self, cross: bool):
        super().__init__()
        if cross:
            self.qk = nn.Linear(DIM, DIM)
            self.v = nn.Linear(DIM, DIM)
        else:
            self.Wqkv = nn.Linear(DIM, 3 * DIM)
        self.out = nn.Linear(DIM, DIM)
        self.ffn0 = nn.Linear(2 * DIM, 2 * DIM)
        self.ffn_ln = nn.LayerNorm(2 * DIM, eps=1e-5)
        self.ffn3 = nn.Linear(2 * DIM, DIM)

    def ffn(self, x, message):
        h = self.ffn0(torch.cat([x, message], dim=-1))
        return x + self.ffn3(F.gelu(self.ffn_ln(h)))


def _heads(x):
    """[B, M, DIM] -> [B, HEADS, M, HEAD_DIM]."""
    return x.reshape(x.shape[0], x.shape[1], HEADS, HEAD_DIM).transpose(1, 2)


def _unheads(x):
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], DIM)


def _rotary(q, cos, sin):
    """Interleaved-pair rotation: (q0, q1) -> (q0 c - q1 s, q1 c + q0 s)."""
    q2 = q.reshape(q.shape[:-1] + (HEAD_DIM // 2, 2))
    rot = torch.stack([-q2[..., 1], q2[..., 0]], dim=-1).reshape(q.shape)
    return q * cos + rot * sin


def _masked_softmax(logits, kmask):
    """Softmax over the last axis with keys outside ``kmask`` [B, Mk]
    filled with -1e30 first (an all-masked row is uniform)."""
    return torch.softmax(torch.where(kmask[:, None, None, :], logits,
                                     _NEG), dim=-1)


def _posenc(kpts, size, Wr):
    """kpts [B, M, 2], size [B, 2] -> interleaved rotary cos/sin
    [B, 1, M, HEAD_DIM]."""
    shift = size / 2.0
    scale = torch.amax(size, dim=-1) / 2.0
    k = (kpts - shift[:, None, :]) / scale[:, None, None]
    emb = torch.repeat_interleave(k @ Wr.T, 2, dim=-1)
    return torch.cos(emb)[:, None], torch.sin(emb)[:, None]


class LightGlue(nn.Module):
    def __init__(self, input_dim: int = 256):
        super().__init__()
        self.input_proj = nn.Linear(input_dim, DIM)
        self.posenc_Wr = nn.Parameter(torch.zeros(HEAD_DIM // 2, 2))
        self.self_blocks = nn.ModuleList(_Block(False)
                                         for _ in range(N_LAYERS))
        self.cross_blocks = nn.ModuleList(_Block(True)
                                          for _ in range(N_LAYERS))
        self.match_final = nn.Linear(DIM, DIM)
        self.match_ability = nn.Linear(DIM, 1)

    def _self(self, blk, x, cos, sin, mask):
        q, k, v = (_heads(a) for a in blk.Wqkv(x).chunk(3, dim=-1))
        q, k = _rotary(q, cos, sin), _rotary(k, cos, sin)
        logits = q @ k.transpose(-1, -2) / HEAD_DIM ** 0.5
        msg = blk.out(_unheads(_masked_softmax(logits, mask) @ v))
        return blk.ffn(x, msg)

    def _cross(self, blk, x0, x1, m0, m1):
        s = HEAD_DIM ** -0.25
        qk0, qk1 = _heads(blk.qk(x0)) * s, _heads(blk.qk(x1)) * s
        v0, v1 = _heads(blk.v(x0)), _heads(blk.v(x1))
        logits = qk0 @ qk1.transpose(-1, -2)
        msg0 = _masked_softmax(logits, m1) @ v1
        msg1 = _masked_softmax(logits.transpose(-1, -2), m0) @ v0
        return (blk.ffn(x0, blk.out(_unheads(msg0))),
                blk.ffn(x1, blk.out(_unheads(msg1))))

    def forward(self, kpts0, desc0, m0, kpts1, desc1, m1, size0, size1):
        """Batched pairs: kpts [B, M, 2], desc [B, M, D], masks [B, M]
        bool, sizes [B, 2] (width, height) -> log assignment scores
        [B, M0, M1]."""
        x0, x1 = self.input_proj(desc0), self.input_proj(desc1)
        cos0, sin0 = _posenc(kpts0, size0, self.posenc_Wr)
        cos1, sin1 = _posenc(kpts1, size1, self.posenc_Wr)
        for sb, cb in zip(self.self_blocks, self.cross_blocks):
            x0 = self._self(sb, x0, cos0, sin0, m0)
            x1 = self._self(sb, x1, cos1, sin1, m1)
            x0, x1 = self._cross(cb, x0, x1, m0, m1)
        md0 = self.match_final(x0) / DIM ** 0.25
        md1 = self.match_final(x1) / DIM ** 0.25
        sim = torch.where(m0[:, :, None] & m1[:, None, :],
                          md0 @ md1.transpose(-1, -2), _NEG)
        z0 = self.match_ability(x0)[..., 0]
        z1 = self.match_ability(x1)[..., 0]
        certainty = F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
        return (torch.log_softmax(sim, dim=2) + torch.log_softmax(sim, dim=1)
                + certainty)


def filter_matches(scores, m0, m1, threshold: float, max_matches: int):
    """scores [B, M0, M1] -> (matches [B, min(M0, max_matches), 2] int32,
    the valid rows first, count [B], msc [B, M0]): mutual argmaxes (first
    index among ties) whose exp(score) passes ``threshold``."""
    best1 = torch.argmax(scores, dim=2)                    # [B, M0]
    best0 = torch.argmax(scores, dim=1)                    # [B, M1]
    M0 = scores.shape[1]
    mutual = torch.gather(best0, 1, best1) == torch.arange(
        M0, device=scores.device)[None]
    msc = torch.exp(torch.amax(scores, dim=2))
    ok = mutual & (msc > threshold) & m0 & torch.gather(m1, 1, best1)
    # compact to a fixed match budget, valid rows first (stable, as JAX's
    # argsort of ~ok)
    idx0 = torch.argsort((~ok).to(torch.uint8), dim=1,
                         stable=True)[:, :max_matches]
    out = torch.stack([idx0, torch.gather(best1, 1, idx0)], -1).to(torch.int32)
    return out, torch.clamp_max(ok.sum(dim=1), max_matches), msc


def match_tensors(net: LightGlue, kpts0, desc0, m0, kpts1, desc1, m1,
                  size0, size1, threshold: float, max_matches: int):
    """Batched tensors on the net's device -> (matches, count, msc) as
    ``filter_matches`` gives them."""
    with torch.inference_mode(), full_f32():
        scores = net(kpts0, desc0, m0, kpts1, desc1, m1, size0, size1)
        return filter_matches(scores, m0, m1, threshold, max_matches)


def match_pair(kpts0, desc0, valid0, kpts1, desc1, valid1, size, net,
               cfg: LightGlueConfig = LightGlueConfig(), size1=None,
               device="cuda"):
    """One pair -> (matches [k, 2] int32, scores [k]) numpy.  Arrays are the
    padded per-image (keypoints [M, 2], descriptors [M, D], valid [M]) rows
    the extraction gives; ``size`` is image 0's (width, height), ``size1``
    image 1's (default ``size``).  Floats run in the net's dtype; ``net``
    is moved to ``device``."""
    dev = resolve_device(device)
    net = net.to(dev)
    dt = net.posenc_Wr.dtype
    t = lambda a, d=dt: torch.as_tensor(np.asarray(a), device=dev).to(d)[None]
    s0 = t(size)
    s1 = s0 if size1 is None else t(size1)
    out, count, msc = match_tensors(
        net, t(kpts0), t(desc0), t(valid0, torch.bool), t(kpts1), t(desc1),
        t(valid1, torch.bool), s0, s1, cfg.filter_threshold, cfg.max_matches)
    n = int(count[0])
    m = out[0, :n].cpu().numpy()
    return m, msc[0].cpu().numpy()[m[:, 0]] if n else np.zeros(0)


def match_all_pairs(kpts, descs, valids, sizes, net, pairs=None,
                    cfg: LightGlueConfig = LightGlueConfig(),
                    batch: int = None, device="cuda"):
    """{(i, j): matches [k, 2] int32} over ``pairs`` (exhaustive by
    default), ``batch`` pairs at a time (``ISFM_LG_BATCH``, default 8) with
    one host read a batch; the last batch is padded with its last pair and
    the padding's results are thrown away.  ``sizes`` is one (width,
    height) for all images or an [N, 2] array.  Inputs are rounded to
    float32, as JAX's are, then run in the net's dtype."""
    dev = resolve_device(device)
    n = len(descs)
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    if not pairs:
        return {}
    if batch is None:
        batch = int(os.environ.get("ISFM_LG_BATCH", "8"))
    sizes = np.asarray(sizes, np.float32)
    if sizes.ndim == 1:
        sizes = np.broadcast_to(sizes, (n, 2))
    net = net.to(dev)
    dt = net.posenc_Wr.dtype
    t = lambda a, d: torch.as_tensor(np.asarray(a, d), device=dev)
    kp, de = t(kpts, np.float32).to(dt), t(descs, np.float32).to(dt)
    va, sz = t(valids, bool), t(sizes, np.float32).to(dt)
    out = {}
    B = max(1, min(batch, len(pairs)))
    idx = np.asarray(pairs, np.int64)
    for s in range(0, len(pairs), B):
        sel = idx[s:s + B]
        if len(sel) < B:
            sel = np.concatenate([sel, np.repeat(sel[-1:], B - len(sel), 0)])
        i0 = torch.as_tensor(sel[:, 0], device=dev)
        i1 = torch.as_tensor(sel[:, 1], device=dev)
        m_b, c_b, _ = match_tensors(net, kp[i0], de[i0], va[i0], kp[i1],
                                    de[i1], va[i1], sz[i0], sz[i1],
                                    cfg.filter_threshold, cfg.max_matches)
        m_b, c_b = m_b.cpu().numpy(), c_b.cpu().numpy()
        for r in range(min(B, len(pairs) - s)):
            out[tuple(idx[s + r])] = m_b[r, :c_b[r]]
    return out


# ------------------------------------------------------------------ weights

def default_weights_path(features: str = "superpoint") -> str:
    env = os.environ.get("INSTANTSFM_LIGHTGLUE_WEIGHTS")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "instantsfm_tpu",
                        f"{features}_lightglue.npz")


def load_weights(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def try_load_default(features: str = "superpoint"):
    path = default_weights_path(features)
    return load_weights(path) if os.path.exists(path) else None


def random_weights(generator: torch.Generator = None, input_dim: int = 256,
                   dtype=np.float32) -> dict:
    """Architecture-shaped random weights in the npz layout (tests and
    smoke runs only): normal linear maps scaled by 1/sqrt(fan in) (0.02 for
    the FFN outputs), zero biases, unit LayerNorm gains."""
    w = {}

    def lin(name, dout, din, scale=None):
        s = scale if scale is not None else (1.0 / din) ** 0.5
        w[f"{name}_w"] = (torch.randn((dout, din), generator=generator,
                                      dtype=torch.float64) * s
                          ).numpy().astype(dtype)
        w[f"{name}_b"] = np.zeros(dout, dtype)

    lin("input_proj", DIM, input_dim)
    w["posenc_Wr"] = torch.randn((HEAD_DIM // 2, 2), generator=generator,
                                 dtype=torch.float64).numpy().astype(dtype)
    for i in range(N_LAYERS):
        for kind, maps in (("self", [("Wqkv", 3 * DIM, DIM),
                                     ("out", DIM, DIM)]),
                           ("cross", [("qk", DIM, DIM), ("v", DIM, DIM),
                                      ("out", DIM, DIM)])):
            p = f"l{i}_{kind}"
            for name, dout, din in maps:
                lin(f"{p}_{name}", dout, din)
            lin(f"{p}_ffn0", 2 * DIM, 2 * DIM)
            w[f"{p}_ffn_ln_w"] = np.ones(2 * DIM, dtype)
            w[f"{p}_ffn_ln_b"] = np.zeros(2 * DIM, dtype)
            lin(f"{p}_ffn3", DIM, 2 * DIM, scale=0.02)
    lin("match_final", DIM, DIM)
    lin("match_ability", 1, DIM)
    return w


def convert_torch_checkpoint(pth_path: str, out_path: str = None,
                             features: str = "superpoint") -> str:
    """One-time converter: official LightGlue checkpoint
    (``superpoint_lightglue.pth`` et al., or kornia's re-export) -> the npz
    both packages read."""
    sd = torch.load(pth_path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.removeprefix("matcher."): v for k, v in sd.items()}

    def get(name):
        if name not in sd:
            raise KeyError(f"{name} not in checkpoint "
                           f"(keys: {sorted(sd)[:8]}...)")
        return sd[name].numpy()

    out = {"posenc_Wr": get("posenc.Wr.weight")}
    pairs = [("input_proj", "input_proj")]
    for i in range(N_LAYERS):
        t = f"transformers.{i}"
        pairs += [(f"l{i}_self_Wqkv", f"{t}.self_attn.Wqkv"),
                  (f"l{i}_self_out", f"{t}.self_attn.out_proj"),
                  (f"l{i}_cross_qk", f"{t}.cross_attn.to_qk"),
                  (f"l{i}_cross_v", f"{t}.cross_attn.to_v"),
                  (f"l{i}_cross_out", f"{t}.cross_attn.to_out")]
        for kind, src in (("self", "self_attn"), ("cross", "cross_attn")):
            pairs += [(f"l{i}_{kind}_{dst}", f"{t}.{src}.ffn.{n}")
                      for n, dst in ((0, "ffn0"), (1, "ffn_ln"), (3, "ffn3"))]
    last = f"log_assignment.{N_LAYERS - 1}"
    pairs += [("match_final", f"{last}.final_proj"),
              ("match_ability", f"{last}.matchability")]
    for dst, src in pairs:
        out[f"{dst}_w"] = get(f"{src}.weight")
        out[f"{dst}_b"] = get(f"{src}.bias")
    out_path = out_path or default_weights_path(features)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez(out_path, **out)
    return out_path
