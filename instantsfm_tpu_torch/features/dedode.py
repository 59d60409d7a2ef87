"""DeDoDe detector-L and descriptor-B in torch (weight-gated learned
front-end).

Counterpart of ``instantsfm_tpu/features/dedode.py`` (Edstedt et al., 3DV
2024): a VGG-style encoder tapped at strides 1/2/4/8 and a coarse-to-fine
decoder of ConvRefiner stacks that emits a keypoint logit map (detector)
or a dense descriptor field (descriptor), refined residually across scales
with an upsampled context stream.

Every structural width lives in the weights, not in this file: encoder
stage depths come from the key names (``{det|desc}_enc{stage}_{j}``),
refiner block counts likewise (``_ref{scale}_b{j}``), grouped-conv factors
from the shapes (groups = input channels / the weight's), and the optional
BatchNorm of a conv from its ``_bn_g/_b/_m/_v`` keys (eps 1e-5).  The
module keeps every array of the npz JAX's converter writes
(``INSTANTSFM_DEDODE_WEIGHTS``) under its npz name, convolutions as OIHW;
``convert.dedode_from_numpy`` builds it.  Upsampling is bilinear with
half-pixel centres (``F.interpolate``, ``align_corners=False``), which is
what ``jax.image.resize`` computes at 2x.
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

_SCALES = (8, 4, 2, 1)
# kornia's DeDoDe normalizes [0, 1] RGB with ImageNet statistics before the
# encoder; ``extract`` does the same, the raw maps below do not
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class DeDoDeConfig(NamedTuple):
    max_keypoints: int = 4096
    nms_window: int = 3          # dedup adjacent logit maxima
    score_threshold: float = 0.0


class DeDoDe(nn.Module):
    """``weights``: {npz name: tensor}, convolutions OIHW."""

    def __init__(self, weights: dict):
        super().__init__()
        self.w = nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                   for k, v in weights.items()})

    def _conv(self, x, name, groups=1):
        wt = self.w[f"{name}_w"]
        return F.conv2d(x, wt, self.w[f"{name}_b"],
                        padding=wt.shape[-1] // 2, groups=groups)

    def _bn(self, x, name):
        if f"{name}_g" not in self.w:
            return x
        c = lambda s: self.w[f"{name}_{s}"][None, :, None, None]
        return (x - c("m")) * torch.rsqrt(c("v") + 1e-5) * c("g") + c("b")

    def _vgg_features(self, x, prefix):
        """Stage s applies the ``{prefix}_enc{s}_{j}`` 3x3 conv (+BN) ReLU
        layers; features are tapped before each 2x max-pool."""
        feats = {}
        for stage, scale in enumerate((1, 2, 4, 8)):
            if stage > 0:
                x = F.max_pool2d(x, 2)
            j = 0
            while f"{prefix}_enc{stage}_{j}_w" in self.w:
                name = f"{prefix}_enc{stage}_{j}"
                x = F.relu(self._bn(self._conv(x, name), f"{name}_bn"))
                j += 1
            feats[scale] = x
        return feats

    def _refiner(self, x, p):
        """Block 0 maps in -> hidden, then residual hidden blocks, then the
        1x1 out head; a block is grouped 5x5 conv -> (BN) -> ReLU -> 1x1."""
        j, h = 0, None
        while f"{p}_b{j}_c1_w" in self.w:
            name = f"{p}_b{j}"
            src = x if j == 0 else h
            groups = src.shape[1] // self.w[f"{name}_c1_w"].shape[1]
            y = F.relu(self._bn(self._conv(src, f"{name}_c1", groups),
                                f"{name}_c1_bn"))
            y = self._conv(y, f"{name}_c2")
            h = y if j == 0 else h + y
            j += 1
        return self._conv(h, f"{p}_out")

    def _decode(self, feats, prefix, head_dim):
        """Coarse to fine: each scale's refiner takes [encoder feature |
        upsampled context] and emits [head | context]; heads accumulate
        through the 2x upsampling down to stride 1."""
        ctx = acc = None
        for scale in _SCALES:
            f = feats[scale]
            x = f if ctx is None else torch.cat([f, ctx], dim=1)
            out = self._refiner(x, f"{prefix}_ref{scale}")
            head, ctx = out[:, :head_dim], out[:, head_dim:]
            acc = head if acc is None else up2(acc) + head
            ctx = up2(ctx) if scale > 1 and ctx.shape[1] else None
        return acc

    def detector_logits(self, img):
        """img [H, W, 3] -> keypoint logit map [H, W]."""
        feats = self._vgg_features(img.permute(2, 0, 1)[None], "det")
        return self._decode(feats, "det", 1)[0, 0]

    def descriptor_field(self, img):
        """img [H, W, 3] -> dense descriptor field [H, W, D], D the width of
        the stride-1 refiner's head."""
        feats = self._vgg_features(img.permute(2, 0, 1)[None], "desc")
        return self._decode(feats, "desc", self.desc_dim)[0].permute(1, 2, 0)

    @property
    def desc_dim(self) -> int:
        return int(self.w["desc_ref1_out_w"].shape[0])


def up2(x):
    """Bilinear 2x upsampling of [N, C, H, W] with half-pixel centres."""
    return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]),
                         mode="bilinear", align_corners=False)


def _nms(heat, window: int):
    if window <= 1:
        return heat
    r = window // 2
    m = F.max_pool2d(heat[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
    return torch.where(heat >= m, heat, -torch.inf)


def extract_tensors(img, net: DeDoDe, cfg: DeDoDeConfig):
    """img [H, W, 3] float32 in [0, 1] on the net's device, H and W
    multiples of 8 -> (xy [K, 2], score [K], desc [K, D], valid [K])."""
    with torch.inference_mode(), full_f32():
        mean = torch.as_tensor(_IMAGENET_MEAN, device=img.device)
        std = torch.as_tensor(_IMAGENET_STD, device=img.device)
        img = (img - mean) / std
        logits = net.detector_logits(img)
        H, W = logits.shape
        # the detector is trained as a distribution over positions: score
        # by a softmax over the whole image, take the top modes after NMS
        prob = torch.softmax(logits.reshape(-1), dim=0).reshape(H, W)
        score, idx = top_k(_nms(prob, cfg.nms_window).reshape(-1),
                           cfg.max_keypoints)
        xy = torch.stack([idx % W, idx // W], -1).to(torch.float32)
        field = net.descriptor_field(img)
        desc = field.reshape(H * W, -1)[idx]
        desc = desc / torch.clamp_min(
            torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-8)
        return xy, score, desc, score > cfg.score_threshold


def extract(img: np.ndarray, net: DeDoDe, cfg: DeDoDeConfig = None,
            device="cuda"):
    """img [H, W, 3] (or [H, W] grey, stacked) float in [0, 1], zero-padded
    to /8 -> (xy [K, 2], score [K], desc [K, D], valid [K]) numpy,
    detections in the pad dropped; ``net`` is moved to ``device``."""
    cfg = cfg or DeDoDeConfig()
    dev = resolve_device(device)
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    h, w = img.shape[:2]
    img = np.pad(img, ((0, (-h) % 8), (0, (-w) % 8), (0, 0)))
    xy, score, d, valid = (a.cpu().numpy() for a in extract_tensors(
        torch.as_tensor(img, device=dev), net.to(dev), cfg))
    valid &= (xy[:, 0] < w) & (xy[:, 1] < h)
    return xy, score, d, valid


# ------------------------------------------------------------------ weights

def default_weights_path() -> str:
    return os.environ.get(
        "INSTANTSFM_DEDODE_WEIGHTS",
        os.path.join(os.path.expanduser("~"), ".cache", "instantsfm_tpu",
                     "dedode_L_B.npz"))


def load_weights(path: str) -> dict:
    """The npz's arrays (JAX's layout: HWIO convolutions; the 0-d group
    factors and head width as ints)."""
    with np.load(path) as z:
        return {k: int(z[k]) if z[k].ndim == 0 else z[k] for k in z.files}


def try_load_default():
    path = default_weights_path()
    return load_weights(path) if os.path.exists(path) else None


def random_weights(generator: torch.Generator = None,
                   dtype=np.float32) -> dict:
    """Small architecture-shaped weights in the npz layout (tests and smoke
    runs only), JAX's ``random_weights`` widths: one encoder conv a stage
    with [8, 16, 24, 32] channels, refiner hidden widths [32, 24, 16, 8],
    one hidden block, context width 4, descriptor dim 16.  The published
    L/B widths come only with their checkpoints."""
    enc_ch = [8, 16, 24, 32]
    hid = {8: 32, 4: 24, 2: 16, 1: 8}
    ctx_w = 4
    w = {}

    def mk(name, kh, cin, cout):
        w[f"{name}_w"] = (torch.randn((kh, kh, cin, cout), generator=generator,
                                      dtype=torch.float64)
                          * (2.0 / (kh * kh * cin)) ** 0.5
                          ).numpy().astype(dtype)
        w[f"{name}_b"] = np.zeros(cout, dtype)

    for prefix, head in (("det", 1), ("desc", 16)):
        cin = 3
        for i, cout in enumerate(enc_ch):
            mk(f"{prefix}_enc{i}_0", 3, cin, cout)
            cin = cout
        ctx = 0
        for si, scale in enumerate(_SCALES):
            p = f"{prefix}_ref{scale}"
            rin = enc_ch[3 - si] + ctx
            for j in range(2):            # block 0 + 1 hidden block
                mk(f"{p}_b{j}_c1", 5, rin if j == 0 else hid[scale],
                   hid[scale])
                mk(f"{p}_b{j}_c2", 1, hid[scale], hid[scale])
            ctx = 0 if scale == 1 else ctx_w
            mk(f"{p}_out", 1, hid[scale], head + ctx)
    return w


def _walk_torch(sd):
    """State dict -> ordered (key, conv weight, bias, BN dict or None),
    classified by tensor rank and the ``running_mean``/``running_var`` key
    suffixes of a BN that directly follows its conv."""
    items = [(k, v) for k, v in sd.items() if hasattr(v, "ndim")]
    convs = []
    for i, (k, v) in enumerate(items):
        if v.ndim != 4 or not k.endswith("weight"):
            continue
        bn = None
        for k2, v2 in items[i + 1:i + 8]:
            if k2.endswith("running_mean"):
                bb = k2[:-len("running_mean")]
                bn = {"g": sd.get(bb + "weight"), "b": sd.get(bb + "bias"),
                      "m": sd[bb + "running_mean"],
                      "v": sd[bb + "running_var"]}
                break
            if v2.ndim == 4:
                break
        convs.append((k, v, sd.get(k[:-len("weight")] + "bias"), bn))
    return convs


def _convert_one(sd, prefix, out):
    """Map one DeDoDe network's state dict into ``out`` under ``prefix``,
    inferring every width from the shapes; raises with a layer table on a
    structure that contradicts the module's."""
    convs = _walk_torch(sd)
    enc = [c for c in convs if c[1].shape[-1] == 3]      # 3x3 encoder convs
    ref = convs[len(enc):]
    table = lambda cs: [(k, tuple(v.shape)) for k, v, _, _ in cs]
    if [c[1].shape[-1] for c in ref].count(3):
        raise ValueError(f"{prefix}: non-leading 3x3 convs; layer table: "
                         f"{table(convs)}")
    # encoder stages split where the output width changes
    widths = [int(c[1].shape[0]) for c in enc]
    counts, stage_w = [], []
    for wd in widths:
        if stage_w and wd == stage_w[-1] and len(counts) <= len(stage_w):
            counts[-1] += 1
        elif len(stage_w) < 4 and (not stage_w or wd != stage_w[-1]):
            stage_w.append(wd)
            counts.append(1)
        else:
            counts[-1] += 1
    if len(counts) != 4:
        raise ValueError(f"{prefix}: expected 4 encoder stages, inferred "
                         f"{counts} from widths {widths}")
    # a pool between equal-width stages is invisible to the width split
    # (VGG19's conv4/conv5 are both 512 wide): hold real VGG19 widths to
    # their known depths
    if stage_w == [64, 128, 256, 512] and counts != [2, 2, 4, 4]:
        raise ValueError(
            f"{prefix}: VGG19-width encoder but stage depths {counts} != "
            f"[2, 2, 4, 4]; layer table: {table(enc)}")

    def put(name, v, b, bn, cin_actual=None):
        out[f"{name}_w"] = v.numpy().transpose(2, 3, 1, 0)   # OIHW -> HWIO
        out[f"{name}_b"] = (b.numpy() if b is not None
                            else np.zeros(v.shape[0], np.float32))
        if bn is not None:
            for s in ("g", "b", "m", "v"):
                out[f"{name}_bn_{s}"] = bn[s].numpy()
        if cin_actual is not None:
            out[f"{name}_g"] = np.asarray(cin_actual // v.shape[1])

    i = 0
    for stage, n in enumerate(counts):
        for j in range(n):
            put(f"{prefix}_enc{stage}_{j}", *enc[i][1:])
            i += 1

    # refiners: 4 scales x (hb+1 blocks of [5x5, 1x1]) + one 1x1 out head
    if len(ref) % 4 or (len(ref) // 4 - 1) % 2:
        raise ValueError(
            f"{prefix}: refiner conv count {len(ref)} does not factor as "
            f"4*(2*(hb+1)+1); layer table: {table(ref)}")
    per = len(ref) // 4
    nb = (per - 1) // 2
    # the stride-1 refiner's out is the whole head; coarser ones carry
    # [head | context]
    head = int(ref[-1][1].shape[0]) if prefix == "desc" else 1
    enc_w = {1: stage_w[0], 2: stage_w[1], 4: stage_w[2], 8: stage_w[3]}
    ctx = 0
    for si, scale in enumerate(_SCALES):
        p = f"{prefix}_ref{scale}"
        grp = ref[si * per:(si + 1) * per]
        width = enc_w[scale] + ctx
        for j in range(nb):
            (_, v1, b1, n1), (_, v2, b2, n2) = grp[2 * j], grp[2 * j + 1]
            if v1.shape[-1] != 5 or v2.shape[-1] != 1:
                raise ValueError(
                    f"{prefix} ref{scale} block{j}: expected [5x5, 1x1], "
                    f"got {tuple(v1.shape)}, {tuple(v2.shape)}")
            if width % int(v1.shape[1]):
                raise ValueError(
                    f"{prefix} ref{scale} block{j}: input width {width} not "
                    f"divisible by weight cin/groups {int(v1.shape[1])}")
            put(f"{p}_b{j}_c1", v1, b1, n1, cin_actual=width)
            put(f"{p}_b{j}_c2", v2, b2, n2)
            width = int(v2.shape[0])
        _, vo, bo, no = grp[-1]
        put(f"{p}_out", vo, bo, no)
        o = int(vo.shape[0])
        if o < head:
            raise ValueError(f"{prefix} ref{scale}: out width {o} cannot "
                             f"carry the {head}-wide head")
        ctx = o - head if scale > 1 else 0
    if prefix == "desc":
        out["desc_head_dim"] = np.asarray(head)


def convert_torch_checkpoint(detector_pth: str, descriptor_pth: str,
                             out_path: str = None) -> str:
    """One-time converter: public DeDoDe checkpoints (official
    ``dedode_detector_L.pth`` + ``dedode_descriptor_B.pth``, or kornia's
    hub exports) -> the one npz both packages read."""
    out = {}
    for prefix, path in (("det", detector_pth), ("desc", descriptor_pth)):
        sd = torch.load(path, map_location="cpu")
        for k in ("detector", "descriptor", "state_dict", "model"):
            if isinstance(sd, dict) and k in sd:
                sd = sd[k]
        _convert_one(sd, prefix, out)
    out_path = out_path or default_weights_path()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez(out_path, **out)
    return out_path
