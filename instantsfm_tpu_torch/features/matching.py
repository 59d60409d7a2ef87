"""Batched descriptor matching: mutual nearest neighbours with Lowe's ratio
test.

Counterpart of ``instantsfm_tpu/features/matching.py``.  The similarity of
a batch of pairs is one float32 ``torch.matmul`` [B, K, D] x [B, D, K] (JAX
leaves this product to XLA, outside any Pallas kernel), in full float32
whatever the caller set for TF32 (``utils.device.full_f32``); then the top
two similarities and both argmaxes of each row (``torch.argmax`` returns
the first maximum, as ``jnp.argmax``), the mutual and ratio tests, and
compaction of the good rows to the front by a stable sort.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.utils.device import full_f32, resolve_device


def match_pair_batch(desc1, desc2, valid1, valid2, ratio: float,
                     max_matches: int):
    """desc1/2 [B, K, D] float32 L2-normalized, valid1/2 [B, K] bool ->
    (matches [B, M, 2] int32, -1 past each pair's count, count [B]):
    mutual nearest neighbours that pass the ratio test."""
    with full_f32():
        sim = torch.matmul(desc1, desc2.transpose(1, 2))
    sim.masked_fill_(~(valid1[:, :, None] & valid2[:, None, :]), -torch.inf)
    # for unit vectors d^2 = 2 - 2 sim; the ratio test on d
    top2 = torch.topk(sim, 2, dim=2).values                 # [B, K, 2]
    nn12 = torch.argmax(sim, dim=2)                         # [B, K]
    nn21 = torch.argmax(sim, dim=1)                         # [B, L]
    d1 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * top2[..., 0], 0.0))
    d2 = torch.sqrt(torch.clamp_min(2.0 - 2.0 * top2[..., 1], 0.0))
    pass_ratio = d1 < ratio * d2
    K = desc1.shape[1]
    mutual = torch.gather(nn21, 1, nn12) == torch.arange(
        K, device=desc1.device)[None, :]
    good = pass_ratio & mutual & valid1 & torch.isfinite(top2[..., 0])

    # compact to a fixed M per pair, good rows first
    order = torch.sort((~good).to(torch.uint8), dim=1, stable=True).indices
    idx1 = order[:, :max_matches]
    ok = torch.gather(good, 1, idx1)
    idx2 = torch.gather(nn12, 1, idx1)
    matches = torch.stack([idx1, idx2], dim=-1).to(torch.int32)
    count = torch.clamp_max(good.sum(dim=1), max_matches)
    return torch.where(ok[..., None], matches, -1), count


def match_all_pairs(descriptors, valids, ratio=0.8, max_matches=2048,
                    pair_batch=16, pairs=None, device="cuda"):
    """descriptors: list of [K, D] arrays (equal K), valids: list of [K]
    bool.  Returns {(i, j): matches [m, 2] int32 numpy} for i < j
    (exhaustive unless ``pairs`` is given), matched ``pair_batch`` pairs at
    a time on ``device``."""
    dev = resolve_device(device)
    n = len(descriptors)
    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    desc = torch.as_tensor(np.stack(descriptors).astype(np.float32),
                           device=dev)
    valid = torch.as_tensor(np.stack(valids).astype(bool), device=dev)
    out = {}
    for lo in range(0, len(pairs), pair_batch):
        chunk = pairs[lo:lo + pair_batch]
        pad = pair_batch - len(chunk)
        i_idx = torch.as_tensor([p[0] for p in chunk] + [0] * pad, device=dev)
        j_idx = torch.as_tensor([p[1] for p in chunk] + [0] * pad, device=dev)
        m, cnt = match_pair_batch(desc[i_idx], desc[j_idx], valid[i_idx],
                                  valid[j_idx], ratio, max_matches)
        m, cnt = m.cpu().numpy(), cnt.cpu().numpy()
        for k, (i, j) in enumerate(chunk):
            out[(i, j)] = m[k, :cnt[k]]
    return out
