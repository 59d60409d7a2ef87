"""Robust loss kernels as IRLS-style residual/Jacobian whitening.

Counterpart of ``instantsfm_tpu/solve/robust.py``: the whitened residual is
``sqrt(w) * r`` with ``w = rho'(s)`` at the squared block-residual norm
``s = ||r||^2``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple

import torch


class RobustKernel(NamedTuple):
    """weight maps squared block-residual norm -> IRLS weight w = rho'(s);
    loss maps squared norm -> rho(s).  ``kind`` is ``("huber", delta)`` for
    Huber's kernel, the one a closed-form build evaluates itself
    (``solve/ba_closed.py``); empty for any other."""
    weight: Callable
    loss: Callable
    kind: tuple = ()


@lru_cache(maxsize=None)
def trivial() -> RobustKernel:
    return RobustKernel(weight=torch.ones_like, loss=lambda s: s)


@lru_cache(maxsize=None)
def huber(delta: float) -> RobustKernel:
    """rho(s) = s if s <= delta^2 else 2 delta sqrt(s) - delta^2."""
    d2 = delta * delta

    def loss(s):
        return torch.where(s <= d2, s,
                           2.0 * delta * torch.sqrt(s.clamp_min(1e-30)) - d2)

    def weight(s):
        return torch.where(s <= d2, torch.ones_like(s),
                           delta / torch.sqrt(s.clamp_min(1e-30)))

    return RobustKernel(weight=weight, loss=loss, kind=("huber", delta))


@lru_cache(maxsize=None)
def cauchy(c: float) -> RobustKernel:
    """rho(s) = c^2 log(1 + s / c^2)."""
    c2 = c * c
    return RobustKernel(weight=lambda s: 1.0 / (1.0 + s / c2),
                        loss=lambda s: c2 * torch.log1p(s / c2))


def geman_mcclure(sigma: float) -> RobustKernel:
    """w = sigma^2 / (s + sigma^2)^2 (the rotation-averaging IRLS weight)."""
    s2 = sigma * sigma
    return RobustKernel(weight=lambda s: s2 / (s + s2) ** 2,
                        loss=lambda s: s2 * s / (s + s2))
