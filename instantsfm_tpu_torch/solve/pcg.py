"""Matrix-free preconditioned conjugate gradient on torch tensors.

Counterpart of ``instantsfm_tpu/solve/pcg.py``.  The JAX loop is a
``lax.while_loop``; here it is a Python loop whose stop test
``||r||^2 > tol^2 ||b||^2`` is read on the host once per iteration (one
device synchronisation each).
"""

from __future__ import annotations

from typing import Callable

import torch


def _dot(a, b):
    return torch.sum(a * b)


def pcg(matvec: Callable, b, precond: Callable = None, x0=None,
        max_iters: int = 100, tol: float = 1e-5):
    """Solve ``A x = b`` with CG; returns (x, final residual norm, iters).

    ``tol`` is relative to ||b||; ``iters`` is a Python int."""
    if precond is None:
        precond = lambda v: v
    x = torch.zeros_like(b) if x0 is None else x0

    threshold = (tol * tol) * _dot(b, b)
    r = b - matvec(x)
    z = precond(r)
    gamma = _dot(r, z)
    p = z
    k = 0
    while k < max_iters and bool(_dot(r, r) > threshold):
        ap = matvec(p)
        denom = _dot(p, ap)
        alpha = torch.where(denom == 0, torch.zeros_like(denom),
                            gamma / torch.where(denom == 0,
                                                torch.ones_like(denom), denom))
        x = alpha * p + x
        r = -alpha * ap + r
        z = precond(r)
        gamma_new = _dot(r, z)
        beta = torch.where(gamma == 0, torch.zeros_like(gamma),
                           gamma_new / torch.where(gamma == 0,
                                                   torch.ones_like(gamma),
                                                   gamma))
        p = beta * p + z
        gamma = gamma_new
        k += 1
    return x, torch.sqrt(_dot(r, r).clamp_min(0.0)), k
