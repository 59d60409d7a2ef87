"""Matrix-free preconditioned conjugate gradient on torch tensors.

Counterpart of ``instantsfm_tpu/solve/pcg.py``, whose loop is a
``lax.while_loop`` on the device.  Both solvers here share one CG
iteration (``_cg_step``) and stop on ``||r||^2 > tol^2 ||b||^2`` or after
``max_iters`` iterations:

* ``pcg`` is a Python loop that reads the stop test on the host before
  every iteration (the read ``pcg.exit``, one device synchronisation
  each); each iteration's launches are the span ``pcg.iter``.  It runs on
  the CPU and under a process group, whose matvec all-reduces.
* ``graph_pcg`` runs a solve on one CUDA device as captured CUDA graphs
  of ``BLOCK`` predicated iterations (``pcg_iteration``): the test is a
  device flag, an iteration whose test fails leaves the state bit for bit
  as it was, and the host reads the flag once a replay (``pcg.exit``)
  until the solve has ended (``run_blocks``).  A solve is the span
  ``pcg.graph``, a capture ``pcg.capture`` and each replay's launch
  ``pcg.replay``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch

from instantsfm_tpu_torch.utils import debug

# predicated iterations a replay: fewer reads against more no-op
# iterations.  2, 4 and 8 ran within 1.2% of each other in the benchmark's
# BA cell on an H100 (PERF.md); 4 reads half as often as 2 and runs fewer
# than half the no-op iterations of 8
BLOCK = 4


def _dot(a, b):
    return torch.sum(a * b)


def _cg_step(matvec, precond, x, r, p, gamma):
    """One CG iteration from (x, r, p, gamma = r·M r): the new (x, r, p,
    gamma).  A zero ``p·A p`` gives a zero step and a zero ``gamma`` a zero
    ``beta``."""
    ap = matvec(p)
    denom = _dot(p, ap)
    alpha = torch.where(denom == 0, 0.0, gamma / denom)
    x = alpha * p + x
    r = -alpha * ap + r
    z = precond(r)
    gamma_new = _dot(r, z)
    beta = torch.where(gamma == 0, 0.0, gamma_new / gamma)
    p = beta * p + z
    return x, r, p, gamma_new


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
    while k < max_iters and debug.read("pcg.exit", _dot(r, r) > threshold):
        with debug.span("pcg.iter"):
            x, r, p, gamma = _cg_step(matvec, precond, x, r, p, gamma)
            k += 1
    return x, torch.sqrt(_dot(r, r).clamp_min(0.0)), k


class PCGState(NamedTuple):
    """A blocked solve's state, updated in place.  ``status`` (int64 [2])
    is what the host reads: the iterations run (``k`` is its first entry)
    and, at the end of a block, whether the next iteration runs
    (``active``)."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    gamma: torch.Tensor
    threshold: torch.Tensor
    k: torch.Tensor
    active: torch.Tensor
    status: torch.Tensor


def pcg_state(b) -> PCGState:
    status = torch.zeros(2, dtype=torch.int64, device=b.device)
    return PCGState(torch.zeros_like(b), torch.zeros_like(b),
                    torch.zeros_like(b), b.new_zeros(()), b.new_zeros(()),
                    status[0], torch.zeros((), dtype=torch.bool,
                                           device=b.device), status)


def _test(st: PCGState, max_iters: int) -> None:
    torch.logical_and(st.k < max_iters, _dot(st.r, st.r) > st.threshold,
                      out=st.active)


def pcg_start(matvec, precond, b, st: PCGState, max_iters: int,
              tol: float) -> None:
    """The solve's set-up from x = 0, in place, as ``pcg``'s: the
    threshold, r = b - A x, p = M r, gamma = r·p, k = 0 and the first
    test."""
    st.x.zero_()
    st.threshold.copy_((tol * tol) * _dot(b, b))
    torch.sub(b, matvec(st.x), out=st.r)
    z = precond(st.r)
    st.gamma.copy_(_dot(st.r, z))
    st.p.copy_(z)
    st.k.zero_()
    _test(st, max_iters)


def pcg_iteration(matvec, precond, st: PCGState, max_iters: int) -> None:
    """One predicated iteration, in place: where ``active``, ``pcg``'s
    iteration and k + 1; elsewhere x, r, p, gamma and k keep their bits.
    Then the test of the next iteration."""
    new = _cg_step(matvec, precond, st.x, st.r, st.p, st.gamma)
    for v, old in zip(new, (st.x, st.r, st.p, st.gamma)):
        torch.where(st.active, v, old, out=old)
    st.k.add_(st.active)
    _test(st, max_iters)


def pcg_block(matvec, precond, st: PCGState, max_iters: int,
              n: int) -> None:
    """``n`` predicated iterations, then ``active`` into ``status``."""
    for _ in range(n):
        pcg_iteration(matvec, precond, st, max_iters)
    st.status[1].copy_(st.active)


def run_blocks(first: Callable, block: Callable, status) -> int:
    """The host's side of a blocked solve: ``first()`` (the set-up and a
    block), then ``block()`` while the solve runs on, each followed by one
    read of ``status``.  Returns the iterations run."""
    step = first
    while True:
        step()
        k, active = debug.read("pcg.exit", status)
        if not active:
            return int(k)
        step = block


def _capture(fn, recorded, stream, pool=None):
    """(graph, replayed): ``fn``'s launches on ``stream`` recorded into a
    CUDA graph, and the operator's account of what a replay runs again
    (``recorded``, see ``GraphPCG``).  Unlike ``torch.cuda.graph`` this
    neither synchronises the device nor empties the allocator's caches:
    a capture runs nothing."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), recorded() as replayed:
        graph.capture_begin(*(() if pool is None else (pool,)))
        try:
            fn()
        finally:
            graph.capture_end()
    return graph, replayed


class GraphPCG:
    """One shape's captured solve on the current CUDA device: static copies
    of the operands and of b, the state, and two graphs sharing one memory
    pool: the set-up with the first block, and a block.
    ``make_ops(layout, *operands)`` gives (matvec, precond, recorded): the
    operator on the copies, and a context manager around each capture that
    yields the function a replay of that graph calls after it runs (the
    operator's own count of its kernels' executions)."""

    def __init__(self, make_ops, layout, operands, b, max_iters, tol):
        self.inputs = tuple(t.clone() for t in operands)
        self.b = b.clone()
        self.state = st = pcg_state(b)
        matvec, precond, recorded = make_ops(layout, *self.inputs)
        block = partial(pcg_block, matvec, precond, st, max_iters, BLOCK)
        start = partial(pcg_start, matvec, precond, self.b, st, max_iters,
                        tol)

        def first():
            start()
            block()

        # warm-up on the capture's side stream: lazy set-up (K1's build and
        # shared memory opt-in, the allocator's blocks) stays out of it
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            start()
            pcg_iteration(matvec, precond, st, max_iters)
        self.first = _capture(first, recorded, side)
        self.block = _capture(block, recorded, side,
                              pool=self.first[0].pool())
        torch.cuda.current_stream().wait_stream(side)

    @staticmethod
    def _replay(graph, replayed):
        with debug.span("pcg.replay"):
            graph.replay()
        replayed()

    def solve(self, operands, b):
        """(x, iters) of the solve of ``b`` with ``operands``."""
        for dst, src in zip(self.inputs, operands):
            dst.copy_(src)
        self.b.copy_(b)
        iters = run_blocks(partial(self._replay, *self.first),
                           partial(self._replay, *self.block),
                           self.state.status)
        return self.state.x.clone(), iters


# the last shape's captured solve: an ``optimize`` call solves one shape
# throughout, and another shape frees these graphs and copies first
_GRAPHS: dict = {}


def graph_pcg(make_ops, layout, operands, b, max_iters: int = 100,
              tol: float = 1e-5):
    """Solve ``A x = b`` on one CUDA device from x = 0 as ``pcg`` does,
    with (matvec, precond, recorded) = ``make_ops(layout, *operands)`` (see
    ``GraphPCG``): a solve of the shape (``layout``, the operands' and b's
    dtypes and shapes, ``max_iters``, ``tol``) of the last solve copies its
    operands in and replays its graphs; another shape captures anew.
    Returns (x, iters)."""
    with debug.span("pcg.graph"), torch.cuda.device(b.device):
        key = (make_ops, layout, max_iters, tol, b.device,
               tuple((t.dtype, tuple(t.shape)) for t in (b, *operands)))
        entry = _GRAPHS.get(key)
        if entry is None:
            _GRAPHS.clear()
            with debug.span("pcg.capture"):
                entry = GraphPCG(make_ops, layout, operands, b, max_iters,
                                 tol)
            _GRAPHS[key] = entry
        return entry.solve(operands, b)
