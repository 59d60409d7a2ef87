"""Data-dependent loops with few host reads.

A ``lax.while_loop`` on the device tests its exit condition on the device;
a torch loop that reads the condition back on every iteration waits for the
device each time.  ``while_blocked`` runs the body in fixed blocks of
``block`` iterations and reads the condition once a block: inside a block
every iteration first tests the condition on the device and, once it has
fired, ``torch.where`` keeps the state as it was.  Frozen iterations change
nothing, so the result equals the plain while-loop's exactly; they only cost
their (discarded) arithmetic.
"""

from __future__ import annotations

import torch

from instantsfm_tpu_torch.utils import debug


def _where(active, new, old):
    return tuple(torch.where(active, n, o) for n, o in zip(new, old))


class SyncCounter:
    """Host reads of loop conditions, per loop name; each is a
    ``debug.read`` at the site ``<prefix>.<name>``."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.counts = {}

    def read(self, name: str, flag: torch.Tensor) -> bool:
        self.counts[name] = self.counts.get(name, 0) + 1
        return bool(debug.read(f"{self.prefix}.{name}", flag))

    @property
    def total(self) -> int:
        return sum(self.counts.values())


def while_blocked(cond, body, state: tuple, block: int,
                  syncs: SyncCounter = None, name: str = "loop",
                  check_first: bool = False) -> tuple:
    """``while cond(state): state = body(state)`` on tensors, with one host
    read of ``cond`` per block of ``block`` iterations (and one before the
    first block with ``check_first``, for loops that usually do not run).
    ``cond`` returns a 0-dim bool tensor; ``state`` is a tuple of tensors."""
    syncs = syncs if syncs is not None else SyncCounter("loop")
    if check_first and not syncs.read(name, cond(state)):
        return state
    while True:
        for _ in range(block):
            state = _where(cond(state), body(state), state)
        if not syncs.read(name, cond(state)):
            return state
