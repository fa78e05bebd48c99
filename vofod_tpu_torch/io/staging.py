"""Double-buffered host staging for the node's per-scan uploads.

The node copies each scan's host arrays (the raw ranges and intensity, or
the host binner's packed grid, active mask and counts) into one of two sets
of buffers, taken in turn, and uploads the set with one non-blocking copy
per buffer.  On a CUDA device the buffers are pinned once at start-up (no
``pin_memory()`` per scan) and each set is guarded by the CUDA event of its
last copy, so it is never overwritten while that copy is in flight; by the
time a set comes round again the scan that read it has long been read back,
so the guard does not block.  The grid-sharded prebinned step uploads a
set's packed grid slab by slab, one copy on each shard's stream
(parallel/grid_step.py): :meth:`HostStaging.guard` then takes the events of
all those copies.  On the CPU the buffers are plain and the
upload is a copy, so a step never holds a view of a buffer the next scan
overwrites.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class HostStaging:
    """Two sets of host buffers of the given (length, dtype) specs."""

    def __init__(self, specs: Sequence[tuple[int, torch.dtype]], device):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self.sets = [tuple(torch.empty(n, dtype=dt, pin_memory=pin) for n, dt in specs)
                     for _ in range(2)]
        self.events: list[list] = [[], []]
        self.turn = 0

    def next(self) -> tuple[int, tuple[np.ndarray, ...]]:
        """(set index, numpy views of its buffers) of the set to fill next."""
        i, self.turn = self.turn, 1 - self.turn
        for ev in self.events[i]:
            if not ev.query():
                ev.synchronize()
        return i, tuple(t.numpy() for t in self.sets[i])

    def guard(self, i: int, events) -> None:
        """Set ``i`` may be refilled once every one of ``events`` (CUDA
        events of the copies that read it) has completed."""
        self.events[i] = list(events)

    def upload(self, i: int, count: int | None = None) -> tuple[torch.Tensor, ...]:
        """The first ``count`` (default: all) buffers of set ``i`` on the
        device: one non-blocking copy each, then the set's event."""
        bufs = self.sets[i][:count]
        if self.device.type != "cuda":
            return tuple(t.clone() for t in bufs)
        out = tuple(t.to(self.device, non_blocking=True) for t in bufs)
        ev = torch.cuda.Event()
        ev.record()
        self.guard(i, [ev])
        return out
