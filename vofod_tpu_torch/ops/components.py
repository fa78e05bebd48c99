"""Euclidean-tolerance connected components and reachability (K2).

PyTorch counterpart of vofod_tpu/ops/components.py ``propagate_reach`` and
``label_components_seeded`` (ref vofod_nodelet.cpp:689-751: PCL Euclidean
cluster extraction + the close/far split).  Two occupied voxels are adjacent
iff the Euclidean distance of their indices is <= ``radius``.

Both run a FIXED number of Jacobi sweeps with no host sync.  Each sweep is
one launch of the fused CUDA kernel (csrc/propagate.cu) for CUDA tensors,
or the plain version (K1's pool + mask) for CPU tensors, and records a
per-sweep changed flag on the device:

* ``propagate_reach``: the JAX while_loop stops at the first sweep that
  changes nothing or at the cap; growth is monotone, so sweeps past the
  fixpoint are no-ops and ``converged = ~changed[last]`` equals the JAX flag.
* ``label_components_seeded``: the JAX fori_loop already runs ``max_iters``
  sweeps; ``iters`` (the last sweep that changed anything) stays on the
  device.
"""

from __future__ import annotations

import math

import torch

from vofod_tpu_torch import kernels
from vofod_tpu_torch.ops.morphology import ball_pool_plain, ball_taps

Tensor = torch.Tensor

# sentinel label for non-occupied voxels (any value > all flat ids)
SENTINEL = 2**31 - 1


def sweeps_plain(init: Tensor, occ: Tensor, radius: float, n: int) -> tuple[Tensor, Tensor]:
    """Plain version of ``n`` K2 sweeps (K1's plain pool + the mask), on any
    device: (final grid, bool [n] per-sweep changed flags)."""
    cur, flags = init, []
    for _ in range(n):
        if cur.dtype == torch.int32:
            new = torch.where(occ, ball_pool_plain(cur, radius, "min", SENTINEL), SENTINEL)
        else:
            pooled = ball_pool_plain(cur.view(torch.int8), radius, "max", 0)
            new = cur | (occ & (pooled > 0)).to(torch.uint8)
        flags.append(torch.any(new != cur))
        cur = new
    return cur, torch.stack(flags)


def sweeps(init: Tensor, occ: Tensor, radius: float, n: int) -> tuple[Tensor, Tensor]:
    """``n`` Jacobi sweeps from ``init``: int32 keys take the masked
    min-label sweep, uint8 masks the reach sweep.  Returns (final grid,
    bool [n] per-sweep changed flags), both on the device of ``init``."""
    if init.is_cuda:
        taps, halo = ball_taps(radius), int(math.floor(radius))
        occ8 = occ.contiguous().view(torch.uint8)
        changed = torch.zeros(n, dtype=torch.int32, device=init.device)
        # ping-pong between two fresh buffers: the caller's ``init`` is read once
        src, bufs = init.contiguous(), (torch.empty_like(init), torch.empty_like(init))
        for i in range(n):
            dst = bufs[i % 2]
            kernels.propagate_sweep(src, dst, occ8, taps, halo, changed[i])
            src = dst
        return src, changed.bool()
    if init.device.type != "cpu":
        raise ValueError(f"propagation: unsupported device {init.device}")
    return sweeps_plain(init, occ, radius, n)


def propagate_reach(
    occupied: Tensor, seed: Tensor, radius: float, max_iters: int
) -> tuple[Tensor, Tensor]:
    """Grow ``seed & occupied`` through ``occupied`` under ball adjacency.

    Returns (reached bool grid, converged bool scalar): ``converged`` is
    False iff the last of the ``max_iters`` sweeps still changed something.
    """
    occ = occupied.to(torch.bool)
    cur = (occ & seed.to(torch.bool)).to(torch.uint8)
    cur, changed = sweeps(cur, occ, radius, max_iters)
    return cur.bool(), ~changed[-1]


def label_components_seeded(
    occupied: Tensor, seed: Tensor, radius: float, max_iters: int
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One propagation computing components AND seed-reachability together
    (``key0 = reversed flat id + (1 - seed) * NV``; see the JAX docstring).

    Returns (labels, seed_reached, converged, iters): labels = SENTINEL
    off-mask; ``iters`` is the sweep index after which the labels stopped
    changing (``max_iters`` when the last sweep still changed them).
    """
    occ = occupied.to(torch.bool)
    nz, ny, nx = occ.shape
    nv = nz * ny * nx
    # REVERSED flat ids: cluster slots fill in ascending label order, so the
    # highest-altitude components win the low labels (components.py:110-118)
    flat = torch.arange(nv, dtype=torch.int32, device=occ.device).reshape(occ.shape)
    rid = (nv - 1) - flat
    key0 = rid + torch.where(seed & occ, 0, nv).to(torch.int32)
    keys = torch.where(occ, key0, SENTINEL)
    keys, changed = sweeps(keys, occ, radius, max_iters)
    sweep_no = torch.arange(1, max_iters + 1, dtype=torch.int32, device=occ.device)
    iters = (changed.to(torch.int32) * sweep_no).max()
    converged = iters < max_iters
    reached = occ & (keys < nv)
    labels = torch.where(occ, torch.where(keys < nv, keys, keys - nv), SENTINEL)
    return labels, reached, converged, iters
