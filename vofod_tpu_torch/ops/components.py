"""Euclidean-tolerance connected components and reachability (K2), and
the per-component census of the exact sepclusters mode (K13a).

PyTorch counterpart of vofod_tpu/ops/components.py ``propagate_reach``,
``label_components_seeded`` and ``label_components`` (ref
vofod_nodelet.cpp:689-751: PCL Euclidean cluster extraction + the close/far
split) and of vofod_tpu/parallel/gridops.py ``DenseOps.label_census``.  Two
occupied voxels are adjacent iff the Euclidean distance of their indices is
<= ``radius``.

All run Jacobi sweeps with no host sync.  Each sweep is one launch of the
fused CUDA kernel (csrc/propagate.cu) for CUDA tensors, or the plain
version (K1's pool + mask) for CPU tensors, and records a per-sweep changed
flag on the device:

* ``propagate_reach``: the JAX while_loop stops at the first sweep that
  changes nothing or at the cap; growth is monotone, so sweeps past the
  fixpoint are no-ops and ``converged = ~changed[last]`` equals the JAX flag.
* ``label_components_seeded``: the JAX fori_loop already runs ``max_iters``
  sweeps; ``iters`` (the last sweep that changed anything) stays on the
  device.
* ``label_components``: the JAX while_loop runs to the first sweep that
  changes nothing or to the cap.  The cap's worth of sweeps is enqueued and
  each launch past the fixpoint exits at once on the previous sweep's
  device flag (``sweeps(..., until_fixpoint=True)``).

``traced_r2`` (cfg.dynamic_radii): the adjacency is the ball of the
runtime squared radius within the static bound ``radius``, the K14 tap set
ops/morphology.Shells, on the same sweep kernel.

On the grid-sharded step (parallel/gridops.py ZShardOps) the grids are a
shard's z slab: ``sweep_fn`` is then the sharded sweep (a halo exchange
per sweep, K2 on the extended slab with its change flag over the interior
rows, the flags OR-ed over the shards), and the seeded labels take the
slab's first global row ``z0`` and the grid's ``nz``.
"""

from __future__ import annotations

import torch

from vofod_tpu_torch import kernels
from vofod_tpu_torch.ops.morphology import Shells, pool_plain, tap_set

Tensor = torch.Tensor

# sentinel label for non-occupied voxels (any value > all flat ids)
SENTINEL = 2**31 - 1


def sweep_plain(cur: Tensor, occ: Tensor, ball,
                flag_rows: tuple[int, int] | None = None) -> tuple[Tensor, Tensor]:
    """Plain version of one K2 sweep (K1's plain pool over ``ball``: a
    radius, traced shells or a tap set; + the mask), on any device: (new
    grid, bool scalar: a voxel of the z rows ``flag_rows`` (default all)
    changed)."""
    if cur.dtype == torch.int32:
        new = torch.where(occ, pool_plain(cur, ball, "min", SENTINEL), SENTINEL)
    else:
        pooled = pool_plain(cur.view(torch.int8), ball, "max", 0)
        new = cur | (occ & (pooled > 0)).to(torch.uint8)
    rows = slice(None) if flag_rows is None else slice(*flag_rows)
    return new, torch.any(new[rows] != cur[rows])


def sweeps_plain(init: Tensor, occ: Tensor, ball, n: int,
                 until_fixpoint: bool = False) -> tuple[Tensor, Tensor]:
    """Plain version of ``n`` K2 sweeps (:func:`sweep_plain`), on any
    device: (final grid, bool [n] per-sweep changed flags).  With
    ``until_fixpoint`` the sweeps after the first one that changed nothing
    are skipped (their flags False), as the gated kernel launches do."""
    cur, flags = init, []
    for _ in range(n):
        if until_fixpoint and flags and not bool(flags[-1]):
            flags.append(flags[-1])
            continue
        cur, changed = sweep_plain(cur, occ, ball)
        flags.append(changed)
    return cur, torch.stack(flags)


def sweeps(init: Tensor, occ: Tensor, ball, n: int,
           until_fixpoint: bool = False) -> tuple[Tensor, Tensor]:
    """``n`` Jacobi sweeps from ``init`` over ``ball`` (a radius, traced
    shells or a tap set): int32 keys take the masked
    min-label sweep, uint8 masks the reach sweep.  Returns (final grid,
    bool [n] per-sweep changed flags), both on the device of ``init``.
    ``until_fixpoint``: stop after the first sweep that changes nothing (on
    the card, every later launch reads that sweep's flag and exits)."""
    if init.is_cuda:
        taps, halo = tap_set(ball)
        occ8 = occ.contiguous().view(torch.uint8)
        changed = torch.zeros(n, dtype=torch.int32, device=init.device)
        # ping-pong between two fresh buffers: the caller's ``init`` is read
        # once.  Gated, the second starts as ``init``: when sweep 0 is already
        # the fixpoint no later launch writes it, and it may be the one returned
        src = init.contiguous()
        bufs = (torch.empty_like(src), src.clone() if until_fixpoint else torch.empty_like(src))
        for i in range(n):
            dst = bufs[i % 2]
            prev = changed[i - 1] if until_fixpoint and i > 0 else None
            kernels.propagate_sweep(src, dst, occ8, taps, halo, changed[i], prev)
            src = dst
        return src, changed.bool()
    if init.device.type != "cpu":
        raise ValueError(f"propagation: unsupported device {init.device}")
    return sweeps_plain(init, occ, ball, n, until_fixpoint)


def _ball(radius: float, traced_r2):
    return radius if traced_r2 is None else Shells(radius, traced_r2)


def propagate_reach(
    occupied: Tensor, seed: Tensor, radius: float, max_iters: int, traced_r2=None, *,
    sweep_fn=sweeps,
) -> tuple[Tensor, Tensor]:
    """Grow ``seed & occupied`` through ``occupied`` under ball adjacency.

    Returns (reached bool grid, converged bool scalar): ``converged`` is
    False iff the last of the ``max_iters`` sweeps still changed something.
    ``traced_r2``: the runtime squared radius, ``radius`` then the bound.
    ``sweep_fn``: :func:`sweeps`, or the grid-sharded step's.
    """
    occ = occupied.to(torch.bool)
    cur = (occ & seed.to(torch.bool)).to(torch.uint8)
    cur, changed = sweep_fn(cur, occ, _ball(radius, traced_r2), max_iters)
    return cur.bool(), ~changed[-1]


def label_components_seeded(
    occupied: Tensor, seed: Tensor, radius: float, max_iters: int, traced_r2=None, *,
    sweep_fn=sweeps, z0: int = 0, nz: int | None = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One propagation computing components AND seed-reachability together
    (``key0 = reversed flat id + (1 - seed) * NV``; see the JAX docstring).

    Returns (labels, seed_reached, converged, iters): labels = SENTINEL
    off-mask; ``iters`` is the sweep index after which the labels stopped
    changing (``max_iters`` when the last sweep still changed them).
    ``traced_r2``: the runtime squared radius, ``radius`` then the bound.
    ``sweep_fn``, ``z0``, ``nz``: the grid-sharded step's sweep, the slab's
    first global row and the grid's rows (the flat ids stay global).
    """
    occ = occupied.to(torch.bool)
    nzl, ny, nx = occ.shape
    nv = (nzl if nz is None else nz) * ny * nx
    # REVERSED flat ids: cluster slots fill in ascending label order, so the
    # highest-altitude components win the low labels (components.py:110-118)
    f0 = z0 * ny * nx
    flat = torch.arange(f0, f0 + occ.numel(), dtype=torch.int32,
                        device=occ.device).reshape(occ.shape)
    rid = (nv - 1) - flat
    key0 = rid + torch.where(seed & occ, 0, nv).to(torch.int32)
    keys = torch.where(occ, key0, SENTINEL)
    keys, changed = sweep_fn(keys, occ, _ball(radius, traced_r2), max_iters)
    sweep_no = torch.arange(1, max_iters + 1, dtype=torch.int32, device=occ.device)
    iters = (changed.to(torch.int32) * sweep_no).max()
    converged = iters < max_iters
    reached = occ & (keys < nv)
    labels = torch.where(occ, torch.where(keys < nv, keys, keys - nv), SENTINEL)
    return labels, reached, converged, iters


def _label_components(occupied: Tensor, radius: float, max_iters: int,
                      sweep_fn) -> tuple[Tensor, Tensor, Tensor]:
    occ = occupied.to(torch.bool)
    nv = occ.numel()
    flat = torch.arange(nv, dtype=torch.int32, device=occ.device).reshape(occ.shape)
    labels = torch.where(occ, flat, SENTINEL)
    labels, changed = sweep_fn(labels, occ, radius, max_iters, until_fixpoint=True)
    n_run = torch.clamp(changed.sum(dtype=torch.int32) + 1, max=max_iters)
    return labels, ~changed[-1], n_run


def label_components(
    occupied: Tensor, radius: float, max_iters: int
) -> tuple[Tensor, Tensor, Tensor]:
    """Label the components of ``occupied`` with their least member flat id,
    sweeping to the fixpoint or to ``max_iters`` sweeps.

    Returns (labels int32 grid with SENTINEL on empty voxels, converged
    bool, sweeps int32: the sweeps the JAX while_loop runs).  The flags are
    a run of True then False, so the last flag is the while_loop's and the
    loop ran one sweep past the changing ones (or hit the cap)."""
    return _label_components(occupied, radius, max_iters, sweeps)


def label_components_plain(
    occupied: Tensor, radius: float, max_iters: int
) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`label_components` with K2's plain sweeps, on any device."""
    return _label_components(occupied, radius, max_iters, sweeps_plain)


def label_census_plain(labels: Tensor, vals: Tensor, occ: Tensor, ncv: int,
                       min_sure: float) -> tuple[Tensor, Tensor]:
    """Plain version of K13a: the JAX census (int32 scatter-add of ``vals``
    where ``occ`` into bucket ``label``, ids >= ncv dropped, read back at
    ``min(label, ncv - 1)``), 0 off ``occ``; and the flags (any occ, any occ
    with census >= min_sure)."""
    flat_l = labels.reshape(-1).to(torch.int64)
    v = torch.where(occ, vals, 0).reshape(-1)
    keep = flat_l < ncv
    census = torch.zeros(ncv, dtype=torch.int32, device=labels.device)
    census.index_add_(0, flat_l[keep], v[keep])
    cell = census[torch.clamp(flat_l, max=ncv - 1)].reshape(labels.shape)
    cell = torch.where(occ, cell, 0)
    sure = occ & (cell.to(torch.float32) >= min_sure)
    return cell, torch.stack([torch.any(occ), torch.any(sure)])


def label_census(labels: Tensor, vals: Tensor, occ: Tensor, ncv: int,
                 min_sure: float) -> tuple[Tensor, Tensor]:
    """K13a: (per-cell census int32, flags bool [2] = (any occ, any sure
    cell)); see :func:`label_census_plain`."""
    if labels.is_cuda:
        return kernels.label_census(labels.contiguous(), vals.contiguous(), occ.contiguous(),
                                    ncv, min_sure)
    if labels.device.type != "cpu":
        raise ValueError(f"label census: unsupported device {labels.device}")
    return label_census_plain(labels, vals, occ, ncv, min_sure)
