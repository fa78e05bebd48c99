"""Euclidean-tolerance connected components and reachability (K2), and
the per-component census of the exact sepclusters mode (K13a).

PyTorch counterpart of vofod_tpu/ops/components.py ``propagate_reach``,
``label_components_seeded`` and ``label_components`` (ref
vofod_nodelet.cpp:689-751: PCL Euclidean cluster extraction + the close/far
split) and of vofod_tpu/parallel/gridops.py ``DenseOps.label_census``.  Two
occupied voxels are adjacent iff the Euclidean distance of their indices is
<= ``radius``.

All run Jacobi sweeps with no host sync.  On CUDA tensors every sweep of
one call runs in ONE persistent launch of the fused kernel
(csrc/propagate.cu ``vofod_propagate_sweeps``): a grid-wide barrier between
sweeps, the blocks leaving after the first sweep that changed nothing, and
each sweep after the first recomputing only the 32 x 8 x 4 tiles within
the ball's reach of a tile that changed in the sweep before
(:func:`sweeps_tiled_plain` is the plain model of that schedule).  CPU
tensors take the plain version (K1's pool + mask).  Each records a
per-sweep changed flag on the device:

* ``propagate_reach``: the JAX while_loop stops at the first sweep that
  changes nothing or at the cap; growth is monotone, so sweeps past the
  fixpoint are no-ops and ``converged = ~changed[last]`` equals the JAX flag.
* ``label_components_seeded``: the JAX fori_loop already runs ``max_iters``
  sweeps; ``iters`` (the last sweep that changed anything) stays on the
  device.  Sweeps past a fixpoint change nothing, so stopping there
  leaves the labels and flags of the fixed count.
* ``label_components``: the JAX while_loop runs to the first sweep that
  changes nothing or to the cap (``sweeps(..., until_fixpoint=True)``).

``traced_r2`` (cfg.dynamic_radii): the adjacency is the ball of the
runtime squared radius within the static bound ``radius``, the K14 tap set
ops/morphology.Shells, on the same sweep kernel.

On the grid-sharded step (parallel/gridops.py ZShardOps) the grids are a
shard's z slab: ``sweep_fn`` is then the sharded sweeps (parallel/gridops.py
``sharded_sweeps``: K2 launches of several sweeps each on a slab with a halo
as deep as their reach, filled in place once a launch, the flags over the
interior rows and reduced over the shards), and both labellings take the
slab's first global row ``z0`` (the seeded one also the grid's ``nz``).
The census splits into its scatter and read-back passes there (K15b-6a,
:func:`census_scatter_plain`, :func:`census_read_plain`), with a psum of
the census between them.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from vofod_tpu_torch import kernels
from vofod_tpu_torch.ops.morphology import (
    _COMBINE, Shells, is_wide, pool_plain, tap_set, wide_row_pools)

Tensor = torch.Tensor

# sentinel label for non-occupied voxels (any value > all flat ids)
SENTINEL = 2**31 - 1


def sweep_plain(cur: Tensor, occ: Tensor, ball) -> tuple[Tensor, Tensor]:
    """Plain version of one K2 sweep (K1's plain pool over ``ball``: a
    radius, traced shells or a tap set; + the mask), on any device: (new
    grid, bool scalar: a voxel changed)."""
    if cur.dtype == torch.int32:
        new = torch.where(occ, pool_plain(cur, ball, "min", SENTINEL), SENTINEL)
    else:
        pooled = pool_plain(cur.view(torch.int8), ball, "max", 0)
        new = cur | (occ & (pooled > 0)).to(torch.uint8)
    return new, torch.any(new != cur)


def _check_wide(table) -> None:
    """The bounds csrc/ball_pool.cuh ``parse_wide`` holds a wide table to
    before a launch: every pair and slice row within the halo, the
    symmetric pairs first, a row's pair within its group, the chain's
    widths continuing the group before."""
    h, group = table.halo, table.group
    if not ((table.runs >= -h) & (table.runs <= h)).all() or (
            table.runs[:, 0] > table.runs[:, 1]).any():
        raise ValueError("a wide table's run reaches past its halo")
    sym = table.runs[:, 0] == -table.runs[:, 1]
    if sym[int(sym.sum()):].any():
        raise ValueError("a wide table's symmetric pairs do not come first")
    n_in = [min(group, len(table.runs) - g * group) for g in range(table.n_groups)]
    last = -1
    for g, (c0, c1, _) in enumerate(table.chain.tolist()):
        if c1 >= 0 and c0 != last + 1:
            raise ValueError("a wide table's chain skips widths")
        last = max(last, c1)
        for q in set(table.zslice[g].tolist()) - {-1}:
            dy, i = table.rows[table.slices[q, 0]:table.slices[q, 1]].T
            if (np.abs(dy) > h).any() or (i >= n_in[g]).any():
                raise ValueError(f"a wide table's slice {q} reads past its halo or group")


def runs_pool_plain(a: Tensor, table, op: str, fill: int) -> Tensor:
    """Plain model of the wide K2's pool (csrc/propagate.cu
    ``sweep_tile_wide``), on any device: out[v] = ``op`` over the table's
    groups and dz slices (ops/morphology.WideRunTable), each slice's rows
    (dy, pair) read from the pair's x pool over ``a`` padded by ``fill``:
    the group's widths of the chain from the value the group before it
    left, any other pair element by element.  Raises for a table the
    kernel's host check refuses."""
    _check_wide(table)
    combine = _COMBINE[op]
    nz, ny, nx = a.shape
    h, zh = table.halo, table.zhalo
    pad = F.pad(a, (h, h, h, h, zh, zh), value=fill)

    def e(k: int) -> Tensor:
        return pad[:, :, h + k: h + k + nx]

    out, carry = None, None
    for g in range(table.n_groups):
        pools, carry = wide_row_pools(table, g, e, carry, combine)
        for dz in range(-zh, zh + 1):
            q = int(table.zslice[g, zh + dz])
            if q < 0:
                continue
            for dy, i in table.rows[table.slices[q, 0]:table.slices[q, 1]].tolist():
                s = pools[i][zh + dz: zh + dz + nz, h + dy: h + dy + ny]
                out = s if out is None else combine(out, s)
    return out.contiguous()


def sweep_model(cur: Tensor, occ: Tensor, ball) -> tuple[Tensor, Tensor]:
    """One K2 sweep as the kernel pools it: :func:`sweep_plain` in the
    narrow form, the wide form's run decomposition (:func:`runs_pool_plain`
    on ``kernels.sweep_plan``'s table) where ``is_wide``."""
    taps, halo = tap_set(ball)
    if not is_wide(taps, halo):
        return sweep_plain(cur, occ, ball)
    plan = kernels.sweep_plan(taps, halo, cur.element_size())
    if cur.dtype == torch.int32:
        new = torch.where(occ, runs_pool_plain(cur, plan, "min", SENTINEL), SENTINEL)
    else:
        pooled = runs_pool_plain(cur.view(torch.int8), plan, "max", 0)
        new = cur | (occ & (pooled > 0)).to(torch.uint8)
    return new, torch.any(new != cur)


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


def _tiles_any(vox: Tensor, grid_t, tile) -> Tensor:
    """Per tile of ``tile`` (z, y, x) voxels: any voxel of ``vox`` set."""
    pad = [0, grid_t[2] * tile[2] - vox.shape[2], 0, grid_t[1] * tile[1] - vox.shape[1],
           0, grid_t[0] * tile[0] - vox.shape[0]]
    return F.pad(vox, pad).reshape(grid_t[0], tile[0], grid_t[1], tile[1], grid_t[2],
                                   tile[2]).any(5).any(3).any(1)


def sweeps_batch_plain(buf0: Tensor, buf1: Tensor, occ: Tensor, ball, changed: Tensor,
                       tiles: Tensor, i0: int, n: int, grow: int = 0,
                       rows: tuple[int, int] | None = None, gate: Tensor | None = None,
                       tile: tuple[int, int, int] = kernels.TILE_ZYX) -> None:
    """Plain model of one persistent K2 launch's schedule (csrc/propagate.cu
    ``sweeps_kernel``; kernels.propagate_sweeps and propagate_batch), on any
    device: sweeps ``i0 .. i0 + n - 1`` of a call, sweep s reading
    ``(buf0, buf1)[s % 2]`` and writing the other, ``buf0`` holding the
    launch's initial grid, both buffers the fill (SENTINEL, 0) wherever
    ``occ`` is False.  Sweep s computes the ``tile`` (z, y, x) tiles that
    hold an occupied voxel and meet its exact rows [(s + 1) grow, nz - (s +
    1) grow): all of them at s = 0, later those within ``ceil(halo /
    extent)`` tiles per axis of one with a change in sweep s - 1's exact
    rows; the others keep what the destination holds.  Writes
    ``changed[i0 + s]`` (1 iff a voxel of the z ``rows``, default all,
    changed) and ``tiles[i0 + s]`` (tiles computed), and stops when the
    next sweep has no tile.  With ``gate`` 0 it does nothing.  Each sweep pools as
    :func:`sweep_model` (the wide form's run decomposition past halo 7)."""
    if gate is not None and not bool(gate):
        return
    _, halo = tap_set(ball)
    shape = buf0.shape
    nz = shape[0]
    fz0, fz1 = (0, nz) if rows is None else rows
    grid_t = [-(-s // t) for s, t in zip(shape, tile)]
    reach = [-(-halo // t) for t in tile]
    dev = buf0.device
    first_z = torch.arange(grid_t[0], device=dev) * tile[0]  # each tile row's first row
    z = torch.arange(nz, device=dev)[:, None, None]
    held = _tiles_any(occ, grid_t, tile)
    bufs = (buf0, buf1)
    tile_changed = None
    for s in range(n):
        src, dst = bufs[s % 2], bufs[(s + 1) % 2]
        lo, hi = (s + 1) * grow, nz - (s + 1) * grow
        meets = ((first_z < hi) & (first_z + tile[0] > lo))[:, None, None] & held
        if s == 0:
            active = meets
            if not bool(active.any()):
                break
        else:
            near = F.max_pool3d(tile_changed[None, None].to(torch.float32),
                                [2 * r + 1 for r in reach], stride=1, padding=reach)
            active = (near[0, 0] > 0) & meets
            if not bool(active.any()):
                break
        vox = active
        for axis, t in enumerate(tile):
            vox = vox.repeat_interleave(t, dim=axis)
        vox = vox[:shape[0], :shape[1], :shape[2]]
        # the sweep over the active tile rows and the rows their taps read
        rows_on = torch.nonzero(active.any(2).any(1)).flatten()
        za, zb = int(rows_on[0]) * tile[0], min(nz, (int(rows_on[-1]) + 1) * tile[0])
        ra, rb = max(0, za - halo), min(nz, zb + halo)
        new = src.clone()
        new[za:zb] = sweep_model(src[ra:rb], occ[ra:rb], ball)[0][za - ra:zb - ra]
        dst.copy_(torch.where(vox, new, dst))
        d = vox & (new != src)
        tile_changed = _tiles_any(d & (z >= lo) & (z < hi), grid_t, tile)
        changed[i0 + s] = torch.any(d & (z >= fz0) & (z < fz1)).to(changed.dtype)
        tiles[i0 + s] = active.sum().to(tiles.dtype)


def sweeps_tiled_plain(init: Tensor, occ: Tensor, ball, n: int, until_fixpoint: bool = False,
                       tile: tuple[int, int, int] = kernels.TILE_ZYX
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain model of the dense persistent K2 launch, on any device: (final
    grid, bool [n] per-sweep changed flags, int32 [n] tiles computed per
    sweep) of :func:`sweeps_batch_plain` over the whole grid, on
    ``kernels.sweep_buffers(init)`` as the launch (``init`` holds the fill
    off the mask, as :func:`sweeps`' callers' grids do).  It stops after
    the first sweep that changed nothing, in either mode: that sweep is a
    fixpoint, so the grid and flags equal :func:`sweeps_plain`'s with or
    without ``until_fixpoint``."""
    del until_fixpoint  # the schedule always stops at a fixpoint
    bufs = kernels.sweep_buffers(init)
    flags = torch.zeros(n, dtype=torch.int32, device=init.device)
    tiles = torch.zeros(n, dtype=torch.int32, device=init.device)
    sweeps_batch_plain(bufs[0], bufs[1], occ, ball, flags, tiles, 0, n, tile=tile)
    return bufs[n % 2], flags.bool(), tiles


def sweeps(init: Tensor, occ: Tensor, ball, n: int,
           until_fixpoint: bool = False) -> tuple[Tensor, Tensor]:
    """``n`` Jacobi sweeps from ``init`` over ``ball`` (a radius, traced
    shells or a tap set): int32 keys take the masked
    min-label sweep, uint8 masks the reach sweep.  ``init`` holds the fill
    (SENTINEL, 0) wherever ``occ`` is False, as the sweeps leave it (the
    card skips the tiles that hold no occupied voxel).  Returns (final grid,
    bool [n] per-sweep changed flags), both on the device of ``init``.
    ``until_fixpoint``: stop after the first sweep that changes nothing.
    On the card the one persistent launch always stops there, which
    changes neither the grid nor the flags of a fixed count."""
    if init.is_cuda:
        taps, halo = tap_set(ball)
        out, changed, _, _ = kernels.propagate_sweeps(init, occ.contiguous().view(torch.uint8),
                                                      taps, halo, n)
        return out, changed.bool()
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


def label_components(
    occupied: Tensor, radius: float, max_iters: int, *, sweep_fn=sweeps, z0: int = 0,
) -> tuple[Tensor, Tensor, Tensor]:
    """Label the components of ``occupied`` with their least member flat id,
    sweeping to the fixpoint or to ``max_iters`` sweeps.

    Returns (labels int32 grid with SENTINEL on empty voxels, converged
    bool, sweeps int32: the sweeps the JAX while_loop runs).  The flags are
    a run of True then False, so the last flag is the while_loop's and the
    loop ran one sweep past the changing ones (or hit the cap).
    ``sweep_fn``, ``z0``: the grid-sharded step's sweep and the slab's
    first global row (the labels stay global flat ids)."""
    occ = occupied.to(torch.bool)
    f0 = z0 * occ.shape[1] * occ.shape[2]
    flat = torch.arange(f0, f0 + occ.numel(), dtype=torch.int32,
                        device=occ.device).reshape(occ.shape)
    labels = torch.where(occ, flat, SENTINEL)
    labels, changed = sweep_fn(labels, occ, radius, max_iters, until_fixpoint=True)
    n_run = torch.clamp(changed.sum(dtype=torch.int32) + 1, max=max_iters)
    return labels, ~changed[-1], n_run


def label_components_plain(
    occupied: Tensor, radius: float, max_iters: int
) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`label_components` with K2's plain sweeps, on any device."""
    return label_components(occupied, radius, max_iters, sweep_fn=sweeps_plain)


def census_scatter_plain(labels: Tensor, vals: Tensor, occ: Tensor, ncv: int) -> Tensor:
    """Plain version of K13a's (and K15b-6a's) scatter: the int32 [ncv]
    census, ``vals`` added where ``occ`` into bucket ``label`` (ids >= ncv
    dropped)."""
    flat_l = labels.reshape(-1).to(torch.int64)
    v = torch.where(occ, vals, 0).reshape(-1)
    keep = flat_l < ncv
    census = torch.zeros(ncv, dtype=torch.int32, device=labels.device)
    census.index_add_(0, flat_l[keep], v[keep])
    return census


def census_read_plain(labels: Tensor, occ: Tensor, census: Tensor,
                      min_sure: float) -> tuple[Tensor, Tensor]:
    """Plain version of K13a's (and K15b-6a's) read-back: each cell's bucket
    ``census[min(label, ncv - 1)]``, 0 off ``occ``; and the flags (any occ,
    any occ with census >= min_sure)."""
    flat_l = labels.reshape(-1).to(torch.int64)
    cell = census[torch.clamp(flat_l, max=census.numel() - 1)].reshape(labels.shape)
    cell = torch.where(occ, cell, 0)
    sure = occ & (cell.to(torch.float32) >= min_sure)
    return cell, torch.stack([torch.any(occ), torch.any(sure)])


def label_census_plain(labels: Tensor, vals: Tensor, occ: Tensor, ncv: int,
                       min_sure: float) -> tuple[Tensor, Tensor]:
    """Plain version of K13a: the JAX census (int32 scatter-add of ``vals``
    where ``occ`` into bucket ``label``, ids >= ncv dropped, read back at
    ``min(label, ncv - 1)``), 0 off ``occ``; and the flags (any occ, any occ
    with census >= min_sure)."""
    return census_read_plain(labels, occ, census_scatter_plain(labels, vals, occ, ncv),
                             min_sure)


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
