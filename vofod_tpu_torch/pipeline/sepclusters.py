"""Separated-background-cluster maintenance.

PyTorch counterpart of vofod_tpu/pipeline/sepclusters.py (ref
updateSeparatedBGClusters, vofod_nodelet.cpp:1124-1294).

Default mode (``run_sepclusters``): local sure-voxel ball sums (K1) seed a
warm-started reachability through the background (K2), and every voxel
within max_bg_distance of an unsafe background voxel is demoted toward the
ray score: K11's demotion EMA (csrc/ema.cu), the K1 ball max over the
unsafe voxels with the EMA as its epilogue, so the demotion mask is never
stored.  With ``cfg.dynamic_radii`` the three stencils (local-sure sum,
reach, demotion) take the shells of their static bounds kept by the
runtime ``dyn.sepclusters_max_bg_distance`` (K14, ops/morphology.
Shells): the sum as K14, the reach as K2 and the demotion as K11's
epilogue, each on that tap set.

The default mode's grid-wide flags, pools, reach and demotion go through
``ops`` (parallel/gridops.py), as in the JAX stage: on the grid-sharded step
the stencils read halo-extended slabs (the traced ones a halo of their
static bound).

Exact-census mode (``cfg.sepclusters_exact_census``,
:func:`run_sepclusters_exact`): the coarse counted binning (with the
reference's indexing quirk behind ``cfg.compat_counted_indexing``: K13b,
csrc/census.cu), coarse-cell components to convergence (K2 with gated
launches), the per-component sure census (K13a) and the demotion around the
unsure cells' centres, w1^k for k overlapping balls (K13c, csrc/ema.cu).
The coarse lattice is anchored at the grid origin; at the flagship leaf
size 1 it is the fine grid.  On the grid-sharded step (``ops`` a
parallel/gridops.ZShardOps) the coarse pooling stays shard-local (the leaf
divides the shard height), the quirk counts take global export ranks from
gathered column sums and a psum'd rank table (K15b-6b,
:func:`quirk_sure_counts_sharded`), the components and the census go
through ``ops`` (K2 on halo'd slabs, K15b-6a), and K13c reads the coarse
arrays with a halo of the neighbours' rows (K15b-1) through a z window,
writing its own rows: every output is the dense step's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.ops.morphology import (
    Shells, ball_pool_plain, ball_pool_runs_plain, ball_taps, pool_plain, run_table, tap_set)
from vofod_tpu_torch.parallel.gridops import DENSE

Tensor = torch.Tensor


@dataclass
class SepClustersOut:
    grid: Tensor
    safe: Tensor  # carried reachability (warm start); exact mode: member of a sure cluster
    sure_bg_sufficient: Tensor
    converged: Tensor
    label_sweeps: Tensor | None = None  # exact mode: int32 component sweeps run


def demote_weights(its_diff: float, score_ray: float) -> tuple[float, float]:
    """(w1, c) of the demotion EMA ``w1 v + c`` as the JAX step rounds them
    in float32: w1 = clip(0.5^its_diff, 0, 1) (ref :1242-1244), c = (1 - w1)
    * score_ray."""
    w1 = np.float32(min(max(0.5**its_diff, 0.0), 1.0))
    return float(w1), float((np.float32(1.0) - w1) * np.float32(score_ray))


def demote_ema_plain(grid_vals: Tensor, bg: Tensor, safe: Tensor, sure_sufficient: Tensor,
                     ball, w1: float, c: float) -> Tensor:
    """Plain version of K11's demotion EMA (vofod_tpu sepclusters.py:
    144-156): every voxel within ``ball`` (a radius or traced shells) of an
    unsafe background voxel becomes ``w1 * v + c`` (c = (1 - w1) *
    score_ray), when a sure cluster exists."""
    unsafe = bg & ~safe
    demote = pool_plain(unsafe.to(torch.int8), ball, "max", 0) > 0
    return torch.where(demote & sure_sufficient, w1 * grid_vals + c, grid_vals)


def demote_ema_runs_plain(grid_vals: Tensor, bg: Tensor, safe: Tensor, sure_sufficient: Tensor,
                          ball, w1: float, c: float, zchunk: int) -> Tensor:
    """Plain model of K11's demotion kernel (csrc/ema.cu): K1's schedule
    (``ball_pool_runs_plain`` at the int8 tile, z chunks of ``zchunk``)
    staging ``bg & ~safe`` while loading (0 outside the grid), the int8 max
    on ``ball``'s run table (a tile and chunk with no unsafe voxel skips
    it), and the epilogue where K1 stores."""
    nz, ny, nx = grid_vals.shape
    unsafe = bg & ~safe

    def stage(zi, rows, cols):
        out = torch.zeros((len(rows), len(cols)), dtype=torch.int8, device=bg.device)
        if 0 <= zi < nz:
            ry = (rows >= 0) & (rows < ny)
            cx = (cols >= 0) & (cols < nx)
            out[ry[:, None] & cx[None, :]] = unsafe[zi][rows[ry]][:, cols[cx]].reshape(-1).to(
                torch.int8)
        return out

    taps, halo = tap_set(ball)
    pooled = ball_pool_runs_plain(unsafe.to(torch.int8), run_table(taps, halo), "max", 0,
                                  kernels.BALL_POOL_TILE[torch.int8], zchunk, stage,
                                  skip_empty=True)
    return torch.where((pooled > 0) & sure_sufficient, w1 * grid_vals + c, grid_vals)


def demote_ema(grid_vals: Tensor, bg: Tensor, safe: Tensor, sure_sufficient: Tensor,
               ball, w1: float, c: float) -> Tensor:
    if grid_vals.is_cuda:
        return kernels.demote_ema(grid_vals, bg, safe, sure_sufficient, *tap_set(ball), w1, c)
    if grid_vals.device.type != "cpu":
        raise ValueError(f"demotion EMA: unsupported device {grid_vals.device}")
    return demote_ema_plain(grid_vals, bg, safe, sure_sufficient, ball, w1, c)


def traced_radii(cfg: VoFODConfig, dyn: DynParams) -> tuple[float, np.float32, np.float32]:
    """(static bound, runtime radius, its ceiling) of the sepclusters
    stencils under ``cfg.dynamic_radii``, in index units, in the JAX step's
    float32 arithmetic (vofod_tpu sepclusters.py:85-100): the bound is
    ceil(bound_m / voxel) (a bound <= 0 falls back to the static radius),
    mdi = min(f32(max_bg) / voxel, f32(bound_m / voxel)), adj = ceil(mdi)."""
    bound_m = cfg.sepclusters_max_bg_distance_bound
    if bound_m <= 0:
        bound_m = cfg.sepclusters_max_bg_distance
    bound_idx = bound_m / cfg.voxel_size
    mdi = min(np.float32(dyn.sepclusters_max_bg_distance) / np.float32(cfg.voxel_size),
              np.float32(bound_idx))
    return float(math.ceil(bound_idx)), mdi, np.ceil(mdi)


def run_sepclusters(
    cfg: VoFODConfig,
    dyn: DynParams,
    grid_vals: Tensor,
    prev_safe: Tensor,
    its_diff: float,
    prev_sure: Tensor,
    max_iters: int = 8,
    ops=DENSE,
) -> SepClustersOut:
    if cfg.sepclusters_exact_census:
        return run_sepclusters_exact(cfg, dyn, grid_vals, its_diff, prev_sure, ops=ops)
    bg = grid_vals > dyn.thr_new_obstacles
    sure = grid_vals > dyn.thr_sure_obstacles

    if cfg.dynamic_radii:
        # the live-tunable max_bg_distance (ref dynamic_reconfigure,
        # DetectionParams.cfg:36-44): each stencil keeps the shells of its
        # static bound within the runtime radius
        adj_bound, mdi, adj = traced_radii(cfg, dyn)
        local_sure = ops.pool_sum(sure.to(torch.int32), adj_bound + 1.0,
                                  traced_r2=(adj + 1) * (adj + 1))
        reach_r, reach_r2 = adj_bound, adj * adj
        demote_ball = Shells(adj_bound, mdi * mdi)
    else:
        max_dist_idx = cfg.sepclusters_max_bg_distance / cfg.voxel_size
        adj_radius = math.ceil(max_dist_idx)  # cluster tolerance, index units
        # local sure-voxel counts stand in for per-cluster counts (JAX docstring)
        local_sure = ops.pool_sum(sure.to(torch.int32), float(adj_radius) + 1.0)
        reach_r, reach_r2 = float(adj_radius), None
        demote_ball = max_dist_idx
    seeds = sure & (local_sure.to(torch.float32) >= dyn.sepclusters_min_sure_points)
    # empty background: the reference keeps the previous value (:1155-1159)
    sure_sufficient = torch.where(ops.gany(bg), ops.gany(seeds), prev_sure)

    init = (prev_safe & bg) | (seeds & bg)
    safe, converged = ops.propagate_reach(bg, init, reach_r, max_iters, traced_r2=reach_r2)

    # demotion ball: ||d|| <= max_bg_distance/voxel around unsafe background
    # (ref :1219-1237); no demotion at all when no sure cluster exists (ref
    # returns early :1197-1206)
    w1, c = demote_weights(its_diff, dyn.score_ray)
    new_vals = ops.stencil(
        lambda v, b, s: demote_ema(v, b, s, sure_sufficient, demote_ball, w1, c),
        (grid_vals, bg, safe), (0.0, False, False), tap_set(demote_ball)[1])
    return SepClustersOut(
        grid=new_vals, safe=safe, sure_bg_sufficient=sure_sufficient, converged=converged
    )


# =============================================================================
# Exact-census mode (bit-parity with ref vofod_nodelet.cpp:1124-1294)
# =============================================================================


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX step's traced DynParams are."""
    return float(np.float32(x))


def pool_sum_coarse(mask: Tensor, lsz: int) -> Tensor:
    """int32 sums of a fine (nz, ny, nx) int grid over lsz³ coarse cells
    anchored at the grid origin (pad to a multiple, then reshape)."""
    nz, ny, nx = mask.shape
    pz, py, px = (-nz) % lsz, (-ny) % lsz, (-nx) % lsz
    m = F.pad(mask, (0, px, 0, py, 0, pz))
    ncz, ncy, ncx = (nz + pz) // lsz, (ny + py) // lsz, (nx + px) // lsz
    return m.reshape(ncz, lsz, ncy, lsz, ncx, lsz).sum(dim=(1, 3, 5)).to(torch.int32)


def upsample_coarse(mask_c: Tensor, lsz: int, fine_shape) -> Tensor:
    """A coarse mask broadcast back onto the fine lattice (the membership of
    :func:`pool_sum_coarse`)."""
    ncz, ncy, ncx = mask_c.shape
    m = mask_c[:, None, :, None, :, None].expand(ncz, lsz, ncy, lsz, ncx, lsz)
    nz, ny, nx = fine_shape
    return m.reshape(ncz * lsz, ncy * lsz, ncx * lsz)[:nz, :ny, :nx]


def center_mask(mask_c: Tensor, lsz: int) -> Tensor:
    """The EXTENDED-lattice mask (ncz*lsz, ncy*lsz, ncx*lsz) with one True
    per set coarse cell, at its centre ijk*lsz + lsz//2 (ref demotion
    positions, vofod_nodelet.cpp:1253).  Not cropped: a boundary cell's
    centre may lie outside the fine grid while its demotion ball reaches
    in (see the JAX ``_center_mask``)."""
    ncz, ncy, ncx = mask_c.shape
    pat = torch.zeros(lsz, dtype=torch.bool, device=mask_c.device)
    pat[lsz // 2] = True
    return (
        mask_c[:, None, :, None, :, None]
        & pat[None, :, None, None, None, None]
        & pat[None, None, None, :, None, None]
        & pat[None, None, None, None, None, :]
    ).reshape(ncz * lsz, ncy * lsz, ncx * lsz)


def quirk_sure_counts_plain(bg: Tensor, sure: Tensor, lsz: int) -> Tensor:
    """Plain version of K13b (vofod_tpu ``_quirk_sure_counts``): per-coarse
    -cell sure counts with the reference's VoxelGridCounted indexing quirk
    (voxel_grid_counted.cpp:185-187).  The bg voxels are exported x outer,
    z fastest (voxel_map.cpp:190-196) and sorted by x-fastest cell id; the
    sure counts are taken over raw export positions in each cell's rank
    range: quirk = U[first + count] - U[first], U[k] the sure voxels among
    the first k exported."""
    bg_e = bg.permute(2, 1, 0).reshape(-1)
    sure_e = (sure & bg).permute(2, 1, 0).reshape(-1).to(torch.int32)
    nv = bg_e.numel()
    t = torch.cumsum(sure_e, 0).to(torch.int32)  # sure among exported up to i
    rank = torch.cumsum(bg_e.to(torch.int32), 0)  # 1-based rank at bg positions
    u = torch.zeros(nv + 2, dtype=torch.int32, device=bg.device)
    u[rank[bg_e].to(torch.int64)] = t[bg_e]  # u[0] = 0; u[k] for every k <= #bg
    counts_c = pool_sum_coarse(bg.to(torch.int32), lsz)
    cf = counts_c.reshape(-1).to(torch.int64)  # ascending cell id == x-fastest ravel
    first = torch.cumsum(cf, 0) - cf  # exclusive prefix
    quirk = u[first + cf] - u[first]
    return torch.where(cf > 0, quirk, 0).reshape(counts_c.shape)


def _tiled_excl_scan(v: Tensor, tile: int) -> Tensor:
    """The exclusive prefix of a 1-D int64 tensor as a single-pass scan
    forms it: each tile's own exclusive prefix plus the sum of the tiles
    before (what the decoupled look-back gathers)."""
    n = v.numel()
    t = F.pad(v, (0, (-n) % tile)).reshape(-1, tile)
    agg = t.sum(1)
    return ((torch.cumsum(agg, 0) - agg)[:, None] + torch.cumsum(t, 1) - t).reshape(-1)[:n]


def quirk_counts_columnwalk_plain(bg: Tensor, sure: Tensor, lsz: int,
                                  col_tile: int = kernels.QUIRK_COL_TILE,
                                  cell_tile: int = kernels.QUIRK_CELL_TILE) -> Tensor:
    """Plain model of K13b's column-walk design (csrc/census.cu), equal to
    :func:`quirk_sure_counts_plain`.  The export prefix at a voxel is the
    prefix of the (y, x) columns before its own in export order plus its
    column's z prefix: (1) each column's (bg << 32) | (sure & bg) sum; (2)
    their exclusive prefix in export order (e = x * ny + y) by tiles,
    stored at [y, x]; (3) each column walked up z from it, u[rank] = t at
    its bg voxels; (4) the cells' bg counts in x-fastest order (partial top
    cells as :func:`pool_sum_coarse`), their exclusive prefix by tiles and
    quirk = u[first + count] - u[first].  The tiles are the kernel's by
    default.  u gets no zero fill: only u[0] and the ranks 1..#bg are
    written, the rest holds INT32_MIN, which no cell reads.  Nothing on the
    card's path calls it."""
    nz, ny, nx = bg.shape
    pairs = _export_pairs(bg, sure)
    cols = pairs.sum(0)
    excl = _tiled_excl_scan(cols.T.reshape(-1), col_tile).reshape(nx, ny).T
    u = torch.full((bg.numel() + 2,), torch.iinfo(torch.int32).min, dtype=torch.int32,
                   device=bg.device)
    u[0] = 0
    pref = excl + torch.cumsum(pairs, 0)
    u[(pref >> 32)[bg]] = (pref & 0xFFFFFFFF)[bg].to(torch.int32)
    counts_c = pool_sum_coarse(bg.to(torch.int32), lsz)
    cf = counts_c.reshape(-1).to(torch.int64)
    first = _tiled_excl_scan(cf, cell_tile)
    quirk = u[first + cf] - u[first]
    return torch.where(cf > 0, quirk, 0).reshape(counts_c.shape)


def quirk_sure_counts(bg: Tensor, sure: Tensor, lsz: int) -> Tensor:
    """K13b: see :func:`quirk_sure_counts_plain`."""
    if bg.is_cuda:
        return kernels.quirk_counts(bg.contiguous(), sure.contiguous(), lsz)
    if bg.device.type != "cpu":
        raise ValueError(f"quirk counts: unsupported device {bg.device}")
    return quirk_sure_counts_plain(bg, sure, lsz)


def _export_pairs(bg: Tensor, sure: Tensor) -> Tensor:
    """int64 (bg << 32) | (sure & bg) per voxel: both export prefixes in one."""
    return (bg.to(torch.int64) << 32) | (bg & sure).to(torch.int64)


def quirk_columns_plain(bg: Tensor, sure: Tensor) -> Tensor:
    """Plain version of K15b-6b pass 1 (kernels.quirk_columns)."""
    return _export_pairs(bg, sure).sum(0).reshape(-1)


def quirk_ranks_plain(bg: Tensor, sure: Tensor, blocks: Tensor, rank: int,
                      nv: int) -> tuple[Tensor, Tensor]:
    """Plain version of K15b-6b pass 2 (kernels.quirk_ranks): the global
    inclusive export prefixes at the slab's voxels (the columns before in
    export order over every shard, the column's rows on the shards below,
    the local z prefix), u[rank] = t at its bg voxels, and the bg voxels of
    the shards below."""
    nzl, ny, nx = bg.shape
    tot = blocks.sum(0).reshape(ny, nx)
    below = blocks[:rank].sum(0).reshape(ny, nx)
    flat = tot.T.reshape(-1)  # export order: x outer
    excl = (torch.cumsum(flat, 0) - flat).reshape(nx, ny).T
    pref = excl + below + torch.cumsum(_export_pairs(bg, sure), 0)
    u = torch.zeros(nv + 2, dtype=torch.int32, device=bg.device)
    u[(pref >> 32)[bg]] = (pref & 0xFFFFFFFF)[bg].to(torch.int32)
    return u, (below >> 32).sum()


def quirk_query_plain(bg: Tensor, lsz: int, u: Tensor, below: Tensor) -> Tensor:
    """Plain version of K15b-6b pass 3 (kernels.quirk_query): K13b's cell
    queries on the slab's cells, every first rank moved on by ``below``."""
    counts_c = pool_sum_coarse(bg.to(torch.int32), lsz)
    cf = counts_c.reshape(-1).to(torch.int64)
    first = torch.cumsum(cf, 0) - cf + below
    quirk = u[first + cf] - u[first]
    return torch.where(cf > 0, quirk, 0).reshape(counts_c.shape)


def quirk_sure_counts_sharded(bg: Tensor, sure: Tensor, lsz: int, comm) -> Tensor:
    """K15b-6b: :func:`quirk_sure_counts` on a shard's slab (vofod_tpu
    ``_quirk_sure_counts_sharded``), inside ``comm.run``: the column sums
    all-gathered, the slab's ranks scattered into a full-grid int32 table
    (disjoint over the shards) that is psum'd, then the slab's cell
    queries.  The table is replicated at the full grid's size (9.9 MB at
    the flagship), as in JAX: the parity mode does not shrink with n."""
    bg, sure = bg.contiguous(), sure.contiguous()
    nv = bg.numel() * comm.n
    if bg.is_cuda:
        blocks = comm.all_gather(kernels.quirk_columns(bg, sure))
        u, below = kernels.quirk_ranks(bg, sure, blocks, comm.rank, nv)
        return kernels.quirk_query(bg, lsz, comm.psum(u), below)
    if bg.device.type != "cpu":
        raise ValueError(f"quirk counts: unsupported device {bg.device}")
    blocks = comm.all_gather(quirk_columns_plain(bg, sure))
    u, below = quirk_ranks_plain(bg, sure, blocks, comm.rank, nv)
    return quirk_query_plain(bg, lsz, comm.psum(u), below)


def exact_demote_ema_plain(grid_vals: Tensor, occ_c: Tensor, cell_census: Tensor,
                           flags: Tensor, prev_sure: Tensor, lsz: int, radius: float,
                           min_sure: float, w1: float, score: float, thr_new: float,
                           window: tuple[int, int, int] | None = None
                           ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of K13c (vofod_tpu sepclusters.py:356-390): sure
    cells have census >= min_sure; sure_sufficient = any occupied cell ?
    any sure cell : the previous value (``flags`` = K13a's two); every voxel
    within ``radius`` of k unsure-cell centres becomes w1^k v + (1 - w1^k)
    score when sure_sufficient; safe = bg & in a sure cell.  ``window``
    (z_off, zc_lo, ncz): as kernels.exact_demote_ema's (a shard's slab and
    its halo'd coarse arrays).  Returns (new grid, safe, sure_sufficient)."""
    sure_c = occ_c & (cell_census.to(torch.float32) >= min_sure)
    sure_sufficient = torch.where(flags[0], flags[1], prev_sure)
    centers = center_mask(occ_c & ~sure_c, lsz)
    nz, ny, nx = grid_vals.shape
    z1 = 0 if window is None else window[0] - window[1] * lsz  # own rows in the held ones
    k = ball_pool_plain(centers.to(torch.int32), radius, "sum", 0)[z1:z1 + nz, :ny, :nx]
    w1k = torch.pow(w1, k.to(torch.float32))  # k = 0 -> identity
    new_vals = torch.where(sure_sufficient, w1k * grid_vals + (1.0 - w1k) * score, grid_vals)
    c1 = z1 // lsz
    safe = (grid_vals > thr_new) & upsample_coarse(sure_c[c1:c1 + -(-nz // lsz)], lsz,
                                                   grid_vals.shape)
    return new_vals, safe, sure_sufficient


def centre_stage(occ_c: Tensor, cell_census: Tensor, lsz: int, min_sure: float, ncz: int,
                 ncy: int, ncx: int, z_off: int = 0, zc_lo: int = 0):
    """K13c's staging rule (csrc/ema.cu CentreIO), as ``ball_pool_runs_plain``
    takes it: input plane zi (global row z_off + zi) at global ``rows`` and
    ``cols`` holds 1 at the centre ijk * lsz + lsz // 2 of an unsure coarse
    cell (occupied, census < min_sure).  Points are masked by the EXTENDED
    lattice (ncz * lsz, ncy * lsz, ncx * lsz) and by the held coarse rows
    [zc_lo, zc_lo + len(occ_c)), never by the fine grid: a boundary cell's
    centre may lie outside the grid and still demote voxels in it."""
    unsure = occ_c & ~(cell_census.to(torch.float32) >= min_sure)
    mid = lsz // 2

    def on_lattice(v, n):
        return (v >= 0) & (v < n * lsz) & (v % lsz == mid)

    def stage(zi, rows, cols):
        out = torch.zeros((len(rows), len(cols)), dtype=torch.int8, device=occ_c.device)
        gz = z_off + zi
        if not (on_lattice(torch.tensor(gz), ncz) and zc_lo <= gz // lsz < zc_lo + len(unsure)):
            return out
        ry, cx = on_lattice(rows, ncy), on_lattice(cols, ncx)
        cells = unsure[gz // lsz - zc_lo][rows[ry] // lsz][:, cols[cx] // lsz]
        out[ry[:, None] & cx[None, :]] = cells.reshape(-1).to(torch.int8)
        return out

    return stage


def exact_demote_runs_plain(grid_vals: Tensor, occ_c: Tensor, cell_census: Tensor,
                            flags: Tensor, prev_sure: Tensor, lsz: int, radius: float,
                            min_sure: float, w1: float, score: float, thr_new: float,
                            window: tuple[int, int, int] | None, zchunk: int
                            ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain model of K13c's kernel (csrc/ema.cu): K1's schedule
    (``ball_pool_runs_plain`` at the int8 tile, z chunks of ``zchunk``)
    staging :func:`centre_stage` while loading, the ball sum k of the
    centres on the run table (a tile and chunk with no centre skips it; the
    kernel's test, no occupied cell, is stricter and gives the same grid),
    and the epilogue where K1 stores: w1^k v +
    (1 - w1^k) score where sure_sufficient, safe = bg & a sure cell.
    Arguments as :func:`exact_demote_ema_plain`'s."""
    nz, ny, nx = grid_vals.shape
    ncz, z_off, zc_lo = -(-nz // lsz), 0, 0
    if window is not None:
        z_off, zc_lo, ncz = window
    stage = centre_stage(occ_c, cell_census, lsz, min_sure, ncz, -(-ny // lsz), -(-nx // lsz),
                         z_off, zc_lo)
    k = ball_pool_runs_plain(torch.empty_like(grid_vals, dtype=torch.int8),
                             run_table(radius), "sum", 0, kernels.BALL_POOL_TILE[torch.int8],
                             zchunk, stage, skip_empty=True)
    sure_sufficient = torch.where(flags[0], flags[1], prev_sure)
    w1k = torch.pow(w1, k.to(torch.float32))
    new_vals = torch.where(sure_sufficient, w1k * grid_vals + (1.0 - w1k) * score, grid_vals)
    sure_c = occ_c & (cell_census.to(torch.float32) >= min_sure)
    c1 = z_off // lsz - zc_lo
    safe = (grid_vals > thr_new) & upsample_coarse(
        sure_c[c1:c1 + -(-nz // lsz)], lsz, grid_vals.shape)
    return new_vals, safe, sure_sufficient


def exact_demote_ema(grid_vals: Tensor, occ_c: Tensor, cell_census: Tensor, flags: Tensor,
                     prev_sure: Tensor, lsz: int, radius: float, min_sure: float, w1: float,
                     score: float, thr_new: float,
                     window: tuple[int, int, int] | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """K13c: see :func:`exact_demote_ema_plain`."""
    if grid_vals.is_cuda:
        return kernels.exact_demote_ema(
            grid_vals, occ_c.contiguous(), cell_census.contiguous(), flags, prev_sure, lsz,
            ball_taps(radius), int(math.floor(radius)), min_sure, w1, score, thr_new, window)
    if grid_vals.device.type != "cpu":
        raise ValueError(f"exact demotion EMA: unsupported device {grid_vals.device}")
    return exact_demote_ema_plain(grid_vals, occ_c, cell_census, flags, prev_sure, lsz, radius,
                                  min_sure, w1, score, thr_new, window)


def run_sepclusters_exact(
    cfg: VoFODConfig,
    dyn: DynParams,
    grid_vals: Tensor,
    its_diff: float,
    prev_sure: Tensor,
    max_label_iters: int = 128,
    ops=DENSE,
) -> SepClustersOut:
    """Reference-exact separated-background maintenance (vofod_tpu
    ``run_sepclusters_exact``; see the module docstring).  The carried
    ``safe`` means "member of a sure coarse cluster" in this mode, so the
    previous one is not read.  ``ops``: the grid provider; on the
    grid-sharded step the grids are a shard's slab."""
    max_dist_idx = cfg.sepclusters_max_bg_distance / cfg.voxel_size
    mv = math.ceil(max_dist_idx)  # max_voxel_dist (ref :1143)
    lsz = max(mv - 1, 1)  # ref :1162 (PCL breaks at 0)
    bg = grid_vals > dyn.thr_new_obstacles
    sure = grid_vals > dyn.thr_sure_obstacles
    counts_c = pool_sum_coarse(bg.to(torch.int32), lsz)
    if cfg.compat_counted_indexing:
        if ops.is_sharded:
            sure_c = quirk_sure_counts_sharded(bg, sure, lsz, ops.comm)
        else:
            sure_c = quirk_sure_counts(bg, sure, lsz)
    else:
        sure_c = pool_sum_coarse((bg & sure).to(torch.int32), lsz)
    occ_c = counts_c > 0
    # coarse cells cluster at tolerance max_voxel_dist on cell centres lsz
    # apart (ref :1171): adjacency radius mv / lsz
    labels, converged, n_sweeps = ops.label_components(occ_c, mv / lsz, max_label_iters)
    min_sure = _f32(dyn.sepclusters_min_sure_points)
    ncz = occ_c.shape[0] * (ops.n if ops.is_sharded else 1)
    cell_census, flags = ops.label_census(labels, sure_c, occ_c,
                                          ncz * occ_c.shape[1] * occ_c.shape[2], min_sure)
    w1, _ = demote_weights(its_diff, dyn.score_ray)  # ref :1242-1244
    # the demotion ball reaches ceil(floor(r) / lsz) coarse rows past the slab
    (occ_h, census_h), win = ops.halo_window((occ_c, cell_census), (False, 0),
                                             -(-int(math.floor(max_dist_idx)) // lsz), ncz)
    window = None if win is None else (win[2] * lsz, win[1], ncz)
    new_vals, safe, sure_sufficient = exact_demote_ema(
        grid_vals, occ_h, census_h, flags, prev_sure, lsz, max_dist_idx, min_sure, w1,
        _f32(dyn.score_ray), _f32(dyn.thr_new_obstacles), window)
    return SepClustersOut(grid=new_vals, safe=safe, sure_bg_sufficient=sure_sufficient,
                          converged=converged, label_sweeps=n_sweeps)
