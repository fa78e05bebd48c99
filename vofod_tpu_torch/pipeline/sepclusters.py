"""Separated-background-cluster maintenance (default mode).

PyTorch counterpart of vofod_tpu/pipeline/sepclusters.py ``run_sepclusters``
(ref updateSeparatedBGClusters, vofod_nodelet.cpp:1124-1294): local
sure-voxel ball sums (K1) seed a warm-started reachability through the
background (K2), and every voxel within max_bg_distance of an unsafe
background voxel is demoted toward the ray score: K11's demotion EMA
(csrc/ema.cu), the K1 ball max over the unsafe voxels with the EMA as its
epilogue, so the demotion mask is never stored.  The exact-census mode
(``sepclusters_exact_census``) is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.ops.components import propagate_reach
from vofod_tpu_torch.ops.morphology import ball_pool_plain, ball_pool_sum, ball_taps

Tensor = torch.Tensor


@dataclass
class SepClustersOut:
    grid: Tensor
    safe: Tensor  # carried reachability (warm start)
    sure_bg_sufficient: Tensor
    converged: Tensor


def demote_weights(its_diff: float, score_ray: float) -> tuple[float, float]:
    """(w1, c) of the demotion EMA ``w1 v + c`` as the JAX step rounds them
    in float32: w1 = clip(0.5^its_diff, 0, 1) (ref :1242-1244), c = (1 - w1)
    * score_ray."""
    w1 = np.float32(min(max(0.5**its_diff, 0.0), 1.0))
    return float(w1), float((np.float32(1.0) - w1) * np.float32(score_ray))


def demote_ema_plain(grid_vals: Tensor, bg: Tensor, safe: Tensor, sure_sufficient: Tensor,
                     radius: float, w1: float, c: float) -> Tensor:
    """Plain version of K11's demotion EMA (vofod_tpu sepclusters.py:
    144-156): every voxel within ``radius`` of an unsafe background voxel
    becomes ``w1 * v + c`` (c = (1 - w1) * score_ray), when a sure cluster
    exists."""
    unsafe = bg & ~safe
    demote = ball_pool_plain(unsafe.to(torch.int8), radius, "max", 0) > 0
    return torch.where(demote & sure_sufficient, w1 * grid_vals + c, grid_vals)


def demote_ema(grid_vals: Tensor, bg: Tensor, safe: Tensor, sure_sufficient: Tensor,
               radius: float, w1: float, c: float) -> Tensor:
    if grid_vals.is_cuda:
        return kernels.demote_ema(grid_vals, bg, safe, sure_sufficient, ball_taps(radius),
                                  int(math.floor(radius)), w1, c)
    if grid_vals.device.type != "cpu":
        raise ValueError(f"demotion EMA: unsupported device {grid_vals.device}")
    return demote_ema_plain(grid_vals, bg, safe, sure_sufficient, radius, w1, c)


def run_sepclusters(
    cfg: VoFODConfig,
    dyn: DynParams,
    grid_vals: Tensor,
    prev_safe: Tensor,
    its_diff: float,
    prev_sure: Tensor,
    max_iters: int = 8,
) -> SepClustersOut:
    if cfg.sepclusters_exact_census:
        raise NotImplementedError("sepclusters_exact_census is not ported yet")
    bg = grid_vals > dyn.thr_new_obstacles
    sure = grid_vals > dyn.thr_sure_obstacles

    max_dist_idx = cfg.sepclusters_max_bg_distance / cfg.voxel_size
    adj_radius = math.ceil(max_dist_idx)  # cluster tolerance, index units

    # local sure-voxel counts stand in for per-cluster counts (JAX docstring)
    local_sure = ball_pool_sum(sure.to(torch.int32), float(adj_radius) + 1.0)
    seeds = sure & (local_sure.to(torch.float32) >= dyn.sepclusters_min_sure_points)
    # empty background: the reference keeps the previous value (:1155-1159)
    sure_sufficient = torch.where(torch.any(bg), torch.any(seeds), prev_sure)

    init = (prev_safe & bg) | (seeds & bg)
    safe, converged = propagate_reach(bg, init, float(adj_radius), max_iters)

    # demotion ball: ||d|| <= max_bg_distance/voxel around unsafe background
    # (ref :1219-1237); no demotion at all when no sure cluster exists (ref
    # returns early :1197-1206)
    new_vals = demote_ema(grid_vals, bg, safe, sure_sufficient, max_dist_idx,
                          *demote_weights(its_diff, dyn.score_ray))
    return SepClustersOut(
        grid=new_vals, safe=safe, sure_bg_sufficient=sure_sufficient, converged=converged
    )
