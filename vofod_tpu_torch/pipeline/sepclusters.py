"""Separated-background-cluster maintenance (default mode).

PyTorch counterpart of vofod_tpu/pipeline/sepclusters.py ``run_sepclusters``
(ref updateSeparatedBGClusters, vofod_nodelet.cpp:1124-1294): local
sure-voxel ball sums (K1) seed a warm-started reachability through the
background (K2), and every voxel within max_bg_distance of an unsafe
background voxel (K1 ball max) is demoted toward the ray score.  The
exact-census mode (``sepclusters_exact_census``) is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.ops.components import propagate_reach
from vofod_tpu_torch.ops.morphology import ball_pool_max, ball_pool_sum

Tensor = torch.Tensor


@dataclass
class SepClustersOut:
    grid: Tensor
    safe: Tensor  # carried reachability (warm start)
    sure_bg_sufficient: Tensor
    converged: Tensor


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

    unsafe = bg & ~safe
    # demotion ball: ||d|| <= max_bg_distance/voxel (ref :1219-1237)
    demote = ball_pool_max(unsafe.to(torch.int8), max_dist_idx, fill=0) > 0

    w1 = min(max(0.5 ** its_diff, 0.0), 1.0)  # ref :1242-1244
    # no demotion at all when no sure cluster exists (ref returns early :1197-1206)
    new_vals = torch.where(
        demote & sure_sufficient,
        w1 * grid_vals + (1.0 - w1) * float(dyn.score_ray),
        grid_vals,
    )
    return SepClustersOut(
        grid=new_vals, safe=safe, sure_bg_sufficient=sure_sufficient, converged=converged
    )
