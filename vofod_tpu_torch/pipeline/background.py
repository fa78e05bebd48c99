"""Background separation + voxel-map point update.

PyTorch counterpart of vofod_tpu/pipeline/background.py ``split_and_update``
(ref findCloseFarClusters, vofod_nodelet.cpp:701-751, and updateVoxel
:776-796): the sticky background-sufficiency gate, the close/far split and
component labels from ONE seeded propagation (K1 ball-max seeds, K2
sweeps), and the weighted EMA point update ``w = 2^-count`` (K11's point
EMA, csrc/ema.cu, for CUDA tensors; :func:`point_ema_plain` for CPU ones).
With ``cfg.compat_hascloseto_bounds`` the seeds come from the reference's
exact hasCloseTo box (K1 with the ops/morphology.hascloseto_taps tap set)
instead of the symmetric ball.  With ``cfg.dynamic_radii`` the seed pool
and the sweeps take the shells of the static bound kept by the runtime
``dyn.ground_points_max_distance`` (K14, ops/morphology.shell_taps).
The grid-wide sums, the seed pool and the seeded propagation go through
``ops`` (parallel/gridops.py), as in the JAX stage.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.ops.components import label_components_seeded
from vofod_tpu_torch.ops.morphology import ball_pool_max_traced, hascloseto_pool_any
from vofod_tpu_torch.parallel.gridops import DENSE

Tensor = torch.Tensor


@dataclass
class BackgroundOut:
    grid: Tensor  # updated confidence grid
    occupied: Tensor  # bool — voxels with points this scan (the "flags")
    far: Tensor  # bool — occupied, not background-connected
    close: Tensor
    labels: Tensor  # int32 component labels (SENTINEL off-mask)
    n_bg_voxels: Tensor
    n_occupied: Tensor  # int32 — occupied voxels
    bg_sufficient: Tensor
    cc_converged: Tensor
    cc_iters: Tensor


def point_ema_plain(grid_vals: Tensor, counts: Tensor, close: Tensor, score_point: float,
                    score_unknown: float) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of K11's point EMA (vofod_tpu background._finish, ref
    updateVoxel :789-795): (new grid, far, int32 count of occupied voxels)."""
    occupied = counts > 0
    w = torch.exp2(-counts.clamp(0, 63).to(torch.float32))
    score = torch.where(close, score_point, score_unknown)
    new_vals = torch.where(occupied, w * grid_vals + (1.0 - w) * score, grid_vals)
    return new_vals, occupied & ~close, occupied.sum().to(torch.int32)


def point_ema(grid_vals: Tensor, counts: Tensor, close: Tensor, score_point: float,
              score_unknown: float) -> tuple[Tensor, Tensor, Tensor]:
    if grid_vals.is_cuda:
        return kernels.point_ema(grid_vals, counts, close, score_point, score_unknown)
    if grid_vals.device.type != "cpu":
        raise ValueError(f"point EMA: unsupported device {grid_vals.device}")
    return point_ema_plain(grid_vals, counts, close, score_point, score_unknown)


def traced_radius(cfg: VoFODConfig, dyn: DynParams) -> tuple[float, np.float32]:
    """(static bound, runtime r²) of the clustering radius under
    ``cfg.dynamic_radii``, in index units, in the JAX step's float32
    arithmetic (vofod_tpu background.py:48-58): r_idx = f32(radius) / voxel,
    r² = min(r_idx², f32(bound²)); a bound <= 0 falls back to the static
    radius."""
    bound_m = cfg.ground_points_max_distance_bound
    if bound_m <= 0:
        bound_m = cfg.ground_points_max_distance
    bound = bound_m / cfg.voxel_size
    r_idx = np.float32(dyn.ground_points_max_distance) / np.float32(cfg.voxel_size)
    return bound, min(r_idx * r_idx, np.float32(bound * bound))


def split_and_update(
    cfg: VoFODConfig, dyn: DynParams, grid_vals: Tensor, counts: Tensor,
    prev_bg_sufficient: Tensor, ops=DENSE,
) -> BackgroundOut:
    traced_r2 = None
    if cfg.dynamic_radii:
        radius, traced_r2 = traced_radius(cfg, dyn)
    else:
        radius = cfg.ground_points_max_distance / cfg.voxel_size

    # sticky, on the pre-update map, like the reference (:713-725)
    bg_mask = grid_vals > dyn.thr_new_obstacles
    n_bg = ops.gsum(bg_mask).to(torch.int32)
    bg_sufficient = prev_bg_sufficient | (
        n_bg > cfg.background_min_sufficient_pts
    )

    occupied = counts > 0
    if cfg.compat_hascloseto_bounds:
        # the reference's box [idx - ceil(r), idx + ceil(r)): at the shipped
        # integer radius (3.0) the +3 axis-extreme offsets are not searched
        bg_near = hascloseto_pool_any(bg_mask, radius)
    elif traced_r2 is not None:
        bg_near = ball_pool_max_traced(bg_mask.to(torch.int8), traced_r2, radius, fill=0) > 0
    else:
        bg_near = ops.pool_max(bg_mask.to(torch.int8), radius, fill=0) > 0
    seed = occupied & bg_near
    if traced_r2 is None:
        labels, close, cc_converged, cc_iters = ops.label_seeded(
            occupied, seed, radius, cfg.cc_sweeps)
    else:
        labels, close, cc_converged, cc_iters = label_components_seeded(
            occupied, seed, radius, cfg.cc_sweeps, traced_r2=traced_r2)
    # EMA point update (ref updateVoxel :789-795), far = occupied & ~close
    new_vals, far, n_occupied = point_ema(
        grid_vals, counts, close, float(dyn.score_point), float(dyn.score_unknown))
    n_occupied = ops.psum(n_occupied)
    return BackgroundOut(
        grid=new_vals,
        occupied=occupied,
        far=far,
        close=close,
        labels=labels,
        n_bg_voxels=n_bg,
        n_occupied=n_occupied,
        bg_sufficient=bg_sufficient,
        cc_converged=cc_converged,
        cc_iters=cc_iters,
    )
