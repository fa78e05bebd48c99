"""Detection extraction: confidence submap score, covariance, pdet.

PyTorch counterpart of vofod_tpu/pipeline/detect.py ``extract_detections``
(ref extractDetections, vofod_nodelet.cpp:833-880) and of the dense
provider's ``submaps3`` (vofod_tpu/parallel/gridops.py:176-196): per
cluster a CSxCSxCS window around the inflated-AABB centre, the uncertainty
sum over the in-box voxels, exp(-uncertainty), detection probability,
covariance and ids.  On CUDA tensors all of it is the hand-written kernel
K10 (csrc/detect.cu), one block per cluster slot, which reads the box ∩
window of the slots that keep a confidence straight from the grids; CPU
tensors take :func:`detect_slots_plain`.

On the grid-sharded step (``ops`` a parallel/gridops.ZShardOps) K10 reads
each shard's slab extended by the window's half width, and each slot's
confidence comes from the shard holding its window centre, the others
giving 0 before the sum over the shards (``window``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.parallel.gridops import DENSE
from vofod_tpu_torch.pipeline.classify import CLS_MAV, ClassifyOut
from vofod_tpu_torch.pipeline.state import Detections

Tensor = torch.Tensor

_INT_MAX = 2**31 - 1


class DetectConsts(NamedTuple):
    """K10's float32 constants, each rounded as the plain version's tensor
    op rounds it (division by a constant is a multiply by its float32
    reciprocal on every device, as PyTorch's CUDA division does)."""

    score: float  # score_ray: member voxels count as free air
    inv_score: float  # 1 / score_ray
    inv_v: float  # 1 / (vertical resolution x cls_min_points)
    inv_h: float  # 1 / horizontal resolution
    sigma: float  # output_position_sigma

    @staticmethod
    def make(cfg: VoFODConfig, dyn: DynParams) -> "DetectConsts":
        f32 = np.float32
        vres = cfg.sensor.vertical_fov / cfg.sensor.vertical_rays
        hres = 2.0 * math.pi / cfg.sensor.horizontal_rays
        return DetectConsts(
            float(f32(dyn.score_ray)), float(f32(1.0) / f32(dyn.score_ray)),
            float(f32(1.0) / (f32(vres) * f32(dyn.cls_min_points))),
            float(f32(1.0) / f32(hres)), float(f32(dyn.output_position_sigma)),
        )


# csrc/detect.cu DET_WARPS: the warps of a slot's block, which set the
# order of its window sum (kernels.detect_geometry reads the kernel's)
DET_WARPS = 4


def window_sums_plain(lo_i: Tensor, hi_i: Tensor, ctr_i: Tensor, cs: int, grid_shape,
                      vals: Tensor, far: Tensor, labels: Tensor, reps: Tensor,
                      c: "DetectConsts", reading: Tensor, z_lo: int = 0) -> Tensor:
    """[K] float32: each slot's uncertainty sum over its box ∩ CS³ window
    (lo_i, hi_i, ctr_i: [K, 3] (x, y, z) indices), in the order
    csrc/detect.cu adds it; 0 for the slots that do not read (``reading``
    False).  A row (z, y) of the box ∩ window takes P lanes (the power of
    two at or above its width, at most 32), so a warp covers 32 / P rows a
    step and the block's DET_WARPS warps cover DET_WARPS x 32 / P rows;
    thread (w, lane) adds its voxels left to right (rows in steps, the row's
    x chunks of P within each), then a shuffle tree in each warp (lane l +=
    lane l + 16, + 8, ...) and the same tree over the warps' sums.  Voxels
    outside the grids' rows [z_lo, z_lo + rows) read the fills 0 / False /
    INT_MAX; member voxels (far, the slot's label) count as free air."""
    nz, ny, nx = grid_shape
    dev = vals.device
    K = lo_i.shape[0]
    half = cs // 2
    ws = ctr_i - half
    b0 = torch.maximum(lo_i, ws)
    nw = torch.clamp(torch.minimum(hi_i, ws + cs - 1) - b0 + 1, min=0)
    nw = torch.where(reading[:, None], nw, 0)
    nxw, nyw, nzw = nw[:, 0], nw[:, 1], nw[:, 2]
    R = nyw * nzw
    P = torch.ones_like(nxw)  # lanes a row: the power of two at or above its width, <= 32
    for _ in range(5):
        P = torch.where(P < nxw, P * 2, P)
    G = 32 // P
    C = (nxw + P - 1) // P
    n_items = int((((R + DET_WARPS * G - 1) // (DET_WARPS * G)) * C).max()) if K else 0
    if n_items == 0:
        return torch.zeros(K, dtype=torch.float32, device=dev)
    n_rows = int(((R + DET_WARPS * G - 1) // (DET_WARPS * G)).max())
    n_chunks = int(C.max())
    t = torch.arange(32 * DET_WARPS, device=dev)
    w, lane = t // 32, t % 32
    s, xo = lane[None, :] // P[:, None], lane[None, :] % P[:, None]  # [K, T]
    i = torch.arange(n_rows, device=dev)[None, None, :, None]
    ch = torch.arange(n_chunks, device=dev)[None, None, None, :]
    r = (i * DET_WARPS + w[None, :, None, None]) * G[:, None, None, None] + s[:, :, None, None]
    xoff = ch * P[:, None, None, None] + xo[:, :, None, None]
    valid = (r < R[:, None, None, None]) & (xoff < nxw[:, None, None, None])
    rows_y = torch.clamp(nyw, min=1)[:, None, None, None]
    gz = b0[:, 2, None, None, None] + r // rows_y
    gy = b0[:, 1, None, None, None] + r % rows_y
    gx = b0[:, 0, None, None, None] + xoff
    lz = gz - z_lo
    inside = (valid & (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny) & (gz >= 0) & (gz < nz)
              & (lz >= 0) & (lz < vals.shape[0]))
    g = torch.where(inside, (lz * ny + gy) * nx + gx, 0).long()
    v = torch.where(inside, vals.reshape(-1)[g], 0.0)
    member = inside & far.reshape(-1)[g] & (labels.reshape(-1)[g] == reps[:, None, None, None])
    v_eff = torch.where(member, c.score, v)  # members count as free air (ref :855-860)
    contrib = torch.where(valid, 1.0 - v_eff * c.inv_score, 0.0).reshape(K, 32 * DET_WARPS, -1)
    acc = torch.zeros((K, 32 * DET_WARPS), dtype=torch.float32, device=dev)
    for j in range(contrib.shape[2]):
        acc = acc + contrib[:, :, j]
    acc = acc.reshape(K, DET_WARPS, 32)
    for h in (16, 8, 4, 2, 1):
        acc = acc[..., :h] + acc[..., h:2 * h]
    acc = acc[..., 0]
    h = DET_WARPS // 2
    while h > 0:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


def detect_boxes(grid: GridSpec, aabb_min: Tensor, aabb_max: Tensor):
    """(lo, hi, ctr) int32 [K, 3] (x, y, z): each slot's AABB as voxel
    indices inflated by 2 and clamped to the grid, and its window centre
    (ref voxel_map.cpp:547-571)."""
    lo_i = torch.stack(grid.coord_to_idx(aabb_min), dim=-1)
    hi_i = torch.stack(grid.coord_to_idx(aabb_max), dim=-1)
    hi_lim = [grid.nx - 1, grid.ny - 1, grid.nz - 1]
    lo_i = torch.stack([torch.clamp(lo_i[:, a] - 2, 0, hi_lim[a]) for a in range(3)], -1)
    hi_i = torch.stack([torch.clamp(hi_i[:, a] + 2, 0, hi_lim[a]) for a in range(3)], -1)
    return lo_i, hi_i, torch.div(lo_i + hi_i, 2, rounding_mode="floor")


def detect_slots_plain(grid: GridSpec, cs: int, c: DetectConsts, grid_vals: Tensor,
                       far: Tensor, labels: Tensor, aabb_min: Tensor, aabb_max: Tensor,
                       reps: Tensor, n_points: Tensor, cluster_class: Tensor,
                       obb_center: Tensor, sensor_pos: Tensor, det_counter: Tensor,
                       window: tuple[int, int, int, int] | None = None):
    """Plain version of K10: (valid, ids, confidence, pdet, covariance,
    new det_counter) of the K cluster slots, every float op in the order
    csrc/detect.cu computes it (the window sum in its order,
    :func:`window_sums_plain`).  Only a mav slot centred in the owned rows
    keeps a confidence, so only those read a window.  ``window``: as
    kernels.detect's."""
    _, z_lo, own0, own1 = (grid.nz, 0, 0, grid.nz) if window is None else window
    dev = grid_vals.device
    is_mav = cluster_class == CLS_MAV
    dd = obb_center - sensor_pos[None, :]
    dist = torch.sqrt((dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1]) + dd[:, 2] * dd[:, 2])

    lo_i, hi_i, ctr_i = detect_boxes(grid, aabb_min, aabb_max)
    keep = is_mav & (ctr_i[:, 2] >= own0) & (ctr_i[:, 2] < own1)
    n_pts = torch.clamp(n_points, min=1).to(torch.float32)
    unc = window_sums_plain(lo_i, hi_i, ctr_i, cs, grid.shape, grid_vals, far, labels, reps,
                            c, keep, z_lo) / n_pts
    confidence = torch.where(keep, torch.exp(-unc), 0.0)

    # detection probability (ref :869-874)
    ang = torch.arctan(torch.reciprocal(torch.clamp(dist, min=1e-6)))
    pdet = torch.clamp(ang * c.inv_v, max=1.0) * torch.clamp(ang * c.inv_h, max=1.0)

    # covariance (ref :849)
    sigma = torch.sqrt(torch.clamp(dist, min=0.0)) * c.sigma
    cov = sigma[:, None, None] * torch.eye(3, device=dev)[None, :, :]

    # ids: monotonic counter over valid detections (ref :845)
    mav_i = is_mav.to(torch.int32)
    order = torch.cumsum(mav_i, 0, dtype=torch.int32) - 1
    ids = (det_counter + torch.where(is_mav, order, 0)).to(torch.int32)
    new_counter = det_counter + mav_i.sum().to(torch.int32)
    return is_mav, ids, confidence, torch.where(is_mav, pdet, 0.0), cov, new_counter


def detect_slots(grid: GridSpec, cs: int, c: DetectConsts, grid_vals: Tensor, far: Tensor,
                 labels: Tensor, aabb_min: Tensor, aabb_max: Tensor, reps: Tensor,
                 n_points: Tensor, cluster_class: Tensor, obb_center: Tensor,
                 sensor_pos: Tensor, det_counter: Tensor,
                 window: tuple[int, int, int, int] | None = None):
    """K10; ``window`` (nz, z_lo, own_z0, own_z1): the grids hold the rows
    [z_lo, z_lo + rows) of the nz-row grid, and only the slots centred in
    [own_z0, own_z1) get their confidence (default: the whole grid)."""
    if grid_vals.is_cuda:
        return kernels.detect(
            grid_vals, far, labels, aabb_min, aabb_max, reps, n_points, cluster_class,
            obb_center, sensor_pos.contiguous(), det_counter, cs, grid.origin,
            grid.inv_voxel, c, window)
    if grid_vals.device.type != "cpu":
        raise ValueError(f"detect: unsupported device {grid_vals.device}")
    return detect_slots_plain(grid, cs, c, grid_vals, far, labels, aabb_min, aabb_max, reps,
                              n_points, cluster_class, obb_center, sensor_pos, det_counter,
                              window)


def extract_detections(
    cfg: VoFODConfig,
    dyn: DynParams,
    grid: GridSpec,
    grid_vals: Tensor,
    labels: Tensor,
    far: Tensor,
    cls_out: ClassifyOut,
    sensor_pos: Tensor,
    det_counter: Tensor,
    ops=DENSE,
) -> tuple[Detections, Tensor]:
    cs = cfg.confidence_submap
    (vals_w, far_w, labels_w), window = ops.halo_window(
        (grid_vals, far, labels), (0.0, False, _INT_MAX), cs - cs // 2, grid.nz)
    valid, ids, confidence, pdet, cov, new_counter = detect_slots(
        grid, cs, DetectConsts.make(cfg, dyn), vals_w, far_w, labels_w,
        cls_out.aabb_min, cls_out.aabb_max, cls_out.reps, cls_out.n_points,
        cls_out.cluster_class, cls_out.obb_center, sensor_pos, det_counter, window,
    )
    confidence = ops.psum(confidence)  # the slots' shards' values, 0 elsewhere
    dets = Detections(
        valid=valid,
        id=ids,
        position=cls_out.obb_center,
        covariance=cov,
        n_points=cls_out.n_points,
        confidence=confidence,
        detection_probability=pdet,
        aabb_min=cls_out.aabb_min,
        aabb_max=cls_out.aabb_max,
        cluster_class=cls_out.cluster_class,
        obb_center=cls_out.obb_center,
        obb_extent=cls_out.obb_extent,
        obb_axes=cls_out.obb_axes,
    )
    return dets, new_counter
