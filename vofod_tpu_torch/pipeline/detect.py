"""Detection extraction: confidence submap score, covariance, pdet.

PyTorch counterpart of vofod_tpu/pipeline/detect.py ``extract_detections``
(ref extractDetections, vofod_nodelet.cpp:833-880) and of the dense
provider's ``submaps3`` (vofod_tpu/parallel/gridops.py:176-196): per
cluster a CSxCSxCS window around the inflated-AABB centre, the uncertainty
sum over the in-box voxels, exp(-uncertainty), detection probability,
covariance and ids.  On CUDA tensors all of it is the hand-written kernel
K10 (csrc/detect.cu), one block per cluster slot reading its window
straight from the grids; CPU tensors take :func:`detect_slots_plain`.

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
import torch.nn.functional as F

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.parallel.gridops import DENSE
from vofod_tpu_torch.pipeline.classify import CLS_MAV, ClassifyOut
from vofod_tpu_torch.pipeline.state import Detections

Tensor = torch.Tensor

_INT_MAX = 2**31 - 1


def submaps3(vals: Tensor, far: Tensor, labels: Tensor, ctr_i: Tensor, cs: int,
             z_lo: int = 0):
    """Per-cluster CS³ windows of (vals, far, labels) around integer centres
    ctr_i [K, 3] (x, y, z): window position a holds grid index
    ctr - CS//2 + a; out-of-grid reads give 0 / False / INT_MAX
    (ref getSubmapCopy, voxel_map.cpp:547-571).  The grids hold the z rows
    from ``z_lo`` on (a window outside them reads clamped rows)."""
    half = cs // 2
    pv = F.pad(vals, (half,) * 6, value=0.0)
    pf = F.pad(far, (half,) * 6, value=False)
    pl = F.pad(labels, (half,) * 6, value=_INT_MAX)
    r = torch.arange(cs, dtype=torch.int64, device=vals.device)
    # padded index = grid index + half = ctr + a
    xi = (ctr_i[:, 0].long()[:, None] + r)[:, None, None, :]
    yi = (ctr_i[:, 1].long()[:, None] + r)[:, None, :, None]
    zi = (ctr_i[:, 2].long()[:, None] - z_lo + r).clamp(0, pv.shape[0] - 1)[:, :, None, None]
    return pv[zi, yi, xi], pf[zi, yi, xi], pl[zi, yi, xi]


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


# threads per block of csrc/detect.cu: the window sum's order
_DET_T = 256


def _block_sum(x: Tensor) -> Tensor:
    """Row sums of x [K, n] in csrc/detect.cu's order: thread t adds
    x[t], x[t + 256], ... left to right, then a pairwise tree over the 256
    partial sums."""
    K, n = x.shape
    J = -(-n // _DET_T)
    parts = F.pad(x, (0, J * _DET_T - n)).reshape(K, J, _DET_T)
    acc = torch.zeros((K, _DET_T), dtype=x.dtype, device=x.device)
    for j in range(J):
        acc = acc + parts[:, j]
    s = _DET_T // 2
    while s > 0:
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


def detect_slots_plain(grid: GridSpec, cs: int, c: DetectConsts, grid_vals: Tensor,
                       far: Tensor, labels: Tensor, aabb_min: Tensor, aabb_max: Tensor,
                       reps: Tensor, n_points: Tensor, cluster_class: Tensor,
                       obb_center: Tensor, sensor_pos: Tensor, det_counter: Tensor,
                       window: tuple[int, int, int, int] | None = None):
    """Plain version of K10: (valid, ids, confidence, pdet, covariance,
    new det_counter) of the K cluster slots, every float op in the order
    csrc/detect.cu computes it (the window sum in its block order).
    ``window``: as kernels.detect's."""
    half = cs // 2
    _, z_lo, own0, own1 = (grid.nz, 0, 0, grid.nz) if window is None else window
    dev = grid_vals.device
    is_mav = cluster_class == CLS_MAV
    dd = obb_center - sensor_pos[None, :]
    dist = torch.sqrt((dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1]) + dd[:, 2] * dd[:, 2])

    # inflated (by 2) and clamped AABB index boxes (ref voxel_map.cpp:547-571)
    lo_i = torch.stack(grid.coord_to_idx(aabb_min), dim=-1)  # [K,3] (x,y,z)
    hi_i = torch.stack(grid.coord_to_idx(aabb_max), dim=-1)
    hi_lim = [grid.nx - 1, grid.ny - 1, grid.nz - 1]
    lo_i = torch.stack([torch.clamp(lo_i[:, a] - 2, 0, hi_lim[a]) for a in range(3)], -1)
    hi_i = torch.stack([torch.clamp(hi_i[:, a] + 2, 0, hi_lim[a]) for a in range(3)], -1)
    ctr_i = torch.div(lo_i + hi_i, 2, rounding_mode="floor")

    sub_vals, sub_far, sub_lab = submaps3(grid_vals, far, labels, ctr_i, cs, z_lo)

    r = torch.arange(cs, dtype=torch.int32, device=dev)
    ax = ctr_i[:, :, None] - half + r  # [K, 3, CS] absolute (x, y, z) indices
    inx = (ax[:, 0] >= lo_i[:, 0, None]) & (ax[:, 0] <= hi_i[:, 0, None])
    iny = (ax[:, 1] >= lo_i[:, 1, None]) & (ax[:, 1] <= hi_i[:, 1, None])
    inz = (ax[:, 2] >= lo_i[:, 2, None]) & (ax[:, 2] <= hi_i[:, 2, None])
    inbox = inz[:, :, None, None] & iny[:, None, :, None] & inx[:, None, None, :]
    member = sub_far & (sub_lab == reps[:, None, None, None])
    # member voxels count as free air (ref :855-860)
    v_eff = torch.where(member, c.score, sub_vals)
    contrib = torch.where(inbox, 1.0 - v_eff * c.inv_score, 0.0)
    n_pts = torch.clamp(n_points, min=1).to(torch.float32)
    unc = _block_sum(contrib.reshape(contrib.shape[0], -1)) / n_pts
    own = (ctr_i[:, 2] >= own0) & (ctr_i[:, 2] < own1)
    confidence = torch.where(is_mav & own, torch.exp(-unc), 0.0)

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
