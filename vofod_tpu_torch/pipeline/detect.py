"""Detection extraction: confidence submap score, covariance, pdet.

PyTorch counterpart of vofod_tpu/pipeline/detect.py ``extract_detections``
(ref extractDetections, vofod_nodelet.cpp:833-880) and of the dense
provider's ``submaps3`` (vofod_tpu/parallel/gridops.py:176-196), here a
plain function: per cluster a CSxCSxCS window around the inflated-AABB
centre, the uncertainty sum over the in-box voxels, exp(-uncertainty).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.pipeline.classify import CLS_MAV, ClassifyOut
from vofod_tpu_torch.pipeline.state import Detections

Tensor = torch.Tensor

_INT_MAX = 2**31 - 1


def submaps3(vals: Tensor, far: Tensor, labels: Tensor, ctr_i: Tensor, cs: int):
    """Per-cluster CS³ windows of (vals, far, labels) around integer centres
    ctr_i [K, 3] (x, y, z): window position a holds grid index
    ctr - CS//2 + a; out-of-grid reads give 0 / False / INT_MAX
    (ref getSubmapCopy, voxel_map.cpp:547-571)."""
    half = cs // 2
    pv = F.pad(vals, (half,) * 6, value=0.0)
    pf = F.pad(far, (half,) * 6, value=False)
    pl = F.pad(labels, (half,) * 6, value=_INT_MAX)
    r = torch.arange(cs, dtype=torch.int64, device=vals.device)
    # padded index = grid index + half = ctr + a
    xi = (ctr_i[:, 0].long()[:, None] + r)[:, None, None, :]
    yi = (ctr_i[:, 1].long()[:, None] + r)[:, None, :, None]
    zi = (ctr_i[:, 2].long()[:, None] + r)[:, :, None, None]
    return pv[zi, yi, xi], pf[zi, yi, xi], pl[zi, yi, xi]


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
) -> tuple[Detections, Tensor]:
    CS = cfg.confidence_submap
    half = CS // 2
    dev = grid_vals.device

    is_mav = cls_out.cluster_class == CLS_MAV
    dist = torch.linalg.vector_norm(cls_out.obb_center - sensor_pos[None, :], dim=-1)

    # inflated (by 2) and clamped AABB index boxes (ref voxel_map.cpp:547-571)
    lo_i = torch.stack(grid.coord_to_idx(cls_out.aabb_min), dim=-1)  # [K,3] (x,y,z)
    hi_i = torch.stack(grid.coord_to_idx(cls_out.aabb_max), dim=-1)
    hi_lim = [grid.nx - 1, grid.ny - 1, grid.nz - 1]
    lo_i = torch.stack([torch.clamp(lo_i[:, a] - 2, 0, hi_lim[a]) for a in range(3)], -1)
    hi_i = torch.stack([torch.clamp(hi_i[:, a] + 2, 0, hi_lim[a]) for a in range(3)], -1)
    ctr_i = torch.div(lo_i + hi_i, 2, rounding_mode="floor")

    sub_vals, sub_far, sub_lab = submaps3(grid_vals, far, labels, ctr_i, CS)

    r = torch.arange(CS, dtype=torch.int32, device=dev)
    ax = ctr_i[:, :, None] - half + r  # [K, 3, CS] absolute (x, y, z) indices
    inx = (ax[:, 0] >= lo_i[:, 0, None]) & (ax[:, 0] <= hi_i[:, 0, None])
    iny = (ax[:, 1] >= lo_i[:, 1, None]) & (ax[:, 1] <= hi_i[:, 1, None])
    inz = (ax[:, 2] >= lo_i[:, 2, None]) & (ax[:, 2] <= hi_i[:, 2, None])
    inbox = inz[:, :, None, None] & iny[:, None, :, None] & inx[:, None, None, :]
    member = sub_far & (sub_lab == cls_out.reps[:, None, None, None])
    # member voxels count as free air (ref :855-860)
    v_eff = torch.where(member, float(dyn.score_ray), sub_vals)
    contrib = torch.where(inbox, 1.0 - v_eff / float(dyn.score_ray), 0.0)
    n_pts = torch.clamp(cls_out.n_points, min=1).to(torch.float32)
    unc = contrib.reshape(contrib.shape[0], -1).sum(dim=1) / n_pts
    confidence = torch.where(is_mav, torch.exp(-unc), 0.0)

    # detection probability (ref :869-874)
    vres = cfg.sensor.vertical_fov / cfg.sensor.vertical_rays
    hres = 2.0 * math.pi / cfg.sensor.horizontal_rays
    ang = torch.arctan(1.0 / torch.clamp(dist, min=1e-6))
    pdet_v = torch.clamp(ang / float(np.float32(vres) * np.float32(dyn.cls_min_points)), max=1.0)
    pdet_h = torch.clamp(ang / hres, max=1.0)
    pdet = pdet_v * pdet_h

    # covariance (ref :849)
    sigma = torch.sqrt(torch.clamp(dist, min=0.0)) * float(dyn.output_position_sigma)
    cov = sigma[:, None, None] * torch.eye(3, device=dev)[None, :, :]

    # ids: monotonic counter over valid detections (ref :845)
    mav_i = is_mav.to(torch.int32)
    order = torch.cumsum(mav_i, 0, dtype=torch.int32) - 1
    ids = det_counter + torch.where(is_mav, order, 0)
    new_counter = det_counter + mav_i.sum().to(torch.int32)

    dets = Detections(
        valid=is_mav,
        id=ids.to(torch.int32),
        position=cls_out.obb_center,
        covariance=cov,
        n_points=cls_out.n_points,
        confidence=confidence,
        detection_probability=torch.where(is_mav, pdet, 0.0),
        aabb_min=cls_out.aabb_min,
        aabb_max=cls_out.aabb_max,
        cluster_class=cls_out.cluster_class,
        obb_center=cls_out.obb_center,
        obb_extent=cls_out.obb_extent,
        obb_axes=cls_out.obb_axes,
    )
    return dets, new_counter
