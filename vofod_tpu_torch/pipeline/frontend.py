"""Scan frontend: range image -> world points -> masks -> count grids (K3).

PyTorch counterpart of vofod_tpu/pipeline/frontend.py ``run_frontend`` (ref
filterAndTransform, vofod_nodelet.cpp:619-686).  The per-pixel front half —
range x LUT + offset, the exclude box in the sensor frame, the pose, the
operation-area crop, the clamped flat id and the histogram — is the fused
CUDA kernel K3 (csrc/frontend_bin.cu) for CUDA tensors and
:func:`frontend_bin_plain` for CPU tensors.  Both return the per-pixel
own-airframe mask and flat ids; the first 4096 airframe hits in pixel
order, compacted by K6, then become raycast blockers (frontend.py:61-77).

:func:`run_frontend_prebinned` is the device half of the prebinned ingest
(vofod_tpu ``run_frontend_prebinned``): the host binned the scan
(io/binner.py), and the device unpacks the uint8 grid with K15a
(csrc/unpack.cu) for CUDA tensors, :func:`unpack_plain` for CPU ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import VoFODConfig
from vofod_tpu_torch.geometry import GridSpec, box_mask, se3_apply
from vofod_tpu_torch.ops.binning import bin_points, point_fids
from vofod_tpu_torch.ops.compaction import masked_compact
from vofod_tpu_torch.sensor import RANGE_TO_METERS

Tensor = torch.Tensor

# capacity for compacted own-airframe returns (a real airframe subtends a
# few thousand pixels at most)
_MAX_EXCLUDE_HITS = 4096


@dataclass
class FrontendOut:
    counts: Tensor  # int32 (nz, ny, nx) — filtered weighted downsample
    blockers: Tensor  # bool (nz, ny, nx) — all returns (raycast opacity)
    n_valid_points: Tensor  # int32 — points surviving the filters
    n_exclude_hits: Tensor  # int32 — own-airframe returns (cap overflow check)


def frontend_bin_plain(cfg: VoFODConfig, grid: GridSpec, lut_dirs: Tensor,
                       lut_offs: Tensor, ranges_mm: Tensor, pose: Tensor):
    """Plain version of K3: (counts, n_valid, excl [N] bool, fid [N] int32)."""
    r = ranges_mm.to(torch.float32) * RANGE_TO_METERS
    has_return = r > 0
    pts_sensor = lut_dirs * r[:, None] + lut_offs
    in_exclude = box_mask(pts_sensor, cfg.exclude_box.lo, cfg.exclude_box.hi)
    pts_world = se3_apply(pose, pts_sensor)
    in_oparea = box_mask(pts_world, cfg.oparea.lo, cfg.oparea.hi)
    valid = has_return & ~in_exclude & in_oparea
    counts = bin_points(grid, pts_world, valid)
    fid, _ = point_fids(grid, pts_world, valid)
    excl = has_return & in_oparea & in_exclude
    return counts, valid.sum().to(torch.int32), excl, fid


def _frontend_boxes(cfg: VoFODConfig, grid: GridSpec) -> np.ndarray:
    return np.concatenate(
        [cfg.exclude_box.lo, cfg.exclude_box.hi, cfg.oparea.lo, cfg.oparea.hi,
         grid.origin]
    ).astype(np.float32)


def frontend_bin(cfg: VoFODConfig, grid: GridSpec, lut_dirs: Tensor,
                 lut_offs: Tensor, ranges_mm: Tensor, pose: Tensor):
    if ranges_mm.is_cuda:
        return kernels.frontend_bin(
            ranges_mm, lut_dirs, lut_offs, pose, _frontend_boxes(cfg, grid),
            grid.inv_voxel, RANGE_TO_METERS, grid.shape,
        )
    if ranges_mm.device.type != "cpu":
        raise ValueError(f"frontend: unsupported device {ranges_mm.device}")
    return frontend_bin_plain(cfg, grid, lut_dirs, lut_offs, ranges_mm, pose)


def run_frontend(
    cfg: VoFODConfig,
    grid: GridSpec,
    lut_dirs: Tensor,  # float32 [N, 3] (device-resident constant)
    lut_offs: Tensor,  # float32 [N, 3]
    ranges_mm: Tensor,  # float32 [N]
    pose: Tensor,  # float32 [4, 4]
) -> FrontendOut:
    counts, n_valid, excl, fid = frontend_bin(
        cfg, grid, lut_dirs, lut_offs, ranges_mm, pose
    )
    # raycast opacity: any return inside the grid, own-airframe hits
    # included (they truncate rays in the reference too, :1455); the first
    # _MAX_EXCLUDE_HITS in pixel order are scattered, overflow is flagged
    eids, evalid, etotal = masked_compact(excl, _MAX_EXCLUDE_HITS)
    efid = fid[eids.long()]
    excl_counts = torch.zeros(grid.n_voxels, dtype=torch.int32, device=counts.device)
    excl_counts.index_add_(0, efid.long(), evalid.to(torch.int32))
    blockers = (counts > 0) | (excl_counts.reshape(grid.shape) > 0)
    return FrontendOut(
        counts=counts,
        blockers=blockers,
        n_valid_points=n_valid,
        n_exclude_hits=etotal,
    )


def unpack_plain(packed: Tensor) -> tuple[Tensor, Tensor]:
    """Plain version of K15a: (counts = packed & 0x3F as int32, blockers =
    packed >= 0x80)."""
    return (packed & 0x3F).to(torch.int32), packed >= 0x80


def unpack(packed: Tensor) -> tuple[Tensor, Tensor]:
    if packed.is_cuda:
        return kernels.unpack(packed.contiguous())
    if packed.device.type != "cpu":
        raise ValueError(f"unpack: unsupported device {packed.device}")
    return unpack_plain(packed)


def run_frontend_prebinned(scan) -> FrontendOut:
    """The frontend of a host-binned ``PrebinnedScan`` (pipeline/state.py).

    Equal to :func:`run_frontend` on the same scan (vofod_tpu
    frontend.py:99-103): the 6-bit count clamp matches the point EMA's own
    clamp at 63, and the blocker bit covers every own-airframe hit, with no
    counterpart of the raw path's 4,096-hit compaction cap."""
    counts, blockers = unpack(scan.packed)
    return FrontendOut(counts=counts, blockers=blockers, n_valid_points=scan.stats[0],
                       n_exclude_hits=scan.stats[1])
