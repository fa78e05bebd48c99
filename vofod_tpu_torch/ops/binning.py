"""Point-to-voxel binning: the VoxelGridWeighted analogue.

PyTorch counterpart of vofod_tpu/ops/binning.py ``point_fids`` /
``bin_points`` (ref src/voxel_grid_weighted.cpp:119-190: the per-scan
weighted downsample is exactly a histogram over the map lattice).  These are
the plain versions the frontend's fused CUDA kernel K3
(csrc/frontend_bin.cu) is held to; ``pipeline/frontend.py`` picks between
them by device.
"""

from __future__ import annotations

import torch

from vofod_tpu_torch.geometry import GridSpec

Tensor = torch.Tensor


def point_fids(grid: GridSpec, pts: Tensor, valid: Tensor) -> tuple[Tensor, Tensor]:
    """Clamped flat ids + in-bounds mask: (fid int32 [N], inb bool [N])."""
    ix, iy, iz = grid.coord_to_idx(pts)
    inb = grid.in_limits_idx(ix, iy, iz) & valid
    fid = grid.flat_id(
        ix.clamp(0, grid.nx - 1), iy.clamp(0, grid.ny - 1), iz.clamp(0, grid.nz - 1)
    )
    return fid, inb


def bin_points(grid: GridSpec, pts: Tensor, valid: Tensor) -> Tensor:
    """Histogram points into the voxel grid: int32 (nz, ny, nx) counts
    (integer index_add: exact in any order)."""
    fid, inb = point_fids(grid, pts, valid)
    counts = torch.zeros(grid.n_voxels, dtype=torch.int32, device=pts.device)
    counts.index_add_(0, fid.long(), inb.to(torch.int32))
    return counts.reshape(grid.shape)
