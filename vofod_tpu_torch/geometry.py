"""Grid geometry core: coordinate <-> index math, limits, SE(3) helpers.

PyTorch counterpart of vofod_tpu/geometry.py (ref src/voxel_map.cpp:592-619
coordToIdx/idxToCoord, :288-303 inLimits).  Grids are ``(nz, ny, nx)`` with
X fastest, and flat voxel ids are ``(z * ny + y) * nx + x`` — the JAX
layout, so the two packages' grids compare element for element.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

Tensor = torch.Tensor


def to_int32(x: Tensor) -> Tensor:
    """float -> int32 the way XLA converts: NaN -> 0, out-of-range values
    saturate (a plain ``.to(torch.int32)`` of those is undefined)."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0**31, neginf=-(2.0**31))
    return x.clamp(-(2.0**31), 2.0**31 - 128).to(torch.int32)


@dataclass(frozen=True)
class GridSpec:
    """Static description of the dense voxel grid (hashable)."""

    origin: tuple[float, float, float]  # world coords of the low corner of voxel 0,0,0
    shape: tuple[int, int, int]  # (nz, ny, nx)
    voxel_size: float

    @staticmethod
    def from_config(cfg) -> "GridSpec":
        return GridSpec(cfg.grid_origin, cfg.grid_shape, cfg.voxel_size)

    @property
    def nz(self) -> int:
        return self.shape[0]

    @property
    def ny(self) -> int:
        return self.shape[1]

    @property
    def nx(self) -> int:
        return self.shape[2]

    @property
    def n_voxels(self) -> int:
        return self.nz * self.ny * self.nx

    @property
    def inv_voxel(self) -> float:
        return 1.0 / self.voxel_size

    # -- coordinate math (element-wise, on any device) ------------------------
    def coord_to_idx(self, xyz: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """World coords [..., 3] -> int32 voxel indices (ix, iy, iz):
        ``floor((coord - origin) / voxel)`` in float32 (ref voxel_map.cpp:592-599).
        Indices may lie outside the grid; combine with :meth:`in_limits_idx`."""
        ox, oy, oz = self.origin
        inv = self.inv_voxel
        ix = to_int32(torch.floor((xyz[..., 0] - ox) * inv))
        iy = to_int32(torch.floor((xyz[..., 1] - oy) * inv))
        iz = to_int32(torch.floor((xyz[..., 2] - oz) * inv))
        return ix, iy, iz

    def idx_to_coord(self, ix: Tensor, iy: Tensor, iz: Tensor) -> Tensor:
        """Voxel indices -> world coords of the voxel *center*
        (ref voxel_map.cpp:607-613: ``(idx + 0.5) * voxel + origin``)."""
        ox, oy, oz = self.origin
        vs = self.voxel_size
        x = (ix.to(torch.float32) + 0.5) * vs + ox
        y = (iy.to(torch.float32) + 0.5) * vs + oy
        z = (iz.to(torch.float32) + 0.5) * vs + oz
        return torch.stack([x, y, z], dim=-1)

    def in_limits_idx(self, ix: Tensor, iy: Tensor, iz: Tensor) -> Tensor:
        return (
            (ix >= 0) & (ix < self.nx) & (iy >= 0) & (iy < self.ny)
            & (iz >= 0) & (iz < self.nz)
        )

    def in_limits_host(self, xyz: np.ndarray) -> bool:
        """Whether one host point lies in the grid, with the float32 math of
        :meth:`coord_to_idx` — the step's raycast predicate reads it without
        a device sync."""
        p = np.asarray(xyz, np.float32)
        o = np.asarray(self.origin, np.float32)
        with np.errstate(invalid="ignore"):
            f = np.floor((p - o) * np.float32(self.inv_voxel))
        n = np.array([self.nx, self.ny, self.nz], np.float32)
        return bool(np.all((f >= 0) & (f < n)))

    def flat_id(self, ix: Tensor, iy: Tensor, iz: Tensor) -> Tensor:
        """Flat voxel id for (z, y, x)-ordered grids."""
        return (iz * self.ny + iy) * self.nx + ix

    def unflatten_id(self, fid: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        ix = fid % self.nx
        rem = fid // self.nx
        iy = rem % self.ny
        iz = rem // self.ny
        return ix, iy, iz


def se3_apply(T: Tensor, pts: Tensor) -> Tensor:
    """Apply a 4x4 transform to points [..., 3]:
    ``p'_a = ((R_a0 x + R_a1 y) + R_a2 z) + t_a``, elementwise in this fixed
    order (no matrix product, so no FMA or blocked summation): the frontend
    kernel (csrc/frontend_bin.cu) computes exactly these float32 roundings."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    out = [
        ((T[a, 0] * x + T[a, 1] * y) + T[a, 2] * z) + T[a, 3] for a in range(3)
    ]
    return torch.stack(out, dim=-1)


def box_mask(pts: Tensor, lo, hi) -> Tensor:
    """Points [..., 3] inside the closed AABB [lo, hi] (PCL CropBox semantics,
    ref vofod_nodelet.cpp:626-655); lo/hi are rounded to float32 as in JAX
    and compared as host scalars (no upload)."""
    lo = [float(v) for v in np.asarray(lo, np.float32)]
    hi = [float(v) for v in np.asarray(hi, np.float32)]
    out = None
    for a in range(3):
        m = (pts[..., a] >= lo[a]) & (pts[..., a] <= hi[a])
        out = m if out is None else out & m
    return out


def yaw_rotation(yaw_rad: float) -> np.ndarray:
    c, s = np.cos(yaw_rad), np.sin(yaw_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=np.float32)
