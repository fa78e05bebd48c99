"""Dense 3-D morphology over the voxel grid: Euclidean-ball pooling (K1).

PyTorch counterpart of vofod_tpu/ops/morphology.py ``ball_pool_min/max/sum``
(ref VoxelMap::hasCloseTo, src/voxel_map.cpp:376-400, and the Euclidean
cluster tolerance, vofod_nodelet.cpp:689-698, evaluated for every voxel).

A CUDA tensor goes to the hand-written stencil (csrc/ball_pool.cu); a CPU
tensor takes the plain version below, which is the JAX decomposition (x
running pools shared across rows, then one shifted combine per (dz, dy)
row).  Integer pools are exact in any order, so both are bit-equal to JAX.

Grids are (nz, ny, nx); radii are in voxel units and may be fractional.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from vofod_tpu_torch import kernels

Tensor = torch.Tensor

INT_FILL = {
    "min": {torch.int8: 127, torch.int32: 2**31 - 1},
    "max": {torch.int8: -128, torch.int32: -(2**31)},
}


@functools.lru_cache(maxsize=None)
def ball_offsets(radius: float) -> tuple[tuple[int, int, int], ...]:
    """Integer offsets (dz, dy, dx) with ||d||₂ <= radius (inclusive)."""
    r = int(math.floor(radius))
    out = []
    r2 = radius * radius + 1e-9
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dz * dz + dy * dy + dx * dx <= r2:
                    out.append((dz, dy, dx))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def ball_taps(radius: float) -> np.ndarray:
    """The tap list the CUDA kernels take: int32 [n_taps, 3] (dz, dy, dx)."""
    return np.asarray(ball_offsets(radius), np.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def _ball_rows(radius: float) -> tuple[tuple[int, int, int], ...]:
    """(dz, dy, half_width_x) rows covering the ball."""
    r = int(math.floor(radius))
    r2 = radius * radius + 1e-9
    rows = []
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            rem = r2 - dz * dz - dy * dy
            if rem >= 0:
                rows.append((dz, dy, int(math.floor(math.sqrt(rem)))))
    return tuple(rows)


_COMBINE = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}


def ball_pool_plain(a: Tensor, radius: float, op: str, fill: int) -> Tensor:
    """Plain version: the JAX decomposition, out[v] = op over ball(radius)."""
    combine = _COMBINE[op]
    nz, ny, nx = a.shape
    rows = _ball_rows(radius)
    widths = sorted({w for _, _, w in rows})
    xpool = {0: a}
    max_w = widths[-1]
    if max_w > 0:
        pad = F.pad(a, (max_w, max_w), value=fill)
        prev = a
        for w in range(1, max_w + 1):
            lo = pad[:, :, max_w - w: max_w - w + nx]
            hi = pad[:, :, max_w + w: max_w + w + nx]
            prev = combine(combine(lo, prev), hi)
            if w in widths:
                xpool[w] = prev
    m = max(max(abs(dz), abs(dy)) for dz, dy, _ in rows)
    padded = {w: F.pad(xpool[w], (0, 0, m, m, m, m), value=fill) for w in widths}
    out = None
    for dz, dy, w in rows:
        s = padded[w][m + dz: m + dz + nz, m + dy: m + dy + ny, :]
        out = s if out is None else combine(out, s)
    return out.contiguous()


def ball_pool(a: Tensor, radius: float, op: str, fill: int) -> Tensor:
    if a.is_cuda:
        return kernels.ball_pool(
            a, ball_taps(radius), int(math.floor(radius)), op, fill
        )
    if a.device.type != "cpu":
        raise ValueError(f"ball pool: unsupported device {a.device}")
    return ball_pool_plain(a, radius, op, fill)


def ball_pool_min(a: Tensor, radius: float, fill=None) -> Tensor:
    return ball_pool(a, radius, "min", INT_FILL["min"][a.dtype] if fill is None else fill)


def ball_pool_max(a: Tensor, radius: float, fill=None) -> Tensor:
    return ball_pool(a, radius, "max", INT_FILL["max"][a.dtype] if fill is None else fill)


def ball_pool_sum(a: Tensor, radius: float) -> Tensor:
    return ball_pool(a, radius, "sum", 0)
