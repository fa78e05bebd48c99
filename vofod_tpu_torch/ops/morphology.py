"""Dense 3-D morphology over the voxel grid: Euclidean-ball pooling (K1).

PyTorch counterpart of vofod_tpu/ops/morphology.py ``ball_pool_min/max/sum``
(ref VoxelMap::hasCloseTo, src/voxel_map.cpp:376-400, and the Euclidean
cluster tolerance, vofod_nodelet.cpp:689-698, evaluated for every voxel)
and ``hascloseto_pool_any`` (the reference's exact hasCloseTo box, a K1 tap
set: :func:`hascloseto_taps`).

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


@functools.lru_cache(maxsize=None)
def hascloseto_taps(radius: float) -> np.ndarray:
    """The reference's hasCloseTo search (voxel_map.cpp:376-400) as a K1 tap
    list, int32 [n_taps, 3]: offsets in the box [-ceil(r), ceil(r)) on each
    axis with ||d||² <= r² + 1e-9.  The upper bound is EXCLUSIVE, so at an
    integer radius the +r axis-extreme offsets are missing (bug for bug);
    the box reaches -ceil(r), hence K1's halo is ceil(r), not floor(r)."""
    m = int(math.ceil(radius))
    r2 = radius * radius + 1e-9
    out = [(dz, dy, dx) for dz in range(-m, m) for dy in range(-m, m) for dx in range(-m, m)
           if dz * dz + dy * dy + dx * dx <= r2]
    return np.asarray(out, np.int32).reshape(-1, 3)


def tap_pool_plain(a: Tensor, taps: np.ndarray, op: str, fill: int) -> Tensor:
    """Plain version of K1 on an arbitrary tap list: out[v] = op over
    a[v + d] for the taps d (out-of-grid taps read ``fill``), one shifted
    slice per tap."""
    combine = _COMBINE[op]
    nz, ny, nx = a.shape
    h = int(np.abs(taps).max()) if len(taps) else 0
    pad = F.pad(a, (h, h, h, h, h, h), value=fill)
    out = None
    for dz, dy, dx in taps.tolist():
        s = pad[h + dz: h + dz + nz, h + dy: h + dy + ny, h + dx: h + dx + nx]
        out = s if out is None else combine(out, s)
    return out.contiguous()


def hascloseto_pool_any(mask: Tensor, radius: float) -> Tensor:
    """Reference-exact hasCloseTo for every voxel (vofod_tpu
    ``hascloseto_pool_any``): True where a ``mask`` voxel lies in the
    :func:`hascloseto_taps` box.  CUDA tensors: K1's int8 max with that tap
    set and halo ceil(r); CPU tensors: :func:`tap_pool_plain`."""
    taps = hascloseto_taps(radius)
    m8 = mask.to(torch.int8)
    if m8.is_cuda:
        return kernels.ball_pool(m8.contiguous(), taps, int(math.ceil(radius)), "max", 0) > 0
    if m8.device.type != "cpu":
        raise ValueError(f"hasCloseTo pool: unsupported device {m8.device}")
    return tap_pool_plain(m8, taps, "max", 0) > 0


def ball_pool_min(a: Tensor, radius: float, fill=None) -> Tensor:
    return ball_pool(a, radius, "min", INT_FILL["min"][a.dtype] if fill is None else fill)


def ball_pool_max(a: Tensor, radius: float, fill=None) -> Tensor:
    return ball_pool(a, radius, "max", INT_FILL["max"][a.dtype] if fill is None else fill)


def ball_pool_sum(a: Tensor, radius: float) -> Tensor:
    return ball_pool(a, radius, "sum", 0)
