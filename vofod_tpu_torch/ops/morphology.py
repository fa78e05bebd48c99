"""Dense 3-D morphology over the voxel grid: Euclidean-ball pooling (K1, K14).

PyTorch counterpart of vofod_tpu/ops/morphology.py ``ball_pool_min/max/sum``
(ref VoxelMap::hasCloseTo, src/voxel_map.cpp:376-400, and the Euclidean
cluster tolerance, vofod_nodelet.cpp:689-698, evaluated for every voxel),
``hascloseto_pool_any`` (the reference's exact hasCloseTo box, a K1 tap
set: :func:`hascloseto_taps`) and ``ball_pool_{min,max,sum}_traced`` (K14,
the live-tunable radii of ``cfg.dynamic_radii``: the shells of a static
bound kept by a runtime r², another K1 tap set: :func:`shell_taps`).

A "ball" below is a radius (the static ball of :func:`ball_offsets`), the
:class:`Shells` of a traced-radius pool, or a tap set, int32 [n_taps, 3].
The CUDA kernels take any tap set within halo 7 (radius < 8 voxels, at
most 2,103 taps); past that they raise.

A CUDA tensor goes to the hand-written stencil (csrc/ball_pool.cu); a CPU
tensor takes the plain version below, which is the JAX decomposition (x
running pools shared across rows, then one shifted combine per (dz, dy)
row).  Integer pools are exact in any order, so both are bit-equal to JAX.

Grids are (nz, ny, nx); radii are in voxel units and may be fractional.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

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


def tap_set(ball) -> tuple[np.ndarray, int]:
    """(taps, halo) the kernels take for a ball: a radius gives its static
    ball and halo floor(radius); shells and tap sets their largest
    |offset|."""
    if isinstance(ball, Shells):
        ball = ball.taps
    if isinstance(ball, np.ndarray):
        return ball, int(np.abs(ball).max())
    return ball_taps(ball), int(math.floor(ball))


def pool_plain(a: Tensor, ball, op: str, fill: int) -> Tensor:
    """Plain version of K1 on a ball: a radius and the shells of a traced
    pool take the JAX decomposition (the shells at their equivalent
    radius), a tap set one shifted slice per tap."""
    if isinstance(ball, np.ndarray):
        return tap_pool_plain(a, ball, op, fill)
    if isinstance(ball, Shells):
        ball = ball.radius
    return ball_pool_plain(a, ball, op, fill)


def ball_pool(a: Tensor, ball, op: str, fill: int) -> Tensor:
    """K1: out[v] = op over ``ball`` (a radius, traced shells or a tap set)
    of a."""
    if a.is_cuda:
        return kernels.ball_pool(a, *tap_set(ball), op, fill)
    if a.device.type != "cpu":
        raise ValueError(f"ball pool: unsupported device {a.device}")
    return pool_plain(a, ball, op, fill)


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
    return ball_pool(mask.to(torch.int8).contiguous(), hascloseto_taps(radius), "max", 0) > 0


def ball_pool_min(a: Tensor, radius: float, fill=None) -> Tensor:
    return ball_pool(a, radius, "min", INT_FILL["min"][a.dtype] if fill is None else fill)


def ball_pool_max(a: Tensor, radius: float, fill=None) -> Tensor:
    return ball_pool(a, radius, "max", INT_FILL["max"][a.dtype] if fill is None else fill)


def ball_pool_sum(a: Tensor, radius: float) -> Tensor:
    return ball_pool(a, radius, "sum", 0)


@functools.lru_cache(maxsize=None)
def ball_shells(bound: float) -> tuple[tuple[int, tuple], ...]:
    """Offsets within ``bound`` grouped into shells of equal squared index
    distance, ascending: ((r2, ((dz, dy, dx), ...)), ...) (vofod_tpu
    ``ball_shells``)."""
    shells: dict[int, list] = {}
    for o in ball_offsets(bound):
        shells.setdefault(o[0] * o[0] + o[1] * o[1] + o[2] * o[2], []).append(o)
    return tuple((r2, tuple(offs)) for r2, offs in sorted(shells.items()))


@functools.lru_cache(maxsize=None)
def shell_taps(bound: float, r2: float) -> np.ndarray:
    """The tap set of a traced-radius pool (vofod_tpu ``_ball_pool_traced``):
    shell 0 and every shell of ``bound`` with ``float32(r2_shell) <= r2``,
    int32 [n_taps, 3].  ``r2`` is the squared radius in index units as the
    JAX step computes it in float32 (the callers round it so on the host);
    the JAX pool compares each shell with it under a ``where``."""
    r2 = np.float32(r2)
    out = [o for r2s, offs in ball_shells(bound) if r2s == 0 or np.float32(r2s) <= r2
           for o in offs]
    return np.asarray(out, np.int32).reshape(-1, 3)


@dataclass(frozen=True)
class Shells:
    """The ball of a traced-radius pool: the shells of the static ``bound``
    (index units) kept by the runtime squared radius ``r2``."""

    bound: float
    r2: float

    @property
    def taps(self) -> np.ndarray:
        """The kernels' tap set (:func:`shell_taps`)."""
        return shell_taps(self.bound, self.r2)

    @property
    def radius(self) -> float:
        """A radius whose static ball is the same set: the kept shells are
        all the integer squared distances up to min(r2, the bound's last)."""
        last = ball_shells(self.bound)[-1][0]
        return math.sqrt(min(math.floor(np.float32(self.r2)), last))


def ball_pool_max_traced(a: Tensor, r2: float, bound: float, fill=None) -> Tensor:
    return shell_pool(a, r2, bound, "max", INT_FILL["max"][a.dtype] if fill is None else fill)


def ball_pool_min_traced(a: Tensor, r2: float, bound: float, fill=None) -> Tensor:
    return shell_pool(a, r2, bound, "min", INT_FILL["min"][a.dtype] if fill is None else fill)


def ball_pool_sum_traced(a: Tensor, r2: float, bound: float) -> Tensor:
    return shell_pool(a, r2, bound, "sum", 0)


def shell_pool(a: Tensor, r2: float, bound: float, op: str, fill: int) -> Tensor:
    """K14: ``op`` over the shells of ``bound`` kept by the runtime ``r2``.
    CUDA tensors: K1's kernel on :func:`shell_taps`, halo its largest
    |offset| (a launch argument: nothing recompiles when r2 moves); CPU
    tensors: the plain decomposition at the equivalent radius
    (:attr:`Shells.radius`).  Min, max and integer sum do not depend on the
    order, so both equal the JAX shell-by-shell form."""
    shells = Shells(bound, r2)
    if a.is_cuda:
        return kernels.shell_pool(a, *tap_set(shells), op, fill)
    if a.device.type != "cpu":
        raise ValueError(f"shell pool: unsupported device {a.device}")
    return pool_plain(a, shells, op, fill)
