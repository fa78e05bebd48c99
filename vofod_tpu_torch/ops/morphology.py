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
The CUDA kernels take any tap set, of any radius.

A CUDA tensor goes to the hand-written stencil (csrc/ball_pool.cu), given
the ball's :class:`RunTable` (its x-runs, pairs and z slices) within halo
7, or past it its :class:`WideTable` (the set cut into pieces within halo
7, one launch a piece, the pieces' pools folded); a CPU tensor takes the
plain version below, which is the JAX decomposition (x running pools
shared across rows, then one shifted combine per (dz, dy) row).
:func:`ball_pool_runs_plain` models the kernel's schedule, both forms, on
the CPU.  Integer pools are exact in any order, so all are bit-equal to
JAX.

Grids are (nz, ny, nx); radii are in voxel units and may be fractional.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import ClassVar

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


@dataclass(frozen=True, eq=False)
class RunTable:
    """K1's tap set as the kernel runs it (csrc/ball_pool.cu).

    The taps are cut into x-runs ``(dz, dy, lo, hi)``, each a (dz, dy)
    row's contiguous dx values.  The distinct ``(lo, hi)`` pairs (``runs``,
    int32 [n_runs, 2]) are pooled once per staged row, in groups of
    :data:`kernels.BALL_RUN_GROUP`, the pools shared memory holds at once.
    A symmetric pair ``(-w, w)`` is pooled on the chain ``S[w] = op(S[w -
    1], e[-w], e[w])`` of the row's elements ``e`` (the JAX x pools' nested
    widths); ``sym`` int32 [n_groups, 8] holds each pair ``(-w, w)``'s index
    within its group, -1 where the group has none.  Any other pair is
    pooled element by element.

    A z slice is the rows ``(dy, run)`` of one dz; equal slices (a ball's
    dz and -dz) are kept once and feed each accumulator k = halo - dz they
    belong to.  ``slices`` int32 [n_slices, 3]: ``first row, end row,
    kmask`` (bit k for accumulator k), group by group (``gslice`` int32
    [n_groups + 1]: the slices of group g are ``gslice[g]:gslice[g + 1]``);
    ``rows`` int32 [n_rows, 2]: ``dy, run`` (its index within the group).
    ``blob`` is the packed int16 form the kernel takes."""

    halo: int
    runs: np.ndarray
    sym: np.ndarray
    gslice: np.ndarray
    slices: np.ndarray
    rows: np.ndarray
    blob: np.ndarray
    blob_ptr: int  # the blob's address, taken once (numpy's .ctypes costs a microsecond)
    wide: ClassVar[bool] = False

    @property
    def n_groups(self) -> int:
        return len(self.gslice) - 1

    def combines(self) -> int:
        """Combines an output voxel takes: 2 a step of the symmetric
        pairs' chain (to the widest), hi - lo for any other pair, one a
        slice row and one a slice's accumulator (radius 3: 6 + 18 + 7)."""
        n, group = 0, kernels.BALL_RUN_GROUP
        for g in range(self.n_groups):
            pairs = self.runs[g * group:(g + 1) * group].tolist()
            widths = [hi for lo, hi in pairs if lo == -hi]
            n += 2 * max(widths, default=0)
            n += sum(hi - lo for lo, hi in pairs if lo != -hi)
        for first, end, kmask in self.slices.tolist():
            n += end - first + bin(kmask).count("1")
        return n


@dataclass(frozen=True, eq=False)
class WideTable:
    """A tap set past halo 7 as the kernels' wide form runs it
    (csrc/ball_pool.cuh ``PieceIO``): each axis of the set's extent cut into
    segments of at most 15 offsets, and each box of segments that holds taps
    a piece: its taps recentred on the box's centre ``shifts[i]`` (dz, dy,
    dx), a :class:`RunTable` within halo 7 (``pieces[i]``).  A piece's
    launch stages the input shifted by its centre and folds its pool into
    the pieces' before it; ``blob``, ``lens`` and ``shifts`` are what the C
    entry points take (the pieces' packed tables back to back)."""

    halo: int
    shifts: np.ndarray  # int32 [n_pieces, 3]
    pieces: tuple
    blob: np.ndarray
    lens: np.ndarray
    wide: ClassVar[bool] = True

    @property
    def n_pieces(self) -> int:
        return len(self.pieces)

    @property
    def args(self) -> tuple:
        """(tables, lens, shifts, n_pieces) as the wide entries take them."""
        return (self.blob.ctypes.data, self.lens.ctypes.data, self.shifts.ctypes.data,
                self.n_pieces)

    def combines(self) -> int:
        """Combines an output voxel takes over the pieces, one more a piece
        for the fold."""
        return sum(p.combines() + 1 for p in self.pieces)


def pool_combines(taps: np.ndarray) -> int:
    """Combines an output voxel of a pool over ``taps`` takes in the run
    decomposition, counted as one run table of any size and halo would
    take them, whatever cut the kernel makes: 2 a step of one chain of the
    symmetric pairs (to the widest), hi - lo for any other pair, one a
    slice row (equal slices, a ball's dz and -dz, counted once) and one a
    slice's accumulator (one a dz).  A narrow table of one group counts
    the same (:meth:`RunTable.combines`)."""
    runs = x_runs(taps)
    pairs = {(lo, hi) for _, _, lo, hi in runs}
    n = 2 * max((hi for lo, hi in pairs if lo == -hi), default=0)
    n += sum(hi - lo for lo, hi in pairs if lo != -hi)
    by_dz: dict[int, list] = {}
    for dz, dy, lo, hi in runs:
        by_dz.setdefault(dz, []).append((dy, lo, hi))
    return n + sum(map(len, {tuple(sorted(s)) for s in by_dz.values()})) + len(by_dz)


def x_runs(taps: np.ndarray) -> list[tuple[int, int, int, int]]:
    """The maximal x-runs ``(dz, dy, lo, hi)`` of a tap set: each (dz, dy)
    row's dx values cut where they have a gap."""
    rows: dict[tuple[int, int], list[int]] = {}
    for dz, dy, dx in np.asarray(taps).reshape(-1, 3).tolist():
        rows.setdefault((dz, dy), []).append(dx)
    out = []
    for (dz, dy), dxs in sorted(rows.items()):
        dxs = sorted(set(dxs))
        lo = prev = dxs[0]
        for dx in dxs[1:] + [None]:
            if dx is None or dx != prev + 1:
                out.append((dz, dy, lo, prev))
                lo = dx
            prev = dx
    return out


def _build_run_table(taps: np.ndarray, halo: int) -> RunTable:
    kernels._taps_arg(taps, halo)  # the stencil kernels' limits
    if len(np.unique(taps.reshape(-1, 3), axis=0)) != len(taps):
        raise ValueError("a ball pool's tap set must not repeat a tap")
    runs_dz = x_runs(taps)
    # symmetric pairs first, narrowest first: the chain pools them in order
    pairs = sorted({(lo, hi) for _, _, lo, hi in runs_dz},
                   key=lambda p: (p[0] != -p[1], p[1] - p[0], p[0]))
    group = kernels.BALL_RUN_GROUP
    index = {p: i for i, p in enumerate(pairs)}
    n_groups = -(-len(pairs) // group)
    sym = np.full((n_groups, 8), -1, np.int32)
    for i, (lo, hi) in enumerate(pairs):
        if lo == -hi:
            sym[i // group, hi] = i % group
    # per group, the slice (sorted rows) of each dz; equal slices kept once
    by_g: dict[int, dict[int, list]] = {}
    for dz, dy, lo, hi in runs_dz:
        i = index[(lo, hi)]
        by_g.setdefault(i // group, {}).setdefault(halo - dz, []).append((dy, i % group))
    gslice, slices, rows = [0], [], []
    for g in range(n_groups):
        kmasks: dict[tuple, int] = {}
        for k, sl in sorted(by_g.get(g, {}).items()):
            key = tuple(sorted(sl))
            kmasks[key] = kmasks.get(key, 0) | 1 << k
        for key, kmask in kmasks.items():
            slices.append((len(rows), len(rows) + len(key), kmask))
            rows += key
        gslice.append(len(slices))
    runs = np.asarray(pairs, np.int32).reshape(-1, 2)
    slices = np.asarray(slices, np.int32).reshape(-1, 3)
    rows = np.asarray(rows, np.int32).reshape(-1, 2)
    gslice = np.asarray(gslice, np.int32)
    blob = np.concatenate([
        [halo, len(runs), len(rows), len(slices)], runs.reshape(-1), sym.reshape(-1), gslice,
        slices.reshape(-1), (rows[:, 0] + kernels.TABLE_HALO) * 256 + rows[:, 1]]).astype(np.int16)
    return RunTable(halo, runs, sym, gslice, slices, rows, blob, blob.ctypes.data)


def _segments(lo: int, hi: int, centred: bool = False) -> list[tuple[int, int]]:
    """[lo, hi] cut into the fewest segments of at most 2 x 7 + 1 offsets,
    of near-equal length; with ``centred`` and an odd length, the fewest
    odd number of them, mirrored about the range's centre (the middle one
    centred on it)."""
    size, width = hi - lo + 1, 2 * kernels.TABLE_HALO + 1
    n = -(-size // width)
    if centred and size % 2 and n > 1:
        n += n % 2 == 0
        m, k = size // n | 1, n // 2  # the middle's length (odd); segments a side
        side = (size - m) // 2
        left = [(lo + side * i // k, lo + side * (i + 1) // k - 1) for i in range(k)]
        right = [(lo + hi - b, lo + hi - a) for a, b in reversed(left)]
        return left + [(lo + side, hi - side)] + right
    edges = [lo + size * i // n for i in range(n + 1)]
    return [(edges[i], edges[i + 1] - 1) for i in range(n)]


def _build_wide_table(taps: np.ndarray, halo: int) -> WideTable:
    kernels._taps_arg(taps, halo)
    if len(np.unique(taps, axis=0)) != len(taps):
        raise ValueError("a ball pool's tap set must not repeat a tap")
    # x cut about its centre: a ball's middle pieces keep symmetric x-runs,
    # pooled on the chain, and the outer ones short runs
    axes = [_segments(int(taps[:, k].min()), int(taps[:, k].max()), centred=k == 2)
            for k in range(3)]
    shifts, pieces = [], []
    for sz in axes[0]:
        for sy in axes[1]:
            for sx in axes[2]:
                lo, hi = np.array([sz[0], sy[0], sx[0]]), np.array([sz[1], sy[1], sx[1]])
                sel = ((taps >= lo) & (taps <= hi)).all(1)
                if not sel.any():
                    continue
                centre = (lo + hi) // 2
                rel = (taps[sel] - centre).astype(np.int32)
                shifts.append(centre)
                pieces.append(_build_run_table(rel, int(np.abs(rel).max())))
    return WideTable(halo, np.asarray(shifts, np.int32).reshape(-1, 3), tuple(pieces),
                     np.concatenate([p.blob for p in pieces]),
                     np.asarray([len(p.blob) for p in pieces], np.int32))


def is_wide(taps: np.ndarray, halo: int) -> bool:
    """Whether the stencil kernels (K1, K14, K11's demotion, K13c and K2)
    take a tap set at ``halo`` in their wide forms: past one run table's
    halo (:data:`kernels.TABLE_HALO`), or past the :data:`kernels.TAP_STRUCT`
    taps that K2's narrow form passes by value (CUDA's 32,764-byte parameter
    limit).  One rule for both, so that a set takes the same form in K1 and
    K2; the production sets (radius < 8, at most 2,103 taps) are narrow."""
    return halo > kernels.TABLE_HALO or len(taps) > kernels.TAP_STRUCT


@functools.lru_cache(maxsize=256)
def _run_table_of_taps(key: bytes, halo: int) -> RunTable | WideTable:
    taps = np.frombuffer(key, np.int32).reshape(-1, 3)
    if is_wide(taps, halo):
        return _build_wide_table(taps, halo)
    return _build_run_table(taps, halo)


def run_table(ball, halo: int | None = None) -> RunTable | WideTable:
    """The :class:`RunTable` of a ball (a radius, traced shells or a tap
    set) at ``halo`` (default :func:`tap_set`'s), or its :class:`WideTable`
    where :func:`is_wide`, built once per tap set and halo; the kernels'
    wrappers pass a tap set and its halo."""
    taps, reach = tap_set(ball)
    taps = np.ascontiguousarray(taps, np.int32).reshape(-1, 3)
    return _run_table_of_taps(taps.tobytes(), reach if halo is None else halo)


def ball_pool_runs_plain(a: Tensor, table: RunTable, op: str, fill: int,
                         tile: tuple[int, int], zchunk: int, staging=None,
                         skip_empty: bool = False) -> Tensor:
    """Plain model of the K1 kernel's schedule, on any device: ``a``'s
    (y, x) plane cut into ``tile`` (TY, TX) column tiles and its z into
    chunks of ``zchunk`` output planes.  A tile and chunk stages every input
    plane from ``halo`` before its chunk to ``halo`` after it (out-of-grid
    voxels read ``fill``) with ``halo`` rows and 8 columns around the tile.
    Per group of pairs it pools each staged row: the symmetric pairs on one
    chain, the others element by element; then each slice combines its
    rows' pools and feeds the accumulators of the output planes in the
    chunk it belongs to.  Output plane ``zi - halo`` is done after input
    plane ``zi``.

    ``staging(zi, rows, cols)``, where given, is the staging rule of a kernel
    that builds the pooled value while loading (K11's demotion, K13c): the
    staged values of input plane ``zi`` at the global ``rows`` and
    ``cols`` (int64, out-of-grid ones included), in place of ``a``'s padded
    by ``fill``; ``a`` then gives only the output's shape, dtype and
    device.  The sum of int8 values (K13c's s16 pairs) is taken in int32.
    With ``skip_empty`` a tile and chunk whose staged values are all 0 pools
    nothing: its outputs are the op's identity (K11's and K13c's kernels
    then run only their epilogue).

    A :class:`WideTable` runs its pieces in order, each on the staging
    shifted by its centre, and folds their pools with ``op``."""
    combine = _COMBINE[op]
    if table.wide:
        stage = staging if staging is not None else _grid_staging(a, fill)
        out = None
        for (dz, dy, dx), piece in zip(table.shifts.tolist(), table.pieces):
            got = ball_pool_runs_plain(
                a, piece, op, fill, tile, zchunk, skip_empty=skip_empty,
                staging=lambda zi, rows, cols, dz=dz, dy=dy, dx=dx: stage(zi + dz, rows + dy,
                                                                          cols + dx))
            out = got if out is None else combine(out, got)
        return out
    nz, ny, nx = a.shape
    h, (ty, tx), pad = table.halo, tile, 8
    nty, ntx = -(-ny // ty), -(-nx // tx)
    dtype = torch.int32 if op == "sum" else a.dtype
    ident = 0 if op == "sum" else INT_FILL[op][a.dtype]
    group = kernels.BALL_RUN_GROUP
    out = torch.empty_like(a, dtype=dtype)
    fill_plane = torch.full((ny, nx), fill, dtype=a.dtype, device=a.device)
    rows = torch.arange(-h, nty * ty + h, device=a.device)
    cols = torch.arange(-pad, ntx * tx + pad, device=a.device)
    for zc0 in range(0, nz, zchunk):
        zc1 = min(nz, zc0 + zchunk)
        acc = [torch.full((nty, ntx, ty, tx), ident, dtype=dtype, device=a.device)
               for _ in range(2 * h + 1)]
        busy = torch.zeros((nty, ntx, 1, 1), dtype=torch.bool, device=a.device)
        dones = []
        for zi in range(zc0 - h, zc1 + h):
            if staging is not None:
                staged = staging(zi, rows, cols).to(dtype)
            else:
                plane = a[zi] if 0 <= zi < nz else fill_plane
                staged = F.pad(plane, (pad, ntx * tx - nx + pad, h, nty * ty - ny + h),
                               value=fill).to(dtype)
            # [tiles_y, tiles_x, TY + 2h, TX + 16]
            stage = staged.unfold(0, ty + 2 * h, ty).unfold(1, tx + 2 * pad, tx)
            e = {k: stage[..., pad + k: pad + k + tx] for k in range(-h, h + 1)}
            busy |= (stage[..., pad - h: pad + tx + h] != 0).any(-1).any(-1)[..., None, None]
            for g in range(table.n_groups):
                pairs = table.runs[g * group:(g + 1) * group].tolist()
                pools = [None] * len(pairs)
                chain = e[0]
                for w in range(h + 1):
                    if w:
                        chain = combine(combine(chain, e[-w]), e[w])
                    if table.sym[g, w] >= 0:
                        pools[table.sym[g, w]] = chain
                for i, (lo, hi) in enumerate(pairs):
                    if lo != -hi:
                        pools[i] = e[lo]
                        for k in range(lo + 1, hi + 1):
                            pools[i] = combine(pools[i], e[k])
                for first, end, kmask in table.slices[table.gslice[g]:
                                                      table.gslice[g + 1]].tolist():
                    live = [k for k in range(2 * h + 1)
                            if kmask >> k & 1 and zc0 <= zi - h + k < zc1]
                    if not live:
                        continue
                    d = None
                    for dy, run in table.rows[first:end].tolist():
                        s = pools[run][:, :, h + dy: h + dy + ty, :]
                        d = s if d is None else combine(d, s)
                    for k in live:
                        acc[k] = combine(acc[k], d)
            if zi - h >= zc0:
                dones.append((zi - h, acc[0]))
            acc = acc[1:] + [torch.full_like(acc[0], ident)]
        for zo, done in dones:  # a skipping tile's decision takes its whole chunk
            if skip_empty:
                done = torch.where(busy, done, torch.full_like(done, ident))
            out[zo] = done.permute(0, 2, 1, 3).reshape(nty * ty, ntx * tx)[:ny, :nx]
    return out


_COMBINE = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}


def _grid_staging(a: Tensor, fill: int):
    """K1's staging rule as a ``staging`` function: input plane ``zi`` of
    ``a`` at the global ``rows`` and ``cols``, ``fill`` outside the grid."""
    nz, ny, nx = a.shape
    fill_t = torch.tensor(fill, dtype=a.dtype, device=a.device)

    def stage(zi: int, rows: Tensor, cols: Tensor) -> Tensor:
        if not 0 <= zi < nz:
            return fill_t.expand(len(rows), len(cols))
        ok = ((rows >= 0) & (rows < ny))[:, None] & ((cols >= 0) & (cols < nx))[None, :]
        v = a[zi][rows.clamp(0, ny - 1)][:, cols.clamp(0, nx - 1)]
        return torch.where(ok, v, fill_t)
    return stage


def ball_pool_plain(a: Tensor, radius: float, op: str, fill: int) -> Tensor:
    """Plain version: the JAX decomposition, out[v] = op over ball(radius),
    with the grid padded by ``fill`` on every axis before the x pools, so
    that an out-of-grid tap reads ``fill`` also in a sum (the JAX form pads
    the x pools of out-of-grid rows with one ``fill`` each; its sums use
    fill 0, where the two agree)."""
    combine = _COMBINE[op]
    nz, ny, nx = a.shape
    rows = _ball_rows(radius)
    widths = sorted({w for _, _, w in rows})
    m = max(max(abs(dz), abs(dy)) for dz, dy, _ in rows)
    max_w = widths[-1]
    pad = F.pad(a, (max_w, max_w, m, m, m, m), value=fill)
    prev = pad[:, :, max_w: max_w + nx]
    xpool = {0: prev}
    for w in range(1, max_w + 1):
        lo = pad[:, :, max_w - w: max_w - w + nx]
        hi = pad[:, :, max_w + w: max_w + w + nx]
        prev = combine(combine(lo, prev), hi)
        if w in widths:
            xpool[w] = prev
    out = None
    for dz, dy, w in rows:
        s = xpool[w][m + dz: m + dz + nz, m + dy: m + dy + ny, :]
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
