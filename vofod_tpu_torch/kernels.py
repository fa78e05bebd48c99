"""Build, load and launch the hand-written CUDA kernels (K1-K15, K7s).

The sources in ``csrc/`` compile with ``nvcc`` into ONE shared library with
a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so the
build takes seconds).  The library is built at first use into
``build/vofod_tpu_torch/`` at the root of the checkout, keyed by a hash of
the sources and flags; a missing ``nvcc`` or a failed build raises with the
compiler's output — there is no fallback to the plain PyTorch versions.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch``, launches on the calling thread's current stream, raises
when the launch returns a CUDA error, and adds one to its entry of
:data:`LAUNCHES` (under a lock: the grid-sharded step launches from one
thread per shard).  The ops modules call these wrappers for CUDA tensors
only; CPU tensors take the plain versions beside them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "vofod_tpu_torch"
_SOURCES = ("ball_pool.cu", "propagate.cu", "frontend_bin.cu", "cone_sweep.cu",
            "compact.cu", "explore.cu", "classify_stats.cu", "ray_gate.cu", "ray_update.cu",
            "detect.cu", "ema.cu", "dda.cu", "census.cu", "unpack.cu", "halo.cu")
_HEADERS = ("common.cuh", "ball_pool.cuh", "lookback.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: dict[str, int] = {
    "ball_pool": 0,
    "shell_pool": 0,
    "propagate_sweeps": 0,
    "propagate_batch": 0,
    "frontend_bin": 0,
    "cone_sweep": 0,
    "masked_compact": 0,
    "explore_bfs": 0,
    "demote": 0,
    "explore_seq": 0,
    "cluster_stats": 0,
    "gate_faces": 0,
    "ray_update": 0,
    "detect": 0,
    "point_ema": 0,
    "demote_ema": 0,
    "dda": 0,
    "ray_ema": 0,
    "label_census": 0,
    "quirk_counts": 0,
    "exact_demote_ema": 0,
    "unpack": 0,
    "halo_exchange": 0,
    "halo_fold_min": 0,
    "cone_sweep_lat": 0,
    "cone_sweep_z": 0,
    "cone_sweep_zt": 0,
    "census_scatter": 0,
    "census_read": 0,
    "quirk_columns": 0,
    "quirk_ranks": 0,
    "quirk_query": 0,
    "dda_slab": 0,
    "explore_cut": 0,
    "explore_seq_stack": 0,
    "ball_pool_wide": 0,
    "shell_pool_wide": 0,
    "propagate_sweeps_wide": 0,
    "propagate_batch_wide": 0,
    "demote_ema_wide": 0,
    "exact_demote_ema_wide": 0,
}

# The stencil kernels (K1 and the demotion EMAs of K11 and K13c on its run
# table, K2, K14) take any tap set.  One run table holds a set within halo
# TABLE_HALO (csrc/common.cuh VOFOD_MAX_HALO), and K2's taps travel by value
# up to TAP_STRUCT taps within it (VOFOD_MAX_TAPS_LARGE; the ball of r^2 <
# 64 has 2,103): the production radii.  A set past either takes every
# stencil's wide form (ops/morphology.is_wide; "*_wide" in LAUNCHES): K1's
# run table cut into pieces within
# TABLE_HALO (ops/morphology.WideTable), one launch a piece, and K2's taps
# in bands from global memory (:func:`sweep_plan`).
TABLE_HALO = 7
TAP_STRUCT = 2112
# the wide K2's dynamic shared memory a block, at most: a band's box and its
# taps' offsets (the H100 opts in to 232,448 bytes a block)
K2_WIDE_SMEM = 200 * 1024
# their output tile (z, y, x): csrc/common.cuh TILE_Z, TILE_Y, TILE_X
TILE_ZYX = (4, 8, 32)
# K4's, K15b-3's and K15b-4b's blocks a cone: csrc/cone_sweep.cu CONE_CLUSTER
CONE_CLUSTER = 16
# K13b's and K15b-6b's single-pass scans: export-order columns per tile of
# the column prefix, cells per tile of the cell pass (csrc/census.cu
# COL_TILE, CELL_TILE)
QUIRK_COL_TILE = 1024
QUIRK_CELL_TILE = 4096
# K15b-7a's schedule, as csrc/explore.cu's constants of explore_cut_kernel
# (for its plain model): z planes of a query slot a block, warps a block and
# rows in flight a warp
CUT_PLANES = 4
CUT_WARPS = 4
CUT_ROWS = 16

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong


def reset_launch_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def _count(name: str, n: int = 1) -> None:
    with _count_lock:
        LAUNCHES[name] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "vofod_tpu_torch CUDA kernels cannot be built"
    )


def build() -> tuple[Path, str]:
    """Compile the kernel library if this source hash is not built yet: one
    ``nvcc -c`` per source, all started together, then one link.
    Returns (path of the .so, compiler log of the build or '' if cached)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _LINK_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    so = _BUILD_DIR / f"libvofod_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, ""
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=_BUILD_DIR))
    try:
        jobs = []
        for src in _SOURCES:
            obj, log = work / f"{src}.o", work / f"{src}.log"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(_CSRC / src)]
            with open(log, "w") as f:
                jobs.append((cmd, obj, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
        for *_, proc in jobs:
            proc.wait()
        logs = [log.read_text() for _, _, log, _ in jobs]
        for (cmd, _, _, proc), text in zip(jobs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{text}")
        tmp = work / "lib.so"
        cmd = [nvcc, *_LINK_FLAGS, "-o", str(tmp), *(str(obj) for _, obj, _, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so, "".join(logs)


def load():
    """Build (if needed) and load the library once per process."""
    global _lib
    if _lib is not None:  # loaded: no lock on the launch path
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so, _ = build()
        lib = ctypes.CDLL(str(so))
        lib.vofod_ball_pool.argtypes = [
            _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P]
        lib.vofod_propagate_sweeps.argtypes = [
            _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P,
            _P, _P, ctypes.POINTER(_I), _P]
        lib.vofod_propagate_sweeps_wide.argtypes = [
            _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P,
            _P, _P, _P, _P, _P, ctypes.POINTER(_I), _P]
        lib.vofod_ball_pool_wide.argtypes = [
            _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P]
        lib.vofod_demote_ema_wide.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _F, _F, _P, _P, _P, _P]
        lib.vofod_exact_demote_ema_wide.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P]
        lib.vofod_frontend_bin.argtypes = [
            _P, _P, _P, _P, _I, _P, _F, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.vofod_cone_sweep.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.vofod_compact.argtypes = [_P, _P, _P, _I, _LL, _I, _P, _P, _LL, _P, _P, _P, _P]
        lib.vofod_compact_geometry.argtypes = [_P]
        lib.vofod_explore.argtypes = [
            _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.vofod_demote.argtypes = [
            _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P]
        lib.vofod_explore_sequential.argtypes = [
            _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _P, _P,
            _P, _P, _P, _P]
        lib.vofod_explore_seq_scratch.argtypes = [_I, _I, _I, _I, ctypes.POINTER(_LL)]
        lib.vofod_cluster_stats.argtypes = [
            _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _P]
        lib.vofod_gate_faces.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P]
        lib.vofod_ray_update.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P]
        lib.vofod_ray_update_geometry.argtypes = [_P]
        lib.vofod_detect.argtypes = [_P] * 20
        lib.vofod_detect_geometry.argtypes = [_P]
        lib.vofod_point_ema.argtypes = [_P, _P, _P, _LL, _F, _F, _P, _P, _P, _P]
        lib.vofod_demote_ema.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _I, _F, _F, _P, _P, _P]
        lib.vofod_dda.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P]
        lib.vofod_ray_ema.argtypes = [_P, _P, _P, _LL, _P, _I, _P, _I, _P]
        lib.vofod_label_census.argtypes = [_P, _P, _P, _LL, _I, _F, _P, _P, _P, _P]
        lib.vofod_census_scatter.argtypes = [_P, _P, _P, _LL, _I, _P, _P]
        lib.vofod_census_read.argtypes = [_P, _P, _P, _LL, _I, _F, _P, _P, _P]
        lib.vofod_quirk_counts.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
        lib.vofod_quirk_columns.argtypes = [_P, _P, _I, _I, _I, _P, _P]
        lib.vofod_quirk_ranks.argtypes = [_P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _LL, _P, _P]
        lib.vofod_quirk_geometry.argtypes = [_P]
        lib.vofod_quirk_query.argtypes = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.vofod_exact_demote_ema.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P]
        lib.vofod_unpack.argtypes = [_P, _P, _P, _LL, _P]
        lib.vofod_halo_exchange.argtypes = [
            _P, _P, _I, _I, _I, _I, _LL, ctypes.c_char_p, _I, ctypes.c_uint, _P]
        lib.vofod_halo_fold_min.argtypes = [_P, _P, _I, _I, _LL, ctypes.c_char_p, _I, _P]
        lib.vofod_halo_geometry.argtypes = [_P]
        lib.vofod_cone_sweep_lat.argtypes = [_P] * 6 + [_I] * 9 + [_P]
        lib.vofod_cone_sweep_z.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        lib.vofod_cone_sweep_zt.argtypes = [_P] * 6 + [_I] * 10 + [_P]
        lib.vofod_explore_cut.argtypes = [_P, _I, _I, _I, _I, _P, _P, _P, _P, _F, _F, _I, _I,
                                          _P, _P]
        lib.vofod_explore_seq_stack.argtypes = ([_P, _I, _I, _I, _P, _I, _I] + [_P] * 9 + [_F]
                                                + [_I] * 4 + [_P] * 9)
        for fn in (lib.vofod_ball_pool, lib.vofod_propagate_sweeps,
                   lib.vofod_frontend_bin, lib.vofod_cone_sweep, lib.vofod_compact,
                   lib.vofod_compact_geometry,
                   lib.vofod_explore, lib.vofod_demote, lib.vofod_explore_sequential,
                   lib.vofod_explore_seq_scratch,
                   lib.vofod_cluster_stats,
                   lib.vofod_gate_faces, lib.vofod_ray_update, lib.vofod_ray_update_geometry,
                   lib.vofod_detect, lib.vofod_detect_geometry,
                   lib.vofod_point_ema, lib.vofod_demote_ema, lib.vofod_dda,
                   lib.vofod_ray_ema, lib.vofod_label_census, lib.vofod_quirk_counts,
                   lib.vofod_exact_demote_ema, lib.vofod_unpack, lib.vofod_halo_exchange,
                   lib.vofod_halo_fold_min, lib.vofod_halo_geometry, lib.vofod_cone_sweep_lat,
                   lib.vofod_cone_sweep_z, lib.vofod_cone_sweep_zt, lib.vofod_census_scatter,
                   lib.vofod_census_read,
                   lib.vofod_quirk_columns, lib.vofod_quirk_ranks, lib.vofod_quirk_query,
                   lib.vofod_explore_cut, lib.vofod_explore_seq_stack,
                   lib.vofod_propagate_sweeps_wide, lib.vofod_ball_pool_wide,
                   lib.vofod_demote_ema_wide, lib.vofod_exact_demote_ema_wide):
            fn.restype = _I
        _lib = lib
        return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _stream(device_index: int | None = None) -> int:
    """The raw current stream of the calling thread on ``device_index``
    (default: the current device).  ``torch.accelerator.current_stream`` is
    one C call; ``torch.cuda.current_stream()`` builds a Python ``Stream``
    (1.1 against 6.8 us a call on the H100 machine's host)."""
    return torch.accelerator.current_stream(device_index).native_handle


def _require(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _taps_arg(taps: np.ndarray, halo: int):
    """The tap set as the C entry points take it; raises for an empty set or
    one reaching past ``halo``."""
    arr = np.ascontiguousarray(taps, dtype=np.int32).reshape(-1, 3)
    reach = int(np.abs(arr).max()) if len(arr) else 0
    if not (len(arr) >= 1 and reach <= halo):
        raise ValueError(f"the stencil kernels take a non-empty tap set within its halo; got "
                         f"{len(arr)} taps reaching {reach} with halo {halo}")
    return arr, arr.ctypes.data_as(_P)


def _fold_scratch(shape, dtype, device) -> torch.Tensor:
    """The wide run-table forms' fold: int32 (nz, ny, units a row, 4 words),
    K1's unit of 8 int8 voxels (4 words of s16 pairs) or 4 int32 voxels."""
    nz, ny, nx = shape
    vx = 8 if dtype == torch.int8 else 4
    return torch.empty((nz, ny, -(-nx // vx), 4), dtype=torch.int32, device=device)


_DTYPE_CODE = {torch.int8: 0, torch.int32: 1}
_OP_CODE = {"min": 0, "max": 1, "sum": 2}
# K1's column tiles (y, x) by dtype (csrc/ball_pool.cu Lanes: 16 x 16
# threads of 8 int8 or 4 int32 voxels)
BALL_POOL_TILE = {torch.int8: (16, 128), torch.int32: (16, 64)}
# the (lo, hi) pairs whose pools K1 holds in shared memory at once (BP_GROUP)
BALL_RUN_GROUP = 8


def _pool(a: torch.Tensor, taps: np.ndarray, halo: int, op: str, fill: int,
          used=None) -> torch.Tensor:
    if a.dtype not in _DTYPE_CODE or a.dim() != 3:
        raise ValueError(f"ball_pool takes a 3-D int8/int32 grid, got {a.dtype} {tuple(a.shape)}")
    if op == "sum" and a.dtype != torch.int32:
        raise ValueError("ball_pool sum takes int32")
    _require(a, "ball_pool input", a.dtype)
    from vofod_tpu_torch.ops.morphology import run_table  # it imports this module

    table = run_table(taps, halo)
    out = torch.empty_like(a)
    nz, ny, nx = a.shape
    if table.wide:
        acc = _fold_scratch(a.shape, a.dtype, a.device)
        err = load().vofod_ball_pool_wide(
            a.data_ptr(), out.data_ptr(), _DTYPE_CODE[a.dtype], _OP_CODE[op], nz, ny, nx,
            *table.args, int(fill), acc.data_ptr(), used, _stream(a.get_device()))
        _check(err, "vofod_ball_pool_wide")
        return out, table.n_pieces
    err = load().vofod_ball_pool(
        a.data_ptr(), out.data_ptr(), _DTYPE_CODE[a.dtype], _OP_CODE[op],
        nz, ny, nx, table.blob_ptr, len(table.blob), int(fill), used, _stream(a.get_device()))
    _check(err, "vofod_ball_pool")
    return out, 0


def ball_pool_schedule(a: torch.Tensor, taps: np.ndarray, halo: int, op: str,
                       fill: int) -> tuple[torch.Tensor, dict]:
    """K1 once, with the schedule the card chose for it: (output, {zchunk,
    blocks, blocks_per_sm})."""
    used = (ctypes.c_int * 3)()
    out, pieces = _pool(a, taps, halo, op, fill, used)
    _count_pool("ball_pool", pieces)
    return out, _schedule(used)


def _count_pool(name: str, pieces: int) -> None:
    """A run-table call's launches: one, or one a piece of the wide form."""
    if pieces:
        _count(name + "_wide", pieces)
    else:
        _count(name)


def ball_pool(a: torch.Tensor, taps: np.ndarray, halo: int, op: str,
              fill: int) -> torch.Tensor:
    """K1: out[v] = op over the ball taps of a (out-of-grid taps read fill),
    run from the tap set's run table (ops/morphology.run_table); a set past
    halo 7 in the wide form, one launch a piece."""
    out, pieces = _pool(a, taps, halo, op, fill)
    _count_pool("ball_pool", pieces)
    return out


def shell_pool(a: torch.Tensor, taps: np.ndarray, halo: int, op: str,
               fill: int) -> torch.Tensor:
    """K14: the traced-radius pool of cfg.dynamic_radii — K1's kernel on the
    kept shells of a static bound (ops/morphology.shell_taps)."""
    out, pieces = _pool(a, taps, halo, op, fill)
    _count_pool("shell_pool", pieces)
    return out


def sweep_tiles(shape) -> int:
    """K2's output tiles (:data:`TILE_ZYX`) over a grid of ``shape``."""
    n = 1
    for size, tile in zip(shape, TILE_ZYX):
        n *= -(-size // tile)
    return n


def sweeps_scratch(shape, n_sweeps: int, n_launches: int, device) -> tuple:
    """The scratch of one call of ``n_sweeps`` K2 sweeps in ``n_launches``
    persistent launches on a grid of ``shape``: (changed int32 [n_sweeps],
    tiles computed int32 [n_sweeps], barrier counters [n_launches], the
    tiles' marks), views of one zeroed tensor, then the work lists (int32
    [2, tiles]) and the tiles' occupancy (int32 [tiles]), views of one
    uninitialised tensor."""
    n_tiles = sweep_tiles(shape)
    flat = torch.zeros(2 * n_sweeps + n_launches + n_tiles, dtype=torch.int32, device=device)
    work = torch.empty(3 * n_tiles, dtype=torch.int32, device=device)
    return (flat[:n_sweeps], flat[n_sweeps:2 * n_sweeps],
            flat[2 * n_sweeps:2 * n_sweeps + n_launches], flat[2 * n_sweeps + n_launches:],
            work[:2 * n_tiles], work[2 * n_tiles:])


def _sweeps(buf0, buf1, occ, taps, halo, scratch, launch: int, i0: int, n: int, grow: int,
            rows, gate, share: int, name: str) -> int:
    mode = {torch.int32: 0, torch.uint8: 1}.get(buf0.dtype)
    if mode is None or buf0.dim() != 3:
        raise ValueError(f"{name} takes a 3-D int32/uint8 grid, got {buf0.dtype}")
    if n < 1:
        raise ValueError(f"{name} runs at least one sweep, got {n}")
    _require(buf0, f"{name} buf0", buf0.dtype)
    _require(buf1, f"{name} buf1", buf0.dtype, buf0.shape)
    _require(occ, f"{name} occ", torch.uint8, buf0.shape)
    if gate is not None:
        _require(gate, f"{name} gate", torch.int32, ())
    changed, tiles, barriers, marks, lists, tile_occ = scratch
    if not (i0 + n <= changed.shape[0] and launch < barriers.shape[0]
            and marks.shape[0] == sweep_tiles(buf0.shape)):
        raise ValueError(f"{name}: scratch of {changed.shape[0]} sweeps, {barriers.shape[0]} "
                         f"launches and {marks.shape[0]} tiles for sweeps {i0}..{i0 + n - 1} "
                         f"of launch {launch} on {tuple(buf0.shape)}")
    keep, ptr = _taps_arg(taps, halo)
    nz, ny, nx = buf0.shape
    fz0, fz1 = (0, nz) if rows is None else rows
    blocks = _I(0)
    tail = (i0, n, grow, fz0, fz1, None if gate is None else gate.data_ptr(), share,
            changed.data_ptr(), tiles.data_ptr(), barriers.data_ptr() + 4 * launch,
            marks.data_ptr(), lists.data_ptr(), tile_occ.data_ptr(), ctypes.byref(blocks),
            _stream())
    from vofod_tpu_torch.ops.morphology import is_wide  # it imports this module
    if is_wide(keep, halo):
        plan = sweep_plan(keep, halo, buf0.element_size())
        err = load().vofod_propagate_sweeps_wide(
            buf0.data_ptr(), buf1.data_ptr(), occ.data_ptr(), mode, nz, ny, nx,
            plan.on(buf0.device).data_ptr(), plan.n_bands, plan.bz, plan.by, plan.max_taps,
            halo, *tail)
        _check(err, "vofod_propagate_sweeps_wide")
        _count(name + "_wide")
        return blocks.value
    err = load().vofod_propagate_sweeps(
        buf0.data_ptr(), buf1.data_ptr(), occ.data_ptr(), mode, nz, ny, nx, ptr, len(keep),
        halo, *tail)
    _check(err, "vofod_propagate_sweeps")
    _count(name)
    return blocks.value


class SweepPlan:
    """K2's wide form's taps (csrc/propagate.cu ``WideTaps``): the set cut
    into bands of at most ``bz`` dz x ``by`` dy values, band b the taps
    ``bands[b, 2]:bands[b, 3]`` with dz from ``bands[b, 0]`` and dy from
    ``bands[b, 1]``; ``offsets`` each tap's index into its band's box of
    (TILE_Z + bz - 1) x (TILE_Y + by - 1) x (TILE_X + 2 halo) cells, from the
    box cell of the tile's first voxel; ``taps`` in band order.  The
    extents are the widest that keep the box and a band's offsets within
    :data:`K2_WIDE_SMEM` with the fewest cells staged over the bands."""

    def __init__(self, taps: np.ndarray, halo: int, itemsize: int):
        tz, ty, tx = TILE_ZYX
        sx = tx + 2 * halo
        best = None
        for by in range(2 * halo + 1, 0, -1):
            for bz in range(2 * halo + 1, 0, -1):
                box = sx * (ty + by - 1) * (tz + bz - 1)
                if -(-box * itemsize // 16) * 16 > K2_WIDE_SMEM:
                    continue
                band = (taps[:, 0] + halo) // bz * (2 * halo + 1) + (taps[:, 1] + halo) // by
                _, counts = np.unique(band, return_counts=True)
                if -(-box * itemsize // 16) * 16 + 4 * int(counts.max()) > K2_WIDE_SMEM:
                    continue
                cost = len(counts) * box
                if best is None or cost < best[0]:
                    best = (cost, bz, by, band)
                break  # the widest bz that fits this by
        if best is None:
            raise ValueError(f"K2's wide form stages no band of halo {halo} within "
                             f"{K2_WIDE_SMEM} bytes")
        _, bz, by, band = best
        order = np.argsort(band, kind="stable")
        self.taps = taps[order]
        keys, first, counts = np.unique(band[order], return_index=True, return_counts=True)
        z0 = keys // (2 * halo + 1) * bz - halo
        y0 = keys % (2 * halo + 1) * by - halo
        self.bands = np.stack([z0, y0, first, first + counts], 1).astype(np.int32)
        band_of = np.repeat(np.arange(len(keys)), counts)
        dz, dy, dx = self.taps.T
        self.offsets = (((dz - z0[band_of]) * (ty + by - 1) + dy - y0[band_of]) * sx
                        + dx + halo).astype(np.int32)
        self.halo, self.bz, self.by = halo, bz, by
        self.n_bands, self.max_taps = len(keys), int(counts.max())
        self._flat = torch.from_numpy(np.concatenate([self.bands.reshape(-1), self.offsets]))
        self._dev: dict = {}

    def on(self, device: torch.device) -> torch.Tensor:
        """The plan as the kernel reads it (int32 [4 n_bands + n_taps]), on
        ``device``: copied once a (device, stream) from pinned memory on that
        stream, so that the launches after it on the stream see it and no
        copy waits on the host."""
        key = (str(device), _stream(device.index))
        got = self._dev.get(key)
        if got is None:
            with _lock:
                got = self._dev.get(key)
                if got is None:
                    if not self._flat.is_pinned():
                        self._flat = self._flat.pin_memory()  # kept: the copies read it later
                    got = self._dev[key] = self._flat.to(device, non_blocking=True)
        return got


_plans: dict = {}


def sweep_plan(taps: np.ndarray, halo: int, itemsize: int) -> SweepPlan:
    """The :class:`SweepPlan` of a tap set, built once per set, halo and
    element size."""
    arr = np.ascontiguousarray(taps, dtype=np.int32).reshape(-1, 3)
    key = (arr.tobytes(), halo, itemsize)
    plan = _plans.get(key)
    if plan is None:
        with _lock:
            plan = _plans.get(key)
            if plan is None:
                plan = _plans[key] = SweepPlan(arr, halo, itemsize)
    return plan


def sweep_buffers(init: torch.Tensor, halo: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's two buffers for ``init`` (int32 keys or uint8 reach) with
    ``halo`` more rows at each end, both the fill (SENTINEL, 0) but the
    first's rows [halo, halo + nz), which hold ``init``.  A launch never
    writes a tile that holds no occupied voxel, so both buffers must hold
    the fill wherever the occupancy is 0: the second does by this
    allocation, the first because ``init`` does (the callers' contract,
    ops/components.sweeps).  One fill kernel and one copy."""
    fill = {torch.int32: 2**31 - 1, torch.uint8: 0}[init.dtype]
    if not halo:
        return (torch.clone(init, memory_format=torch.contiguous_format),
                torch.full(init.shape, fill, dtype=init.dtype, device=init.device))
    nz = init.shape[0]
    bufs = torch.full((2, nz + 2 * halo) + tuple(init.shape[1:]), fill, dtype=init.dtype,
                      device=init.device)
    bufs[0, halo:halo + nz] = init
    return bufs[0], bufs[1]


def propagate_sweeps(init: torch.Tensor, occ: torch.Tensor, taps: np.ndarray, halo: int,
                     n: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """K2, persistent: ``n`` Jacobi sweeps from ``init`` in one cooperative
    launch, sweep i from ``bufs[i % 2]`` into the other of the wrapper's
    :func:`sweep_buffers` (``init`` holds the fill wherever ``occ`` is 0).
    int32: min-label sweeps, uint8: reach sweeps.  Stops after the first
    sweep that changed nothing (a fixpoint; the later flags stay 0).
    Returns (final grid, changed int32 [n], tiles computed int32 [n],
    blocks launched); raises when the launch is refused."""
    bufs = sweep_buffers(init)
    scratch = sweeps_scratch(init.shape, max(n, 1), 1, init.device)
    blocks = _sweeps(*bufs, occ, taps, halo, scratch, 0, 0, n, 0, None, None, 1,
                     "propagate_sweeps")
    return bufs[n % 2], scratch[0], scratch[1], blocks


def propagate_batch(buf0: torch.Tensor, buf1: torch.Tensor, occ: torch.Tensor,
                    taps: np.ndarray, halo: int, scratch: tuple, launch: int, i0: int, n: int,
                    grow: int, rows: tuple[int, int], gate: torch.Tensor | None,
                    share: int) -> int:
    """K2 on a shard's halo-extended slab: sweeps ``i0 .. i0 + n - 1`` of a
    sharded ``sweeps()`` call in one cooperative launch (its number
    ``launch`` of the call), from ``buf0`` (the slab with fresh halo rows)
    and ``buf1`` (earlier values), both holding the fill wherever ``occ``
    is 0 (:func:`sweep_buffers` makes them), the result's exact rows in
    ``(buf0, buf1)[n % 2]``.  ``grow``: the rows the exact region loses at
    each end a sweep; ``rows``: the interior (z0, z1) whose changes set the
    flags; ``gate``: None or the
    previous launch's last global flag (the launch does nothing when it is
    0); ``share``: the shards on this card (the launch takes a
    ``share``-th of its resident blocks).  ``scratch``: the call's
    :func:`sweeps_scratch`, whose changed and tiles entries ``i0 ..`` the
    launch writes.  Returns the blocks launched."""
    return _sweeps(buf0, buf1, occ, taps, halo, scratch, launch, i0, n, grow, rows, gate, share,
                   "propagate_batch")


def frontend_bin(ranges: torch.Tensor, dirs: torch.Tensor, offs: torch.Tensor,
                 pose: torch.Tensor, boxes: np.ndarray, inv_voxel: float,
                 range_scale: float, shape: tuple[int, int, int],
                 slab: tuple[int, int] | None = None):
    """K3: (counts int32 grid, n_valid int32 scalar, excl bool [N],
    fid int32 [N] global ids).  ``slab`` (z0, rows): the counts hold only
    those z rows of the grid ``shape`` (a shard's), default all."""
    lib = load()
    n = ranges.shape[0]
    _require(ranges, "frontend ranges", torch.float32, (n,))
    _require(dirs, "frontend lut dirs", torch.float32, (n, 3))
    _require(offs, "frontend lut offs", torch.float32, (n, 3))
    _require(pose, "frontend pose", torch.float32, (4, 4))
    dev = ranges.device
    nz, ny, nx = shape
    z0, nzl = (0, nz) if slab is None else slab
    counts = torch.zeros((nzl, ny, nx), dtype=torch.int32, device=dev)
    n_valid = torch.zeros((), dtype=torch.int32, device=dev)
    excl = torch.empty(n, dtype=torch.bool, device=dev)
    fid = torch.empty(n, dtype=torch.int32, device=dev)
    b = np.ascontiguousarray(boxes, dtype=np.float32)
    assert b.shape == (15,)
    err = lib.vofod_frontend_bin(
        ranges.data_ptr(), dirs.data_ptr(), offs.data_ptr(), pose.data_ptr(),
        n, b.ctypes.data_as(_P), float(inv_voxel), float(range_scale),
        nz, ny, nx, z0, nzl, counts.data_ptr(), n_valid.data_ptr(), excl.data_ptr(),
        fid.data_ptr(), _stream())
    _check(err, "vofod_frontend_bin")
    _count("frontend_bin")
    return counts, n_valid, excl, fid


def cone_sweep(opaque: torch.Tensor, rel_x: torch.Tensor, rel_y: torch.Tensor,
               rel_z: torch.Tensor) -> torch.Tensor:
    """K4: transmittance T [6, nz, ny, nx] f32 of the six cone sweeps, each
    cone on a thread-block cluster of :data:`CONE_CLUSTER` blocks.  Raises
    when the card cannot schedule such a cluster."""
    if opaque.dim() != 3:
        raise ValueError("cone_sweep takes a 3-D opacity window")
    nz, ny, nx = opaque.shape
    _require(opaque, "cone_sweep opaque", torch.uint8)
    _require(rel_x, "cone_sweep rel_x", torch.float32, (nx,))
    _require(rel_y, "cone_sweep rel_y", torch.float32, (ny,))
    _require(rel_z, "cone_sweep rel_z", torch.float32, (nz,))
    lib = load()
    T = torch.empty((6, nz, ny, nx), dtype=torch.float32, device=opaque.device)
    err = lib.vofod_cone_sweep(
        opaque.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(),
        rel_z.data_ptr(), T.data_ptr(), nz, ny, nx, _stream())
    _check(err, "vofod_cone_sweep")
    _count("cone_sweep")
    return T


# K6's schedule (csrc/compact.cu CT, VEC): threads a tile, 16-byte chunks a
# thread, and so mask bytes a tile (its TILE, which compact_geometry reads)
COMPACT_THREADS, COMPACT_VEC = 256, 4
COMPACT_TILE = COMPACT_THREADS * COMPACT_VEC * 16
# K6's look-back state (csrc/compact.cu): per (device, stream), two zeroed
# int64 buffers of [1 + tiles] words and the one the next launch uses; each
# launch zeroes the other for the launch after it.  The lock keeps two host
# threads launching on one stream from taking the same buffer.  The pair
# assumes eager launches: a captured CUDA graph replays one buffer order,
# so capturing K6 needs an epoch-tagged state or a last-tile clear.
_compact_state: dict[tuple[int, int], list] = {}
_compact_lock = threading.Lock()


def _compact_state_for(dev: torch.device, stream: int, tiles: int) -> list:
    key = (dev.index, stream)
    st = _compact_state.get(key)
    if st is None or st[0].numel() < tiles + 1:
        # zeroed here only: the launches on this stream keep them zero
        words = max(tiles + 1, 512)
        st = [torch.zeros(words, dtype=torch.int64, device=dev),
              torch.zeros(words, dtype=torch.int64, device=dev), 0]
        _compact_state[key] = st
    return st


def compact_geometry() -> tuple[int, int]:
    """K6's (mask bytes per tile, blocks the current card holds resident)."""
    out = (ctypes.c_int * 2)()
    _check(load().vofod_compact_geometry(out), "vofod_compact_geometry")
    return out[0], out[1]


def masked_compact(mask: torch.Tensor, capacity: int, labels: torch.Tensor | None = None,
                   sel: torch.Tensor | None = None):
    """K6: (ids int32 [capacity], valid bool [capacity], total int32 scalar)
    of the set elements of ``mask`` — or, with ``labels`` and ``sel``, of
    ``mask & isin(labels, sel)`` (``sel``: int32, at most 32 values).  One
    launch."""
    lib = load()
    _require(mask, "compact mask", torch.bool)
    n = mask.numel()
    if n == 0 or capacity <= 0:
        raise ValueError(f"masked_compact needs n > 0 and capacity > 0, got {n}, {capacity}")
    lab_ptr = sel_ptr = None
    nsel = 0
    if labels is not None:
        _require(labels, "compact labels", torch.int32, mask.shape)
        _require(sel, "compact sel", torch.int32)
        nsel = sel.numel()
        if not 0 < nsel <= 32:
            raise ValueError(f"compact sel takes 1-32 labels, got {nsel}")
        lab_ptr, sel_ptr = labels.data_ptr(), sel.data_ptr()
    dev = mask.device
    stream = _stream()
    ptr = mask.data_ptr()
    # three allocations cost the host less than one carved into three views
    ids = torch.empty(capacity, dtype=torch.int32, device=dev)
    valid = torch.empty(capacity, dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    with _compact_lock:
        st = _compact_state_for(dev, stream, -(-(n + ptr % 16) // COMPACT_TILE))
        use, other = st[st[2]], st[1 - st[2]]
        err = lib.vofod_compact(
            ptr, lab_ptr, sel_ptr, nsel, n, capacity, use.data_ptr(), other.data_ptr(),
            use.numel(), ids.data_ptr(), valid.data_ptr(), total.data_ptr(), stream)
        _check(err, "vofod_compact")
        st[2] ^= 1  # launched: it zeroes `other`, which the next launch uses
    _count("masked_compact")
    return ids, valid, total


def _z_window(vmap: torch.Tensor, z_window: tuple[int, int] | None) -> tuple[int, int]:
    """(z_lo, nz_g): the grid's first z row in ``vmap`` and the grid's
    rows — (0, rows of vmap) but on the grid-sharded step, where vmap is a
    shard's halo-extended slab."""
    return (0, vmap.shape[0]) if z_window is None else z_window


def explore(vmap: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor, qz: torch.Tensor,
            qvalid: torch.Tensor, max_manhattan: torch.Tensor, thr_frontiers: float,
            thr_ground: float, submap: int, max_iters: int,
            z_window: tuple[int, int] | None = None):
    """K7: (connected bool [Q], reached int64 [Q, S, S] packed rows,
    corners int32 [Q, 3]).  ``z_window`` (z_lo, nz_g): vmap holds the rows
    [z_lo, z_lo + rows) of an nz_g-row grid (:func:`_z_window`).  The
    corners are the first 3 Q int32 of one allocation whose last int32 is
    K8's write count, which the launch zeroes (:func:`demote_`)."""
    lib = load()
    if vmap.dim() != 3:
        raise ValueError("explore takes a 3-D grid")
    Q, S = qx.shape[0], int(submap)
    if not 2 <= S <= 64:
        raise ValueError(f"explore submap side must be in [2, 64], got {S}")
    _require(vmap, "explore grid", torch.float32)
    for t, name in ((qx, "qx"), (qy, "qy"), (qz, "qz"), (max_manhattan, "max_manhattan")):
        _require(t, f"explore {name}", torch.int32, (Q,))
    _require(qvalid, "explore qvalid", torch.bool, (Q,))
    dev = vmap.device
    connected = torch.empty(Q, dtype=torch.bool, device=dev)
    reached = torch.empty((Q, S, S), dtype=torch.int64, device=dev)
    corners = torch.empty(3 * Q + 1, dtype=torch.int32, device=dev).as_strided((Q, 3), (3, 1))
    nz, ny, nx = vmap.shape
    err = lib.vofod_explore(
        vmap.data_ptr(), nz, ny, nx, *_z_window(vmap, z_window), qx.data_ptr(), qy.data_ptr(),
        qz.data_ptr(), qvalid.data_ptr(), max_manhattan.data_ptr(), float(thr_frontiers),
        float(thr_ground), Q, S, int(max_iters), connected.data_ptr(), reached.data_ptr(),
        corners.data_ptr(), corners.data_ptr() + 12 * Q, _stream())
    _check(err, "vofod_explore")
    _count("explore_bfs")
    return connected, reached, corners


def demote_count(corners: torch.Tensor) -> torch.Tensor:
    """K8's write count: the int32 after K7's ``corners`` in their
    allocation, which K7's launch zeroed and K8 adds to.  Raises on corners
    that :func:`explore` did not make."""
    base, Q = corners._base, corners.shape[0]
    if (base is None or base.dtype != torch.int32 or base.shape != (3 * Q + 1,)
            or corners.data_ptr() != base.data_ptr()):
        raise ValueError("demote_ takes the corners of kernels.explore (their allocation holds "
                         "K8's write count)")
    return base[3 * Q]


def demote_(vmap: torch.Tensor, reached: torch.Tensor, corners: torch.Tensor,
            qslot: torch.Tensor, connected: torch.Tensor, qvalid: torch.Tensor,
            qgate: torch.Tensor, query_overflow: torch.Tensor, thr_frontiers: float,
            z_window: tuple[int, int] | None = None):
    """K8, in place on ``vmap``: min(v, thr) at the reached voxels of every
    query that demotes.  Returns (the int32 count of those writes — the
    count :func:`demote_count` finds beside ``corners``, which K7 zeroed —,
    cluster_connected bool [K]: whether a slot has a connected query).
    ``z_window``: as :func:`explore`'s."""
    lib = load()
    Q, S = reached.shape[0], reached.shape[1]
    K = qgate.shape[0]
    _require(vmap, "demote grid", torch.float32)
    if vmap.dim() != 3:
        raise ValueError("demote takes a 3-D grid")
    _require(reached, "demote reached", torch.int64, (Q, S, S))
    _require(corners, "demote corners", torch.int32, (Q, 3))
    _require(qslot, "demote qslot", torch.bool, (Q, K))
    _require(connected, "demote connected", torch.bool, (Q,))
    _require(qvalid, "demote qvalid", torch.bool, (Q,))
    _require(qgate, "demote qgate", torch.bool, (K,))
    _require(query_overflow, "demote query_overflow", torch.bool, ())
    n_writes = demote_count(corners)
    cluster_connected = torch.empty(K, dtype=torch.bool, device=vmap.device)
    nz, ny, nx = vmap.shape
    err = lib.vofod_demote(
        vmap.data_ptr(), nz, ny, nx, *_z_window(vmap, z_window), reached.data_ptr(),
        corners.data_ptr(), S, qslot.data_ptr(), connected.data_ptr(), qvalid.data_ptr(),
        qgate.data_ptr(), query_overflow.data_ptr(), Q, K, float(thr_frontiers),
        n_writes.data_ptr(), cluster_connected.data_ptr(), _stream())
    _check(err, "vofod_demote")
    _count("demote")
    return n_writes, cluster_connected


# K7s's and K15b-7b's launch state (csrc/explore.cu explore_spec_kernel):
# the int32 ticket its blocks take, per (device, stream) as K6's look-back
# state (the grid-sharded step's shards launch at once on their own
# streams), zeroed once here and set back to 0 by each launch's last block;
# and the scratch bytes a launch takes, by (Q, K, S, dense).
_seq_tickets: dict[tuple[int, int], torch.Tensor] = {}
_seq_scratch_bytes: dict[tuple[int, int, int, bool], int] = {}
_seq_lock = threading.Lock()


def seq_ticket(dev: torch.device, stream: int) -> torch.Tensor:
    """The ticket of K7s / K15b-7b launches on ``stream`` of ``dev`` (0
    between launches)."""
    key = (dev.index, stream)
    t = _seq_tickets.get(key)
    if t is None:
        with _seq_lock:
            t = _seq_tickets.setdefault(key, torch.zeros(1, dtype=torch.int32, device=dev))
    return t


def _seq_launch_state(dev: torch.device, Q: int, K: int, S: int, dense: bool):
    """(scratch uint8 tensor, ticket, stream) of one K7s / K15b-7b launch on
    the calling thread's current stream."""
    key = (Q, K, S, dense)
    n = _seq_scratch_bytes.get(key)
    if n is None:
        out = _LL()
        _check(load().vofod_explore_seq_scratch(Q, K, S, int(dense), ctypes.byref(out)),
               "vofod_explore_seq_scratch")
        n = _seq_scratch_bytes[key] = out.value
    stream = _stream(dev.index)
    return torch.empty(n, dtype=torch.uint8, device=dev), seq_ticket(dev, stream), stream


def _seq_args(name: str, Q: int, S: int, qx, qy, qz, qvalid, qlabels, qids, qslot,
              max_manhattan, query_overflow, stats) -> int:
    """Checks K7s's / K15b-7b's query table; returns K."""
    K = qslot.shape[-1] if qslot.dim() == 2 else 0
    if not 2 <= S <= 64:
        raise ValueError(f"explore submap side must be in [2, 64], got {S}")
    if not (1 <= Q <= 4096 and K >= 1):
        raise ValueError(f"{name} takes 1-4096 queries and >= 1 slot, got Q={Q}, K={K}")
    for t, what in ((qx, "qx"), (qy, "qy"), (qz, "qz"), (qlabels, "qlabels"), (qids, "qids"),
                    (max_manhattan, "max_manhattan")):
        _require(t, f"{name} {what}", torch.int32, (Q,))
    _require(qvalid, f"{name} qvalid", torch.bool, (Q,))
    _require(qslot, f"{name} qslot", torch.bool, (Q, K))
    _require(query_overflow, f"{name} query_overflow", torch.bool, ())
    if stats is not None:
        _require(stats, f"{name} stats", torch.int32, (4,))
    return K


def explore_sequential_(vmap: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                        qz: torch.Tensor, qvalid: torch.Tensor, qlabels: torch.Tensor,
                        qids: torch.Tensor, qslot: torch.Tensor, max_manhattan: torch.Tensor,
                        query_overflow: torch.Tensor, thr_frontiers: float, thr_ground: float,
                        submap: int, max_iters: int, stats: torch.Tensor | None = None):
    """K7s, in place on ``vmap``: the queries explored in (label, id) order,
    a failed one demoting its reached voxels before the next runs — every
    valid query flooded at once on the grid before the walk, then one
    block's walk flooding again only those whose flood meets an earlier
    failed one's.  Returns (cluster_connected bool [K], n_writes int32).
    ``stats``: None, or int32 [4] the walk writes its counts into (floods
    redone, speculative floods tested, failed queries, valid queries)."""
    if vmap.dim() != 3:
        raise ValueError("explore_sequential takes a 3-D grid")
    Q, S = qx.shape[0], int(submap)
    K = _seq_args("explore_seq", Q, S, qx, qy, qz, qvalid, qlabels, qids, qslot, max_manhattan,
                  query_overflow, stats)
    _require(vmap, "explore_seq grid", torch.float32)
    dev = vmap.device
    cluster_connected = torch.empty(K, dtype=torch.bool, device=dev)
    n_writes = torch.empty((), dtype=torch.int32, device=dev)
    scratch, ticket, stream = _seq_launch_state(dev, Q, K, S, True)
    nz, ny, nx = vmap.shape
    err = load().vofod_explore_sequential(
        vmap.data_ptr(), nz, ny, nx, qx.data_ptr(), qy.data_ptr(), qz.data_ptr(),
        qvalid.data_ptr(), qlabels.data_ptr(), qids.data_ptr(), qslot.data_ptr(),
        max_manhattan.data_ptr(), query_overflow.data_ptr(), float(thr_frontiers),
        float(thr_ground), Q, K, S, int(max_iters), cluster_connected.data_ptr(),
        n_writes.data_ptr(), scratch.data_ptr(), ticket.data_ptr(),
        None if stats is None else stats.data_ptr(), stream)
    _check(err, "vofod_explore_sequential")
    _count("explore_seq")
    return cluster_connected, n_writes


def stack_words(submap: int) -> torch.dtype:
    """K15b-7's word: uint32 rows (as int32) for S <= 32, else 64-bit."""
    return torch.int32 if submap <= 32 else torch.int64


def explore_cut(vmap: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor, qz: torch.Tensor,
                qvalid: torch.Tensor, thr_frontiers: float, thr_ground: float, submap: int,
                z_lo: int) -> torch.Tensor:
    """K15b-7a: the [Q, 2, S, S] band and ground rows of every valid query's
    submap rows inside ``vmap``, the grid's z rows [z_lo, z_lo + rows) (0
    elsewhere); :data:`CUT_PLANES` z planes of a slot a block, on
    :data:`CUT_WARPS` warps."""
    if vmap.dim() != 3:
        raise ValueError("explore_cut takes a 3-D grid")
    Q, S = qx.shape[0], int(submap)
    if not 2 <= S <= 64 or not 1 <= Q <= 65535:
        raise ValueError(f"explore_cut takes S in [2, 64] and 1-65535 queries, got S={S}, Q={Q}")
    _require(vmap, "explore_cut grid", torch.float32)
    for t, name in ((qx, "qx"), (qy, "qy"), (qz, "qz")):
        _require(t, f"explore_cut {name}", torch.int32, (Q,))
    _require(qvalid, "explore_cut qvalid", torch.bool, (Q,))
    stack = torch.empty((Q, 2, S, S), dtype=stack_words(S), device=vmap.device)
    nz, ny, nx = vmap.shape
    err = load().vofod_explore_cut(
        vmap.data_ptr(), nz, ny, nx, int(z_lo), qx.data_ptr(), qy.data_ptr(), qz.data_ptr(),
        qvalid.data_ptr(), float(thr_frontiers), float(thr_ground), Q, S, stack.data_ptr(),
        _stream())
    _check(err, "vofod_explore_cut")
    _count("explore_cut")
    return stack


def explore_seq_stack(stack: torch.Tensor, grid_shape, qx: torch.Tensor, qy: torch.Tensor,
                      qz: torch.Tensor, qvalid: torch.Tensor, qlabels: torch.Tensor,
                      qids: torch.Tensor, qslot: torch.Tensor, max_manhattan: torch.Tensor,
                      query_overflow: torch.Tensor, max_iters: int, slab: torch.Tensor,
                      z_lo: int, thr_frontiers: float, stats: torch.Tensor | None = None):
    """K15b-7b and K15b-7c: K7s on the replicated stack of a grid of
    ``grid_shape``, in the same speculate-then-commit launch, whose walk
    stores thr_frontiers at each failed query's reached voxels inside
    ``slab`` (the grid's z rows [z_lo, z_lo + rows), IN PLACE) as the query
    fails.  Returns (cluster_connected bool [K], reached [Q, S, S] words,
    corners int32 [Q, 3], demoted bool [Q], n_writes int32: the slab's
    stores).  ``stats``: as :func:`explore_sequential_`'s."""
    if stack.dim() != 4 or stack.shape[1] != 2 or stack.shape[2] != stack.shape[3]:
        raise ValueError(f"explore_seq_stack takes a [Q, 2, S, S] stack, got {tuple(stack.shape)}")
    Q, S = stack.shape[0], stack.shape[-1]
    K = _seq_args("explore_seq_stack", Q, S, qx, qy, qz, qvalid, qlabels, qids, qslot,
                  max_manhattan, query_overflow, stats)
    _require(stack, "explore_seq_stack stack", stack_words(S))
    _require(slab, "explore_seq_stack slab", torch.float32)
    nz, ny, nx = (int(d) for d in grid_shape)
    if slab.dim() != 3 or tuple(slab.shape[1:]) != (ny, nx) or not (
            0 <= z_lo and z_lo + slab.shape[0] <= nz):
        raise ValueError(f"explore_seq_stack takes a slab of the grid's z rows, got "
                         f"{tuple(slab.shape)} at z_lo={z_lo} of {(nz, ny, nx)}")
    dev = stack.device
    conn = torch.empty(K, dtype=torch.bool, device=dev)
    n_writes = torch.empty((), dtype=torch.int32, device=dev)
    reached = torch.empty((Q, S, S), dtype=stack.dtype, device=dev)
    corners = torch.empty((Q, 3), dtype=torch.int32, device=dev)
    demoted = torch.empty(Q, dtype=torch.bool, device=dev)
    scratch, ticket, stream = _seq_launch_state(dev, Q, K, S, False)
    err = load().vofod_explore_seq_stack(
        stack.data_ptr(), nz, ny, nx, slab.data_ptr(), int(z_lo), slab.shape[0], qx.data_ptr(),
        qy.data_ptr(), qz.data_ptr(), qvalid.data_ptr(), qlabels.data_ptr(), qids.data_ptr(),
        qslot.data_ptr(), max_manhattan.data_ptr(), query_overflow.data_ptr(),
        float(thr_frontiers), Q, K, S, int(max_iters), conn.data_ptr(), n_writes.data_ptr(),
        reached.data_ptr(), corners.data_ptr(), demoted.data_ptr(), scratch.data_ptr(),
        ticket.data_ptr(), None if stats is None else stats.data_ptr(), stream)
    _check(err, "vofod_explore_seq_stack")
    _count("explore_seq_stack")
    return conn, reached, corners, demoted, n_writes


# K9: F up to K9_SMEM_KEYS sorts in one block's shared memory (one launch);
# past it, chunks of K9_CHUNK keys (csrc/classify_stats.cu SMEM_KEYS, CHUNK;
# the entry refuses a scratch smaller than its own constants need)
K9_SMEM_KEYS = 8192
K9_CHUNK = 8192
_stats_consts: dict = {}


def _stats_host(grid_origin, voxel_size: float, gates):
    """The K9 entry's two host float32 arrays, kept per (grid, gates)."""
    key = (*grid_origin, voxel_size, *gates)
    got = _stats_consts.get(key)
    if got is None:
        if len(_stats_consts) >= 64:  # live-tuned gates: keep the recent ones
            _stats_consts.clear()
        grid_f = np.array([*grid_origin, voxel_size], dtype=np.float32)
        gate_f = np.array(gates, dtype=np.float32)
        if grid_f.shape != (4,) or gate_f.shape != (4,):
            raise ValueError("cluster_stats takes a 3-D origin, a voxel size and 4 gates")
        got = _stats_consts[key] = (grid_f, gate_f, grid_f.ctypes.data_as(_P),
                                    gate_f.ctypes.data_as(_P))
    return got[2], got[3]


def cluster_stats(fids: torch.Tensor, fvalid: torch.Tensor, labels: torch.Tensor, K: int,
                  grid_origin, voxel_size: float, gates, sensor_pos: torch.Tensor,
                  bg_sufficient: torch.Tensor, sure_bg_sufficient: torch.Tensor,
                  ftotal: torch.Tensor, grid_yx: tuple[int, int]) -> dict[str, torch.Tensor]:
    """K9: the per-slot statistics of the far list (any F >= 1), keyed as
    pipeline/classify.py ``ClusterStats``.  ``labels``: the far voxels'
    labels, int32 [F]; ``grid_yx``: the grid's (ny, nx).  ``gates``:
    (min_points, max_distance, max_size, max_explore_distance).  The
    outputs are views of one device buffer."""
    lib = load()
    F = fids.shape[0]
    _require(fids, "stats fids", torch.int32, (F,))
    _require(fvalid, "stats fvalid", torch.bool, (F,))
    _require(labels, "stats labels", torch.int32, (F,))
    _require(sensor_pos, "stats sensor_pos", torch.float32, (3,))
    _require(bg_sufficient, "stats bg_sufficient", torch.bool, ())
    _require(sure_bg_sufficient, "stats sure_bg_sufficient", torch.bool, ())
    _require(ftotal, "stats ftotal", torch.int32, ())
    # one float32 buffer: the chunked path's scratch (12 bytes a key slot),
    # then the outputs in csrc/classify_stats.cu StatsOut's layout
    scratch = 0 if F <= K9_SMEM_KEYS else 3 * K9_CHUNK * -(-F // K9_CHUNK)
    n_flags = -(-(3 * K + 1) // 4)
    buf = torch.empty(scratch + 26 * K + n_flags, dtype=torch.float32, device=fids.device)
    _, box, axes, size, i32, b8 = buf.split([scratch, 12 * K, 9 * K, K, 4 * K, n_flags])
    out = dict(zip(("aabb_min", "aabb_max", "obb_center", "obb_extent"),
                   box.view(4, K, 3).unbind(0)))
    out["axes"] = axes.view(K, 3, 3)
    out["obb_size"] = size
    out.update(zip(("reps", "npts", "m_k", "rep_sel"), i32.view(torch.int32).view(4, K).unbind(0)))
    flags = b8.view(torch.bool)
    out.update(zip(("slot_valid", "gated", "qgate"), flags[:3 * K].view(3, K).unbind(0)))
    out["cluster_overflow"] = flags[3 * K]
    grid_f, gate_f = _stats_host(grid_origin, voxel_size, gates)
    ny, nx = grid_yx
    err = lib.vofod_cluster_stats(
        fids.data_ptr(), fvalid.data_ptr(), labels.data_ptr(), F, K, ny, nx, grid_f, gate_f,
        sensor_pos.data_ptr(), bg_sufficient.data_ptr(), sure_bg_sufficient.data_ptr(),
        ftotal.data_ptr(), box.data_ptr(), buf.data_ptr(), 4 * scratch, _stream())
    _check(err, "vofod_cluster_stats")
    _count("cluster_stats")
    return out


def _host_i32(*vals):
    arr = np.array(vals, dtype=np.int32)
    return arr, arr.ctypes.data_as(_P)


def _host_f32(*vals):
    arr = np.array(vals, dtype=np.float32)
    return arr, arr.ctypes.data_as(_P)


def gate_faces(active: torch.Tensor, face_dirs: torch.Tensor, rot: torch.Tensor,
               table: torch.Tensor | None, pools: tuple[int, int, int, int],
               scalars: np.ndarray) -> torch.Tensor:
    """K5a: f32 [P] gate value of each face texel (P = face_dirs rows).
    pools: (pool_v, pool_h, n_rows, n_cols); scalars: the float32
    constants of ops/raycast.py _gate_scalars."""
    if active.dim() != 2:
        raise ValueError("gate_faces takes the [H, W] active-ray image")
    H, W = active.shape
    P = face_dirs.shape[0]
    _require(active, "gate active", torch.bool)
    _require(face_dirs, "gate face_dirs", torch.float32, (P, 3))
    _require(rot, "gate rot", torch.float32, (3, 3))
    n_tbl = 0
    if table is not None:
        n_tbl = table.shape[0]
        _require(table, "gate row table", torch.float32, (n_tbl,))
    ints = _host_i32(H, W, *pools, P, n_tbl)
    floats = _host_f32(*scalars)
    if floats[0].shape != (9,):
        raise ValueError(f"gate_faces takes 9 float constants, got {floats[0].shape}")
    out = torch.empty(P, dtype=torch.float32, device=active.device)
    err = load().vofod_gate_faces(
        active.data_ptr(), face_dirs.data_ptr(), rot.data_ptr(),
        None if table is None else table.data_ptr(), ints[1], floats[1], out.data_ptr(),
        _stream())
    _check(err, "vofod_gate_faces")
    _count("gate_faces")
    return out


def ray_update(vals: torch.Tensor, had_point: torch.Tensor, T6: torch.Tensor,
               faces: torch.Tensor | None, rel_x: torch.Tensor, rel_y: torch.Tensor,
               rel_z: torch.Tensor, rot: torch.Tensor, x0: int, y0: int, c, ema,
               gmax=None) -> None:
    """K5b, in place on ``vals``: the window's raylen from K4's T6 and the
    gate faces, then the ray EMA.  c: ops/raycast.py RayConsts; ema:
    RayEma.  One launch under the new rule, two under the old, whose max
    over the window passes through ``gmax`` (int32 bits of a non-negative
    float -> the same over every shard) between them when given."""
    if vals.dim() != 3:
        raise ValueError("ray_update takes the 3-D grid")
    nz, ny, nx = vals.shape
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    _require(vals, "ray vals", torch.float32)
    _require(had_point, "ray had_point", torch.bool, vals.shape)
    _require(T6, "ray T6", torch.float32, (6, nz, wy, wx))
    _require(rel_x, "ray rel_x", torch.float32, (wx,))
    _require(rel_y, "ray rel_y", torch.float32, (wy,))
    _require(rel_z, "ray rel_z", torch.float32, (nz,))
    _require(rot, "ray rot", torch.float32, (3, 3))
    F = 0
    if faces is not None:
        F = faces.shape[-1]
        _require(faces, "ray faces", torch.float32, (6, F, F))
    if not (0 <= x0 and x0 + wx <= nx and 0 <= y0 and y0 + wy <= ny):
        raise ValueError(f"ray window ({x0}, {y0}, {wx}, {wy}) outside the grid")
    ints = _host_i32(nz, ny, nx, wy, wx, y0, x0, F)
    floats = _host_f32(*c, ema.coef, ema.its, ema.weight, ema.score)
    raylen_w = max_bits = None
    if not ema.new_rule:
        raylen_w = torch.empty(nz * wy * wx, dtype=torch.float32, device=vals.device)
        max_bits = torch.zeros((), dtype=torch.int32, device=vals.device)
    def launch(passes: int) -> None:
        err = load().vofod_ray_update(
            vals.data_ptr(), had_point.data_ptr(), T6.data_ptr(),
            None if faces is None else faces.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(),
            rel_z.data_ptr(), rot.data_ptr(), ints[1], floats[1], int(bool(ema.new_rule)),
            None if raylen_w is None else raylen_w.data_ptr(),
            None if max_bits is None else max_bits.data_ptr(), passes, _stream())
        _check(err, "vofod_ray_update")

    _rule_passes(launch, ema, gmax, max_bits)
    _count("ray_update", 1 if ema.new_rule else 2)


def ray_update_geometry() -> tuple[int, int]:
    """K5b's tile (voxels along x, rows along y), which ops/raycast.py
    RAY_TILE mirrors."""
    out = (ctypes.c_int * 2)()
    _check(load().vofod_ray_update_geometry(out), "vofod_ray_update_geometry")
    return out[0], out[1]


def _rule_passes(launch, ema, gmax, max_bits) -> None:
    """The ray EMA's launches: all passes in one under the new rule (or
    with no ``gmax``); under the old, the max pass, the max over the shards
    (``gmax`` of the int32 bits), then the EMA pass."""
    if ema.new_rule or gmax is None:
        launch(3)
    else:
        launch(1)
        max_bits.copy_(gmax(max_bits))
        launch(2)


def detect(vals: torch.Tensor, far: torch.Tensor, labels: torch.Tensor,
           aabb_min: torch.Tensor, aabb_max: torch.Tensor, reps: torch.Tensor,
           n_points: torch.Tensor, cluster_class: torch.Tensor, obb_center: torch.Tensor,
           sensor_pos: torch.Tensor, det_counter: torch.Tensor, cs: int, origin,
           inv_voxel: float, c, window: tuple[int, int, int, int] | None = None):
    """K10: (valid bool [K], ids int32 [K], confidence f32 [K], pdet f32
    [K], covariance f32 [K, 3, 3], new counter int32) of the K cluster
    slots.  c: pipeline/detect.py DetectConsts.  ``window`` (nz, z_lo,
    own_z0, own_z1): the grids hold the rows [z_lo, z_lo + rows) of an
    nz-row grid and only the slots centred in [own_z0, own_z1) get their
    confidence (default: the whole grid)."""
    if vals.dim() != 3:
        raise ValueError("detect takes the 3-D grid")
    K = reps.shape[0]
    _require(vals, "detect vals", torch.float32)
    _require(far, "detect far", torch.bool, vals.shape)
    _require(labels, "detect labels", torch.int32, vals.shape)
    for t, name in ((aabb_min, "aabb_min"), (aabb_max, "aabb_max"), (obb_center, "obb_center")):
        _require(t, f"detect {name}", torch.float32, (K, 3))
    for t, name in ((reps, "reps"), (n_points, "n_points"), (cluster_class, "cluster_class")):
        _require(t, f"detect {name}", torch.int32, (K,))
    _require(sensor_pos, "detect sensor_pos", torch.float32, (3,))
    _require(det_counter, "detect det_counter", torch.int32, ())
    dev = vals.device
    valid = torch.empty(K, dtype=torch.bool, device=dev)
    ids = torch.empty(K, dtype=torch.int32, device=dev)
    confidence = torch.empty(K, dtype=torch.float32, device=dev)
    pdet = torch.empty(K, dtype=torch.float32, device=dev)
    cov = torch.empty((K, 3, 3), dtype=torch.float32, device=dev)
    new_counter = torch.empty((), dtype=torch.int32, device=dev)
    nzb, ny, nx = vals.shape
    nz, z_lo, own0, own1 = (nzb, 0, 0, nzb) if window is None else window
    ints = _host_i32(nz, ny, nx, K, cs, z_lo, nzb, own0, own1)
    floats = _host_f32(*origin, inv_voxel, *c)
    err = load().vofod_detect(
        vals.data_ptr(), far.data_ptr(), labels.data_ptr(), aabb_min.data_ptr(),
        aabb_max.data_ptr(), reps.data_ptr(), n_points.data_ptr(), cluster_class.data_ptr(),
        obb_center.data_ptr(), sensor_pos.data_ptr(), det_counter.data_ptr(), ints[1],
        floats[1], valid.data_ptr(), ids.data_ptr(), confidence.data_ptr(), pdet.data_ptr(),
        cov.data_ptr(), new_counter.data_ptr(), _stream())
    _check(err, "vofod_detect")
    _count("detect")
    return valid, ids, confidence, pdet, cov, new_counter


def detect_geometry() -> int:
    """K10's warps a slot, which set its window sum's order
    (pipeline/detect.py DET_WARPS mirrors it)."""
    out = (ctypes.c_int * 1)()
    _check(load().vofod_detect_geometry(out), "vofod_detect_geometry")
    return out[0]


def point_ema(vals: torch.Tensor, counts: torch.Tensor, close: torch.Tensor,
              score_point: float, score_unknown: float):
    """K11 point EMA: (new grid f32, far bool, n_occupied int32 scalar)."""
    _require(vals, "point_ema vals", torch.float32)
    _require(counts, "point_ema counts", torch.int32, vals.shape)
    _require(close, "point_ema close", torch.bool, vals.shape)
    out = torch.empty_like(vals)
    far = torch.empty(vals.shape, dtype=torch.bool, device=vals.device)
    n_occupied = torch.zeros((), dtype=torch.int32, device=vals.device)
    err = load().vofod_point_ema(
        vals.data_ptr(), counts.data_ptr(), close.data_ptr(), vals.numel(),
        float(score_point), float(score_unknown), out.data_ptr(), far.data_ptr(),
        n_occupied.data_ptr(), _stream())
    _check(err, "vofod_point_ema")
    _count("point_ema")
    return out, far, n_occupied


def _schedule(used) -> dict:
    return dict(zchunk=used[0], blocks=used[1], blocks_per_sm=used[2])


def _demote(vals, bg, safe, sure_sufficient, taps, halo, w1, c, used=None) -> torch.Tensor:
    if vals.dim() != 3:
        raise ValueError("demote_ema takes the 3-D grid")
    _require(vals, "demote_ema vals", torch.float32)
    _require(bg, "demote_ema bg", torch.bool, vals.shape)
    _require(safe, "demote_ema safe", torch.bool, vals.shape)
    _require(sure_sufficient, "demote_ema sure_sufficient", torch.bool, ())
    from vofod_tpu_torch.ops.morphology import run_table  # it imports this module

    table = run_table(taps, halo)
    out = torch.empty_like(vals)
    nz, ny, nx = vals.shape
    head = (vals.data_ptr(), bg.data_ptr(), safe.data_ptr(), sure_sufficient.data_ptr(),
            nz, ny, nx)
    if table.wide:
        acc = _fold_scratch(vals.shape, torch.int8, vals.device)
        err = load().vofod_demote_ema_wide(*head, *table.args, float(w1), float(c),
                                           out.data_ptr(), acc.data_ptr(), used, _stream())
        _check(err, "vofod_demote_ema_wide")
        _count("demote_ema_wide", table.n_pieces)
        return out
    err = load().vofod_demote_ema(
        *head, table.blob_ptr, len(table.blob), float(w1), float(c), out.data_ptr(), used,
        _stream())
    _check(err, "vofod_demote_ema")
    _count("demote_ema")
    return out


def demote_ema(vals: torch.Tensor, bg: torch.Tensor, safe: torch.Tensor,
               sure_sufficient: torch.Tensor, taps: np.ndarray, halo: int, w1: float,
               c: float) -> torch.Tensor:
    """K11 demotion EMA: K1's int8 ball max (run table of ``taps``) of ``bg
    & ~safe``, built while staging, with ``v' = w1 v + c`` where it is set
    and ``sure_sufficient``, applied where K1 stores."""
    return _demote(vals, bg, safe, sure_sufficient, taps, halo, w1, c)


def demote_ema_schedule(vals, bg, safe, sure_sufficient, taps, halo, w1,
                        c) -> tuple[torch.Tensor, dict]:
    """K11's demotion once, with the schedule the card chose (as
    :func:`ball_pool_schedule`)."""
    used = (ctypes.c_int * 3)()
    out = _demote(vals, bg, safe, sure_sufficient, taps, halo, w1, c, used)
    return out, _schedule(used)


def dda(starts: torch.Tensor, dirs: torch.Tensor, lengths: torch.Tensor, valid: torch.Tensor,
        shape: tuple[int, int, int], floats: np.ndarray, n_steps: int) -> torch.Tensor:
    """K12 walk: the f32 raylen grid ``shape`` of the rays' DDA chords,
    summed in float64 and rounded once.  floats: the f32 grid constants (ox,
    oy, oz, vs, 1/vs, vs/2) of ops/raycast.py ``_dda_consts``."""
    return _dda(starts, dirs, lengths, valid, shape, floats, n_steps, (0, shape[0]), "dda")


def dda_slab(starts: torch.Tensor, dirs: torch.Tensor, lengths: torch.Tensor,
             valid: torch.Tensor, shape: tuple[int, int, int], floats: np.ndarray, n_steps: int,
             slab: tuple[int, int]) -> torch.Tensor:
    """K15b-6c: K12's walk on every ray, keeping the chords of the grid rows
    ``slab`` (z0, rows) only: a shard's rows of :func:`dda`'s grid."""
    return _dda(starts, dirs, lengths, valid, shape, floats, n_steps, slab, "dda_slab")


def _dda(starts, dirs, lengths, valid, shape, floats, n_steps, slab, name) -> torch.Tensor:
    R = starts.shape[0]
    _require(starts, "dda starts", torch.float32, (R, 3))
    _require(dirs, "dda dirs", torch.float32, (R, 3))
    _require(lengths, "dda lengths", torch.float32, (R,))
    _require(valid, "dda valid", torch.bool, (R,))
    fl = _host_f32(*floats)
    if fl[0].shape != (6,):
        raise ValueError(f"dda takes 6 float constants, got {fl[0].shape}")
    nz, ny, nx = shape
    z0, nzl = slab
    ints = _host_i32(nx, ny, nz, n_steps, z0, nzl)
    acc = torch.zeros((nzl, ny, nx), dtype=torch.float64, device=starts.device)
    raylen = torch.empty((nzl, ny, nx), dtype=torch.float32, device=starts.device)
    err = load().vofod_dda(starts.data_ptr(), dirs.data_ptr(), lengths.data_ptr(),
                           valid.data_ptr(), R, fl[1], ints[1], acc.data_ptr(),
                           raylen.data_ptr(), _stream())
    _check(err, "vofod_dda")
    _count(name)
    return raylen


def ray_ema(vals: torch.Tensor, had_point: torch.Tensor, raylen: torch.Tensor, ema,
            gmax=None) -> None:
    """K12 EMA pass, in place on ``vals``: the ray EMA (ops/raycast.py
    RayEma ``ema``) on a full-grid raylen field.  One launch under the new
    rule, two under the old, whose max passes through ``gmax`` (int32 bits
    of a non-negative float -> the same over every shard) between them
    when given."""
    _require(vals, "ray_ema vals", torch.float32)
    _require(had_point, "ray_ema had_point", torch.bool, vals.shape)
    _require(raylen, "ray_ema raylen", torch.float32, vals.shape)
    floats = _host_f32(ema.coef, ema.its, ema.weight, ema.score)
    max_bits = None
    if not ema.new_rule:
        max_bits = torch.zeros((), dtype=torch.int32, device=vals.device)
    def launch(passes: int) -> None:
        err = load().vofod_ray_ema(
            vals.data_ptr(), had_point.data_ptr(), raylen.data_ptr(), vals.numel(), floats[1],
            int(bool(ema.new_rule)), None if max_bits is None else max_bits.data_ptr(), passes,
            _stream())
        _check(err, "vofod_ray_ema")

    _rule_passes(launch, ema, gmax, max_bits)
    _count("ray_ema", 1 if ema.new_rule else 2)


def label_census(labels: torch.Tensor, vals: torch.Tensor, occ: torch.Tensor, ncv: int,
                 min_sure: float):
    """K13a: (cell census int32, flags bool [2]) — the census of ``vals``
    over each component (label = bucket), read back per cell where ``occ``;
    flags = (any occ, any occ & census >= min_sure)."""
    _require(labels, "census labels", torch.int32)
    _require(vals, "census vals", torch.int32, labels.shape)
    _require(occ, "census occ", torch.bool, labels.shape)
    dev = labels.device
    census = torch.zeros(ncv, dtype=torch.int32, device=dev)
    out = torch.empty_like(labels)
    flags = torch.zeros(2, dtype=torch.bool, device=dev)
    err = load().vofod_label_census(
        labels.data_ptr(), vals.data_ptr(), occ.data_ptr(), labels.numel(), int(ncv),
        float(min_sure), census.data_ptr(), out.data_ptr(), flags.data_ptr(), _stream())
    _check(err, "vofod_label_census")
    _count("label_census")
    return out, flags


def census_scatter(labels: torch.Tensor, vals: torch.Tensor, occ: torch.Tensor,
                   ncv: int) -> torch.Tensor:
    """K15b-6a scatter: the int32 [ncv] census of a slab's cells, ``vals``
    added at each occupied cell's global label (ids >= ncv dropped)."""
    _require(labels, "census labels", torch.int32)
    _require(vals, "census vals", torch.int32, labels.shape)
    _require(occ, "census occ", torch.bool, labels.shape)
    census = torch.zeros(ncv, dtype=torch.int32, device=labels.device)
    err = load().vofod_census_scatter(labels.data_ptr(), vals.data_ptr(), occ.data_ptr(),
                                      labels.numel(), int(ncv), census.data_ptr(), _stream())
    _check(err, "vofod_census_scatter")
    _count("census_scatter")
    return census


def census_read(labels: torch.Tensor, occ: torch.Tensor, census: torch.Tensor,
                min_sure: float):
    """K15b-6a read-back: (cell census int32, flags bool [2] of this slab's
    cells) from the psum'd ``census``, as :func:`label_census`'s second pass."""
    _require(labels, "census labels", torch.int32)
    _require(occ, "census occ", torch.bool, labels.shape)
    _require(census, "census", torch.int32)
    out = torch.empty_like(labels)
    flags = torch.zeros(2, dtype=torch.bool, device=labels.device)
    err = load().vofod_census_read(labels.data_ptr(), occ.data_ptr(), census.data_ptr(),
                                   labels.numel(), census.numel(), float(min_sure),
                                   out.data_ptr(), flags.data_ptr(), _stream())
    _check(err, "vofod_census_read")
    _count("census_read")
    return out, flags


def quirk_counts(bg: torch.Tensor, sure: torch.Tensor, lsz: int) -> torch.Tensor:
    """K13b: the per-coarse-cell sure counts with the reference's
    VoxelGridCounted indexing quirk, int32 (ceil(nz/lsz), ceil(ny/lsz),
    ceil(nx/lsz)).  Four launches; the rank table gets no zero fill."""
    if bg.dim() != 3:
        raise ValueError("quirk_counts takes 3-D grids")
    _require(bg, "quirk bg", torch.bool)
    _require(sure, "quirk sure", torch.bool, bg.shape)
    nz, ny, nx = bg.shape
    nv, plane = bg.numel(), ny * nx
    dev = bg.device
    cshape = (-(-nz // lsz), -(-ny // lsz), -(-nx // lsz))
    nc = cshape[0] * cshape[1] * cshape[2]
    scratch = torch.empty(2 * plane + 2 + -(-plane // QUIRK_COL_TILE) + -(-nc // QUIRK_CELL_TILE),
                          dtype=torch.int64, device=dev)
    u = torch.empty(nv + 2, dtype=torch.int32, device=dev)
    out = torch.empty(cshape, dtype=torch.int32, device=dev)
    err = load().vofod_quirk_counts(bg.data_ptr(), sure.data_ptr(), nz, ny, nx, int(lsz),
                                    scratch.data_ptr(), u.data_ptr(), out.data_ptr(), _stream())
    _check(err, "vofod_quirk_counts")
    _count("quirk_counts")
    return out


def quirk_geometry() -> dict[str, int]:
    """K13b's and K15b-6b's single-pass scans on the current device:
    columns per tile of the column prefix, cells per tile of the cell pass,
    and how many blocks of each the card holds resident at once."""
    out = (ctypes.c_int * 4)()
    _check(load().vofod_quirk_geometry(out), "vofod_quirk_geometry")
    return dict(col_tile=out[0], cell_tile=out[1], col_resident=out[2], cell_resident=out[3])


def quirk_columns(bg: torch.Tensor, sure: torch.Tensor) -> torch.Tensor:
    """K15b-6b pass 1: int64 [ny * nx], each (y, x) column's sum over the
    slab of (bg << 32) | (sure & bg)."""
    if bg.dim() != 3:
        raise ValueError("quirk_columns takes a 3-D slab")
    _require(bg, "quirk bg", torch.bool)
    _require(sure, "quirk sure", torch.bool, bg.shape)
    nzl, ny, nx = bg.shape
    cols = torch.empty(ny * nx, dtype=torch.int64, device=bg.device)
    err = load().vofod_quirk_columns(bg.data_ptr(), sure.data_ptr(), nzl, ny, nx,
                                     cols.data_ptr(), _stream())
    _check(err, "vofod_quirk_columns")
    _count("quirk_columns")
    return cols


def quirk_ranks(bg: torch.Tensor, sure: torch.Tensor, blocks: torch.Tensor, rank: int,
                nv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K15b-6b passes 2 and 3: (u int32 [nv + 2] with u[rank] = t at the
    slab's bg voxels, 0 elsewhere; int64 scalar: the bg voxels of the shards
    below) from every shard's :func:`quirk_columns` ``blocks`` [n, ny * nx].
    Two launches beside the memsets of u and of the scan's state."""
    _require(bg, "quirk bg", torch.bool)
    _require(sure, "quirk sure", torch.bool, bg.shape)
    nzl, ny, nx = bg.shape
    nsh, plane = blocks.shape[0], ny * nx
    _require(blocks, "quirk blocks", torch.int64, (nsh, plane))
    dev = bg.device
    scratch = torch.empty(plane + 1 + -(-plane // QUIRK_COL_TILE), dtype=torch.int64, device=dev)
    u = torch.empty(nv + 2, dtype=torch.int32, device=dev)
    below = torch.empty((), dtype=torch.int64, device=dev)
    err = load().vofod_quirk_ranks(bg.data_ptr(), sure.data_ptr(), nzl, ny, nx,
                                   blocks.data_ptr(), nsh, int(rank), scratch.data_ptr(),
                                   u.data_ptr(), u.numel(), below.data_ptr(), _stream())
    _check(err, "vofod_quirk_ranks")
    _count("quirk_ranks")
    return u, below


def quirk_query(bg: torch.Tensor, lsz: int, u: torch.Tensor, below: torch.Tensor) -> torch.Tensor:
    """K15b-6b pass 4: the slab's per-coarse-cell quirk counts (int32
    (nzl / lsz, ceil(ny / lsz), ceil(nx / lsz))) from the psum'd ``u`` and
    :func:`quirk_ranks`' ``below``.  One launch beside the memset of the
    scan's state."""
    _require(bg, "quirk bg", torch.bool)
    _require(u, "quirk u", torch.int32)
    _require(below, "quirk below", torch.int64, ())
    nzl, ny, nx = bg.shape
    if nzl % lsz:
        raise ValueError(f"quirk_query: the leaf {lsz} must divide the slab height {nzl}")
    dev = bg.device
    cshape = (nzl // lsz, -(-ny // lsz), -(-nx // lsz))
    nc = cshape[0] * cshape[1] * cshape[2]
    scratch = torch.empty(1 + -(-nc // QUIRK_CELL_TILE), dtype=torch.int64, device=dev)
    out = torch.empty(cshape, dtype=torch.int32, device=dev)
    err = load().vofod_quirk_query(bg.data_ptr(), nzl, ny, nx, int(lsz), u.data_ptr(),
                                   below.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                                   _stream())
    _check(err, "vofod_quirk_query")
    _count("quirk_query")
    return out


def _exact_demote(vals, occ_c, census, flags, prev_sure, lsz, taps, halo, min_sure, w1, score,
                  thr_new, window, used=None):
    if vals.dim() != 3:
        raise ValueError("exact_demote_ema takes the 3-D grid")
    nz, ny, nx = vals.shape
    cshape = (-(-nz // lsz), -(-ny // lsz), -(-nx // lsz))
    win = None
    if window is not None:
        z_off, zc_lo, ncz = window
        cshape = (occ_c.shape[0],) + cshape[1:]
        win = _host_i32(z_off, zc_lo, occ_c.shape[0], ncz)
    _require(vals, "exact_demote vals", torch.float32)
    _require(occ_c, "exact_demote occ_c", torch.bool, cshape)
    _require(census, "exact_demote census", torch.int32, cshape)
    _require(flags, "exact_demote flags", torch.bool, (2,))
    _require(prev_sure, "exact_demote prev_sure", torch.bool, ())
    from vofod_tpu_torch.ops.morphology import run_table  # it imports this module

    table = run_table(taps, halo)
    dev = vals.device
    out = torch.empty_like(vals)
    safe = torch.empty(vals.shape, dtype=torch.bool, device=dev)
    sure_out = torch.empty((), dtype=torch.bool, device=dev)
    floats = _host_f32(min_sure, w1, score, thr_new)
    head = (vals.data_ptr(), occ_c.data_ptr(), census.data_ptr(), flags.data_ptr(),
            prev_sure.data_ptr(), nz, ny, nx, int(lsz))
    outs = (floats[1], None if win is None else win[1], out.data_ptr(), safe.data_ptr(),
            sure_out.data_ptr())
    if table.wide:
        # k sums in the s16 lanes of csrc/ema.cu: at most the centres (one a
        # lsz-lattice point) in the ball's box, never near 2^15 at the exact
        # census's leaf, ceil(r) - 1
        if min(len(taps), ((2 * halo) // lsz + 1) ** 3) >= 2**15:
            raise ValueError(f"K13c sums fewer than 2^15 centres a voxel: {len(taps)} taps "
                             f"at leaf size {lsz}")
        acc = _fold_scratch(vals.shape, torch.int8, dev)
        err = load().vofod_exact_demote_ema_wide(*head, *table.args, *outs, acc.data_ptr(), used,
                                                 _stream())
        _check(err, "vofod_exact_demote_ema_wide")
        _count("exact_demote_ema_wide", table.n_pieces)
        return out, safe, sure_out
    err = load().vofod_exact_demote_ema(
        *head, table.blob_ptr, len(table.blob), *outs, used, _stream())
    _check(err, "vofod_exact_demote_ema")
    _count("exact_demote_ema")
    return out, safe, sure_out


def exact_demote_ema(vals: torch.Tensor, occ_c: torch.Tensor, census: torch.Tensor,
                     flags: torch.Tensor, prev_sure: torch.Tensor, lsz: int, taps: np.ndarray,
                     halo: int, min_sure: float, w1: float, score: float, thr_new: float,
                     window: tuple[int, int, int] | None = None):
    """K13c: (new grid f32, safe bool grid, sure_sufficient bool scalar) of
    the exact demotion: w1^k v + (1 - w1^k) score, k = K1's ball sum (run
    table of ``taps``) of the unsure coarse-cell centres on the extended
    lattice, built while staging; flags: K13a's.  ``window`` (z_off, zc_lo,
    ncz): ``vals`` holds the rows [z_off, z_off + rows) of a grid of ncz
    coarse rows and occ_c / census its coarse rows from zc_lo (a shard's slab
    and its halo'd coarse arrays); default the whole grid."""
    return _exact_demote(vals, occ_c, census, flags, prev_sure, lsz, taps, halo, min_sure, w1,
                         score, thr_new, window)


def exact_demote_ema_schedule(vals, occ_c, census, flags, prev_sure, lsz, taps, halo, min_sure,
                              w1, score, thr_new, window=None):
    """K13c once, with the schedule the card chose: (out, safe, sure,
    {zchunk, blocks, blocks_per_sm})."""
    used = (ctypes.c_int * 3)()
    got = _exact_demote(vals, occ_c, census, flags, prev_sure, lsz, taps, halo, min_sure, w1,
                        score, thr_new, window, used)
    return (*got, _schedule(used))


def unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K15a: (counts int32, blockers bool) of the host-binned uint8 grid:
    counts = packed & 0x3F, blockers = packed >= 0x80."""
    if not (packed.is_cuda and packed.dtype == torch.uint8 and packed.is_contiguous()):
        _require(packed, "unpack packed", torch.uint8)  # raises, naming what is wrong
    n = packed.numel()
    if n == 0:
        raise ValueError("unpack takes a non-empty grid")
    # empty_like: the cheapest allocation on the host (chip_ab.py's profile)
    counts = torch.empty_like(packed, dtype=torch.int32)
    blockers = torch.empty_like(packed, dtype=torch.bool)
    err = load().vofod_unpack(packed.data_ptr(), counts.data_ptr(), blockers.data_ptr(), n,
                              _stream(packed.get_device()))
    _check(err, "vofod_unpack")
    _count("unpack")
    return counts, blockers


_MAX_HOPS = 16  # csrc/halo.cu MAX_HOPS


def _hops_arg(lo: list, hi: list, takes: list[int], like: torch.Tensor,
              hi_takes: list[int] | None = None) -> bytes:
    """The packed hop table of csrc/halo.cu: per hop (lo block pointer, hi
    block pointer, lo rows, hi rows) as four int64, 0 for a missing block;
    ``hi_takes`` (default ``takes``) the high side's rows a hop, the shorter
    list padded with 0.  Checks what the C side cannot: each block's device,
    dtype, shape and contiguity against ``like`` (a slab of the same
    planes)."""
    hi_takes = takes if hi_takes is None else hi_takes
    n = max(len(takes), len(hi_takes))
    if n > _MAX_HOPS:
        raise ValueError(f"halo of {n} hops; the kernels take at most {_MAX_HOPS}")
    if len(lo) != len(takes) or len(hi) != len(hi_takes):
        raise ValueError(f"halo blocks ({len(lo)}, {len(hi)}) for hops of rows {takes} / "
                         f"{hi_takes}")
    dev, dt, plane = like.device, like.dtype, tuple(like.shape[1:])
    flat = []
    for h in range(n):
        row = []
        for blocks, rows in ((lo, takes), (hi, hi_takes)):
            blk, take = (blocks[h], rows[h]) if h < len(rows) else (None, 0)
            want = (take,) + plane
            if blk is not None and (blk.shape != want or blk.dtype != dt or blk.device != dev
                                    or not blk.is_contiguous()):
                raise ValueError(f"halo block {blk.dtype} {tuple(blk.shape)} on {blk.device}: "
                                 f"expected a contiguous {dt} {want} on {dev}")
            row.append((0 if blk is None else blk.data_ptr(), take))
        flat += (row[0][0], row[1][0], row[0][1], row[1][1])
    return struct.pack("<%dq" % len(flat), *flat)


_FILL_BITS = {torch.float32: lambda v: struct.unpack("<I", struct.pack("<f", v))[0],
              torch.int32: lambda v: int(v) & 0xFFFFFFFF,
              torch.uint8: lambda v: int(v) & 0xFF, torch.int8: lambda v: int(v) & 0xFF,
              torch.bool: lambda v: int(bool(v))}
HALO_DTYPES = frozenset(_FILL_BITS)  # the slabs K15b-1 takes


def _halo_slab(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda or t.dtype not in HALO_DTYPES or t.dim() < 2 or not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous CUDA f32/int32/int8/uint8/bool slab, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def halo_exchange(g: torch.Tensor, lo: list, hi: list, takes: list[int], fill) -> torch.Tensor:
    """K15b-1: the slab ``g`` [nzl, ...] extended by r = sum(takes) rows on
    each side: hop h's block ``lo[h]`` (the last takes[h] rows of the shard h
    below) and ``hi[h]`` (the first rows of the shard h above), ``fill``
    where a block is None.  f32 / int32 / int8 / uint8 / bool."""
    _halo_slab(g, "halo_exchange")
    hops = _hops_arg(lo, hi, takes, g)
    nzl, r = g.shape[0], sum(takes)
    ext = torch.empty((nzl + 2 * r,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
    err = load().vofod_halo_exchange(
        g.data_ptr(), ext.data_ptr(), g.element_size(), nzl, r, r, g.numel() // nzl, hops,
        len(takes), _FILL_BITS[g.dtype](fill), _stream())
    _check(err, "vofod_halo_exchange")
    _count("halo_exchange")
    return ext


def halo_fill_(ext: torch.Tensor, r: int, lo: list, hi: list, takes: list[int], fill,
               hi_takes: list[int] | None = None) -> None:
    """K15b-1 in place: the halo rows of ``ext`` [r + nzl + r_hi, ...] from
    the hops' blocks (as :func:`halo_exchange`), its interior rows
    untouched: r = sum(takes) rows below and r_hi = sum(hi_takes) above
    (``hi_takes`` default ``takes``; a hop of 0 rows on one side brings
    nothing there).  Launches nothing when there is no halo row."""
    _halo_slab(ext, "halo_fill_")
    hi_takes = takes if hi_takes is None else hi_takes
    r_hi = sum(hi_takes)
    nzl = ext.shape[0] - r - r_hi
    if nzl < 1 or r != sum(takes):
        raise ValueError(f"halo_fill_: {ext.shape[0]} rows cannot hold a halo of {takes} / "
                         f"{hi_takes}")
    if r + r_hi == 0:
        return
    hops = _hops_arg(lo, hi, takes, ext, hi_takes)
    err = load().vofod_halo_exchange(
        None, ext.data_ptr(), ext.element_size(), nzl, r, r_hi, ext.numel() // ext.shape[0],
        hops, max(len(takes), len(hi_takes)), _FILL_BITS[ext.dtype](fill), _stream())
    _check(err, "vofod_halo_exchange")
    _count("halo_exchange")


def halo_geometry() -> dict[str, int]:
    """K15b-1 on the current device: bytes a thread block copies (one tile)
    and how many blocks the card holds resident at once."""
    out = (ctypes.c_int * 2)()
    _check(load().vofod_halo_geometry(out), "vofod_halo_geometry")
    return dict(tile_bytes=out[0], resident=out[1])


def halo_fold_min(ext: torch.Tensor, r: int, from_next: list, from_prev: list,
                  takes: list[int]) -> torch.Tensor:
    """K15b-2: the interior rows of ``ext`` [nzl + 2r, ...] (f32) min-folded
    with the blocks the neighbours sent back: ``from_next[h]`` onto the last
    takes[h] rows, ``from_prev[h]`` onto the first (None: no shard)."""
    _require(ext, "fold ext", torch.float32)
    nzl = ext.shape[0] - 2 * r
    if nzl < 1:
        raise ValueError(f"halo_fold_min: {ext.shape[0]} rows cannot hold a halo of {r}")
    hops = _hops_arg(from_next, from_prev, takes, ext)
    out = torch.empty((nzl,) + tuple(ext.shape[1:]), dtype=torch.float32, device=ext.device)
    err = load().vofod_halo_fold_min(ext.data_ptr(), out.data_ptr(), nzl, r, ext[0].numel(),
                                     hops, len(takes), _stream())
    _check(err, "vofod_halo_fold_min")
    _count("halo_fold_min")
    return out


def _cone_slab(opaque: torch.Tensor, rel_x: torch.Tensor, rel_y: torch.Tensor,
               rel_z: torch.Tensor, carry: torch.Tensor | None, slab, rows, p0: int, m: int,
               n_planes: int, carry_shape, what: str) -> None:
    """The checks of K15b-3's and K15b-4b's launches (see the wrappers)."""
    nz, wy, wx = opaque.shape
    _require(opaque, f"{what} opaque", torch.uint8)
    _require(rel_x, f"{what} rel_x", torch.float32, (wx,))
    _require(rel_y, f"{what} rel_y", torch.float32, (wy,))
    _require(rel_z, f"{what} rel_z", torch.float32, (nz,))
    if not (0 <= slab[0] <= rows[0] < rows[1] <= slab[1] and 0 <= p0 < n_planes and m >= 1):
        raise ValueError(f"{what}: slab {tuple(slab)}, T rows {tuple(rows)}, planes [{p0}, "
                         f"{p0 + m}) of {n_planes}")
    if carry is not None:
        _require(carry, f"{what} carry", torch.bfloat16, carry_shape)
    elif p0 > 0 or p0 + m < n_planes:
        raise ValueError(f"{what}: planes [{p0}, {p0 + m}) of {n_planes} need a carry")


def cone_sweep_lat(opaque: torch.Tensor, rel_x: torch.Tensor, rel_y: torch.Tensor,
                   rel_z: torch.Tensor, carry: torch.Tensor | None, T4: torch.Tensor,
                   slab: tuple[int, int], rows: tuple[int, int], p0: int, m: int) -> None:
    """K15b-3, one launch: planes [p0, p0 + m) of the x and y cones (each
    clipped to its own planes) on the z rows [slab[0], slab[1]) of the
    window, each cone on a thread-block cluster of
    :data:`CONE_CLUSTER` blocks (see csrc/cone_sweep.cu).  opaque:
    uint8 window [nz, wy, wx]; rel_*: its f32 offsets; carry: bf16 [slab
    rows, 4, max(wx, wy)], the carry of every slab row, read when p0 > 0 and
    written in place when planes follow (None when the launch sweeps every
    plane); T4: f32 [4, rows[1] - rows[0], wy, wx], the x and y cones of the
    z rows [rows[0], rows[1]), written in place.  Raises when the card
    cannot schedule such a cluster."""
    nz, wy, wx = opaque.shape
    pb = max(wx, wy)
    _cone_slab(opaque, rel_x, rel_y, rel_z, carry, slab, rows, p0, m, pb,
               (slab[1] - slab[0], 4, pb), "cone_lat")
    if slab[1] > nz:
        raise ValueError(f"cone_lat: slab {tuple(slab)} past the window's {nz} z rows")
    _require(T4, "cone_lat T", torch.float32, (4, rows[1] - rows[0], wy, wx))
    err = load().vofod_cone_sweep_lat(
        opaque.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(), rel_z.data_ptr(),
        None if carry is None else carry.data_ptr(), T4.data_ptr(), nz, wy, wx, int(slab[0]),
        int(slab[1]), int(rows[0]), int(rows[1]), int(p0), int(m), _stream())
    _check(err, "vofod_cone_sweep_lat")
    _count("cone_sweep_lat")


def cone_sweep_z(opaque: torch.Tensor, rel_x: torch.Tensor, rel_y: torch.Tensor,
                 rel_z: torch.Tensor, carry_in: torch.Tensor, T2: torch.Tensor,
                 keep: tuple[bool, bool]) -> torch.Tensor:
    """K15b-4a, a shard's kept cones of one round: the z cones in ``keep``
    (at least one) over the shard's planes, each on a thread-block cluster of
    :data:`CONE_CLUSTER` blocks, from their carry planes in ``carry_in``
    (bf16 [2, wy, wx]); writes their T2 (f32 [2, nzl, wy, wx]) and returns
    the carry planes out (the planes of the cones not kept undefined)."""
    nzl, wy, wx = opaque.shape
    _require(opaque, "cone_z opaque", torch.uint8)
    _require(rel_x, "cone_z rel_x", torch.float32, (wx,))
    _require(rel_y, "cone_z rel_y", torch.float32, (wy,))
    _require(rel_z, "cone_z rel_z", torch.float32, (nzl,))
    _require(carry_in, "cone_z carry_in", torch.bfloat16, (2, wy, wx))
    _require(T2, "cone_z T", torch.float32, (2, nzl, wy, wx))
    if not any(keep):
        raise ValueError("cone_sweep_z sweeps at least one cone")
    carry_out = torch.empty_like(carry_in)
    err = load().vofod_cone_sweep_z(
        opaque.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(), rel_z.data_ptr(),
        carry_in.data_ptr(), carry_out.data_ptr(), T2.data_ptr(), nzl, wy, wx,
        int(keep[0]) | (int(keep[1]) << 1), _stream())
    _check(err, "vofod_cone_sweep_z")
    _count("cone_sweep_z")
    return carry_out


def cone_sweep_zt(opaque: torch.Tensor, rel_x: torch.Tensor, rel_y: torch.Tensor,
                  rel_z: torch.Tensor, carry: torch.Tensor | None, T2: torch.Tensor,
                  slab: tuple[int, int], rows: tuple[int, int], p0: int, m: int) -> None:
    """K15b-4b, one launch: planes [p0, p0 + m) of both z cones on the y
    rows [slab[0], slab[1]) of the window (slab[1] <= wy), each cone on a
    thread-block cluster of :data:`CONE_CLUSTER` blocks (see
    csrc/cone_sweep.cu).  opaque: uint8 window [nz, wy, wx]; rel_*: its f32
    offsets; carry: bf16 [slab rows, 2, wx], read when p0 > 0 and written in
    place when planes follow (None when the launch sweeps every plane); T2:
    f32 [2, nz, t_ny, wx], the y rows [rows[0], rows[1]) at its rows from 0
    (t_ny >= rows[1] - rows[0]), written in place."""
    nz, wy, wx = opaque.shape
    _cone_slab(opaque, rel_x, rel_y, rel_z, carry, slab, rows, p0, m, nz,
               (slab[1] - slab[0], 2, wx), "cone_zt")
    if slab[1] > wy:
        raise ValueError(f"cone_zt: slab {tuple(slab)} past the window's {wy} y rows")
    _require(T2, "cone_zt T", torch.float32)
    t_ny = T2.shape[2] if T2.dim() == 4 else -1
    if tuple(T2.shape) != (2, nz, t_ny, wx) or t_ny < rows[1] - rows[0]:
        raise ValueError(f"cone_zt T {tuple(T2.shape)}: expected (2, {nz}, >= "
                         f"{rows[1] - rows[0]}, {wx})")
    err = load().vofod_cone_sweep_zt(
        opaque.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(), rel_z.data_ptr(),
        None if carry is None else carry.data_ptr(), T2.data_ptr(), nz, wy, wx, int(slab[0]),
        int(slab[1]), int(rows[0]), int(rows[1]), t_ny, int(p0), int(m), _stream())
    _check(err, "vofod_cone_sweep_zt")
    _count("cone_sweep_zt")
