"""Build, load and launch the hand-written CUDA kernels (K1-K15, K7s).

The sources in ``csrc/`` compile with ``nvcc`` into ONE shared library with
a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so the
build takes seconds).  The library is built at first use into
``build/vofod_tpu_torch/`` at the root of the checkout, keyed by a hash of
the sources and flags; a missing ``nvcc`` or a failed build raises with the
compiler's output — there is no fallback to the plain PyTorch versions.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch``, launches on ``torch.cuda.current_stream()``, raises
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
_HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: dict[str, int] = {
    "ball_pool": 0,
    "shell_pool": 0,
    "propagate_sweep": 0,
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
}

# The stencil kernels (K1, K2, the K11 and K13c epilogues, K14) take any tap
# set of at most MAX_TAPS offsets within halo MAX_HALO (csrc/common.cuh): the
# ball of r^2 < 64 has 2,103 taps.

MAX_TAPS = 2112
MAX_HALO = 7

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
    with _lock:
        if _lib is not None:
            return _lib
        so, _ = build()
        lib = ctypes.CDLL(str(so))
        lib.vofod_ball_pool.argtypes = [
            _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P]
        lib.vofod_propagate_sweep.argtypes = [
            _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I, _P]
        lib.vofod_frontend_bin.argtypes = [
            _P, _P, _P, _P, _I, _P, _F, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.vofod_cone_sweep.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
        lib.vofod_compact.argtypes = [_P, _P, _P, _I, _LL, _I, _P, _P, _P, _P, _P]
        lib.vofod_explore.argtypes = [
            _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _P, _P, _P, _P]
        lib.vofod_demote.argtypes = [
            _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P]
        lib.vofod_explore_sequential.argtypes = [
            _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _P, _P,
            _P]
        lib.vofod_cluster_stats.argtypes = [
            _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P]
        lib.vofod_gate_faces.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P]
        lib.vofod_ray_update.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P]
        lib.vofod_detect.argtypes = [_P] * 20
        lib.vofod_point_ema.argtypes = [_P, _P, _P, _LL, _F, _F, _P, _P, _P, _P]
        lib.vofod_demote_ema.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _F, _F, _P, _P]
        lib.vofod_dda.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P]
        lib.vofod_ray_ema.argtypes = [_P, _P, _P, _LL, _P, _I, _P, _P]
        lib.vofod_label_census.argtypes = [_P, _P, _P, _LL, _I, _F, _P, _P, _P, _P]
        lib.vofod_quirk_counts.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
        lib.vofod_exact_demote_ema.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P]
        lib.vofod_unpack.argtypes = [_P, _P, _P, _LL, _P]
        lib.vofod_halo_exchange.argtypes = [
            _P, _P, _I, _I, _I, _LL, _P, _P, _P, _I, ctypes.c_uint, _P]
        lib.vofod_halo_fold_min.argtypes = [_P, _P, _I, _I, _LL, _P, _P, _P, _I, _P]
        lib.vofod_cone_sweep_lat.argtypes = [_P] * 9 + [_I] * 4 + [_P]
        lib.vofod_cone_sweep_z.argtypes = [_P] * 7 + [_I] * 4 + [_P]
        for fn in (lib.vofod_ball_pool, lib.vofod_propagate_sweep,
                   lib.vofod_frontend_bin, lib.vofod_cone_sweep, lib.vofod_compact,
                   lib.vofod_explore, lib.vofod_demote, lib.vofod_explore_sequential,
                   lib.vofod_cluster_stats,
                   lib.vofod_gate_faces, lib.vofod_ray_update, lib.vofod_detect,
                   lib.vofod_point_ema, lib.vofod_demote_ema, lib.vofod_dda,
                   lib.vofod_ray_ema, lib.vofod_label_census, lib.vofod_quirk_counts,
                   lib.vofod_exact_demote_ema, lib.vofod_unpack, lib.vofod_halo_exchange,
                   lib.vofod_halo_fold_min, lib.vofod_cone_sweep_lat, lib.vofod_cone_sweep_z):
            fn.restype = _I
        _lib = lib
        return lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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
    """The tap set as the C entry points take it; raises past the kernels'
    limits (MAX_TAPS taps, every |offset| <= halo <= MAX_HALO)."""
    arr = np.ascontiguousarray(taps, dtype=np.int32).reshape(-1, 3)
    reach = int(np.abs(arr).max()) if len(arr) else 0
    if not (1 <= len(arr) <= MAX_TAPS and reach <= halo <= MAX_HALO):
        raise ValueError(
            f"the stencil kernels take 1-{MAX_TAPS} taps within halo {MAX_HALO} (radius < 8 "
            f"voxels); got {len(arr)} taps reaching {reach} with halo {halo}")
    return arr, arr.ctypes.data_as(_P)


_DTYPE_CODE = {torch.int8: 0, torch.int32: 1}
_OP_CODE = {"min": 0, "max": 1, "sum": 2}


def _pool(a: torch.Tensor, taps: np.ndarray, halo: int, op: str, fill: int) -> torch.Tensor:
    if a.dtype not in _DTYPE_CODE or a.dim() != 3:
        raise ValueError(f"ball_pool takes a 3-D int8/int32 grid, got {a.dtype} {tuple(a.shape)}")
    if op == "sum" and a.dtype != torch.int32:
        raise ValueError("ball_pool sum takes int32")
    _require(a, "ball_pool input", a.dtype)
    keep, ptr = _taps_arg(taps, halo)
    out = torch.empty_like(a)
    nz, ny, nx = a.shape
    err = load().vofod_ball_pool(
        a.data_ptr(), out.data_ptr(), _DTYPE_CODE[a.dtype], _OP_CODE[op],
        nz, ny, nx, ptr, len(keep), halo, int(fill), _stream())
    _check(err, "vofod_ball_pool")
    return out


def ball_pool(a: torch.Tensor, taps: np.ndarray, halo: int, op: str,
              fill: int) -> torch.Tensor:
    """K1: out[v] = op over the ball taps of a (out-of-grid taps read fill)."""
    out = _pool(a, taps, halo, op, fill)
    _count("ball_pool")
    return out


def shell_pool(a: torch.Tensor, taps: np.ndarray, halo: int, op: str,
               fill: int) -> torch.Tensor:
    """K14: the traced-radius pool of cfg.dynamic_radii — K1's kernel on the
    kept shells of a static bound (ops/morphology.shell_taps)."""
    out = _pool(a, taps, halo, op, fill)
    _count("shell_pool")
    return out


def propagate_sweep(src: torch.Tensor, dst: torch.Tensor, occ: torch.Tensor,
                    taps: np.ndarray, halo: int, changed: torch.Tensor,
                    prev_changed: torch.Tensor | None = None,
                    flag_rows: tuple[int, int] | None = None) -> None:
    """K2: one Jacobi sweep src -> dst.  int32 src: min-label sweep (off-mask
    SENTINEL); uint8 src: reach sweep.  ORs 1 into ``changed`` (device
    int32 scalar) when any voxel of the z rows ``flag_rows`` (default: all)
    changed.  With ``prev_changed`` (the previous sweep's flag) the launch
    does nothing when that flag is 0."""
    lib = load()
    mode = {torch.int32: 0, torch.uint8: 1}.get(src.dtype)
    if mode is None or src.dim() != 3:
        raise ValueError(f"propagate_sweep takes a 3-D int32/uint8 grid, got {src.dtype}")
    _require(src, "propagate_sweep src", src.dtype)
    _require(dst, "propagate_sweep dst", src.dtype, src.shape)
    _require(occ, "propagate_sweep occ", torch.uint8, src.shape)
    _require(changed, "propagate_sweep changed", torch.int32, ())
    if prev_changed is not None:
        _require(prev_changed, "propagate_sweep prev_changed", torch.int32, ())
    keep, ptr = _taps_arg(taps, halo)
    nz, ny, nx = src.shape
    fz0, fz1 = (0, nz) if flag_rows is None else flag_rows
    err = lib.vofod_propagate_sweep(
        src.data_ptr(), dst.data_ptr(), occ.data_ptr(), mode, nz, ny, nx,
        ptr, len(keep), halo, changed.data_ptr(),
        None if prev_changed is None else prev_changed.data_ptr(), fz0, fz1, _stream())
    _check(err, "vofod_propagate_sweep")
    _count("propagate_sweep")


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
    """K4: transmittance T [6, nz, ny, nx] f32 of the six cone sweeps."""
    lib = load()
    if opaque.dim() != 3:
        raise ValueError("cone_sweep takes a 3-D opacity window")
    nz, ny, nx = opaque.shape
    _require(opaque, "cone_sweep opaque", torch.uint8)
    _require(rel_x, "cone_sweep rel_x", torch.float32, (nx,))
    _require(rel_y, "cone_sweep rel_y", torch.float32, (ny,))
    _require(rel_z, "cone_sweep rel_z", torch.float32, (nz,))
    T = torch.empty((6, nz, ny, nx), dtype=torch.float32, device=opaque.device)
    err = lib.vofod_cone_sweep(
        opaque.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(),
        rel_z.data_ptr(), T.data_ptr(), nz, ny, nx, _stream())
    _check(err, "vofod_cone_sweep")
    _count("cone_sweep")
    return T


_COMPACT_CHUNK = 4096  # elements per block of csrc/compact.cu


def masked_compact(mask: torch.Tensor, capacity: int, labels: torch.Tensor | None = None,
                   sel: torch.Tensor | None = None):
    """K6: (ids int32 [capacity], valid bool [capacity], total int32 scalar)
    of the set elements of ``mask`` — or, with ``labels`` and ``sel``, of
    ``mask & isin(labels, sel)`` (``sel``: int32, at most 32 values)."""
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
    nb = -(-n // _COMPACT_CHUNK)
    scratch = torch.empty(2 * nb, dtype=torch.int32, device=dev)
    ids = torch.empty(capacity, dtype=torch.int32, device=dev)
    valid = torch.empty(capacity, dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    err = lib.vofod_compact(
        mask.data_ptr(), lab_ptr, sel_ptr, nsel, n, capacity, scratch.data_ptr(),
        ids.data_ptr(), valid.data_ptr(), total.data_ptr(), _stream())
    _check(err, "vofod_compact")
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
    [z_lo, z_lo + rows) of an nz_g-row grid (:func:`_z_window`)."""
    lib = load()
    if vmap.dim() != 3:
        raise ValueError("explore takes a 3-D grid")
    Q, S = qx.shape[0], int(submap)
    if not 2 <= S <= 62:
        raise ValueError(f"explore submap side must be in [2, 62], got {S}")
    _require(vmap, "explore grid", torch.float32)
    for t, name in ((qx, "qx"), (qy, "qy"), (qz, "qz"), (max_manhattan, "max_manhattan")):
        _require(t, f"explore {name}", torch.int32, (Q,))
    _require(qvalid, "explore qvalid", torch.bool, (Q,))
    dev = vmap.device
    connected = torch.empty(Q, dtype=torch.bool, device=dev)
    reached = torch.empty((Q, S, S), dtype=torch.int64, device=dev)
    corners = torch.empty((Q, 3), dtype=torch.int32, device=dev)
    nz, ny, nx = vmap.shape
    err = lib.vofod_explore(
        vmap.data_ptr(), nz, ny, nx, *_z_window(vmap, z_window), qx.data_ptr(), qy.data_ptr(), qz.data_ptr(),
        qvalid.data_ptr(), max_manhattan.data_ptr(), float(thr_frontiers), float(thr_ground),
        Q, S, int(max_iters), connected.data_ptr(), reached.data_ptr(), corners.data_ptr(),
        _stream())
    _check(err, "vofod_explore")
    _count("explore_bfs")
    return connected, reached, corners


def demote_(vmap: torch.Tensor, reached: torch.Tensor, corners: torch.Tensor,
            qslot: torch.Tensor, connected: torch.Tensor, qvalid: torch.Tensor,
            qgate: torch.Tensor, query_overflow: torch.Tensor, thr_frontiers: float,
            z_window: tuple[int, int] | None = None):
    """K8, in place on ``vmap``: min(v, thr) at the reached voxels of every
    query that demotes.  Returns the int32 count of those writes.
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
    n_writes = torch.zeros((), dtype=torch.int32, device=vmap.device)
    nz, ny, nx = vmap.shape
    err = lib.vofod_demote(
        vmap.data_ptr(), nz, ny, nx, *_z_window(vmap, z_window), reached.data_ptr(), corners.data_ptr(), S,
        qslot.data_ptr(), connected.data_ptr(), qvalid.data_ptr(), qgate.data_ptr(),
        query_overflow.data_ptr(), Q, K, float(thr_frontiers), n_writes.data_ptr(), _stream())
    _check(err, "vofod_demote")
    _count("demote")
    return n_writes


def explore_sequential_(vmap: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor,
                        qz: torch.Tensor, qvalid: torch.Tensor, qlabels: torch.Tensor,
                        qids: torch.Tensor, qslot: torch.Tensor, max_manhattan: torch.Tensor,
                        query_overflow: torch.Tensor, thr_frontiers: float, thr_ground: float,
                        submap: int, max_iters: int):
    """K7s, in place on ``vmap``: the queries explored one at a time in
    (label, id) order, a failed one demoting its reached voxels before the
    next runs.  Returns (cluster_connected bool [K], n_writes int32)."""
    if vmap.dim() != 3:
        raise ValueError("explore_sequential takes a 3-D grid")
    Q, S = qx.shape[0], int(submap)
    K = qslot.shape[-1] if qslot.dim() == 2 else 0
    if not 2 <= S <= 62:
        raise ValueError(f"explore submap side must be in [2, 62], got {S}")
    if not (1 <= Q <= 4096 and K >= 1):
        raise ValueError(f"explore_sequential takes 1-4096 queries and >= 1 slot, got Q={Q}, "
                         f"K={K}")
    _require(vmap, "explore_seq grid", torch.float32)
    for t, name in ((qx, "qx"), (qy, "qy"), (qz, "qz"), (qlabels, "qlabels"), (qids, "qids"),
                    (max_manhattan, "max_manhattan")):
        _require(t, f"explore_seq {name}", torch.int32, (Q,))
    _require(qvalid, "explore_seq qvalid", torch.bool, (Q,))
    _require(qslot, "explore_seq qslot", torch.bool, (Q, K))
    _require(query_overflow, "explore_seq query_overflow", torch.bool, ())
    dev = vmap.device
    cluster_connected = torch.empty(K, dtype=torch.bool, device=dev)
    n_writes = torch.empty((), dtype=torch.int32, device=dev)
    nz, ny, nx = vmap.shape
    err = load().vofod_explore_sequential(
        vmap.data_ptr(), nz, ny, nx, qx.data_ptr(), qy.data_ptr(), qz.data_ptr(),
        qvalid.data_ptr(), qlabels.data_ptr(), qids.data_ptr(), qslot.data_ptr(),
        max_manhattan.data_ptr(), query_overflow.data_ptr(), float(thr_frontiers),
        float(thr_ground), Q, K, S, int(max_iters), cluster_connected.data_ptr(),
        n_writes.data_ptr(), _stream())
    _check(err, "vofod_explore_sequential")
    _count("explore_seq")
    return cluster_connected, n_writes


# output fields of K9, in the order of csrc/classify_stats.cu StatsOut
_STATS_FIELDS = (
    ("reps", torch.int32, ()), ("slot_valid", torch.bool, ()), ("npts", torch.int32, ()),
    ("aabb_min", torch.float32, (3,)), ("aabb_max", torch.float32, (3,)),
    ("obb_center", torch.float32, (3,)), ("axes", torch.float32, (3, 3)),
    ("obb_extent", torch.float32, (3,)), ("obb_size", torch.float32, ()),
    ("gated", torch.bool, ()), ("m_k", torch.int32, ()), ("qgate", torch.bool, ()),
    ("rep_sel", torch.int32, ()),
)


def cluster_stats(fids: torch.Tensor, fvalid: torch.Tensor, labels: torch.Tensor, K: int,
                  grid_origin, voxel_size: float, gates, sensor_pos: torch.Tensor,
                  bg_sufficient: torch.Tensor, sure_bg_sufficient: torch.Tensor,
                  ftotal: torch.Tensor, grid_yx: tuple[int, int]) -> dict[str, torch.Tensor]:
    """K9: the per-slot statistics of the far list, keyed as
    ``_STATS_FIELDS`` plus ``cluster_overflow``.  ``labels``: the far
    voxels' labels, int32 [F]; ``grid_yx``: the grid's (ny, nx).
    ``gates``: (min_points, max_distance, max_size, max_explore_distance)."""
    lib = load()
    F = fids.shape[0]
    _require(fids, "stats fids", torch.int32, (F,))
    _require(fvalid, "stats fvalid", torch.bool, (F,))
    _require(labels, "stats labels", torch.int32, (F,))
    _require(sensor_pos, "stats sensor_pos", torch.float32, (3,))
    _require(bg_sufficient, "stats bg_sufficient", torch.bool, ())
    _require(sure_bg_sufficient, "stats sure_bg_sufficient", torch.bool, ())
    _require(ftotal, "stats ftotal", torch.int32, ())
    dev = fids.device
    out = {name: torch.empty((K, *tail), dtype=dt, device=dev)
           for name, dt, tail in _STATS_FIELDS}
    out["cluster_overflow"] = torch.empty((), dtype=torch.bool, device=dev)
    ptrs = np.array([t.data_ptr() for t in out.values()], dtype=np.int64)
    slot_scratch = torch.empty(F, dtype=torch.int32, device=dev)
    grid_f = np.array([*grid_origin, voxel_size], dtype=np.float32)
    gate_f = np.array(gates, dtype=np.float32)
    assert grid_f.shape == (4,) and gate_f.shape == (4,)
    ny, nx = grid_yx
    err = lib.vofod_cluster_stats(
        fids.data_ptr(), fvalid.data_ptr(), labels.data_ptr(), F, K, ny, nx,
        grid_f.ctypes.data_as(_P), gate_f.ctypes.data_as(_P), sensor_pos.data_ptr(),
        bg_sufficient.data_ptr(), sure_bg_sufficient.data_ptr(), ftotal.data_ptr(),
        slot_scratch.data_ptr(), ptrs.ctypes.data_as(_P), _stream())
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

    if ema.new_rule or gmax is None:
        launch(3)
    else:
        launch(1)
        max_bits.copy_(gmax(max_bits))
        launch(2)
    _count("ray_update", 1 if ema.new_rule else 2)


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


def demote_ema(vals: torch.Tensor, bg: torch.Tensor, safe: torch.Tensor,
               sure_sufficient: torch.Tensor, taps: np.ndarray, halo: int, w1: float,
               c: float) -> torch.Tensor:
    """K11 demotion EMA: the K1 ball max of ``bg & ~safe`` (ball ``taps``)
    with ``v' = w1 v + c`` where it is set and ``sure_sufficient``."""
    if vals.dim() != 3:
        raise ValueError("demote_ema takes the 3-D grid")
    _require(vals, "demote_ema vals", torch.float32)
    _require(bg, "demote_ema bg", torch.bool, vals.shape)
    _require(safe, "demote_ema safe", torch.bool, vals.shape)
    _require(sure_sufficient, "demote_ema sure_sufficient", torch.bool, ())
    keep, ptr = _taps_arg(taps, halo)
    out = torch.empty_like(vals)
    nz, ny, nx = vals.shape
    err = load().vofod_demote_ema(
        vals.data_ptr(), bg.data_ptr(), safe.data_ptr(), sure_sufficient.data_ptr(),
        nz, ny, nx, ptr, len(keep), halo, float(w1), float(c), out.data_ptr(), _stream())
    _check(err, "vofod_demote_ema")
    _count("demote_ema")
    return out


def dda(starts: torch.Tensor, dirs: torch.Tensor, lengths: torch.Tensor, valid: torch.Tensor,
        shape: tuple[int, int, int], floats: np.ndarray, n_steps: int) -> torch.Tensor:
    """K12 walk: the f32 raylen grid ``shape`` of the rays' DDA chords,
    summed in float64 and rounded once.  floats: the f32 grid constants (ox,
    oy, oz, vs, 1/vs, vs/2) of ops/raycast.py ``_dda_consts``."""
    R = starts.shape[0]
    _require(starts, "dda starts", torch.float32, (R, 3))
    _require(dirs, "dda dirs", torch.float32, (R, 3))
    _require(lengths, "dda lengths", torch.float32, (R,))
    _require(valid, "dda valid", torch.bool, (R,))
    fl = _host_f32(*floats)
    if fl[0].shape != (6,):
        raise ValueError(f"dda takes 6 float constants, got {fl[0].shape}")
    nz, ny, nx = shape
    ints = _host_i32(nx, ny, nz, n_steps)
    acc = torch.zeros(shape, dtype=torch.float64, device=starts.device)
    raylen = torch.empty(shape, dtype=torch.float32, device=starts.device)
    err = load().vofod_dda(starts.data_ptr(), dirs.data_ptr(), lengths.data_ptr(),
                           valid.data_ptr(), R, fl[1], ints[1], acc.data_ptr(),
                           raylen.data_ptr(), _stream())
    _check(err, "vofod_dda")
    _count("dda")
    return raylen


def ray_ema(vals: torch.Tensor, had_point: torch.Tensor, raylen: torch.Tensor, ema) -> None:
    """K12 EMA pass, in place on ``vals``: the ray EMA (ops/raycast.py
    RayEma ``ema``) on a full-grid raylen field.  One launch under the new
    rule, two under the old."""
    _require(vals, "ray_ema vals", torch.float32)
    _require(had_point, "ray_ema had_point", torch.bool, vals.shape)
    _require(raylen, "ray_ema raylen", torch.float32, vals.shape)
    floats = _host_f32(ema.coef, ema.its, ema.weight, ema.score)
    max_bits = None
    if not ema.new_rule:
        max_bits = torch.zeros((), dtype=torch.int32, device=vals.device)
    err = load().vofod_ray_ema(
        vals.data_ptr(), had_point.data_ptr(), raylen.data_ptr(), vals.numel(), floats[1],
        int(bool(ema.new_rule)), None if max_bits is None else max_bits.data_ptr(), _stream())
    _check(err, "vofod_ray_ema")
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


def quirk_counts(bg: torch.Tensor, sure: torch.Tensor, lsz: int) -> torch.Tensor:
    """K13b: the per-coarse-cell sure counts with the reference's
    VoxelGridCounted indexing quirk, int32 (ceil(nz/lsz), ceil(ny/lsz),
    ceil(nx/lsz))."""
    if bg.dim() != 3:
        raise ValueError("quirk_counts takes 3-D grids")
    _require(bg, "quirk bg", torch.bool)
    _require(sure, "quirk sure", torch.bool, bg.shape)
    nz, ny, nx = bg.shape
    nv = bg.numel()
    dev = bg.device
    scratch = torch.empty(2 * (-(-nv // _COMPACT_CHUNK)), dtype=torch.int64, device=dev)
    u = torch.zeros(nv + 2, dtype=torch.int32, device=dev)
    out = torch.empty((-(-nz // lsz), -(-ny // lsz), -(-nx // lsz)), dtype=torch.int32,
                      device=dev)
    err = load().vofod_quirk_counts(bg.data_ptr(), sure.data_ptr(), nz, ny, nx, int(lsz),
                                    scratch.data_ptr(), u.data_ptr(), out.data_ptr(), _stream())
    _check(err, "vofod_quirk_counts")
    _count("quirk_counts")
    return out


def exact_demote_ema(vals: torch.Tensor, occ_c: torch.Tensor, census: torch.Tensor,
                     flags: torch.Tensor, prev_sure: torch.Tensor, lsz: int, taps: np.ndarray,
                     halo: int, min_sure: float, w1: float, score: float, thr_new: float):
    """K13c: (new grid f32, safe bool grid, sure_sufficient bool scalar) of
    the exact demotion: w1^k v + (1 - w1^k) score, k = the ball sum
    (``taps``) of the unsure coarse-cell centres; flags: K13a's."""
    if vals.dim() != 3:
        raise ValueError("exact_demote_ema takes the 3-D grid")
    nz, ny, nx = vals.shape
    cshape = (-(-nz // lsz), -(-ny // lsz), -(-nx // lsz))
    _require(vals, "exact_demote vals", torch.float32)
    _require(occ_c, "exact_demote occ_c", torch.bool, cshape)
    _require(census, "exact_demote census", torch.int32, cshape)
    _require(flags, "exact_demote flags", torch.bool, (2,))
    _require(prev_sure, "exact_demote prev_sure", torch.bool, ())
    dev = vals.device
    out = torch.empty_like(vals)
    safe = torch.empty(vals.shape, dtype=torch.bool, device=dev)
    sure_out = torch.empty((), dtype=torch.bool, device=dev)
    keep, ptr = _taps_arg(taps, halo)
    floats = _host_f32(min_sure, w1, score, thr_new)
    err = load().vofod_exact_demote_ema(
        vals.data_ptr(), occ_c.data_ptr(), census.data_ptr(), flags.data_ptr(),
        prev_sure.data_ptr(), nz, ny, nx, int(lsz), ptr, len(keep), halo, floats[1],
        out.data_ptr(), safe.data_ptr(), sure_out.data_ptr(), _stream())
    _check(err, "vofod_exact_demote_ema")
    _count("exact_demote_ema")
    return out, safe, sure_out


def unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K15a: (counts int32, blockers bool) of the host-binned uint8 grid:
    counts = packed & 0x3F, blockers = packed >= 0x80."""
    _require(packed, "unpack packed", torch.uint8)
    if packed.numel() == 0:
        raise ValueError("unpack takes a non-empty grid")
    counts = torch.empty(packed.shape, dtype=torch.int32, device=packed.device)
    blockers = torch.empty(packed.shape, dtype=torch.bool, device=packed.device)
    err = load().vofod_unpack(packed.data_ptr(), counts.data_ptr(), blockers.data_ptr(),
                              packed.numel(), _stream())
    _check(err, "vofod_unpack")
    _count("unpack")
    return counts, blockers


_MAX_HOPS = 16  # csrc/halo.cu MAX_HOPS


def _hop_args(lo: list, hi: list, takes: list[int]):
    """Host arrays of the per-hop block pointers (NULL for None) and rows."""
    if len(takes) > _MAX_HOPS:
        raise ValueError(f"halo of {len(takes)} hops; the kernels take at most {_MAX_HOPS}")
    lo_p = (_P * max(len(takes), 1))(*[None if t is None else t.data_ptr() for t in lo])
    hi_p = (_P * max(len(takes), 1))(*[None if t is None else t.data_ptr() for t in hi])
    tk = np.array(takes or [0], dtype=np.int32)
    return lo_p, hi_p, tk, tk.ctypes.data_as(_P)


def _blocks_ok(blocks: list, g: torch.Tensor, takes: list[int], name: str) -> None:
    for b, take in zip(blocks, takes):
        if b is not None:
            _require(b, name, g.dtype, (take,) + tuple(g.shape[1:]))


_FILL_BITS = {torch.float32: lambda v: int(np.float32(v).view(np.uint32)),
              torch.int32: lambda v: int(np.int32(v).view(np.uint32)),
              torch.uint8: lambda v: int(v) & 0xFF, torch.int8: lambda v: int(v) & 0xFF,
              torch.bool: lambda v: int(bool(v))}
HALO_DTYPES = frozenset(_FILL_BITS)  # the slabs K15b-1 takes


def halo_exchange(g: torch.Tensor, lo: list, hi: list, takes: list[int], fill) -> torch.Tensor:
    """K15b-1: the slab ``g`` [nzl, ...] extended by r = sum(takes) rows on
    each side: hop h's block ``lo[h]`` (the last takes[h] rows of the shard h
    below) and ``hi[h]`` (the first rows of the shard h above), ``fill``
    where a block is None.  f32 / int32 / int8 / uint8 / bool."""
    if g.dtype not in HALO_DTYPES or g.dim() < 2:
        raise ValueError(f"halo_exchange takes an f32/int32/int8/uint8/bool slab, got {g.dtype}")
    _require(g, "halo slab", g.dtype)
    _blocks_ok(lo, g, takes, "halo lo block")
    _blocks_ok(hi, g, takes, "halo hi block")
    nzl, r = g.shape[0], sum(takes)
    ext = torch.empty((nzl + 2 * r,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
    lo_p, hi_p, _, tk = _hop_args(lo, hi, takes)
    err = load().vofod_halo_exchange(
        g.data_ptr(), ext.data_ptr(), g.element_size(), nzl, r, g[0].numel(), lo_p, hi_p, tk,
        len(takes), _FILL_BITS[g.dtype](fill), _stream())
    _check(err, "vofod_halo_exchange")
    _count("halo_exchange")
    return ext


def halo_fold_min(ext: torch.Tensor, r: int, from_next: list, from_prev: list,
                  takes: list[int]) -> torch.Tensor:
    """K15b-2: the interior rows of ``ext`` [nzl + 2r, ...] (f32) min-folded
    with the blocks the neighbours sent back: ``from_next[h]`` onto the last
    takes[h] rows, ``from_prev[h]`` onto the first (None: no shard)."""
    _require(ext, "fold ext", torch.float32)
    nzl = ext.shape[0] - 2 * r
    if nzl < 1:
        raise ValueError(f"halo_fold_min: {ext.shape[0]} rows cannot hold a halo of {r}")
    _blocks_ok(from_next, ext[:nzl], takes, "fold block")
    _blocks_ok(from_prev, ext[:nzl], takes, "fold block")
    out = torch.empty((nzl,) + tuple(ext.shape[1:]), dtype=torch.float32, device=ext.device)
    nx_p, pv_p, _, tk = _hop_args(from_next, from_prev, takes)
    err = load().vofod_halo_fold_min(ext.data_ptr(), out.data_ptr(), nzl, r, ext[0].numel(),
                                     nx_p, pv_p, tk, len(takes), _stream())
    _check(err, "vofod_halo_fold_min")
    _count("halo_fold_min")
    return out


def cone_sweep_lat(opaque: torch.Tensor, rel_x: torch.Tensor, rel_y: torch.Tensor,
                   rel_z: torch.Tensor, tmp_in: torch.Tensor | None, lo: torch.Tensor | None,
                   hi: torch.Tensor | None, tmp_out: torch.Tensor, T4: torch.Tensor,
                   k: int) -> None:
    """K15b-3, launch k: the A pass of plane k - 1 and the B pass of plane k
    of the x and y cones on a shard's window (see csrc/cone_sweep.cu).
    tmp_*: bf16 [nzl, 4, max(wx, wy)]; lo / hi: the received bf16 rows [1,
    4, PB] / [2, 4, PB] or None (the global edge); T4: f32 [4, nzl, wy, wx],
    written in place."""
    nzl, wy, wx = opaque.shape
    pb = max(wx, wy)
    _require(opaque, "cone_lat opaque", torch.uint8)
    _require(rel_x, "cone_lat rel_x", torch.float32, (wx,))
    _require(rel_y, "cone_lat rel_y", torch.float32, (wy,))
    _require(rel_z, "cone_lat rel_z", torch.float32, (nzl,))
    for t, name, rows in ((tmp_in, "tmp_in", nzl), (tmp_out, "tmp_out", nzl), (lo, "lo", 1),
                          (hi, "hi", 2)):
        if t is not None:
            _require(t, f"cone_lat {name}", torch.bfloat16, (rows, 4, pb))
    _require(T4, "cone_lat T", torch.float32, (4, nzl, wy, wx))
    ptr = [None if t is None else t.data_ptr() for t in (tmp_in, lo, hi)]
    err = load().vofod_cone_sweep_lat(
        opaque.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(), rel_z.data_ptr(), *ptr,
        tmp_out.data_ptr(), T4.data_ptr(), nzl, wy, wx, int(k), _stream())
    _check(err, "vofod_cone_sweep_lat")
    _count("cone_sweep_lat")


def cone_sweep_z(opaque: torch.Tensor, rel_x: torch.Tensor, rel_y: torch.Tensor,
                 rel_z: torch.Tensor, carry_in: torch.Tensor, T2: torch.Tensor,
                 keep: tuple[bool, bool]) -> torch.Tensor:
    """K15b-4a, one round: the z cones over a shard's planes from the carry
    planes ``carry_in`` (bf16 [2, wy, wx]); writes T2 (f32 [2, nzl, wy, wx])
    for the cones in ``keep`` and returns the carry planes out."""
    nzl, wy, wx = opaque.shape
    _require(opaque, "cone_z opaque", torch.uint8)
    _require(rel_x, "cone_z rel_x", torch.float32, (wx,))
    _require(rel_y, "cone_z rel_y", torch.float32, (wy,))
    _require(rel_z, "cone_z rel_z", torch.float32, (nzl,))
    _require(carry_in, "cone_z carry_in", torch.bfloat16, (2, wy, wx))
    _require(T2, "cone_z T", torch.float32, (2, nzl, wy, wx))
    carry_out = torch.empty_like(carry_in)
    err = load().vofod_cone_sweep_z(
        opaque.data_ptr(), rel_x.data_ptr(), rel_y.data_ptr(), rel_z.data_ptr(),
        carry_in.data_ptr(), carry_out.data_ptr(), T2.data_ptr(), nzl, wy, wx,
        int(keep[0]) | (int(keep[1]) << 1), _stream())
    _check(err, "vofod_cone_sweep_z")
    _count("cone_sweep_z")
    return carry_out
