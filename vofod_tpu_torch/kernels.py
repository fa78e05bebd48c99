"""Build, load and launch the hand-written CUDA kernels (K1-K4).

The sources in ``csrc/`` compile with ``nvcc`` into ONE shared library with
a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so the
build takes seconds).  The library is built at first use into
``build/vofod_tpu_torch/`` at the root of the checkout, keyed by a hash of
the sources and flags; a missing ``nvcc`` or a failed build raises with the
compiler's output — there is no fallback to the plain PyTorch versions.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch``, launches on ``torch.cuda.current_stream()``, raises
when the launch returns a CUDA error, and adds one to its entry of
:data:`LAUNCHES`.  The ops modules call these wrappers for CUDA tensors
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
_SOURCES = ("ball_pool.cu", "propagate.cu", "frontend_bin.cu", "cone_sweep.cu")
_HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: dict[str, int] = {
    "ball_pool": 0,
    "propagate_sweep": 0,
    "frontend_bin": 0,
    "cone_sweep": 0,
}

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


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
    """Compile the kernel library if this source hash is not built yet.
    Returns (path of the .so, compiler log of the build or '' if cached)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    so = _BUILD_DIR / f"libvofod_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so, ""
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(_CSRC / s) for s in _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
    os.replace(tmp, so)
    return so, log


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
            _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P]
        lib.vofod_frontend_bin.argtypes = [
            _P, _P, _P, _P, _I, _P, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.vofod_cone_sweep.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
        for fn in (lib.vofod_ball_pool, lib.vofod_propagate_sweep,
                   lib.vofod_frontend_bin, lib.vofod_cone_sweep):
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


def _taps_arg(taps: np.ndarray):
    arr = np.ascontiguousarray(taps, dtype=np.int32)
    return arr, arr.ctypes.data_as(_P)


_DTYPE_CODE = {torch.int8: 0, torch.int32: 1}
_OP_CODE = {"min": 0, "max": 1, "sum": 2}


def ball_pool(a: torch.Tensor, taps: np.ndarray, halo: int, op: str,
              fill: int) -> torch.Tensor:
    """K1: out[v] = op over the ball taps of a (out-of-grid taps read fill)."""
    lib = load()
    if a.dtype not in _DTYPE_CODE or a.dim() != 3:
        raise ValueError(f"ball_pool takes a 3-D int8/int32 grid, got {a.dtype} {tuple(a.shape)}")
    if op == "sum" and a.dtype != torch.int32:
        raise ValueError("ball_pool sum takes int32")
    _require(a, "ball_pool input", a.dtype)
    out = torch.empty_like(a)
    keep, ptr = _taps_arg(taps)
    nz, ny, nx = a.shape
    err = lib.vofod_ball_pool(
        a.data_ptr(), out.data_ptr(), _DTYPE_CODE[a.dtype], _OP_CODE[op],
        nz, ny, nx, ptr, len(keep), halo, int(fill), _stream())
    _check(err, "vofod_ball_pool")
    LAUNCHES["ball_pool"] += 1
    return out


def propagate_sweep(src: torch.Tensor, dst: torch.Tensor, occ: torch.Tensor,
                    taps: np.ndarray, halo: int, changed: torch.Tensor) -> None:
    """K2: one Jacobi sweep src -> dst.  int32 src: min-label sweep (off-mask
    SENTINEL); uint8 src: reach sweep.  ORs 1 into ``changed`` (device
    int32 scalar) when any voxel changed."""
    lib = load()
    mode = {torch.int32: 0, torch.uint8: 1}.get(src.dtype)
    if mode is None or src.dim() != 3:
        raise ValueError(f"propagate_sweep takes a 3-D int32/uint8 grid, got {src.dtype}")
    _require(src, "propagate_sweep src", src.dtype)
    _require(dst, "propagate_sweep dst", src.dtype, src.shape)
    _require(occ, "propagate_sweep occ", torch.uint8, src.shape)
    _require(changed, "propagate_sweep changed", torch.int32, ())
    keep, ptr = _taps_arg(taps)
    nz, ny, nx = src.shape
    err = lib.vofod_propagate_sweep(
        src.data_ptr(), dst.data_ptr(), occ.data_ptr(), mode, nz, ny, nx,
        ptr, len(keep), halo, changed.data_ptr(), _stream())
    _check(err, "vofod_propagate_sweep")
    LAUNCHES["propagate_sweep"] += 1


def frontend_bin(ranges: torch.Tensor, dirs: torch.Tensor, offs: torch.Tensor,
                 pose: torch.Tensor, boxes: np.ndarray, inv_voxel: float,
                 range_scale: float, shape: tuple[int, int, int]):
    """K3: (counts int32 grid, n_valid int32 scalar, excl bool [N],
    fid int32 [N])."""
    lib = load()
    n = ranges.shape[0]
    _require(ranges, "frontend ranges", torch.float32, (n,))
    _require(dirs, "frontend lut dirs", torch.float32, (n, 3))
    _require(offs, "frontend lut offs", torch.float32, (n, 3))
    _require(pose, "frontend pose", torch.float32, (4, 4))
    dev = ranges.device
    counts = torch.zeros(shape, dtype=torch.int32, device=dev)
    n_valid = torch.zeros((), dtype=torch.int32, device=dev)
    excl = torch.empty(n, dtype=torch.bool, device=dev)
    fid = torch.empty(n, dtype=torch.int32, device=dev)
    b = np.ascontiguousarray(boxes, dtype=np.float32)
    assert b.shape == (15,)
    nz, ny, nx = shape
    err = lib.vofod_frontend_bin(
        ranges.data_ptr(), dirs.data_ptr(), offs.data_ptr(), pose.data_ptr(),
        n, b.ctypes.data_as(_P), float(inv_voxel), float(range_scale),
        nz, ny, nx, counts.data_ptr(), n_valid.data_ptr(), excl.data_ptr(),
        fid.data_ptr(), _stream())
    _check(err, "vofod_frontend_bin")
    LAUNCHES["frontend_bin"] += 1
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
    LAUNCHES["cone_sweep"] += 1
    return T
