"""Build and load the native host library (``native/frontend.cpp``, the scan
binner, and ``native/pc_loader.cpp``, the SPSC scan ring of io/scan_queue.py
and the ASCII cloud reader of io/pc_loader.py) for the port.

The port's own loader in place of vofod_tpu/io/pc_loader ``_native_lib``:
at first use it compiles the two sources in ``native/`` (read, never
written) with ``g++`` and the flags of ``native/Makefile`` into
``build/vofod_tpu_torch/`` at the root of the checkout, keyed by a hash of
the sources, the flags, the compiler and the host CPU (``-march=native``
code runs only where it was built).  ``-ffp-contract=off`` keeps the host
binner's float32 arithmetic unfused, so its counts are bit-equal to the
device frontend's (K3).  A missing compiler or a failed build raises with
the compiler's output; nothing falls back to the numpy binner.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_NATIVE = _ROOT / "native"
_BUILD_DIR = _ROOT / "build" / "vofod_tpu_torch"
_SOURCES = ("frontend.cpp", "pc_loader.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-ffp-contract=off", "-fopenmp-simd",
             "-march=native", "-shared")

_lib = None
_lock = threading.Lock()


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the native host binner cannot be built")
    return found


def _host_id() -> bytes:
    """The CPU's identity for the build key: -march=native code is tied to it."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith(("flags", "Features"))), "")
    except OSError:
        flags = ""
    return f"{platform.machine()}|{flags}".encode()


def build() -> Path:
    """Compile the library if this key is not built yet; returns its path."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + version.encode() + _host_id())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_NATIVE / name).read_bytes())
    so = _BUILD_DIR / f"libvofod_native_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=_BUILD_DIR))
    try:
        tmp = work / "lib.so"
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(_NATIVE / s) for s in _SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def load():
    """Build (if needed) and load the library once per process, with the
    binner's and the scan ring's signatures set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        P, I32, F = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float
        lib.vofod_binner_create.restype = P
        lib.vofod_binner_create.argtypes = [P, P, ctypes.c_longlong, P, P, P, P, P, P,
                                            I32, I32, I32, F]
        lib.vofod_binner_destroy.restype = None
        lib.vofod_binner_destroy.argtypes = [P]
        lib.vofod_binner_bin_dense.restype = None
        lib.vofod_binner_bin_dense.argtypes = [P, P, P, P, F, P, P, P]
        # the SPSC scan ring (io/scan_queue.py)
        LL = ctypes.c_longlong
        # the ASCII cloud reader (io/pc_loader.py)
        lib.vofod_count_points.restype = LL
        lib.vofod_count_points.argtypes = [ctypes.c_char_p]
        lib.vofod_load_cloud.restype = LL
        lib.vofod_load_cloud.argtypes = [ctypes.c_char_p, ctypes.POINTER(F), LL]
        lib.vofod_queue_create.restype = P
        lib.vofod_queue_create.argtypes = [LL, LL]
        lib.vofod_queue_destroy.restype = None
        lib.vofod_queue_destroy.argtypes = [P]
        for name in ("vofod_queue_push", "vofod_queue_pop"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [P, P]
        for name in ("vofod_queue_size", "vofod_queue_dropped"):
            getattr(lib, name).restype = LL
            getattr(lib, name).argtypes = [P]
        _lib = lib
        return lib
