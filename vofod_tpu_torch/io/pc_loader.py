"""ASCII point-cloud loading: .pts / .txt (the reference's pc_loader).

PyTorch-port counterpart of vofod_tpu/io/pc_loader.py.  Semantics of ref
src/pc_loader.cpp:17-90: for ``.pts`` the first line is the point count;
otherwise the count is the number of remaining lines.  Each point line is
whitespace-tokenized ``x y z [extras ignored]``.

``use_native=True`` (the default) parses with ``native/pc_loader.cpp``
through the port's own loader (io/native.py, built at first use); a
library that cannot be built raises, it does not fall back.  The numpy
parser runs only when asked (``use_native=False``) and is the tests'
reference.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np


def load_cloud(path: str, use_native: bool = True) -> np.ndarray:
    """Load an ASCII cloud; returns float32 [N, 3].

    Raises FileNotFoundError / ValueError like the reference logs errors
    (pc_loader.cpp:21-27 bad file, :52-60 bad line).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if not use_native:
        return _load_cloud_np(path)
    from vofod_tpu_torch.io import native

    lib = native.load()
    n = lib.vofod_count_points(path.encode())
    if n < 0:
        raise ValueError(f"cannot parse {path!r} (native loader)")
    out = np.empty((int(n), 3), np.float32)
    got = lib.vofod_load_cloud(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(n)
    )
    if got < 0:
        raise ValueError(f"cannot parse {path!r} (native loader)")
    return out[: int(got)]


def _load_cloud_np(path: str) -> np.ndarray:
    with open(path) as f:
        lines = [ln for ln in (l.strip() for l in f) if ln]
    if not lines:
        return np.zeros((0, 3), np.float32)
    start = 0
    if path.endswith(".pts"):
        # first line is the point count (ref pc_loader.cpp:31-40); the
        # reference trusts it for preallocation but reads what is there
        toks = lines[0].split()
        if len(toks) == 1:
            try:
                int(toks[0])
                start = 1
            except ValueError:
                pass
    pts = []
    for ln in lines[start:]:
        toks = ln.split()
        if len(toks) < 3:
            raise ValueError(f"bad point line in {path!r}: {ln!r}")
        pts.append((float(toks[0]), float(toks[1]), float(toks[2])))
    return np.asarray(pts, np.float32).reshape(-1, 3)


def save_cloud(path: str, pts: np.ndarray, pts_header: bool | None = None):
    """Write an ASCII cloud (count header for .pts)."""
    pts = np.asarray(pts).reshape(-1, 3)
    header = pts_header if pts_header is not None else path.endswith(".pts")
    with open(path, "w") as f:
        if header:
            f.write(f"{len(pts)}\n")
        for x, y, z in pts:
            f.write(f"{x} {y} {z}\n")
