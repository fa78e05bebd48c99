"""Streaming scan queue on the native SPSC ring buffer.

PyTorch-side counterpart of vofod_tpu/io/scan_queue.py ``ScanQueue`` (which
imports no JAX, but lives in a package whose import loads it).  The
reference's data path is the nodelet subscriber queue drained by
pointcloud_loop worker threads (vofod_nodelet.cpp:1113-1122); here the
native lock-free ring of ``native/pc_loader.cpp`` (``vofod_queue_*``, built
by io/native.py) decouples a producer thread (a sensor feed or a recording
reader) from the detector's feeder, and counts the frames it drops when the
consumer falls behind (the back-pressure of a depth-limited ROS
subscriber).  The frame layout and the push / pop / drop semantics are the
original's; there is no pure-Python fallback: a failed build raises.
"""

from __future__ import annotations

import numpy as np

from vofod_tpu_torch.io import native


class ScanQueue:
    """Fixed-capacity queue of (ranges_mm u32 [N], intensity f32 [N],
    pose f32 [16]) frames.

    The intensity channel rides every frame so that the reference's
    ``raycast/min_intensity`` per-pixel gate (vofod_nodelet.cpp:1449) works
    on the serving path; a producer without one pushes ``None``, stored as
    all-ones, which the gate always passes (as ``process_scan(intensity=
    None)``)."""

    def __init__(self, n_points: int, capacity: int = 8):
        self.n_points = n_points
        self.capacity = capacity
        self._frame_dtype = np.dtype(
            [
                ("ranges", np.uint32, (n_points,)),
                ("intensity", np.float32, (n_points,)),
                ("pose", np.float32, (16,)),
            ]
        )
        self._lib = native.load()
        self._q = self._lib.vofod_queue_create(self._frame_dtype.itemsize, capacity)

    def push(
        self, ranges_mm: np.ndarray, pose: np.ndarray,
        intensity: np.ndarray | None = None,
    ) -> bool:
        """Copy one frame into the ring; False (and counted as dropped) when
        the ring is full."""
        frame = np.zeros((), self._frame_dtype)
        frame["ranges"] = np.asarray(ranges_mm, np.uint32).reshape(-1)
        frame["intensity"] = (
            1.0 if intensity is None
            else np.asarray(intensity, np.float32).reshape(-1)
        )
        frame["pose"] = np.asarray(pose, np.float32).reshape(-1)
        return bool(self._lib.vofod_queue_push(self._q, frame.ctypes.data))

    def pop(self):
        """Returns (ranges u32 [N], intensity f32 [N], pose f32 [4,4]) or
        None when empty."""
        f = np.empty((), self._frame_dtype)
        if not self._lib.vofod_queue_pop(self._q, f.ctypes.data):
            return None
        return f["ranges"].copy(), f["intensity"].copy(), f["pose"].reshape(4, 4).copy()

    def __len__(self) -> int:
        return int(self._lib.vofod_queue_size(self._q))

    @property
    def dropped(self) -> int:
        return int(self._lib.vofod_queue_dropped(self._q))

    def __del__(self):
        q = getattr(self, "_q", None)
        if q is not None:
            self._q = None
            self._lib.vofod_queue_destroy(q)
