"""MaskCreator tool: accumulate a sensor FOV mask from live scans.

PyTorch-port counterpart of vofod_tpu/runtime/mask_creator.py.  Reference:
the second nodelet, vofod/MaskCreator (src/mask_creator.cpp): pixels that
EVER return ``range == 0`` across accumulated scans are marked occluded
(cloud_callback :217-235); ~save / ~reset services (:193-211, 253-260).
The accumulator is a bool tensor on the device (``acc &= r > 0`` a scan);
``mask()`` reads it back once.  The mask is written as .npy or .png.
"""

from __future__ import annotations

import numpy as np
import torch

from vofod_tpu_torch.runtime.node import resolve_device


class MaskCreator:
    def __init__(self, vertical_rays: int, horizontal_rays: int, *, device="cuda"):
        self.device = resolve_device(device)
        self.h = vertical_rays
        self.w = horizontal_rays
        self._acc = torch.ones(vertical_rays * horizontal_rays, dtype=torch.bool,
                               device=self.device)
        self._n_scans = 0

    def add_scan(self, ranges_mm: np.ndarray) -> None:
        r = np.ascontiguousarray(np.asarray(ranges_mm).reshape(-1).astype(np.uint32))
        if r.shape[0] != self.h * self.w:
            raise ValueError("scan size mismatch")
        # uint32 r > 0 is r != 0: the bits go up as int32
        r_dev = torch.from_numpy(r.view(np.int32)).to(self.device)
        self._acc &= r_dev != 0
        self._n_scans += 1

    @property
    def n_scans(self) -> int:
        return self._n_scans

    def mask(self) -> np.ndarray:
        """uint8 [H, W]; 1 = pixel usable (had a return in every scan)."""
        return self._acc.cpu().numpy().reshape(self.h, self.w).astype(np.uint8)

    def save(self, path: str) -> None:
        """~save service (ref mask_creator.cpp:253-260)."""
        m = self.mask()
        if path.endswith(".npy"):
            np.save(path, m)
            return
        try:
            from PIL import Image  # optional

            Image.fromarray(m * 255).save(path)
        except ImportError:
            np.save(path + ".npy", m)

    def reset(self) -> None:
        """~reset service."""
        self._acc.fill_(True)
        self._n_scans = 0
