"""Sensor model: per-pixel ray LUT and FOV mask.

A numpy-only copy of the parts of vofod_tpu/sensor.py that the PyTorch port
runs (importing vofod_tpu loads JAX); tests/test_torch_shared_copies.py holds
it to the original.  Builds the per-pixel ray ``directions`` and ``offsets``
lookup tables either from an ideal spherical model (simulation, ref
src/vofod_nodelet.cpp:374-420) or from Ouster beam calibration angles (ref
:358-371, via ouster::make_xyz_lut) or an Ouster metadata JSON
(``parse_ouster_metadata``), loads the FOV mask (ref load_mask :504-562)
and destaggers organized fields.

Row/column convention: arrays are (H, W) = (vertical_rays, horizontal_rays);
flat pixel index is ``row * W + col`` like the reference's organized clouds
(vofod_nodelet.cpp:1449).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RANGE_TO_METERS = 0.001  # Ouster ranges are millimetres (ref vofod_nodelet.cpp:1455)


@dataclass(frozen=True)
class XyzLut:
    """Per-pixel ray model: point = direction * range + offset (sensor frame).

    ``directions``: float32 [H*W, 3], normalized.
    ``offsets``:    float32 [H*W, 3].
    (ref xyz_lut_t struct, vofod_nodelet.cpp:77-81)
    """

    directions: np.ndarray
    offsets: np.ndarray
    height: int
    width: int

    def __post_init__(self):
        assert self.directions.shape == (self.height * self.width, 3)
        assert self.offsets.shape == (self.height * self.width, 3)


def make_lut_simulation(width: int, height: int, vertical_fov: float) -> XyzLut:
    """Ideal spherical ray model used for simulated sensors
    (ref initialize_sensor_lut_simulation, vofod_nodelet.cpp:374-420).

    Azimuth sweeps [0, 2π] over columns, elevation sweeps
    [-vfov/2, +vfov/2] over rows; offsets are zero.
    """
    yaw_step = 2.0 * np.pi / (width - 1)
    pitch_step = vertical_fov / (height - 1)
    cols = np.arange(width, dtype=np.float64)
    rows = np.arange(height, dtype=np.float64)
    yaw = cols * yaw_step  # [W]
    pitch = rows * pitch_step - vertical_fov / 2.0  # [H]
    cp = np.cos(pitch)[:, None]
    dirs = np.stack(
        [
            cp * np.cos(yaw)[None, :],
            cp * np.sin(yaw)[None, :],
            np.broadcast_to(np.sin(pitch)[:, None], (height, width)),
        ],
        axis=-1,
    )  # [H, W, 3]
    dirs = dirs.reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    offs = np.zeros_like(dirs)
    return XyzLut(dirs.astype(np.float32), offs.astype(np.float32), height, width)


def make_lut_ouster(
    width: int,
    height: int,
    beam_azimuth_angles_deg,
    beam_altitude_angles_deg,
    lidar_origin_to_beam_origin_mm: float = 0.0,
    lidar_to_sensor_transform: np.ndarray | None = None,
    range_unit: float = RANGE_TO_METERS,
) -> XyzLut:
    """Calibrated Ouster ray model (semantics of ouster::make_xyz_lut as used
    by ref initialize_sensor_lut, vofod_nodelet.cpp:358-371).

    For pixel (u=row, v=col):
      encoder azimuth  θ_e = 2π (1 - v / W)
      beam azimuth     θ_a = -2π az_deg[u] / 360
      beam altitude    φ   =  2π alt_deg[u] / 360
      direction = (cos(θ_e+θ_a) cos φ, sin(θ_e+θ_a) cos φ, sin φ)
      offset    = n (cos θ_e, sin θ_e, 0) - n * direction
    with n = lidar_origin_to_beam_origin_mm * range_unit, then transformed by
    lidar_to_sensor_transform (rotation for directions, full for offsets, with
    the translation scaled by range_unit).  Directions are re-normalized like
    the reference (vofod_nodelet.cpp:369).
    """
    az = np.asarray(beam_azimuth_angles_deg, dtype=np.float64)
    alt = np.asarray(beam_altitude_angles_deg, dtype=np.float64)
    assert az.shape == (height,) and alt.shape == (height,)
    n = lidar_origin_to_beam_origin_mm * range_unit

    v = np.arange(width, dtype=np.float64)
    theta_e = 2.0 * np.pi * (1.0 - v / width)  # [W]
    theta_a = -2.0 * np.pi * az / 360.0  # [H]
    phi = 2.0 * np.pi * alt / 360.0  # [H]

    ce, se = np.cos(theta_e)[None, :], np.sin(theta_e)[None, :]
    cphi, sphi = np.cos(phi)[:, None], np.sin(phi)[:, None]
    th = theta_e[None, :] + theta_a[:, None]
    dirs = np.stack(
        [np.cos(th) * cphi, np.sin(th) * cphi, np.broadcast_to(sphi, th.shape)], axis=-1
    )  # [H, W, 3]
    offs = np.stack(
        [n * ce - n * dirs[..., 0], n * se - n * dirs[..., 1], -n * dirs[..., 2]],
        axis=-1,
    )

    if lidar_to_sensor_transform is not None:
        T = np.asarray(lidar_to_sensor_transform, dtype=np.float64).reshape(4, 4)
        R, t = T[:3, :3], T[:3, 3] * range_unit
        dirs = dirs @ R.T
        offs = offs @ R.T + t

    dirs = dirs.reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return XyzLut(
        dirs.astype(np.float32), offs.reshape(-1, 3).astype(np.float32), height, width
    )


def parse_ouster_metadata(metadata_json: str):
    """Parse an Ouster sensor metadata JSON (the get_metadata service payload
    the reference consumes, ref initialize_sensor vofod_nodelet.cpp:446-501).

    Returns (SensorConfig, XyzLut, pixel_shift_by_row).  Accepts both the
    flat legacy format and the nested (firmware >= 2.x) format with
    ``beam_intrinsics`` / ``lidar_data_format`` sections.
    """
    import json

    from vofod_tpu_torch.config import SensorConfig

    m = json.loads(metadata_json)
    beam = m.get("beam_intrinsics", m)
    fmt = m.get("lidar_data_format", m.get("data_format", m))
    alt = beam["beam_altitude_angles"]
    az = beam.get("beam_azimuth_angles", [0.0] * len(alt))
    n_off = float(beam.get("lidar_origin_to_beam_origin_mm", 0.0))
    H = int(fmt.get("pixels_per_column", len(alt)))
    W = int(fmt.get("columns_per_frame", 1024))
    shift = fmt.get("pixel_shift_by_row", [0] * H)
    l2s = m.get("lidar_intrinsics", m).get("lidar_to_sensor_transform", None)

    cfg = SensorConfig(
        vertical_rays=H,
        horizontal_rays=W,
        vertical_fov=float(abs(alt[-1] - alt[0])) * np.pi / 180.0,
        simulation=False,
        beam_azimuth_angles_deg=tuple(float(a) for a in az),
        beam_altitude_angles_deg=tuple(float(a) for a in alt),
        lidar_origin_to_beam_origin_mm=n_off,
    )
    lut = make_lut_ouster(
        W, H, az, alt, n_off,
        lidar_to_sensor_transform=np.asarray(l2s, np.float64).reshape(4, 4)
        if l2s is not None
        else None,
    )
    return cfg, lut, np.asarray(shift, np.int64)


def make_lut(cfg_sensor) -> XyzLut:
    """Build the LUT for a SensorConfig (metadata variant when beam angles are
    provided, ideal spherical model otherwise; ref initialize_sensor
    :446-501 with its rosparam fallback :422-444)."""
    H, W = cfg_sensor.vertical_rays, cfg_sensor.horizontal_rays
    if cfg_sensor.beam_altitude_angles_deg is not None:
        az = cfg_sensor.beam_azimuth_angles_deg or (0.0,) * H
        return make_lut_ouster(
            W, H, az, cfg_sensor.beam_altitude_angles_deg,
            cfg_sensor.lidar_origin_to_beam_origin_mm,
        )
    return make_lut_simulation(W, H, cfg_sensor.vertical_fov)


# =============================================================================
# FOV mask
# =============================================================================


def load_mask(
    path: str | None,
    width: int,
    height: int,
    pixel_shift_by_row=None,
    mangle: bool = False,
) -> np.ndarray:
    """Load a sensor FOV mask as uint8 [H*W] (1 = pixel usable).

    Mirrors ref load_mask (vofod_nodelet.cpp:504-562): a missing or wrong-size
    file yields an all-ones mask; with ``mangle`` the mask is destaggered via
    ``pixel_shift_by_row`` and written column-major (``index = vv*H + u``,
    ref :536-541 — a reference layout quirk preserved for parity).

    Accepts ``.npy`` (uint8/bool [H, W]) or ``.png`` (grayscale, loaded via
    OpenCV if available, else a tiny builtin PNG reader for 8-bit grayscale).
    """
    ones = np.ones(width * height, dtype=np.uint8)
    if not path:
        return ones
    mask = _read_mask_file(path)
    if mask is None:
        return ones
    if mask.shape != (height, width):
        # wrong dimensions => ignore the mask (ref :553-556)
        return ones
    mask = (mask > 0).astype(np.uint8)
    if not mangle:
        return mask.reshape(-1)
    if pixel_shift_by_row is None:
        pixel_shift_by_row = np.zeros(height, dtype=np.int64)
    shift = np.asarray(pixel_shift_by_row, dtype=np.int64)
    out = np.full(width * height, 1, dtype=np.uint8)
    u = np.arange(height)[:, None]
    v = np.arange(width)[None, :]
    vv = (v + shift[:, None]) % width
    out[(vv * height + u).reshape(-1)] = mask.reshape(-1)
    return out


def _read_mask_file(path: str) -> np.ndarray | None:
    import os

    if not os.path.exists(path):
        return None
    if path.endswith(".npy"):
        m = np.load(path)
        return np.asarray(m)
    try:  # optional OpenCV
        import cv2  # type: ignore

        m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        return m
    except ImportError:
        pass
    try:
        from PIL import Image  # type: ignore

        return np.asarray(Image.open(path).convert("L"))
    except ImportError:
        return None


def destagger(img: np.ndarray, pixel_shift_by_row) -> np.ndarray:
    """Destagger an organized (H, W) Ouster field by per-row pixel shift."""
    H, W = img.shape[:2]
    shift = np.asarray(pixel_shift_by_row, dtype=np.int64)
    cols = (np.arange(W)[None, :] + shift[:, None]) % W
    return np.take_along_axis(img, cols, axis=1)


# =============================================================================
# Consistency check
# =============================================================================


def check_sensor_params(
    lut: XyzLut, points: np.ndarray, ranges_mm: np.ndarray, tolerance: float = 1e-3
) -> bool:
    """Validate that actual point positions match ``dir * range + offset``
    (ref check_sensor_params, vofod_nodelet.cpp:1869-1917, tolerance 1e-3 m).

    ``points``: [H*W, 3] sensor-frame points; ``ranges_mm``: [H*W] uint32.
    Returns True when all valid (range > 0, finite) points agree with the LUT.
    """
    r = ranges_mm.astype(np.float64) * RANGE_TO_METERS
    valid = (r > 0) & np.isfinite(points).all(axis=-1)
    if not valid.any():
        return False
    recon = lut.directions.astype(np.float64) * r[:, None] + lut.offsets
    err = np.linalg.norm(recon[valid] - points[valid].astype(np.float64), axis=-1)
    return bool(np.max(err) <= tolerance)
