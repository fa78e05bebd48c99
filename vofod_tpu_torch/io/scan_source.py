"""Scan sources: the analytic scene simulator + NPZ replay.

A copy of vofod_tpu/io/scan_source.py that imports no JAX (the original
reaches JAX through vofod_tpu.sensor); tests/test_torch_shared_copies.py
holds it to the original.

The reference's acceptance test is a Gazebo two-UAV scene (tmux/simulation/,
SURVEY.md §4); this module provides the equivalent fake sensor backend: an
ideal-spherical-LUT scanner (ref initialize_sensor_lut_simulation,
vofod_nodelet.cpp:374-420) ray-traced against an analytic scene of a ground
plane, boxes and spheres — used by tests, the demo, and the benchmark.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vofod_tpu_torch.sensor import XyzLut


@dataclass
class Sphere:
    center: np.ndarray
    radius: float


@dataclass
class AxisBox:
    lo: np.ndarray
    hi: np.ndarray


@dataclass
class Scene:
    """Analytic scene: ground plane at z, plus boxes and spheres."""

    ground_z: float | None = 0.0
    boxes: list[AxisBox] = field(default_factory=list)
    spheres: list[Sphere] = field(default_factory=list)
    max_range: float = 80.0  # beyond this: no return (range = 0)

    def add_box(self, lo, hi):
        self.boxes.append(AxisBox(np.asarray(lo, np.float64), np.asarray(hi, np.float64)))

    def add_sphere(self, center, radius):
        self.spheres.append(Sphere(np.asarray(center, np.float64), float(radius)))


def render_scan(scene: Scene, lut: XyzLut, pose: np.ndarray) -> np.ndarray:
    """Ray-trace one organized scan.  Returns ranges in mm, uint32 [H*W]
    (Ouster convention: the range is measured along the beam from its own
    origin, so point = dir * range + offset reconstructs the hit)."""
    R = np.asarray(pose, np.float64)[:3, :3]
    t = np.asarray(pose, np.float64)[:3, 3]
    dirs = lut.directions.astype(np.float64) @ R.T  # [N, 3] world
    origs = lut.offsets.astype(np.float64) @ R.T + t  # [N, 3] world

    tmin = np.full(dirs.shape[0], np.inf)

    if scene.ground_z is not None:
        dz = dirs[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            th = (scene.ground_z - origs[:, 2]) / dz
        th = np.where((np.abs(dz) > 1e-12) & (th > 0), th, np.inf)
        tmin = np.minimum(tmin, th)

    for box in scene.boxes:
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs
        t0 = (box.lo[None, :] - origs) * inv
        t1 = (box.hi[None, :] - origs) * inv
        tn = np.nanmax(np.minimum(t0, t1), axis=1)
        tf = np.nanmin(np.maximum(t0, t1), axis=1)
        hit = (tf >= tn) & (tf > 0)
        tb = np.where(tn > 0, tn, tf)  # inside-box rays exit at tf
        tmin = np.where(hit & (tb > 0), np.minimum(tmin, tb), tmin)

    for sph in scene.spheres:
        oc = origs - sph.center[None, :]
        b = np.einsum("ij,ij->i", oc, dirs)
        c = np.einsum("ij,ij->i", oc, oc) - sph.radius**2
        disc = b * b - c
        ok = disc >= 0
        sq = np.sqrt(np.maximum(disc, 0))
        ts = np.where(-b - sq > 0, -b - sq, -b + sq)
        tmin = np.where(ok & (ts > 0), np.minimum(tmin, ts), tmin)

    rng = np.where(np.isfinite(tmin) & (tmin <= scene.max_range), tmin, 0.0)
    return np.round(rng * 1000.0).astype(np.uint32)


def hover_pose(xyz, yaw: float = 0.0) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    T[:3, 3] = np.asarray(xyz, np.float32)
    return T


def save_scans_npz(
    path: str, ranges: np.ndarray, poses: np.ndarray, stamps=None,
    intensity: np.ndarray | None = None,
):
    """Recorded-scan fixture writer (the rosbag-replay analogue).

    ``intensity``: optional per-pixel channel, same shape as ``ranges`` —
    the reference gates raycast pixels on it (vofod_nodelet.cpp:1449,
    raycast/min_intensity); omitted = all pixels pass."""
    arrays = dict(
        ranges=ranges,
        poses=poses,
        stamps=stamps if stamps is not None else np.arange(len(ranges)) * 0.1,
    )
    if intensity is not None:
        arrays["intensity"] = intensity
    np.savez_compressed(path, **arrays)


def load_scans_npz(path: str):
    """Returns (ranges, poses, stamps, intensity-or-None)."""
    z = np.load(path)
    return (
        z["ranges"], z["poses"], z["stamps"],
        z["intensity"] if "intensity" in z.files else None,
    )
