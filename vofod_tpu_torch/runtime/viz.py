"""Visualization exports: ROS-free marker primitives.

PyTorch-port counterpart of vofod_tpu/runtime/viz.py.  The exports work on
numpy: a device tensor passed in (the node's grid, a step output's
cluster fields) is read back with one ``.cpu()`` per array.

Mirrors the reference's RViz publishers (SURVEY.md §2 Visualization):
voxel-map cube lists with sorted per-threshold colors (VoxelMap::visualization,
src/voxel_map.cpp:622-668), operation-area border (:672-785), cluster OBB
wireframes in three class colors (clusters_visualization,
vofod_nodelet.cpp:1930-2044) and rainbow LiDAR FOV rays (:2089-2175, HSVtoRGB
:2108).  Output is plain NumPy marker structs; the optional ROS adapter maps
them to visualization_msgs, and they serialize to NPZ/JSON for offline
viewers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

RGBA = tuple[float, float, float, float]

# Reference palette (config/visualization.yaml) — used when no file is given.
_DEFAULT_VMAP_COLORS: dict[str, RGBA] = {
    "new_obstacles": (0.0, 0.8, 0.8, 1.0),
    "sure_obstacles": (0.0, 0.7, 0.3, 1.0),
    "apriori_map": (0.0, 0.5, 0.0, 1.0),
    "frontiers": (1.0, 0.0, 1.0, 0.3),
    "candidates": (1.0, 0.0, 0.0, 0.8),
}
_DEFAULT_VFLAGS_COLORS: dict[str, RGBA] = {
    "background": (0.0, 0.7, 0.3, 1.0),
    "unknown": (0.1, 0.3, 0.7, 1.0),
}


@dataclass
class VizColors:
    """Marker palette, file-compatible with the reference's
    config/visualization.yaml (param load: vofod_nodelet.cpp:184-191)."""

    vmap: dict[str, RGBA] = field(default_factory=lambda: dict(_DEFAULT_VMAP_COLORS))
    vflags: dict[str, RGBA] = field(
        default_factory=lambda: dict(_DEFAULT_VFLAGS_COLORS)
    )

    def vmap_thresholds(self, dyn) -> list[tuple[float, RGBA]]:
        """The voxel-map threshold→color bindings the reference registers each
        marker publish (vofod_nodelet.cpp:1025-1027): the live thresholds of
        the same names, colored from the palette.  ``voxel_markers`` sorts
        ascending and paints each voxel with the highest threshold it exceeds,
        matching VoxelMap::visualization (voxel_map.cpp:637-664)."""
        return [
            (float(dyn.thr_new_obstacles), self.vmap["new_obstacles"]),
            (float(dyn.thr_sure_obstacles), self.vmap["sure_obstacles"]),
            (float(dyn.thr_apriori), self.vmap["apriori_map"]),
        ]


def load_viz_config(path: str | None = None) -> VizColors:
    """Parse a reference-format visualization.yaml; missing file or keys keep
    the reference's shipped palette (defaults above)."""
    out = VizColors()
    if not path:
        return out
    import yaml

    try:
        with open(path) as f:
            d = yaml.safe_load(f) or {}
    except OSError:
        return out
    for section, dst in (("voxel_map", out.vmap), ("voxel_flags", out.vflags)):
        for name, c in ((d.get(section) or {}).get("colors") or {}).items():
            # a partial entry overrides only the channels it names; the
            # others keep the shipped palette (like the reference's
            # per-param load, vofod_nodelet.cpp param_loader defaults)
            base = dst.get(name, (0.0, 0.0, 0.0, 1.0))
            dst[name] = (
                float(c.get("r", base[0])),
                float(c.get("g", base[1])),
                float(c.get("b", base[2])),
                float(c.get("a", base[3])),
            )
    return out


@dataclass
class Marker:
    """A minimal marker: type + points (+ optional per-point colors)."""

    kind: str  # "cubes" | "lines" | "points"
    points: np.ndarray  # [N, 3] (for lines: consecutive pairs)
    colors: np.ndarray  # [N, 4] rgba in [0,1]
    scale: float = 0.5
    ns: str = ""


def _host(x) -> np.ndarray:
    """numpy view of ``x``: a torch tensor is read back once."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def hsv_to_rgb(h: float, s: float, v: float) -> tuple[float, float, float]:
    """ref HSVtoRGB (vofod_nodelet.cpp:2108-2160)."""
    if s <= 0.0:
        return (v, v, v)
    hh = (h % 360.0) / 60.0
    i = int(hh)
    ff = hh - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * ff)
    t = v * (1.0 - s * (1.0 - ff))
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]


def voxel_markers(
    grid_vals: np.ndarray,
    grid_spec,
    thresholds: list[tuple[float, tuple[float, float, float, float]]],
    max_voxels: int = 200_000,
) -> Marker:
    """Cube list of voxels above the lowest threshold, colored by the highest
    threshold each value exceeds (ref sorted-threshold coloring,
    voxel_map.cpp:637-664)."""
    vals = _host(grid_vals)
    ths = sorted(thresholds, key=lambda t: t[0])
    lo = ths[0][0]
    zz, yy, xx = np.nonzero(vals > lo)
    if len(zz) > max_voxels:
        sel = np.linspace(0, len(zz) - 1, max_voxels).astype(np.int64)
        zz, yy, xx = zz[sel], yy[sel], xx[sel]
    v = vals[zz, yy, xx]
    ox, oy, oz = grid_spec.origin
    vs = grid_spec.voxel_size
    pts = np.stack(
        [(xx + 0.5) * vs + ox, (yy + 0.5) * vs + oy, (zz + 0.5) * vs + oz], axis=1
    ).astype(np.float32)
    colors = np.zeros((len(v), 4), np.float32)
    for thr, color in ths:
        colors[v > thr] = color
    return Marker("cubes", pts, colors, scale=vs, ns="voxel_map")


def border_marker(grid_spec, color=(1.0, 0.0, 0.0, 1.0)) -> Marker:
    """Operation-area wireframe (ref borderVisualization, voxel_map.cpp:672-785)."""
    ox, oy, oz = grid_spec.origin
    vs = grid_spec.voxel_size
    hx, hy, hz = (
        ox + grid_spec.nx * vs,
        oy + grid_spec.ny * vs,
        oz + grid_spec.nz * vs,
    )
    c = np.array(
        [
            [ox, oy, oz], [hx, oy, oz], [ox, hy, oz], [hx, hy, oz],
            [ox, oy, hz], [hx, oy, hz], [ox, hy, hz], [hx, hy, hz],
        ],
        np.float32,
    )
    edges = [
        (0, 1), (0, 2), (1, 3), (2, 3),
        (4, 5), (4, 6), (5, 7), (6, 7),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    pts = np.concatenate([c[[a, b]] for a, b in edges], axis=0)
    colors = np.tile(np.asarray(color, np.float32), (len(pts), 1))
    return Marker("lines", pts, colors, scale=0.1, ns="border")


# class colors (ref clusters_visualization: mav red, unknown yellow-ish,
# invalid gray — vofod_nodelet.cpp:1940-2040)
CLASS_COLORS = {
    0: (0.5, 0.5, 0.5, 0.5),  # invalid
    1: (1.0, 0.0, 0.0, 1.0),  # mav
    2: (1.0, 1.0, 0.0, 0.8),  # unknown
}


def cluster_obb_markers(det) -> Marker:
    """OBB wireframes per classified cluster (needs a Detections struct from
    the step output, host-fetched)."""
    pts_all, col_all = [], []
    cls, valid, n_points = _host(det.cluster_class), _host(det.valid), _host(det.n_points)
    obb_axes, obb_extent, obb_center = _host(det.obb_axes), _host(det.obb_extent), _host(det.obb_center)
    K = len(cls)
    for k in range(K):
        cc = int(cls[k])
        if cc == 0 and not bool(valid[k]):
            if n_points[k] == 0:
                continue
        axes = obb_axes[k]  # rows = axes
        ext = obb_extent[k]
        ctr = obb_center[k]
        corners = []
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    corners.append(
                        ctr
                        + sx * ext[0] * axes[0]
                        + sy * ext[1] * axes[1]
                        + sz * ext[2] * axes[2]
                    )
        c = np.asarray(corners, np.float32)
        edges = [
            (0, 1), (0, 2), (1, 3), (2, 3),
            (4, 5), (4, 6), (5, 7), (6, 7),
            (0, 4), (1, 5), (2, 6), (3, 7),
        ]
        for a, b in edges:
            pts_all.append(c[a])
            pts_all.append(c[b])
            col_all.extend([CLASS_COLORS.get(cc, CLASS_COLORS[0])] * 2)
    if not pts_all:
        return Marker("lines", np.zeros((0, 3), np.float32),
                      np.zeros((0, 4), np.float32), scale=0.05, ns="clusters")
    return Marker(
        "lines",
        np.asarray(pts_all, np.float32),
        np.asarray(col_all, np.float32),
        scale=0.05,
        ns="clusters",
    )


def lidar_ray_markers(
    lut, ranges_mm: np.ndarray, pose: np.ndarray, max_dist: float = 20.0,
    stride: int = 64,
) -> Marker:
    """Rainbow FOV rays (ref lidar_visualization, vofod_nodelet.cpp:2089-2105):
    one line per (strided) pixel, hue by elevation row."""
    R = np.asarray(pose, np.float64)[:3, :3]
    t = np.asarray(pose, np.float64)[:3, 3]
    dirs = (lut.directions.astype(np.float64) @ R.T)[::stride]
    offs = (lut.offsets.astype(np.float64) @ R.T + t)[::stride]
    r = np.asarray(ranges_mm, np.float64).reshape(-1)[::stride] * 1e-3
    r = np.where(r == 0, max_dist, np.minimum(r, max_dist))
    starts = offs
    ends = offs + dirs * r[:, None]
    n = len(starts)
    pts = np.empty((2 * n, 3), np.float32)
    pts[0::2] = starts
    pts[1::2] = ends
    rows = (np.arange(len(lut.directions)) // lut.width)[::stride]
    colors = np.empty((2 * n, 4), np.float32)
    for i, u in enumerate(rows):
        rgb = hsv_to_rgb(360.0 * u / max(lut.height - 1, 1), 1.0, 1.0)
        colors[2 * i] = (*rgb, 0.5)
        colors[2 * i + 1] = (*rgb, 0.5)
    return Marker("lines", pts, colors, scale=0.02, ns="lidar_fov")


def frontier_markers(
    grid_vals: np.ndarray, grid_spec, thr_frontiers: float,
    thr_new_obstacles: float, color=(0.0, 1.0, 1.0, 0.4), max_voxels=100_000,
) -> Marker:
    """Unknown-band ("frontier") voxels — the region exploreToGround walks
    through (ref frontier_visualization, vofod_nodelet.cpp:2048-2085)."""
    vals = _host(grid_vals)
    m = (vals > thr_frontiers) & (vals <= thr_new_obstacles)
    zz, yy, xx = np.nonzero(m)
    if len(zz) > max_voxels:
        sel = np.linspace(0, len(zz) - 1, max_voxels).astype(np.int64)
        zz, yy, xx = zz[sel], yy[sel], xx[sel]
    ox, oy, oz = grid_spec.origin
    vs = grid_spec.voxel_size
    pts = np.stack(
        [(xx + 0.5) * vs + ox, (yy + 0.5) * vs + oy, (zz + 0.5) * vs + oz], axis=1
    ).astype(np.float32)
    colors = np.tile(np.asarray(color, np.float32), (len(pts), 1))
    return Marker("cubes", pts, colors, scale=vs, ns="frontiers")


def save_markers_npz(path: str, markers: list[Marker]):
    data = {}
    for i, m in enumerate(markers):
        data[f"{i}_{m.ns}_{m.kind}_points"] = m.points
        data[f"{i}_{m.ns}_{m.kind}_colors"] = m.colors
    np.savez_compressed(path, **data)
