"""Freespace raycast: the gated six-cone transmittance sweep (K4).

PyTorch counterpart of the production raycast of vofod_tpu/ops/raycast.py
(``raycast_sweep`` and its helpers; ref src/vofod_nodelet.cpp:1396-1606
raycast_cloud).  Rays are straight lines from one origin, so the fraction of
rays reaching a voxel unobstructed obeys a plane-by-plane recurrence along
each of six axis cones; the accumulated chord length is then
T * ray density * voxel volume / d², masked to the FOV and the range.

The cone sweeps are the hand-written CUDA kernel K4 (csrc/cone_sweep.cu)
for CUDA tensors and :func:`cone_sweep_plain` for CPU tensors; both write
T in grid layout, [6, nz, ny, nx] for the cones x+, x-, y+, y-, z+, z-.
The JAX 4+2 padded cone grouping (a TPU workaround) is not kept: each cone
sweeps its own plane shape.  The angular gate (per-pixel FOV-mask and
intensity gates as a direction-dependent active-ray fraction) is a numpy
copy of ``make_angular_gate`` plus plain PyTorch ``gate_faces`` /
``_expand_gate``; the exact DDA mode is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vofod_tpu_torch import kernels
from vofod_tpu_torch.geometry import GridSpec

Tensor = torch.Tensor


# -----------------------------------------------------------------------------
# Angular gate (numpy copy of the JAX package's static gate description)
# -----------------------------------------------------------------------------


class AngularGate(NamedTuple):
    """Static description of the pixel-lattice → angle mapping (see
    vofod_tpu/ops/raycast.py AngularGate)."""

    el_a: float  # row_f = (el - el_b) / el_a  (linear fallback / FOV window)
    el_b: float
    az_a: float  # col_f = (az_unwrapped - az_b) / az_a
    az_b: float
    pool_v: int
    pool_h: int
    n_rows: int  # pooled gate-texture shape
    n_cols: int
    col_period: float  # azimuth period in pooled-column units (wraps)
    face_dirs: np.ndarray  # [6, F, F, 3] world-frame cube-face texel dirs
    # [H] per-row mean elevation (monotone), or None when the linear fit is
    # exact to <0.1 row
    el_rows: np.ndarray | None = None


def _largest_divisor_leq(n: int, k: int) -> int:
    for d in range(max(1, min(n, k)), 0, -1):
        if n % d == 0:
            return d
    return 1


def _face_dirs(face_res: int) -> np.ndarray:
    """[6, F, F, 3] unit directions for cube-face texels, face order matching
    the cones: x+, x-, y+, y-, z+, z-.  Texel (i, j) sits at lateral-ratio
    coords u' = rel_A/rel_sweep, v' = rel_B/rel_sweep in [-1, 1]²
    (x cones: A=z, B=y; y cones: A=z, B=x; z cones: A=y, B=x)."""
    F_ = face_res
    u = np.linspace(-1.0, 1.0, F_)
    U, V = np.meshgrid(u, u, indexing="ij")
    one = np.ones_like(U)
    faces = np.stack(
        [
            np.stack([one, V, U], -1),  # x+
            np.stack([-one, V, U], -1),  # x-
            np.stack([V, one, U], -1),  # y+
            np.stack([V, -one, U], -1),  # y-
            np.stack([V, U, one], -1),  # z+
            np.stack([V, U, -one], -1),  # z-
        ]
    )
    return (faces / np.linalg.norm(faces, axis=-1, keepdims=True)).astype(np.float32)


def make_angular_gate(
    lut, *, face_res: int = 33, target_rows: int = 32, target_cols: int = 128,
) -> AngularGate:
    """Fit the pixel↔angle maps from the sensor LUT (a static constant)."""
    H, W = lut.height, lut.width
    dirs = np.asarray(lut.directions, np.float64).reshape(H, W, 3)

    el_row = np.arcsin(np.clip(dirs[..., 2], -1.0, 1.0)).mean(axis=1)  # [H]
    if H > 1:
        el_a, el_b = np.polyfit(np.arange(H), el_row, 1)
    else:
        el_a, el_b = 1.0, float(el_row[0])
    el_rows = None
    if H > 1:
        row_lin = (el_row - el_b) / el_a
        if np.abs(row_lin - np.arange(H)).max() > 0.1:
            d = np.diff(el_row)
            assert (d > 0).all() or (d < 0).all(), (
                "beam-altitude table must be monotone in the row"
            )
            el_rows = el_row.astype(np.float64)

    mid = dirs[H // 2]
    az_col = np.unwrap(np.arctan2(mid[:, 1], mid[:, 0]))
    if W > 1:
        az_a, az_b = np.polyfit(np.arange(W), az_col, 1)
    else:
        az_a, az_b = 1.0, float(az_col[0])

    pool_v = _largest_divisor_leq(H, max(1, H // target_rows))
    pool_h = _largest_divisor_leq(W, max(1, W // target_cols))
    return AngularGate(
        el_a=float(el_a),
        el_b=float(el_b),
        az_a=float(az_a),
        az_b=float(az_b),
        pool_v=pool_v,
        pool_h=pool_h,
        n_rows=H // pool_v,
        n_cols=W // pool_h,
        col_period=float(2.0 * np.pi / abs(az_a) / pool_h),
        face_dirs=_face_dirs(face_res),
        el_rows=el_rows,
    )


def _row_from_elevation(gate: AngularGate, el: Tensor) -> Tensor:
    """Continuous full-resolution row coordinate for elevations ``el`` [P]:
    the linear map, or the exact monotone inverse of ``gate.el_rows``."""
    if gate.el_rows is None:
        return (el - gate.el_b) / gate.el_a
    tbl = np.asarray(gate.el_rows, np.float32)
    sgn = 1.0 if tbl[-1] > tbl[0] else -1.0
    f = torch.as_tensor(sgn * tbl, device=el.device)  # [H] increasing
    t = sgn * el
    H = f.shape[0]
    idx = torch.clamp(
        torch.sum((t[:, None] >= f[None, :]).to(torch.int32), dim=-1) - 1, 0, H - 2
    )
    f0, f1 = f[:-1][idx], f[1:][idx]
    return idx.to(torch.float32) + (t - f0) / (f1 - f0)


def gate_faces(gate: AngularGate, face_dirs: Tensor, active_hw: Tensor,
               rot_s2w: Tensor) -> Tensor:
    """Sample the pooled active-ray fraction onto the six cube faces.

    face_dirs: the gate's ``face_dirs`` as a [P, 3] float32 tensor on the
    step's device (uploaded once); active_hw: [H, W] bool, pixels that cast
    a ray this scan; rot_s2w: [3, 3] sensor-to-world rotation.
    Returns float32 [6, F, F]; 0 outside the sensor's vertical FOV."""
    G = (
        active_hw.to(torch.float32)
        .reshape(gate.n_rows, gate.pool_v, gate.n_cols, gate.pool_h)
        .mean(dim=(1, 3))
    )  # [V', H']
    d_s = face_dirs @ rot_s2w  # sensor frame: s = Rᵀ w  (row-vector form)
    el = torch.arcsin(torch.clamp(d_s[:, 2], -1.0, 1.0))
    az = torch.atan2(d_s[:, 1], d_s[:, 0])

    g_r = (_row_from_elevation(gate, el) + 0.5) / gate.pool_v - 0.5
    g_c = torch.remainder(
        ((az - gate.az_b) / gate.az_a + 0.5) / gate.pool_h - 0.5, gate.col_period
    )
    dev = active_hw.device
    kr = torch.arange(gate.n_rows, dtype=torch.float32, device=dev)
    kc = torch.arange(gate.n_cols, dtype=torch.float32, device=dev)
    w_r = torch.clamp(1.0 - torch.abs(g_r[:, None] - kr[None, :]), min=0.0)
    d0 = torch.abs(g_c[:, None] - kc[None, :])
    dwrap = torch.minimum(
        d0,
        torch.minimum(
            torch.abs(g_c[:, None] - gate.col_period - kc[None, :]),
            torch.abs(g_c[:, None] + gate.col_period - kc[None, :]),
        ),
    )
    w_c = torch.clamp(1.0 - dwrap, min=0.0)
    w_c = w_c / torch.clamp(w_c.sum(dim=-1, keepdim=True), min=1e-6)
    vals = torch.sum(w_r * (w_c @ G.T), dim=-1)  # [P]
    F_ = gate.face_dirs.shape[1]
    return vals.reshape(6, F_, F_)


# -----------------------------------------------------------------------------
# Cone sweeps (K4) and assembly
# -----------------------------------------------------------------------------


def _bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _tap_weights(rel_s: Tensor, rel_lat: Tensor) -> Tensor:
    """Separable 4-tap interpolation weights for sampling the previous plane
    at lateral coordinate ``-rel_lat / rel_s`` (clipped to ±1 voxel/plane),
    rounded to bf16 as the JAX sweep does.  rel_s: [...]; rel_lat: [n] ->
    [..., n, 4] float32."""
    rs = torch.where(torch.abs(rel_s) < 0.5, 0.5, rel_s)[..., None]
    f = torch.clamp(-rel_lat / rs, -1.0, 1.0)
    lo = torch.floor(f)
    frac = f - lo
    omf = 1.0 - frac
    zero = torch.zeros_like(f)
    w_m1 = torch.where(lo == -1, omf, zero)
    w_0 = torch.where(lo == -1, frac, zero) + torch.where(lo == 0, omf, zero)
    w_p1 = torch.where(lo == 0, frac, zero) + torch.where(lo == 1, omf, zero)
    w_p2 = torch.where(lo == 1, frac, zero)
    return _bf16(torch.stack([w_m1, w_0, w_p1, w_p2], dim=-1))


def _lerp(p: Tensor, w: Tensor, dim: int) -> Tensor:
    """w0*p[i-1] + w1*p[i] + w2*p[i+1] + w3*p[i+2] along ``dim`` (1.0
    outside), summed left to right in float32, then rounded to bf16."""
    n = p.shape[dim]
    pad = [0, 0] * (p.dim() - 1 - dim) + [1, 2]
    q = F.pad(p, pad, value=1.0)
    tap = [q.narrow(dim, k, n) for k in range(4)]
    shape = [1] * p.dim()
    shape[dim] = n
    ws = [w[:, k].reshape(shape) for k in range(4)]
    return _bf16(ws[0] * tap[0] + ws[1] * tap[1] + ws[2] * tap[2] + ws[3] * tap[3])


def _sweep_axis(op_planes: Tensor, rel_s: Tensor, rel_a: Tensor, rel_b: Tensor) -> Tensor:
    """One cone: op_planes [nS, nA, nB] ordered away from the sensor side,
    rel_s [nS].  Returns T [nS, nA, nB] float32 (bf16 values)."""
    nS, nA, nB = op_planes.shape
    carry = torch.ones((nA, nB), dtype=torch.float32, device=op_planes.device)
    wa = _tap_weights(rel_s, rel_a)  # [nS, nA, 4]
    wb = _tap_weights(rel_s, rel_b)  # [nS, nB, 4]
    seed = rel_s <= 1.0
    out = []
    for p in range(nS):
        t = _lerp(_lerp(carry, wb[p], 1), wa[p], 0)
        t = torch.where(seed[p], 1.0, t)
        carry = torch.where(op_planes[p], 0.0, t)
        out.append(t)
    return torch.stack(out)


def cone_sweep_plain(opaque: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor) -> Tensor:
    """Plain version of K4: T [6, nz, ny, nx] float32 for the cones
    x+, x-, y+, y-, z+, z- (the same arithmetic as csrc/cone_sweep.cu)."""
    op = opaque.to(torch.bool)
    op_x = op.permute(2, 0, 1)  # [nx, nz, ny]: A = z, B = y
    op_y = op.permute(1, 0, 2)  # [ny, nz, nx]: A = z, B = x
    tx_f = _sweep_axis(op_x, rel_x, rel_z, rel_y).permute(1, 2, 0)
    tx_b = _sweep_axis(op_x.flip(0), -rel_x.flip(0), rel_z, rel_y).flip(0).permute(1, 2, 0)
    ty_f = _sweep_axis(op_y, rel_y, rel_z, rel_x).permute(1, 0, 2)
    ty_b = _sweep_axis(op_y.flip(0), -rel_y.flip(0), rel_z, rel_x).flip(0).permute(1, 0, 2)
    tz_f = _sweep_axis(op, rel_z, rel_y, rel_x)
    tz_b = _sweep_axis(op.flip(0), -rel_z.flip(0), rel_y, rel_x).flip(0)
    return torch.stack([tx_f, tx_b, ty_f, ty_b, tz_f, tz_b]).contiguous()


def cone_sweep(opaque: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor) -> Tensor:
    if opaque.is_cuda:
        return kernels.cone_sweep(
            opaque.contiguous().view(torch.uint8), rel_x, rel_y, rel_z
        )
    if opaque.device.type != "cpu":
        raise ValueError(f"cone sweep: unsupported device {opaque.device}")
    return cone_sweep_plain(opaque, rel_x, rel_y, rel_z)


def _expand_gate(faces: Tensor, rel_s: Tensor, rel_a: Tensor, rel_b: Tensor) -> Tensor:
    """One cone's face texture [F, F] expanded onto its planes: rel_s [nS],
    rel_a [nA], rel_b [nB] -> [nS, nA, nB] multiplicative gate factor
    (bf16 tents and products, as the JAX einsums)."""
    F_ = faces.shape[-1]
    rs = torch.where(torch.abs(rel_s) < 0.5, 0.5, rel_s)[:, None]
    u = torch.clamp(rel_a[None, :] / rs, -1.0, 1.0)  # [nS, nA]
    v = torch.clamp(rel_b[None, :] / rs, -1.0, 1.0)  # [nS, nB]
    k = torch.arange(F_, dtype=torch.float32, device=faces.device)

    def tent(x):
        g = (x + 1.0) * ((F_ - 1) / 2.0)
        return _bf16(torch.clamp(1.0 - torch.abs(g[..., None] - k), min=0.0))

    tmp = _bf16(torch.einsum("saf,fg->sag", tent(u), _bf16(faces)))
    return _bf16(torch.einsum("sag,sbg->sab", tmp, tent(v)))


def _gate_grid(faces: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor) -> Tensor:
    """The six cones' gate factors in grid layout [6, nz, ny, nx]."""
    gx_f = _expand_gate(faces[0], rel_x, rel_z, rel_y).permute(1, 2, 0)
    gx_b = _expand_gate(faces[1], -rel_x.flip(0), rel_z, rel_y).flip(0).permute(1, 2, 0)
    gy_f = _expand_gate(faces[2], rel_y, rel_z, rel_x).permute(1, 0, 2)
    gy_b = _expand_gate(faces[3], -rel_y.flip(0), rel_z, rel_x).flip(0).permute(1, 0, 2)
    gz_f = _expand_gate(faces[4], rel_z, rel_y, rel_x)
    gz_b = _expand_gate(faces[5], -rel_z.flip(0), rel_y, rel_x).flip(0)
    return torch.stack([gx_f, gx_b, gy_f, gy_b, gz_f, gz_b])


def _assemble_raylen(vs, rel_x, rel_y, rel_z, T6, rot_s2w, max_distance,
                     vertical_fov, v_rays, h_rays) -> Tensor:
    """Cone partition + chord-length density (vofod_tpu _assemble_raylen)."""
    ax = torch.abs(rel_x)[None, None, :]
    ay = torch.abs(rel_y)[None, :, None]
    az = torch.abs(rel_z)[:, None, None]
    in_x = (ax >= ay) & (ax >= az)
    in_y = (~in_x) & (ay >= az)
    in_z = ~(in_x | in_y)
    pos_x = rel_x[None, None, :] > 0
    pos_y = rel_y[None, :, None] > 0
    pos_z = rel_z[:, None, None] > 0
    T = (
        torch.where(in_x & pos_x, T6[0], 0.0)
        + torch.where(in_x & ~pos_x, T6[1], 0.0)
        + torch.where(in_y & pos_y, T6[2], 0.0)
        + torch.where(in_y & ~pos_y, T6[3], 0.0)
        + torch.where(in_z & pos_z, T6[4], 0.0)
        + torch.where(in_z & ~pos_z, T6[5], 0.0)
    )
    rx = rel_x[None, None, :] * vs
    ry = rel_y[None, :, None] * vs
    rz = rel_z[:, None, None] * vs
    d2 = rx * rx + ry * ry + rz * rz
    d = torch.sqrt(d2)
    d_safe = torch.clamp(d, min=vs)
    Rt = rot_s2w.T
    sz = Rt[2, 0] * rx + Rt[2, 1] * ry + Rt[2, 2] * rz
    sin_el = torch.clamp(sz / d_safe, -1.0, 1.0)
    el = torch.arcsin(sin_el)
    cos_el = torch.clamp(torch.cos(el), min=0.05)
    d_az = 2.0 * math.pi / max(h_rays - 1, 1)
    d_el = vertical_fov / max(v_rays - 1, 1)
    density = 1.0 / ((d_az * d_el) * cos_el)  # rays per steradian
    fov = torch.abs(el) <= (vertical_fov / 2.0 + d_el)
    in_range = d <= max_distance
    raylen = T * density * (vs**3) / torch.clamp(d2, min=vs * vs)
    return torch.where(fov & in_range, raylen, 0.0)


# margin (voxels) beyond the max-distance ball kept inside the sweep window
_WINDOW_MARGIN = 8


def _window_sizes(nx: int, ny: int, vs: float, bound: float | None) -> tuple[int, int]:
    if bound is None:
        return nx, ny
    r = int(math.ceil(bound / vs)) + _WINDOW_MARGIN
    w = 2 * r + 1
    return min(nx, w), min(ny, w)


def sweep_window(grid: GridSpec, origin_world: np.ndarray,
                 max_distance_bound: float | None):
    """Host-side window geometry from the host pose: (x0, y0, wx, wy, gx,
    gy, gz) with the sensor position (gx, gy, gz) in float32 voxel units,
    computed exactly as the JAX sweep computes it on the device."""
    nz, ny, nx = grid.shape
    vs = np.float32(grid.voxel_size)
    o = np.asarray(origin_world, np.float32)
    org = np.asarray(grid.origin, np.float32)
    gx, gy, gz = ((o - org) / vs).astype(np.float32)
    wx, wy = _window_sizes(nx, ny, grid.voxel_size, max_distance_bound)
    x0 = int(np.clip(int(np.floor(gx)) - wx // 2, 0, nx - wx))
    y0 = int(np.clip(int(np.floor(gy)) - wy // 2, 0, ny - wy))
    return x0, y0, wx, wy, gx, gy, gz


def raycast_sweep(
    grid: GridSpec,
    opaque: Tensor,
    origin_world: np.ndarray,
    rot_s2w: Tensor,
    *,
    max_distance: float,
    vertical_fov: float,
    v_rays: int,
    h_rays: int,
    gate: Tensor | None = None,
    max_distance_bound: float | None = None,
) -> Tensor:
    """Gather-free accumulated-ray-length field (see the module docstring).

    opaque: (nz, ny, nx) bool — voxels containing scan returns.
    origin_world: host float32 [3] sensor origin (the window and the
      sensor-relative offsets are computed on the host, no sync).
    rot_s2w: [3, 3] sensor-to-world rotation on the grid's device.
    gate: optional [6, F, F] faces from :func:`gate_faces`.
    max_distance_bound: optional static bound; the sweep then runs on a
      ±(bound/voxel + 8)-voxel x/y window around the sensor.

    Returns: float32 (nz, ny, nx) raylen field (≈ sum of ray chord lengths).
    """
    nz, ny, nx = grid.shape
    vs = grid.voxel_size
    dev = opaque.device
    x0, y0, wx, wy, gx, gy, gz = sweep_window(grid, origin_world, max_distance_bound)
    rel_z = torch.arange(nz, dtype=torch.float32, device=dev) + 0.5 - float(gz)
    rel_x = torch.arange(wx, dtype=torch.float32, device=dev) + float(x0) + 0.5 - float(gx)
    rel_y = torch.arange(wy, dtype=torch.float32, device=dev) + float(y0) + 0.5 - float(gy)
    op_w = opaque[:, y0:y0 + wy, x0:x0 + wx]
    T6 = cone_sweep(op_w, rel_x, rel_y, rel_z)
    if gate is not None:
        T6 = T6 * _gate_grid(gate, rel_x, rel_y, rel_z)
    raylen_w = _assemble_raylen(
        vs, rel_x, rel_y, rel_z, T6, rot_s2w, max_distance, vertical_fov,
        v_rays, h_rays,
    )
    if (wx, wy) == (nx, ny):
        return raylen_w
    out = torch.zeros((nz, ny, nx), dtype=torch.float32, device=dev)
    out[:, y0:y0 + wy, x0:x0 + wx] = raylen_w
    return out
