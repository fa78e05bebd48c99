"""Freespace raycast: the angular gate (K5a), the gated six-cone
transmittance sweep (K4), the ray assembly + ray EMA (K5b), and the exact
DDA with its full-grid ray EMA (K12).

PyTorch counterpart of vofod_tpu/ops/raycast.py (the production
``raycast_sweep`` and its helpers, and the reference-exact ``raycast_dda``;
ref src/vofod_nodelet.cpp:1396-1606 raycast_cloud).  Rays are straight lines from one origin, so the fraction of
rays reaching a voxel unobstructed obeys a plane-by-plane recurrence along
each of six axis cones; the accumulated chord length is then
T * ray density * voxel volume / d², masked to the FOV and the range.

The cone sweeps are the hand-written CUDA kernel K4 (csrc/cone_sweep.cu)
for CUDA tensors and :func:`cone_sweep_plain` for CPU tensors; both write
T in grid layout, [6, nz, ny, nx] for the cones x+, x-, y+, y-, z+, z-.
The JAX 4+2 padded cone grouping (a TPU workaround) is not kept: each cone
sweeps its own plane shape.  The angular gate (per-pixel FOV-mask and
intensity gates as a direction-dependent active-ray fraction) is a numpy
copy of ``make_angular_gate``; its face texture is K5a (csrc/ray_gate.cu,
plain version :func:`gate_faces_plain`).  K5b (csrc/ray_update.cu, plain
version :func:`ray_window_update_plain_`) expands the gate per voxel,
assembles the raylen and applies the ray EMA in place on the sweep window,
so the step never builds a full-grid raylen field.

The grid-sharded sweep (:func:`raycast_update_zsharded`, vofod_tpu
``raycast_sweep_zsharded``) runs on a shard's z slab of the window: the x
and y cones with their lateral z rows exchanged every plane step (K15b-3,
csrc/cone_sweep.cu, plain version :func:`cone_lat_step_plain`), the z cones
pipelined over the shards (K15b-4a, plain version
:func:`cone_z_round_plain`) or, with ``zcone_mode="transpose"``, swept
y-sharded between two all_to_alls (K15b-4b, plain version
:func:`cone_zt_step_plain`), then K5b on the slab; its T is bit-equal to
K4's on the same window.

The exact mode walks every ray with Amanatides–Woo (K12, csrc/dda.cu, plain
version :func:`raycast_dda_plain`) into a full-grid raylen field and applies
the same ray EMA to it (K12's second pass, csrc/ray_update.cu
``vofod_ray_ema``, plain version :func:`ray_ema_plain`).  On the
grid-sharded step each shard walks every ray into its slab's rows only
(K15b-6c, :func:`raycast_dda_slab`), and the old rule's max is taken over
the shards.
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


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float (a tensor op with it is
    then exact in the scalar)."""
    return float(np.float32(x))


def _inv(x: float) -> float:
    """float32 reciprocal of ``x``: PyTorch's CUDA division by a Python
    scalar multiplies by it, so the plain versions and the kernels multiply
    by it explicitly on every device."""
    return float(np.float32(1.0) / np.float32(x))


def row_table(gate: AngularGate, device) -> Tensor | None:
    """The sign-folded elevation table of ``gate.el_rows`` (increasing
    float32 [H]) on ``device``, or None for the linear map.  Upload once."""
    if gate.el_rows is None:
        return None
    tbl = np.asarray(gate.el_rows, np.float32)
    return torch.as_tensor(_row_sign(gate) * tbl, device=device)


def _row_sign(gate: AngularGate) -> float:
    tbl = np.asarray(gate.el_rows, np.float32)
    return 1.0 if tbl[-1] > tbl[0] else -1.0


def _row_from_elevation(gate: AngularGate, el: Tensor, table: Tensor | None) -> Tensor:
    """Continuous full-resolution row coordinate for elevations ``el`` [P]:
    the linear map, or the exact monotone inverse of ``gate.el_rows``
    (``table`` from :func:`row_table`)."""
    if gate.el_rows is None:
        return (el - _f32(gate.el_b)) * _inv(gate.el_a)
    t = _row_sign(gate) * el
    H = table.shape[0]
    idx = torch.clamp(
        torch.sum((t[:, None] >= table[None, :]).to(torch.int32), dim=-1) - 1, 0, H - 2
    )
    f0, f1 = table[:-1][idx], table[1:][idx]
    return idx.to(torch.float32) + (t - f0) / (f1 - f0)


def _gate_scalars(gate: AngularGate) -> np.ndarray:
    """K5a's float32 constants, in the order of csrc/ray_gate.cu GateF."""
    sgn = _row_sign(gate) if gate.el_rows is not None else 1.0
    return np.array([
        _inv(gate.pool_v * gate.pool_h), gate.el_b, _inv(gate.el_a), sgn, gate.az_b,
        _inv(gate.az_a), _inv(gate.pool_v), _inv(gate.pool_h), gate.col_period,
    ], np.float32)


def _gate_coords(gate: AngularGate, face_dirs: Tensor, active_hw: Tensor, rot_s2w: Tensor,
                 table: Tensor | None) -> tuple[Tensor, Tensor, Tensor]:
    """K5a's pooled grid G [n_rows, n_cols] and each texel's continuous
    pooled row g_r and column g_c [P], rounded as csrc/ray_gate.cu rounds
    them."""
    if table is None and gate.el_rows is not None:
        table = row_table(gate, active_hw.device)
    cnt = (
        active_hw.to(torch.int32)
        .reshape(gate.n_rows, gate.pool_v, gate.n_cols, gate.pool_h)
        .sum(dim=(1, 3))
    )
    G = cnt.to(torch.float32) * _inv(gate.pool_v * gate.pool_h)  # [V', H'] mean
    d = [face_dirs[:, i] for i in range(3)]
    s = [(d[0] * rot_s2w[0, j] + d[1] * rot_s2w[1, j]) + d[2] * rot_s2w[2, j]
         for j in range(3)]  # sensor frame: s = Rᵀ w
    el = torch.arcsin(torch.clamp(s[2], -1.0, 1.0))
    az = torch.atan2(s[1], s[0])

    g_r = (_row_from_elevation(gate, el, table) + 0.5) * _inv(gate.pool_v) - 0.5
    g_c = torch.remainder(
        ((az - _f32(gate.az_b)) * _inv(gate.az_a) + 0.5) * _inv(gate.pool_h) - 0.5,
        _f32(gate.col_period),
    )
    return G, g_r, g_c


def _col_weight(g_c: Tensor, P: float, kc: Tensor) -> Tensor:
    """The circular column tent of pooled columns ``kc`` at ``g_c``
    (broadcast), as csrc/ray_gate.cu col_weight."""
    dwrap = torch.minimum(
        torch.abs(g_c - kc),
        torch.minimum(torch.abs((g_c - P) - kc), torch.abs((g_c + P) - kc)),
    )
    return torch.clamp(1.0 - dwrap, min=0.0)


def gate_faces_plain(gate: AngularGate, face_dirs: Tensor, active_hw: Tensor,
                     rot_s2w: Tensor, table: Tensor | None = None) -> Tensor:
    """Plain version of K5a (vofod_tpu/ops/raycast.py gate_faces), with
    every rounding step fixed so that csrc/ray_gate.cu reproduces it: the
    sensor-frame directions as ((d0 R0j + d1 R1j) + d2 R2j), division by a
    constant as a multiply by its float32 reciprocal, the azimuth-weight
    sum and the column products summed in ascending column order.  The row
    tent has at most two nonzero taps, so its sum is exact in any order."""
    G, g_r, g_c = _gate_coords(gate, face_dirs, active_hw, rot_s2w, table)
    dev = active_hw.device
    P = _f32(gate.col_period)
    kr = torch.arange(gate.n_rows, dtype=torch.float32, device=dev)
    kc = torch.arange(gate.n_cols, dtype=torch.float32, device=dev)
    w_r = torch.clamp(1.0 - torch.abs(g_r[:, None] - kr[None, :]), min=0.0)
    w_c = _col_weight(g_c[:, None], P, kc[None, :])  # [P, H']
    w_sum = torch.zeros_like(g_c)
    for c in range(gate.n_cols):
        w_sum = w_sum + w_c[:, c]
    w_c = w_c / torch.clamp(w_sum, min=1e-6)[:, None]
    inner = torch.zeros((g_c.shape[0], gate.n_rows), dtype=torch.float32, device=dev)
    for c in range(gate.n_cols):
        inner = inner + w_c[:, c:c + 1] * G[:, c][None, :]
    vals = torch.sum(w_r * inner, dim=-1)  # [P]
    F_ = gate.face_dirs.shape[1]
    return vals.reshape(6, F_, F_)


def gate_tent_support(gate: AngularGate, g_c: Tensor) -> tuple[Tensor, Tensor]:
    """The support of each texel's column tent as csrc/ray_gate.cu walks
    it: (cols int64 [P, 6] ascending, first bool [P, 6]) — the columns
    floor(c) and floor(c) + 1 of c = g_c - period, g_c, g_c + period (as the
    tent rounds them) inside [0, n_cols), sorted, ``first`` marking each
    distinct column once (False at duplicates and outside the range)."""
    P = _f32(gate.col_period)
    cand = []
    for centre in (g_c - P, g_c, g_c + P):
        fc = torch.floor(centre)
        for k in (0.0, 1.0):
            kc = fc + k
            inside = (kc >= 0.0) & (kc <= float(gate.n_cols - 1))
            cand.append(torch.where(inside, kc, float("inf")))
    cols = torch.sort(torch.stack(cand, 1), dim=1).values  # [P, 6], inf last
    first = torch.isfinite(cols)
    first[:, 1:] &= cols[:, 1:] != cols[:, :-1]
    return torch.where(first, cols, 0.0).to(torch.int64), first


def gate_faces_support_plain(gate: AngularGate, face_dirs: Tensor, active_hw: Tensor,
                             rot_s2w: Tensor, table: Tensor | None = None) -> Tensor:
    """Plain model of K5a's support walk (csrc/ray_gate.cu): the weight sum
    and the column products over :func:`gate_tent_support` alone, in its
    ascending order, skipping zero weights as the kernel does.  Bit-equal
    to :func:`gate_faces_plain`: off the support every weight is +0."""
    G, g_r, g_c = _gate_coords(gate, face_dirs, active_hw, rot_s2w, table)
    dev = active_hw.device
    P = _f32(gate.col_period)
    cols, first = gate_tent_support(gate, g_c)
    w = _col_weight(g_c[:, None], P, cols.to(torch.float32))  # [P, 6]
    w_sum = torch.zeros_like(g_c)
    for i in range(6):
        w_sum = torch.where(first[:, i], w_sum + w[:, i], w_sum)
    wn = w / torch.clamp(w_sum, min=1e-6)[:, None]
    inner = torch.zeros((g_c.shape[0], gate.n_rows), dtype=torch.float32, device=dev)
    for i in range(6):
        add = (first[:, i] & (w[:, i] > 0.0))[:, None]
        inner = torch.where(add, inner + wn[:, i:i + 1] * G[:, cols[:, i]].T, inner)
    kr = torch.arange(gate.n_rows, dtype=torch.float32, device=dev)
    w_r = torch.clamp(1.0 - torch.abs(g_r[:, None] - kr[None, :]), min=0.0)
    vals = torch.sum(w_r * inner, dim=-1)
    F_ = gate.face_dirs.shape[1]
    return vals.reshape(6, F_, F_)


def gate_faces(gate: AngularGate, face_dirs: Tensor, active_hw: Tensor,
               rot_s2w: Tensor, table: Tensor | None = None) -> Tensor:
    """Sample the pooled active-ray fraction onto the six cube faces (K5a).

    face_dirs: the gate's ``face_dirs`` as a [P, 3] float32 tensor on the
    step's device (uploaded once); active_hw: [H, W] bool, pixels that cast
    a ray this scan; rot_s2w: [3, 3] sensor-to-world rotation; table: the
    gate's :func:`row_table` on the same device (uploaded once; built here
    when omitted).  Returns float32 [6, F, F]; 0 outside the sensor's
    vertical FOV."""
    if table is None and gate.el_rows is not None:
        table = row_table(gate, active_hw.device)
    if active_hw.is_cuda:
        F_ = gate.face_dirs.shape[1]
        return kernels.gate_faces(
            active_hw.contiguous(), face_dirs, rot_s2w.contiguous(), table,
            (gate.pool_v, gate.pool_h, gate.n_rows, gate.n_cols), _gate_scalars(gate),
        ).reshape(6, F_, F_)
    if active_hw.device.type != "cpu":
        raise ValueError(f"gate faces: unsupported device {active_hw.device}")
    return gate_faces_plain(gate, face_dirs, active_hw, rot_s2w, table)


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


class RayConsts(NamedTuple):
    """Float32 constants of the chord-length density (vofod_tpu
    _assemble_raylen), each already rounded as the tensor op rounds it."""

    vs: float  # voxel size
    vs3: float  # vs**3
    vs2: float  # vs*vs
    c_dens: float  # d_az * d_el (ray spacing, rad²)
    fov_lim: float  # vertical_fov / 2 + d_el
    max_d: float  # max_distance

    @staticmethod
    def make(vs: float, max_distance: float, vertical_fov: float, v_rays: int,
             h_rays: int) -> "RayConsts":
        d_az = 2.0 * math.pi / max(h_rays - 1, 1)
        d_el = vertical_fov / max(v_rays - 1, 1)
        return RayConsts(_f32(vs), _f32(vs**3), _f32(vs * vs), _f32(d_az * d_el),
                         _f32(vertical_fov / 2.0 + d_el), _f32(max_distance))


class RayEma(NamedTuple):
    """The flag-guarded ray EMA (vofod_tpu/pipeline/step.py ray_update):
    the rule and its float32 constants."""

    new_rule: bool
    coef: float  # new rule: weight_coefficient / voxel diagonal
    its: float  # its_diff (steps since the last raycast)
    weight: float  # old rule: weight_coefficient
    score: float  # score_ray


def _lanes(fn, x: Tensor) -> Tensor:
    """``fn(x)`` elementwise with every element in the vectorised loop of
    PyTorch's CPU kernels (the flat length padded to a multiple of 64): their
    scalar tail loop rounds exp2 differently, so without this a voxel's value
    would depend on where it sits in the tensor, and a shard's slab would
    not get its voxels' dense values."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % 64
    return fn(F.pad(flat, (0, pad)))[:flat.numel()].reshape(x.shape)


def ray_ema_plain(vals: Tensor, raylen: Tensor, had_point: Tensor, ema: RayEma,
                  gmax=None) -> Tensor:
    """The ray EMA toward ``ema.score`` where ``raylen > 0`` and no point
    landed this scan (both reference update rules, vofod_nodelet.cpp:
    1550-1601).  The old rule normalises by ``max(raylen)``: on a window,
    the window's max, which is the grid's since raylen is 0 outside it; on
    a shard's slab, that max through ``gmax`` (the max over the shards)."""
    active = (~had_point) & (raylen > 0.0)
    if ema.new_rule:  # ref :1550-1573
        w1 = _lanes(torch.exp2, -ema.its * (ema.coef * raylen))
    else:  # ref :1574-1601: normalize by the max cell value
        max_val = torch.clamp(raylen.max() if gmax is None else gmax(raylen.max()), min=1e-20)
        w_single = ema.weight * torch.sqrt(raylen / max_val)
        w1 = torch.clamp(torch.pow(1.0 - w_single, ema.its), 0.0, 1.0)
    updated = w1 * vals + (1.0 - w1) * ema.score
    return torch.where(active, updated, vals)


def _gate_factor(faces_bf16: Tensor, cone: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """The gate factor of each voxel from its cone's face texture, at the
    face coordinates u, v in [-1, 1] (vofod_tpu _expand_gate).  A tent has
    at most two nonzero taps, so the two einsums of the JAX function are
    two-term sums here: products of bf16 values are exact in float32, the
    sums round once, and the results round to bf16 where the JAX einsums'
    bf16 outputs do."""
    F_ = faces_bf16.shape[-1]
    half = (F_ - 1) / 2.0

    def taps(x):
        g = (x + 1.0) * half
        k0 = torch.floor(g)
        k1 = k0 + 1.0
        w0 = _bf16(torch.clamp(1.0 - torch.abs(g - k0), min=0.0))
        w1 = _bf16(torch.clamp(1.0 - torch.abs(g - k1), min=0.0))  # 0 at g = F-1
        i0 = k0.to(torch.int64).clamp(0, F_ - 1)
        i1 = k1.to(torch.int64).clamp(0, F_ - 1)
        return (i0, w0), (i1, w1)

    (iu0, wu0), (iu1, wu1) = taps(u)
    (iv0, wv0), (iv1, wv1) = taps(v)
    flat = faces_bf16.reshape(-1)
    base = cone * (F_ * F_)

    def tex(iu, iv):
        return flat[base + iu * F_ + iv]

    tmp0 = _bf16(wu0 * tex(iu0, iv0) + wu1 * tex(iu1, iv0))
    tmp1 = _bf16(wu0 * tex(iu0, iv1) + wu1 * tex(iu1, iv1))
    return _bf16(wv0 * tmp0 + wv1 * tmp1)


def ray_window_plain(T6: Tensor, faces: Tensor | None, rel_x: Tensor, rel_y: Tensor,
                     rel_z: Tensor, rot_s2w: Tensor, c: RayConsts) -> Tensor:
    """Plain version of K5b's raylen: cone partition (priority x > y > z),
    the picked cone's T times its gate factor, chord-length density, FOV
    and range masks on the sweep window [nz, wy, wx] (vofod_tpu
    _expand_gate + _assemble_raylen).  Every float32 op in the order
    csrc/ray_update.cu computes it."""
    X = rel_x[None, None, :]
    Y = rel_y[None, :, None]
    Z = rel_z[:, None, None]
    shape = (rel_z.shape[0], rel_y.shape[0], rel_x.shape[0])
    ax, ay, az = torch.abs(X), torch.abs(Y), torch.abs(Z)
    in_x = ((ax >= ay) & (ax >= az)).expand(shape)
    in_y = ~in_x & (ay >= az)
    rel_s = torch.where(in_x, X, torch.where(in_y, Y, Z))
    pos = rel_s > 0
    cone = 2 * torch.where(in_x, 0, torch.where(in_y, 1, 2)) + (~pos).to(torch.int64)
    T = torch.gather(T6, 0, cone[None]).squeeze(0)
    if faces is not None:
        rs = torch.where(pos, rel_s, -rel_s)
        rs = torch.where(torch.abs(rs) < 0.5, 0.5, rs)
        ra = torch.where(in_x | in_y, Z, Y)  # x, y cones: A = z; z cones: A = y
        rb = torch.where(in_x, Y, X)  # x cones: B = y; y, z cones: B = x
        u = torch.clamp(ra / rs, -1.0, 1.0)
        v = torch.clamp(rb / rs, -1.0, 1.0)
        T = T * _gate_factor(_bf16(faces), cone, u, v)
    rx, ry, rz = X * c.vs, Y * c.vs, Z * c.vs
    d2 = (rx * rx + ry * ry) + rz * rz
    d = torch.sqrt(d2)
    d_safe = torch.clamp(d, min=c.vs)
    # elevation in the SENSOR frame: s = Rᵀ (c - o)
    sz = (rot_s2w[0, 2] * rx + rot_s2w[1, 2] * ry) + rot_s2w[2, 2] * rz
    el = torch.arcsin(torch.clamp(sz / d_safe, -1.0, 1.0))
    cos_el = torch.clamp(torch.cos(el), min=0.05)
    density = torch.reciprocal(c.c_dens * cos_el)  # rays per steradian
    keep = (torch.abs(el) <= c.fov_lim) & (d <= c.max_d)
    raylen = ((T * density) * c.vs3) / torch.clamp(d2, min=c.vs2)
    return torch.where(keep, raylen, 0.0)


def ray_window_update_plain_(vals: Tensor, had_point: Tensor, T6: Tensor,
                             faces: Tensor | None, rel_x: Tensor, rel_y: Tensor,
                             rel_z: Tensor, rot_s2w: Tensor, x0: int, y0: int,
                             c: RayConsts, ema: RayEma, gmax=None) -> Tensor:
    """Plain version of K5b, in place on the window of ``vals``."""
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    raylen = ray_window_plain(T6, faces, rel_x, rel_y, rel_z, rot_s2w, c)
    win = (slice(None), slice(y0, y0 + wy), slice(x0, x0 + wx))
    vals[win] = ray_ema_plain(vals[win], raylen, had_point[win], ema, gmax)
    return vals


# csrc/ray_update.cu's tile: RAY_TX voxels along x by RAY_TY rows along y of
# one z plane, a block each (kernels.ray_update_geometry reads the kernel's)
RAY_TILE = (16, 16)


def _tile_nearest(rel: Tensor, t: int) -> Tensor:
    """The smallest |offset| of each t-wide tile's voxel centres along one
    axis, from the tile's two ends as csrc/ray_update.cu takes it (the
    offsets increase along each axis): 0 where the ends straddle the sensor,
    ``fminf``'s NaN rule elsewhere."""
    n = rel.shape[0]
    first = torch.arange(0, n, t, device=rel.device)
    a, b = rel[first], rel[torch.clamp(first + t, max=n) - 1]
    return torch.where((a <= 0.0) & (b >= 0.0), 0.0, torch.fmin(a.abs(), b.abs()))


def ray_cull_plain(T6: Tensor, had_w: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor,
                   rot_s2w: Tensor, c: RayConsts, new_rule: bool) -> dict[str, Tensor]:
    """Plain model of K5b's cull, in the kernel's order of cost: masks
    [nz, wy, wx] of the window voxels still live after each test.  ``tile``
    the test of the RAY_TILE tiles; ``range`` then d <= max_d; ``had`` then
    no point this scan; ``T`` then a nonzero T; ``fov`` then the elevation
    inside the vertical FOV: ``fov`` is the set that reads the gate's faces
    and computes the density.  Under the old rule's first pass (``new_rule`` False: the
    window max) neither ``had`` nor ``T`` culls: the max takes every voxel's
    raylen, NaN included, and a T of 0 times a NaN gate is NaN.  ``had_w``:
    the window of the point flags."""
    shape = (rel_z.shape[0], rel_y.shape[0], rel_x.shape[0])
    tx, ty = RAY_TILE
    # a tile is culled when its nearest voxel centre lies farther than max_d
    # plus one voxel (in voxel units, float32 as the kernel rounds it): a
    # voxel's own range test sees it 1 / vs voxels past its limit, far
    # beyond any rounding
    nx_ = _tile_nearest(rel_x, tx)[None, None, :]
    ny_ = _tile_nearest(rel_y, ty)[None, :, None]
    nz_ = rel_z.abs()[:, None, None]
    dn2 = (nx_ * nx_ + ny_ * ny_) + nz_ * nz_
    lim = np.float32(c.max_d) / np.float32(c.vs) + np.float32(1.0)
    kept = ~(dn2 > float(lim * lim))
    m = {"tile": kept.repeat_interleave(ty, 1)[:, :shape[1]]
         .repeat_interleave(tx, 2)[:, :, :shape[2]]}
    X, Y, Z = rel_x[None, None, :], rel_y[None, :, None], rel_z[:, None, None]
    rx, ry, rz = X * c.vs, Y * c.vs, Z * c.vs
    d2 = (rx * rx + ry * ry) + rz * rz
    d = torch.sqrt(d2)
    m["range"] = m["tile"] & (d <= c.max_d)
    m["had"] = m["range"] & ~had_w if new_rule else m["range"]
    if new_rule:
        ax, ay, az = torch.abs(X), torch.abs(Y), torch.abs(Z)
        in_x = ((ax >= ay) & (ax >= az)).expand(shape)
        in_y = ~in_x & (ay >= az)
        rel_s = torch.where(in_x, X, torch.where(in_y, Y, Z))
        cone = 2 * torch.where(in_x, 0, torch.where(in_y, 1, 2)) + (~(rel_s > 0)).to(torch.int64)
        T = torch.gather(T6, 0, cone[None]).squeeze(0)
        m["T"] = m["had"] & ((T > 0.0) | (T < 0.0))
    else:
        m["T"] = m["had"]
    sz = (rot_s2w[0, 2] * rx + rot_s2w[1, 2] * ry) + rot_s2w[2, 2] * rz
    el = torch.arcsin(torch.clamp(sz / torch.clamp(d, min=c.vs), -1.0, 1.0))
    m["fov"] = m["T"] & (torch.abs(el) <= c.fov_lim)
    return m


def ray_window_update_(vals: Tensor, had_point: Tensor, T6: Tensor, faces: Tensor | None,
                       rel_x: Tensor, rel_y: Tensor, rel_z: Tensor, rot_s2w: Tensor,
                       x0: int, y0: int, c: RayConsts, ema: RayEma, gmax=None) -> Tensor:
    """K5b: the window's raylen from K4's T6 and the gate faces, and the ray
    EMA, written into ``vals`` in place (voxels outside the window have
    raylen 0 and are not touched).  ``gmax``: the old rule's max over the
    shards on the grid-sharded step.  Returns ``vals``."""
    if vals.is_cuda:
        kernels.ray_update(vals, had_point, T6, faces, rel_x, rel_y, rel_z,
                           rot_s2w.contiguous(), x0, y0, c, ema, gmax)
        return vals
    if vals.device.type != "cpu":
        raise ValueError(f"ray update: unsupported device {vals.device}")
    return ray_window_update_plain_(vals, had_point, T6, faces, rel_x, rel_y, rel_z, rot_s2w,
                                    x0, y0, c, ema, gmax)


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


def _window_rel(grid: GridSpec, origin_world: np.ndarray, max_distance_bound, dev):
    """(x0, y0, rel_x, rel_y, rel_z) of the sweep window, the offsets in
    float32 voxel units as the JAX sweep computes them."""
    x0, y0, wx, wy, gx, gy, gz = sweep_window(grid, origin_world, max_distance_bound)
    rel_z = torch.arange(grid.nz, dtype=torch.float32, device=dev) + 0.5 - float(gz)
    rel_x = torch.arange(wx, dtype=torch.float32, device=dev) + float(x0) + 0.5 - float(gx)
    rel_y = torch.arange(wy, dtype=torch.float32, device=dev) + float(y0) + 0.5 - float(gy)
    return x0, y0, rel_x, rel_y, rel_z


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
    """Gather-free accumulated-ray-length field (see the module docstring),
    through K4 and the plain raylen of K5b.  The step does not call it: its
    raycast is :func:`raycast_update_`, which never builds this field.

    opaque: (nz, ny, nx) bool — voxels containing scan returns.
    origin_world: host float32 [3] sensor origin (the window and the
      sensor-relative offsets are computed on the host, no sync).
    rot_s2w: [3, 3] sensor-to-world rotation on the grid's device.
    gate: optional [6, F, F] faces from :func:`gate_faces`.
    max_distance_bound: optional static bound; the sweep then runs on a
      ±(bound/voxel + 8)-voxel x/y window around the sensor.

    Returns: float32 (nz, ny, nx) raylen field (≈ sum of ray chord lengths).
    """
    x0, y0, rel_x, rel_y, rel_z = _window_rel(grid, origin_world, max_distance_bound,
                                              opaque.device)
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    T6 = cone_sweep(opaque[:, y0:y0 + wy, x0:x0 + wx], rel_x, rel_y, rel_z)
    c = RayConsts.make(grid.voxel_size, max_distance, vertical_fov, v_rays, h_rays)
    raylen_w = ray_window_plain(T6, gate, rel_x, rel_y, rel_z, rot_s2w, c)
    if raylen_w.shape == grid.shape:
        return raylen_w
    out = torch.zeros(grid.shape, dtype=torch.float32, device=opaque.device)
    out[:, y0:y0 + wy, x0:x0 + wx] = raylen_w
    return out


def raycast_update_(
    grid: GridSpec,
    vals: Tensor,
    had_point: Tensor,
    opaque: Tensor,
    origin_world: np.ndarray,
    rot_s2w: Tensor,
    ema: RayEma,
    *,
    max_distance: float,
    vertical_fov: float,
    v_rays: int,
    h_rays: int,
    gate: Tensor | None = None,
    max_distance_bound: float | None = None,
) -> Tensor:
    """The step's raycast: the cone sweeps (K4) on the window around the
    sensor, then K5b's raylen and ray EMA in place on ``vals`` — the same
    result as ``ray_update(raycast_sweep(...))`` without the full-grid
    raylen field.  had_point: bool grid of voxels with a point this scan.
    Arguments otherwise as :func:`raycast_sweep`.  Returns ``vals``."""
    x0, y0, rel_x, rel_y, rel_z = _window_rel(grid, origin_world, max_distance_bound,
                                              opaque.device)
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    T6 = cone_sweep(opaque[:, y0:y0 + wy, x0:x0 + wx], rel_x, rel_y, rel_z)
    c = RayConsts.make(grid.voxel_size, max_distance, vertical_fov, v_rays, h_rays)
    return ray_window_update_(vals, had_point, T6, gate, rel_x, rel_y, rel_z, rot_s2w,
                              x0, y0, c, ema)


# -----------------------------------------------------------------------------
# The grid-sharded sweep (K15b-3, K15b-4a)
# -----------------------------------------------------------------------------


def _plane_rs(rel_s: Tensor, n_s: int, p: int, back: bool) -> tuple[int, Tensor]:
    """(grid index, sensor offset) of a cone's p-th plane from the sensor."""
    s = n_s - 1 - p if back else p
    return s, -rel_s[s] if back else rel_s[s]


def _lerp_rows(p: Tensor, w: Tensor) -> Tensor:
    """:func:`_lerp` along the last axis of p [C, m, n] with per-cone weights
    w [C, n, 4] (1.0 outside), summed left to right, rounded to bf16."""
    n = p.shape[-1]
    q = F.pad(p, (1, 2), value=1.0)
    ws = [w[:, None, :, k] for k in range(4)]
    return _bf16(ws[0] * q[..., 0:n] + ws[1] * q[..., 1:n + 1] + ws[2] * q[..., 2:n + 2]
                 + ws[3] * q[..., 3:n + 3])


def cone_lat_step_plain(opaque: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor,
                        tmp_in: Tensor | None, lo: Tensor | None, hi: Tensor | None,
                        tmp_out: Tensor, T4: Tensor, k: int) -> None:
    """Plain version of K15b-3's launch k, with its arguments (see
    kernels.cone_sweep_lat): per x/y cone, the A pass of plane k - 1 over
    the slab's B-resampled rows with the neighbours' rows around them (1.0
    past the global edge), its T and carry, then the B pass of plane k into
    ``tmp_out``; each pass as :func:`_lerp` sums and rounds it.  Cones of
    one plane shape are stepped together."""
    nzl, wy, wx = opaque.shape
    op = opaque.to(torch.bool)
    dev = opaque.device
    # (cones, planes, lanes, sweep offsets, lane offsets): x cones B = y
    groups = [((0, 1, 2, 3), wx, wy, (rel_x, rel_x, rel_y, rel_y), (rel_y, rel_y, rel_x, rel_x))]
    if wx != wy:
        groups = [((0, 1), wx, wy, (rel_x, rel_x), (rel_y, rel_y)),
                  ((2, 3), wy, wx, (rel_y, rel_y), (rel_x, rel_x))]
    for cones, n_s, n_b, rel_s, rel_b in groups:
        if k > n_s:
            continue
        C = len(cones)
        if k == 0:
            carry = torch.ones((C, nzl, n_b), dtype=torch.float32, device=dev)
        else:
            sr = [_plane_rs(r, n_s, k - 1, c % 2 == 1) for c, r in zip(cones, rel_s)]
            rs = torch.stack([v for _, v in sr])
            ones = torch.ones((C, 1, n_b), dtype=torch.float32, device=dev)
            below = ones if lo is None else lo[0, list(cones), :n_b].float()[:, None]
            above = (torch.cat([ones, ones], 1) if hi is None
                     else hi[:, list(cones), :n_b].float().permute(1, 0, 2))
            mid = tmp_in[:, list(cones), :n_b].float().permute(1, 0, 2)
            ext = torch.cat([below, mid, above], 1)  # rows a-1 .. a+2, [C, nzl + 3, n_b]
            wa = _tap_weights(rs, rel_z.expand(C, nzl))[..., None, :]  # [C, nzl, 1, 4]
            t = _bf16(wa[..., 0] * ext[:, 0:nzl] + wa[..., 1] * ext[:, 1:nzl + 1]
                      + wa[..., 2] * ext[:, 2:nzl + 2] + wa[..., 3] * ext[:, 3:nzl + 3])
            t = torch.where(rs[:, None, None] <= 1.0, 1.0, t)
            planes = []
            for j, (c, (s, _)) in enumerate(zip(cones, sr)):
                if c < 2:
                    T4[c, :, :, s] = t[j]
                    planes.append(op[:, :, s])
                else:
                    T4[c, :, s, :] = t[j]
                    planes.append(op[:, s, :])
            carry = torch.where(torch.stack(planes), 0.0, t)
        if k < n_s:
            rs = torch.stack([_plane_rs(r, n_s, k, c % 2 == 1)[1] for c, r in zip(cones, rel_s)])
            wb = _tap_weights(rs, torch.stack(rel_b))  # [C, n_b, 4]
            tmp_out[:, list(cones), :n_b] = _lerp_rows(carry, wb).to(torch.bfloat16).permute(1, 0, 2)


def cone_z_round_plain(opaque: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor,
                       carry_in: Tensor, T2: Tensor, keep: tuple[bool, bool]) -> Tensor:
    """Plain version of one K15b-4a round (see kernels.cone_sweep_z): the z
    cones over the slab's planes from ``carry_in``, as :func:`_sweep_axis`
    steps them (both cones together); T2 written for the kept cones;
    returns the carry planes out (bf16 [2, wy, wx])."""
    nzl = opaque.shape[0]
    op = opaque.to(torch.bool)
    carry = carry_in.float()
    for p in range(nzl):
        (s0, r0), (s1, r1) = _plane_rs(rel_z, nzl, p, False), _plane_rs(rel_z, nzl, p, True)
        rs = torch.stack([r0, r1])
        wb = _tap_weights(rs, rel_x.expand(2, -1))  # [2, wx, 4]
        wa = _tap_weights(rs, rel_y.expand(2, -1))  # [2, wy, 4]
        t = _lerp_rows(carry, wb)  # along x, then along y (rows)
        t = _lerp_rows(t.transpose(1, 2), wa).transpose(1, 2)
        t = torch.where(rs[:, None, None] <= 1.0, 1.0, t)
        for c, s in ((0, s0), (1, s1)):
            if keep[c]:
                T2[c, s] = t[c]
        carry = torch.where(torch.stack([op[s0], op[s1]]), 0.0, t)
    return carry.to(torch.bfloat16)


def _sharded_step(opaque: Tensor, kernel, plain_fn):
    """The kernel on a CUDA slab, its plain version on a CPU one."""
    if opaque.device.type == "cpu":
        return plain_fn
    if not opaque.is_cuda:
        raise ValueError(f"sharded cone sweep: unsupported device {opaque.device}")
    return kernel


def cone_sweep_lat_sharded(opaque: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor,
                           T4: Tensor, comm) -> None:
    """The x/y cones of a shard's window slab (vofod_tpu
    ``_sweep_cones_lat_sharded``) into T4 [4, nzl, wy, wx]: K15b-3's
    max(wx, wy) + 1 launches, the B-resampled plane's edge rows sent after
    each (the last row up, the first two down) through ``comm`` (a
    parallel/comm.LocalComm, inside its ``run``)."""
    step = _sharded_step(opaque, kernels.cone_sweep_lat, cone_lat_step_plain)
    nzl, wy, wx = opaque.shape
    pb = max(wx, wy)
    n = comm.n
    up = [(i, i + 1) for i in range(n - 1)]
    dn = [(i, i - 1) for i in range(1, n)]
    bufs = [torch.empty((nzl, 4, pb), dtype=torch.bfloat16, device=opaque.device)
            for _ in range(2)]
    lo = hi = None
    for k in range(pb + 1):
        tmp_in, tmp_out = bufs[(k + 1) % 2], bufs[k % 2]
        step(opaque, rel_x, rel_y, rel_z, tmp_in if k else None, lo, hi, tmp_out, T4, k)
        if k < pb:
            lo, hi = comm.ppermutes([(tmp_out[nzl - 1:nzl], up), (tmp_out[:2], dn)])


def cone_sweep_z_pipelined(opaque: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor,
                           T2: Tensor, comm) -> None:
    """The z cones of a shard's window slab (vofod_tpu
    ``_sweep_cones_z_pipelined``) into T2 [2, nzl, wy, wx]: n rounds of
    K15b-4a, the carry planes passed on after each (cone 0 up, cone 1 down);
    shard s keeps cone 0 from round s and cone 1 from round n - 1 - s."""
    step = _sharded_step(opaque, kernels.cone_sweep_z, cone_z_round_plain)
    _, wy, wx = opaque.shape
    n, me = comm.n, comm.rank
    up = [(i, i + 1) for i in range(n - 1)]
    dn = [(i, i - 1) for i in range(1, n)]
    ones = torch.ones((wy, wx), dtype=torch.bfloat16, device=opaque.device)
    carry = torch.stack([ones, ones])
    for r in range(n):
        out = step(opaque, rel_x, rel_y, rel_z, carry, T2, (me == r, me == n - 1 - r))
        if r < n - 1:
            c0, c1 = comm.ppermutes([(out[0], up), (out[1], dn)])
            # a shard with no sender keeps a carry no kept round reads
            carry = torch.stack([ones if c0 is None else c0, ones if c1 is None else c1])


def cone_zt_step_plain(opaque: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor,
                       tmp_in: Tensor | None, lo: Tensor | None, hi: Tensor | None,
                       tmp_out: Tensor, T2: Tensor, k: int, pin_from: int) -> None:
    """Plain version of K15b-4b's launch k, with its arguments (see
    kernels.cone_sweep_zt): per z cone, the A (y) pass of plane k - 1 over
    the shard's x-resampled rows with the neighbours' rows around them (1.0
    past the global edge), its T and carry, then the B (x) pass of plane k
    into ``tmp_out``, the rows from ``pin_from`` on set to 1.0; each pass as
    :func:`_lerp` sums and rounds it."""
    nz, nyl, wx = opaque.shape
    op = opaque.to(torch.bool)
    dev = opaque.device
    if k == 0:
        carry = torch.ones((2, nyl, wx), dtype=torch.float32, device=dev)
    else:
        (s0, r0), (s1, r1) = _plane_rs(rel_z, nz, k - 1, False), _plane_rs(rel_z, nz, k - 1, True)
        rs = torch.stack([r0, r1])
        ones = torch.ones((2, 1, wx), dtype=torch.float32, device=dev)
        below = ones if lo is None else lo[0].float()[:, None]
        above = torch.cat([ones, ones], 1) if hi is None else hi.float().permute(1, 0, 2)
        ext = torch.cat([below, tmp_in.float().permute(1, 0, 2), above], 1)  # [2, nyl + 3, wx]
        wa = _tap_weights(rs, rel_y.expand(2, nyl))[..., None, :]  # [2, nyl, 1, 4]
        t = _bf16(wa[..., 0] * ext[:, 0:nyl] + wa[..., 1] * ext[:, 1:nyl + 1]
                  + wa[..., 2] * ext[:, 2:nyl + 2] + wa[..., 3] * ext[:, 3:nyl + 3])
        t = torch.where(rs[:, None, None] <= 1.0, 1.0, t)
        T2[0, s0], T2[1, s1] = t[0], t[1]
        carry = torch.where(torch.stack([op[s0], op[s1]]), 0.0, t)
    if k < nz:
        rs = torch.stack([_plane_rs(rel_z, nz, k, False)[1], _plane_rs(rel_z, nz, k, True)[1]])
        q = _lerp_rows(carry, _tap_weights(rs, rel_x.expand(2, wx)))
        q[:, pin_from:] = 1.0
        tmp_out.copy_(q.to(torch.bfloat16).permute(1, 0, 2))


def zt_planes(opaque: Tensor, rel_y: Tensor, comm) -> tuple[Tensor, Tensor, int]:
    """The transposed z cones' input on a shard (inside ``comm.run``): the
    window slab's y padded to nyl = ceil(wy / n) rows a shard and made
    y-sharded by an all_to_all, (every z plane of the shard's nyl rows
    [nz, nyl, wx], their sensor offsets (the pad rows' continuing the
    window's), the first pinned local row: the first at or past wy)."""
    wy = opaque.shape[1]
    n, me = comm.n, comm.rank
    nyl = -(-wy // n)
    if nyl < 2:
        raise ValueError(f"transposed z cones: a shard needs >= 2 of the window's {wy} y rows "
                         f"(4-tap halo), got {nyl} over {n} shards")
    pad = nyl * n - wy
    if pad:
        opaque = F.pad(opaque, (0, 0, 0, pad))
        rel_y = torch.cat([rel_y, rel_y[-1] + torch.arange(1, pad + 1, dtype=rel_y.dtype,
                                                           device=rel_y.device)])
    planes = comm.all_to_all(opaque, 1, 0)  # z ascending: the blocks come in rank order
    return planes, rel_y[me * nyl:(me + 1) * nyl].contiguous(), min(max(wy - me * nyl, 0), nyl)


def cone_sweep_z_transposed(opaque: Tensor, rel_x: Tensor, rel_y: Tensor, rel_z: Tensor,
                            T2: Tensor, comm) -> None:
    """The z cones of a shard's window slab (vofod_tpu
    ``_sweep_cones_z_transposed``) into T2 [2, nzl, wy, wx]: the window's y
    padded to a multiple of the n shards, an all_to_all to y-sharded (every
    plane of nyl = ceil(wy / n) rows), K15b-4b's nz + 1 launches with the
    x-resampled plane's edge rows sent after each (the last row up, the
    first two down) and the pad rows pinned to 1.0, and an all_to_all back.
    ``rel_z``: the window's global column.  K15b-4b writes both cones in
    grid order, so one all_to_all brings both back (JAX's scan output holds
    cone 1 reversed, hence its flip and re-reversal)."""
    step = _sharded_step(opaque, kernels.cone_sweep_zt, cone_zt_step_plain)
    _, wy, wx = opaque.shape
    nz = rel_z.shape[0]
    n = comm.n
    planes, rel_yl, pin_from = zt_planes(opaque, rel_y, comm)
    nyl = rel_yl.shape[0]
    up = [(i, i + 1) for i in range(n - 1)]
    dn = [(i, i - 1) for i in range(1, n)]
    Tt = torch.empty((2, nz, nyl, wx), dtype=torch.float32, device=opaque.device)
    bufs = [torch.empty((nyl, 2, wx), dtype=torch.bfloat16, device=opaque.device)
            for _ in range(2)]
    lo = hi = None
    for k in range(nz + 1):
        tmp_in, tmp_out = bufs[(k + 1) % 2], bufs[k % 2]
        step(planes, rel_x, rel_yl, rel_z, tmp_in if k else None, lo, hi, tmp_out, Tt, k,
             pin_from)
        if k < nz:
            lo, hi = comm.ppermutes([(tmp_out[nyl - 1:nyl], up), (tmp_out[:2], dn)])
    T2.copy_(comm.all_to_all(Tt, 1, 2)[:, :, :wy])


def sweep_zsharded(grid: GridSpec, opaque: Tensor, origin_world: np.ndarray, comm,
                   max_distance_bound: float | None = None, zcone_mode: str = "pipelined"):
    """T6 [6, nzl, wy, wx] of a shard's slab of the sweep window (x/y cones
    by K15b-3, z cones by K15b-4a, or K15b-4b when ``zcone_mode`` is
    "transpose") and the window: (T6, x0, y0, rel_x, rel_y, rel_z of the
    slab's rows).  ``opaque``: the shard's bool slab."""
    nzl = opaque.shape[0]
    x0, y0, rel_x, rel_y, rel_z_g = _window_rel(grid, origin_world, max_distance_bound,
                                                opaque.device)
    z0 = comm.rank * nzl
    rel_z = rel_z_g[z0:z0 + nzl].contiguous()
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    op_w = opaque[:, y0:y0 + wy, x0:x0 + wx].contiguous().view(torch.uint8)
    T6 = torch.empty((6, nzl, wy, wx), dtype=torch.float32, device=opaque.device)
    cone_sweep_lat_sharded(op_w, rel_x, rel_y, rel_z, T6[:4], comm)
    if zcone_mode == "transpose":
        cone_sweep_z_transposed(op_w, rel_x, rel_y, rel_z_g, T6[4:], comm)
    else:
        cone_sweep_z_pipelined(op_w, rel_x, rel_y, rel_z, T6[4:], comm)
    return T6, x0, y0, rel_x, rel_y, rel_z


def raycast_update_zsharded(
    grid: GridSpec,
    vals: Tensor,
    had_point: Tensor,
    opaque: Tensor,
    origin_world: np.ndarray,
    rot_s2w: Tensor,
    ema: RayEma,
    *,
    comm,
    max_distance: float,
    vertical_fov: float,
    v_rays: int,
    h_rays: int,
    gate: Tensor | None = None,
    max_distance_bound: float | None = None,
    zcone_mode: str = "pipelined",
) -> Tensor:
    """:func:`raycast_update_` on a shard's z slab (vofod_tpu
    ``raycast_sweep_zsharded``): the window is cropped in x/y only, the
    cones run sharded (:func:`sweep_zsharded`, the z cones pipelined or
    transposed), and K5b assembles and applies the ray EMA on the slab's
    window, the old rule's max taken over the shards.  ``comm``: the
    shards' parallel/comm.LocalComm, inside its ``run``.  Returns ``vals``."""
    T6, x0, y0, rel_x, rel_y, rel_z = sweep_zsharded(grid, opaque, origin_world, comm,
                                                     max_distance_bound, zcone_mode)
    c = RayConsts.make(grid.voxel_size, max_distance, vertical_fov, v_rays, h_rays)
    return ray_window_update_(vals, had_point, T6, gate, rel_x, rel_y, rel_z, rot_s2w, x0, y0,
                              c, ema, gmax=comm.pmax)


# -----------------------------------------------------------------------------
# Exact DDA (K12)
# -----------------------------------------------------------------------------


def dda_n_steps(voxel_size: float, max_length: float) -> int:
    """The DDA's step cap: every ray stops after this many voxel steps."""
    return int(math.ceil(max_length / voxel_size * math.sqrt(3.0))) + 3


def _dda_consts(grid: GridSpec) -> np.ndarray:
    """K12's float32 grid constants (ox, oy, oz, vs, 1/vs, vs/2), each
    rounded as the JAX function's weakly typed Python scalars round."""
    ox, oy, oz = grid.origin
    vs = grid.voxel_size
    return np.array([ox, oy, oz, vs, grid.inv_voxel, vs / 2.0], np.float32)


def dda_emissions_plain(grid: GridSpec, starts: Tensor, dirs: Tensor, lengths: Tensor,
                        valid: Tensor, max_length: float, with_index: bool = False,
                        slab: tuple[int, int] | None = None):
    """The DDA walk's (flat id int64, chord f32) emissions in (step, ray)
    order (vofod_tpu ``dda_emissions``), the zero chords and ids outside the
    grid left out: the JAX walk, vectorised over rays and stepped
    ``dda_n_steps`` times.  ``with_index`` adds each emission's position
    step * R + ray in the full stream (int64).  ``slab`` (z0, rows) walks as
    K15b-6c does (csrc/dda.cu): a ray whose z rows miss a slab smaller than
    the grid is not walked (:func:`dda_slab_skips_plain`), and a ray stops
    once its rows have passed the slab's; the emissions in the slab's rows
    are the dense walk's."""
    vs = grid.voxel_size
    nz, ny, nx = grid.shape
    dev = starts.device
    absdir = torch.abs(dirs)
    step = torch.sign(dirs).to(torch.int32)
    pos = absdir > 0
    inf = torch.full_like(absdir, float("inf"))
    # a true division (a Python scalar over a tensor is a reciprocal multiply)
    tdelta = torch.where(pos, torch.full_like(absdir, _f32(vs)) / absdir, inf)
    ix, iy, iz = grid.coord_to_idx(starts)
    cur = torch.stack([ix, iy, iz], dim=-1)  # (x, y, z)
    ctr = grid.idx_to_coord(ix, iy, iz) - starts
    tmax = torch.where(pos, (_f32(vs / 2.0) + step.to(torch.float32) * ctr) / absdir, inf)
    last = torch.where(step > 0, torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32,
                                               device=dev), 0)
    axes = torch.arange(3, device=dev)
    alive = valid & (lengths > 0)
    if slab is not None and slab[1] < nz:
        alive = alive & ~dda_slab_skips_plain(grid, starts, dirs, lengths, slab)
    prev = torch.zeros_like(lengths)
    fids, ws = [], []
    for _ in range(dda_n_steps(vs, max_length)):
        tx, ty, tz = tmax.unbind(-1)
        # jnp.argmin: the first minimum, x before y before z
        on_x = (tx <= ty) & (tx <= tz)
        axis = torch.where(on_x, 0, torch.where(ty <= tz, 1, 2))
        dist = torch.minimum(torch.minimum(tx, ty), tz)
        ddist = torch.clamp(torch.minimum(dist, lengths) - prev, min=0.0)
        ws.append(torch.where(alive, ddist, 0.0))
        fids.append(grid.flat_id(cur[:, 0], cur[:, 1], cur[:, 2]))
        onehot = axis[:, None] == axes[None, :]
        at_edge = ((cur == last) & onehot).any(dim=-1)
        alive = alive & (dist < lengths) & ~at_edge
        cur = cur + onehot.to(torch.int32) * step
        # select, don't multiply: tdelta is inf on zero-direction axes
        tmax = torch.where(onehot, tmax + tdelta, tmax)
        prev = dist
        if slab is not None:  # z rows run one way along a ray: past the slab, stop
            cz, sz = cur[:, 2], step[:, 2]
            alive = alive & torch.where(sz > 0, cz < slab[0] + slab[1],
                                        (sz == 0) | (cz >= slab[0]))
    fid = torch.stack(fids).reshape(-1).to(torch.int64)
    w = torch.stack(ws).reshape(-1)
    # adding +0.0 changes no sum; the JAX scatter drops ids outside the grid
    keep = (w > 0) & (fid >= 0) & (fid < grid.n_voxels)
    if with_index:
        return fid[keep], w[keep], torch.nonzero(keep).flatten()
    return fid[keep], w[keep]


def raycast_dda_plain(grid: GridSpec, starts: Tensor, dirs: Tensor, lengths: Tensor,
                      valid: Tensor, max_length: float) -> Tensor:
    """Plain version of K12 (vofod_tpu/ops/raycast.py ``raycast_dda``): the
    :func:`dda_emissions_plain` stream added with ``index_add_``.  On the
    CPU ``index_add_`` adds sequentially in (step, ray) order, as the JAX
    scatter does, so the two agree bit for bit on the same inputs."""
    fid, w = dda_emissions_plain(grid, starts, dirs, lengths, valid, max_length)
    flat = torch.zeros(grid.n_voxels, dtype=torch.float32, device=starts.device)
    flat.index_add_(0, fid, w)
    return flat.reshape(grid.shape)


def raycast_dda_slab_plain(grid: GridSpec, starts: Tensor, dirs: Tensor, lengths: Tensor,
                           valid: Tensor, max_length: float, slab: tuple[int, int]) -> Tensor:
    """Plain version of K15b-6c: :func:`raycast_dda_plain`'s rows ``slab``
    (z0, rows), from the emissions whose flat id lies in them, added in the
    same (step, ray) order."""
    z0, nzl = slab
    plane = grid.ny * grid.nx
    fid, w = dda_emissions_plain(grid, starts, dirs, lengths, valid, max_length)
    lf = fid - z0 * plane
    own = (lf >= 0) & (lf < nzl * plane)
    flat = torch.zeros(nzl * plane, dtype=torch.float32, device=starts.device)
    flat.index_add_(0, lf[own], w[own])
    return flat.reshape(nzl, grid.ny, grid.nx)


def dda_warp_groups_plain(grid: GridSpec, starts: Tensor, dirs: Tensor, lengths: Tensor,
                          valid: Tensor, max_length: float,
                          slab: tuple[int, int] | None = None) -> tuple[Tensor, Tensor]:
    """Plain model of K12's / K15b-6c's warp-combined adds
    (csrc/dda.cu): at each step the lanes of a warp (rays r // 32) whose
    chord lies in the rows ``slab`` (z0, rows; default the whole grid)
    group by voxel, and each group's float64 chords are summed to its
    lowest lane by the kernel's pointer jumping (each round, every member
    adds the partial of the member ``next`` above it and takes that
    member's ``next``), a slab's rays walked by K15b-6c's rules
    (:func:`dda_emissions_plain`).  Returns the groups' slab-local flat ids (int64) and
    sums (float64), in (step, warp, lane) order: one atomicAdd of the kernel
    each."""
    z0, nzl = (0, grid.nz) if slab is None else slab
    plane = grid.ny * grid.nx
    fid, w, idx = dda_emissions_plain(grid, starts, dirs, lengths, valid, max_length,
                                      with_index=True, slab=slab)
    R = starts.shape[0]
    n_warps = -(-R // 32)
    lf = fid - z0 * plane
    own = (lf >= 0) & (lf < nzl * plane)
    lf, w, idx = lf[own], w[own], idx[own]
    row = (idx // R) * n_warps + (idx % R) // 32  # (step, warp)
    rows, row = torch.unique(row, return_inverse=True)
    dev = w.device
    ids = torch.full((len(rows), 32), -1, dtype=torch.int64, device=dev)
    ids[row, (idx % R) % 32] = lf
    vals = torch.zeros((len(rows), 32), dtype=torch.float64, device=dev)
    vals[row, (idx % R) % 32] = w.to(torch.float64)
    lanes = torch.arange(32, device=dev)
    grp = (ids[:, :, None] == ids[:, None, :]) & (ids[:, :, None] >= 0)  # __match_any_sync
    above = grp & (lanes[None, None, :] > lanes[None, :, None])
    nxt = torch.where(above.any(-1), above.to(torch.int32).argmax(-1), -1)
    while bool((nxt >= 0).any()):
        src = torch.where(nxt >= 0, nxt, lanes)
        o, nn = vals.gather(1, src), nxt.gather(1, src)
        vals = torch.where(nxt >= 0, vals + o, vals)
        nxt = torch.where(nxt >= 0, nn, -1)
    lead = (ids >= 0) & ~(grp & (lanes[None, None, :] < lanes[None, :, None])).any(-1)
    return ids[lead], vals[lead]


def dda_slab_skips_plain(grid: GridSpec, starts: Tensor, dirs: Tensor, lengths: Tensor,
                         slab: tuple[int, int]) -> Tensor:
    """The rays K15b-6c drops before walking (csrc/dda.cu), bool [R]: those
    whose z rows, from the start's to that of start + length * dir and 2
    rows wider at each end, miss the slab's rows.  None of them has a chord
    in the slab."""
    z0, nzl = slab
    inv, oz = np.float32(grid.inv_voxel), np.float32(grid.origin[2])
    zs = torch.floor((starts[:, 2] - oz) * inv)
    ze = torch.where(dirs[:, 2] == 0, zs,
                     torch.floor((starts[:, 2] + lengths * dirs[:, 2] - oz) * inv))
    return (torch.fmax(zs, ze) + 2 < z0) | (torch.fmin(zs, ze) - 2 >= z0 + nzl)


def raycast_dda_warp_plain(grid: GridSpec, starts: Tensor, dirs: Tensor, lengths: Tensor,
                           valid: Tensor, max_length: float, slab: tuple[int, int] | None = None,
                           order: torch.Generator | None = None) -> Tensor:
    """Plain model of the warp-combined walk's result: the groups of
    :func:`dda_warp_groups_plain` added into a float64 field in the order
    ``order`` shuffles them to (the kernel's atomics land in any order), then
    rounded once to float32: the slab's rows of the raylen field."""
    nzl = grid.nz if slab is None else slab[1]
    lf, sums = dda_warp_groups_plain(grid, starts, dirs, lengths, valid, max_length, slab)
    perm = torch.randperm(len(lf), generator=order) if order is not None else slice(None)
    acc = torch.zeros(nzl * grid.ny * grid.nx, dtype=torch.float64, device=sums.device)
    acc.index_add_(0, lf[perm], sums[perm])
    return acc.to(torch.float32).reshape(nzl, grid.ny, grid.nx)


def raycast_dda_slab(grid: GridSpec, starts: Tensor, dirs: Tensor, lengths: Tensor,
                     valid: Tensor, max_length: float, slab: tuple[int, int]) -> Tensor:
    """K15b-6c: the rows ``slab`` (z0, rows) of :func:`raycast_dda`'s field,
    every ray walked (vofod_tpu ``ZShardOps.raycast_dda``): a shard's raylen
    on the grid-sharded step."""
    if starts.is_cuda:
        return kernels.dda_slab(starts.contiguous(), dirs.contiguous(), lengths.contiguous(),
                                valid.contiguous(), grid.shape, _dda_consts(grid),
                                dda_n_steps(grid.voxel_size, max_length), slab)
    if starts.device.type != "cpu":
        raise ValueError(f"DDA raycast: unsupported device {starts.device}")
    return raycast_dda_slab_plain(grid, starts, dirs, lengths, valid, max_length, slab)


def raycast_dda(grid: GridSpec, starts: Tensor, dirs: Tensor, lengths: Tensor, valid: Tensor,
                max_length: float) -> Tensor:
    """Exact Amanatides–Woo accumulation (ref voxel_map.cpp:229-263): the
    float32 (nz, ny, nx) field of every ray's chord length per voxel (K12).
    The kernel sums each voxel's chords in float64 and rounds once; the
    plain version adds them in float32 in the JAX scatter's order, whose own
    rounding is ~1e-4 relative where ~all rays start in one voxel.

    starts, dirs: [R, 3] world ray starts (inside the grid where ``valid``)
    and unit directions; lengths: [R] traversal lengths; valid: [R] ray
    gate; max_length: static bound that sizes the step loop."""
    if starts.is_cuda:
        return kernels.dda(starts.contiguous(), dirs.contiguous(), lengths.contiguous(),
                           valid.contiguous(), grid.shape, _dda_consts(grid),
                           dda_n_steps(grid.voxel_size, max_length))
    if starts.device.type != "cpu":
        raise ValueError(f"DDA raycast: unsupported device {starts.device}")
    return raycast_dda_plain(grid, starts, dirs, lengths, valid, max_length)


def ray_ema_grid_(vals: Tensor, had_point: Tensor, raylen: Tensor, ema: RayEma,
                  gmax=None) -> Tensor:
    """K12's second pass: the ray EMA (:func:`ray_ema_plain`) on a full-grid
    raylen field (or a shard's slab of it, the old rule's max then through
    ``gmax``, the max over the shards), in place on ``vals``.  Returns
    ``vals``."""
    if vals.is_cuda:
        kernels.ray_ema(vals, had_point, raylen, ema, gmax)
        return vals
    if vals.device.type != "cpu":
        raise ValueError(f"ray EMA: unsupported device {vals.device}")
    return vals.copy_(ray_ema_plain(vals, raylen, had_point, ema, gmax))
