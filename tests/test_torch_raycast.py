"""K4 parity: the gated cone-sweep raycast, the gate faces and the ray EMA
against vofod_tpu.

Tolerances, with their reasons:

* ``raycast_sweep``: the transmittance carry is bf16.  JAX on the CPU keeps
  some intermediates of its bf16 expressions at float32 (XLA's excess
  precision), while the port rounds the carry to bf16 after each lateral
  pass (as its CUDA kernel does), and the rounding differences carry from
  plane to plane, growing with the number of planes swept.  Bounds: the
  set of nonzero voxels identical; per voxel |Δ| <= 2^-4 x |raylen| (16
  bf16 ulps; measured max 3.2% in the 9 m full frame, 1.7% windowed), the
  99.9th percentile of |Δ|/|raylen| <= 2^-5 (measured 2.2%), and
  max |Δ| <= 1e-3 x max raylen (measured 3.6e-4).
* ``gate_faces``: float32 trig (arcsin, atan2) of two libraries; the faces lie
  in [0, 1]: |Δ| <= 5e-5 (measured <= 7.7e-6), and both sides within
  5e-5 of a float64 evaluation of the same formula (measured <= 5.1e-6).
  The JAX call's two matmuls (``d_w @ rot_s2w``, ``w_c @ G.T``) run at
  HIGHEST precision: at DEFAULT precision a CPU backend may take a
  reduced-precision (bf16-pass) float32 dot, and one such run put 388
  texels up to 2.66e-4 off — an elevation error of ~2.8e-5 rad, the size
  of a bf16x3 product, 35x the float32 one.
* ``ray_update``: float32 elementwise, exp2 / pow of two libraries:
  |Δ| <= 1e-5 relative to the score scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vofod_tpu.config import DynParams as JDyn, VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.ops import raycast as jr
from vofod_tpu.pipeline.step import ray_update as j_ray_update
from vofod_tpu.sensor import make_lut_ouster, make_lut_simulation
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops import raycast as tr
from vofod_tpu_torch.pipeline.step import ray_update

SHAPE, VS, ORIGIN = (12, 30, 40), 0.5, (-10.0, -7.5, -1.0)
H, W = 16, 64
SWEEP_RTOL = 2.0**-4
SWEEP_RTOL_P999 = 2.0**-5


def _lut(kind):
    if kind == "sim":
        return make_lut_simulation(W, H, np.deg2rad(90.0))
    u = np.linspace(-1.0, 1.0, H)
    alt = -45.0 * np.sign(u) * np.abs(u) ** 1.3
    return make_lut_ouster(W, H, 3.0 * np.sin(np.linspace(0, 2 * np.pi, H)), alt, 15.806)


def _rot(yaw, pitch=0.0):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    return (Rz @ Ry).astype(np.float32)


def _faces(lut, active, R):
    gate = jr.make_angular_gate(lut)
    with jax.default_matmul_precision("highest"):
        jf = np.asarray(jr.gate_faces(gate, jnp.asarray(active), jnp.asarray(R)))
    tf = tr.gate_faces(gate, torch.from_numpy(gate.face_dirs.reshape(-1, 3)),
                       torch.from_numpy(active), torch.from_numpy(R))
    return jf, tf, _faces_f64(gate, active, R)


def _faces_f64(gate, active, R):
    """The formula of ``gate_faces`` in float64 numpy (the row table, where
    the LUT has one, as the float32 table both packages use)."""
    G = active.astype(np.float64).reshape(gate.n_rows, gate.pool_v, gate.n_cols,
                                          gate.pool_h).mean(axis=(1, 3))
    d_s = gate.face_dirs.reshape(-1, 3).astype(np.float64) @ R.astype(np.float64)
    el = np.arcsin(np.clip(d_s[:, 2], -1.0, 1.0))
    az = np.arctan2(d_s[:, 1], d_s[:, 0])
    if gate.el_rows is None:
        row = (el - gate.el_b) / gate.el_a
    else:
        tbl = np.asarray(gate.el_rows, np.float32).astype(np.float64)
        sgn = 1.0 if tbl[-1] > tbl[0] else -1.0
        f, t = sgn * tbl, sgn * el
        idx = np.clip((t[:, None] >= f[None, :]).sum(-1) - 1, 0, len(f) - 2)
        row = idx + (t - f[idx]) / (f[idx + 1] - f[idx])
    g_r = (row + 0.5) / gate.pool_v - 0.5
    P = gate.col_period
    g_c = np.mod(((az - gate.az_b) / gate.az_a + 0.5) / gate.pool_h - 0.5, P)
    kr, kc = np.arange(gate.n_rows), np.arange(gate.n_cols)
    w_r = np.maximum(0.0, 1.0 - np.abs(g_r[:, None] - kr[None, :]))
    dwrap = np.minimum(np.abs(g_c[:, None] - kc[None, :]),
                       np.minimum(np.abs(g_c[:, None] - P - kc[None, :]),
                                  np.abs(g_c[:, None] + P - kc[None, :])))
    w_c = np.maximum(0.0, 1.0 - dwrap)
    w_c = w_c / np.maximum(w_c.sum(axis=-1, keepdims=True), 1e-6)
    return np.sum(w_r * (w_c @ G.T), axis=-1).reshape(gate.face_dirs.shape[:3])


@pytest.mark.parametrize("lut_kind", ["sim", "calibrated"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_faces_f32(lut_kind, seed):
    rng = np.random.default_rng(seed)
    active = rng.random((H, W)) < 0.7
    jf, tf, f64 = _faces(_lut(lut_kind), active,
                         _rot(rng.uniform(-2, 2), rng.uniform(-0.3, 0.3)))
    assert tf.shape == jf.shape
    # which side moved, should the two ever disagree
    dev = f"port-f64 {np.abs(tf.numpy() - f64).max():.3g}, jax-f64 {np.abs(jf - f64).max():.3g}"
    np.testing.assert_allclose(tf.numpy(), f64, atol=5e-5, rtol=0, err_msg=dev)
    np.testing.assert_allclose(tf.numpy(), jf, atol=5e-5, rtol=0, err_msg=dev)
    print(f"{lut_kind} seed {seed}: port-jax {np.abs(tf.numpy() - jf).max():.3g}, {dev}")


@pytest.mark.parametrize("window", ["full_frame", "windowed"])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_raycast_sweep_bf16_bound(window, gated, seed):
    rng = np.random.default_rng(10 + seed)
    op = rng.random(SHAPE) < 0.03
    pos = np.array([rng.uniform(-3, 3), rng.uniform(-2, 2), rng.uniform(1.5, 3.5)], np.float32)
    R = _rot(rng.uniform(-1, 1))
    jf = tf = None
    if gated:
        jf, tf, _ = _faces(_lut("sim"), rng.random((H, W)) < 0.8, R)
        jf = jnp.asarray(jf)
    # windowed: the static 3 m bound crops the 40x30 frame to 29x29 voxels
    kw = dict(max_distance=3.0 if window == "windowed" else 9.0,
              vertical_fov=np.deg2rad(90.0), v_rays=H, h_rays=W,
              max_distance_bound=3.0 if window == "windowed" else None)
    want = np.asarray(jr.raycast_sweep(JGrid(ORIGIN, SHAPE, VS), jnp.asarray(op),
                                       jnp.asarray(pos), jnp.asarray(R), gate=jf, **kw))
    got = tr.raycast_sweep(GridSpec(ORIGIN, SHAPE, VS), torch.from_numpy(op), pos,
                           torch.from_numpy(R), gate=tf, **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.array_equal(got > 0, want > 0)
    assert (want > 0).sum() > 100
    d = np.abs(got - want)
    assert np.all(d <= SWEEP_RTOL * np.abs(want))
    nz = want > 0
    assert np.quantile(d[nz] / want[nz], 0.999) <= SWEEP_RTOL_P999
    assert d.max() <= 1e-3 * want.max()


def test_sweep_window_matches_jax_window():
    """The host-side window (from the host pose) is the JAX device window."""
    grid = GridSpec((0.0, 0.0, 0.0), (51, 201, 241), 0.5)
    for pos in ([40.2, 20.7, 3.0], [1.0, 1.0, 1.0], [119.0, 99.0, 5.0]):
        x0, y0, wx, wy, gx, gy, gz = tr.sweep_window(grid, np.asarray(pos, np.float32), 20.0)
        assert (wx, wy) == (97, 97)
        jgx = (jnp.float32(pos[0]) - 0.0) / 0.5
        assert x0 == int(jnp.clip(jnp.floor(jgx).astype(jnp.int32) - wx // 2, 0, 241 - wx))


@pytest.mark.parametrize("new_rule", [True, False])
@pytest.mark.parametrize("its_diff", [1.0, 3.0])
def test_ray_update_both_rules(new_rule, its_diff):
    rng = np.random.default_rng(int(its_diff) + 2 * new_rule)
    vals = rng.uniform(-1000.0, 0.0, SHAPE).astype(np.float32)
    raylen = np.where(rng.random(SHAPE) < 0.6, rng.uniform(0.0, 30.0, SHAPE), 0.0).astype(np.float32)
    had = rng.random(SHAPE) < 0.1
    jd = JDyn(raycast_new_update_rule=new_rule)
    td = DynParams(raycast_new_update_rule=new_rule)
    want = np.asarray(j_ray_update(JConfig(), jd.as_arrays(), jnp.asarray(vals),
                                   jnp.asarray(raylen), jnp.asarray(had), jnp.float32(its_diff)))
    got = ray_update(VoFODConfig(), td, torch.from_numpy(vals), torch.from_numpy(raylen),
                     torch.from_numpy(had), its_diff).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 1000.0)
    assert np.array_equal(got == vals, want == vals)
