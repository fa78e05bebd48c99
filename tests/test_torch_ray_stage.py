"""K5 parity: the plain versions of the gate kernel (K5a, ``gate_faces_plain``)
and of the ray assembly + ray EMA kernel (K5b, ``raycast_update_`` on the
CPU) against the JAX functions they replace.

* K5a against ``vofod_tpu.ops.raycast.gate_faces``: the simulation LUT and a
  calibrated one (per-row elevation table), unpooled and pooled images;
  |Δ| <= 5e-5 (float32 trig of two libraries; faces lie in [0, 1]).
* K5b against ``_expand_gate`` + ``_assemble_raylen`` + ``ray_update`` of
  the JAX package, fed the same cone transmittances T6 (the port's K4 plain
  version) and the same gate faces, so that only what K5b computes is
  compared; the bf16 sweep's own deviation from JAX is bounded separately
  in tests/test_torch_raycast.py.  Both update rules, its_diff 1 and 2,
  windowed and full frame: the set of changed voxels equal, the grid within
  1e-5 x |score_ray|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import DynParams as JDyn, VoFODConfig as JConfig
from vofod_tpu.ops import raycast as jr
from vofod_tpu.pipeline.step import ray_update as j_ray_update
from vofod_tpu.sensor import make_lut_ouster, make_lut_simulation
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops import raycast as tr
from vofod_tpu_torch.pipeline.step import ray_ema

SHAPE, VS, ORIGIN = (12, 30, 40), 0.5, (-10.0, -7.5, -1.0)
FOV = np.deg2rad(90.0)


def _lut(kind, H, W):
    if kind == "sim":
        return make_lut_simulation(W, H, FOV)
    u = np.linspace(-1.0, 1.0, H)
    alt = -45.0 * np.sign(u) * np.abs(u) ** 1.3
    return make_lut_ouster(W, H, 3.0 * np.sin(np.linspace(0, 2 * np.pi, H)), alt, 15.806)


def _rot(yaw, pitch=0.0, roll=0.0):
    cy, sy, cp, sp, cr, sr = (np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch),
                              np.cos(roll), np.sin(roll))
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return (Rz @ Ry @ Rx).astype(np.float32)


@pytest.mark.parametrize("lut_kind", ["sim", "calibrated"])
@pytest.mark.parametrize("H,W", [(16, 64), (64, 256)])
@pytest.mark.parametrize("seed", [0, 1])
def test_gate_faces_plain_against_jax(lut_kind, H, W, seed):
    rng = np.random.default_rng(30 + seed)
    lut = _lut(lut_kind, H, W)
    gate = jr.make_angular_gate(lut)
    assert (gate.el_rows is not None) == (lut_kind == "calibrated")
    assert (gate.pool_v, gate.pool_h) == ((1, 1) if H == 16 else (2, 2))
    active = rng.random((H, W)) < 0.7
    R = _rot(rng.uniform(-2, 2), rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2))
    want = np.asarray(jr.gate_faces(gate, jnp.asarray(active), jnp.asarray(R)))
    fd = torch.from_numpy(gate.face_dirs.reshape(-1, 3))
    table = tr.row_table(gate, "cpu")
    got = tr.gate_faces_plain(gate, fd, torch.from_numpy(active), torch.from_numpy(R), table)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    # the dispatching entry point takes the same plain version on the CPU
    same = tr.gate_faces(gate, fd, torch.from_numpy(active), torch.from_numpy(R))
    assert torch.equal(same, got)
    assert 0.0 < float(got.max()) <= 1.0 + 1e-6


def _jax_gate_grid(faces, rel_x, rel_y, rel_z):
    """The six cones' JAX gate factors in grid layout [6, nz, wy, wx]."""
    def one(c, rs, ra, rb):
        return np.asarray(jr._expand_gate(jnp.asarray(faces[c][None]), jnp.asarray(rs[:, None]),
                                          jnp.asarray(ra[None, :]), jnp.asarray(rb[None, :])))[:, 0]

    gx_f = one(0, rel_x, rel_z, rel_y).transpose(1, 2, 0)
    gx_b = one(1, -rel_x[::-1], rel_z, rel_y)[::-1].transpose(1, 2, 0)
    gy_f = one(2, rel_y, rel_z, rel_x).transpose(1, 0, 2)
    gy_b = one(3, -rel_y[::-1], rel_z, rel_x)[::-1].transpose(1, 0, 2)
    gz_f = one(4, rel_z, rel_y, rel_x)
    gz_b = one(5, -rel_z[::-1], rel_y, rel_x)[::-1]
    return np.stack([gx_f, gx_b, gy_f, gy_b, gz_f, gz_b])


@pytest.mark.parametrize("window", ["full_frame", "windowed"])
@pytest.mark.parametrize("new_rule", [True, False])
@pytest.mark.parametrize("its_diff", [1, 2])
def test_ray_update_window_against_jax(window, new_rule, its_diff):
    rng = np.random.default_rng(40 + 4 * its_diff + 2 * new_rule + (window == "windowed"))
    grid = GridSpec(ORIGIN, SHAPE, VS)
    op = rng.random(SHAPE) < 0.03
    had = op | (rng.random(SHAPE) < 0.05)
    vals = rng.uniform(-1000.0, 0.0, SHAPE).astype(np.float32)
    pos = np.array([rng.uniform(-3, 3), rng.uniform(-2, 2), rng.uniform(1.5, 3.5)], np.float32)
    R = _rot(rng.uniform(-1, 1), rng.uniform(-0.2, 0.2))
    H, W = 16, 64
    gate = jr.make_angular_gate(_lut("sim", H, W))
    faces = np.array(jr.gate_faces(gate, jnp.asarray(rng.random((H, W)) < 0.8),
                                   jnp.asarray(R)))
    bound = 3.0 if window == "windowed" else None
    max_d = 3.0 if window == "windowed" else 9.0
    cfg = VoFODConfig()
    dyn = DynParams(raycast_new_update_rule=new_rule)

    got = tr.raycast_update_(
        grid, torch.from_numpy(vals.copy()), torch.from_numpy(had), torch.from_numpy(op), pos,
        torch.from_numpy(R), ray_ema(cfg, dyn, float(its_diff)), max_distance=max_d,
        vertical_fov=FOV, v_rays=H, h_rays=W, gate=torch.from_numpy(faces),
        max_distance_bound=bound).numpy()

    # JAX on the same transmittances: gate expansion, assembly, EMA
    x0, y0, rel_x, rel_y, rel_z = tr._window_rel(grid, pos, bound, "cpu")
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    assert (wx, wy) == ((29, 29) if window == "windowed" else (40, 30))
    T6 = tr.cone_sweep_plain(torch.from_numpy(op)[:, y0:y0 + wy, x0:x0 + wx],
                             rel_x, rel_y, rel_z).numpy()
    rx, ry, rz = rel_x.numpy(), rel_y.numpy(), rel_z.numpy()
    TG = [jnp.asarray(t) for t in T6 * _jax_gate_grid(faces, rx, ry, rz)]
    raylen_w = np.asarray(jr._assemble_raylen(
        VS, jnp.asarray(rx), jnp.asarray(ry), jnp.asarray(rz), *TG, jnp.asarray(R),
        jnp.float32(max_d), FOV, H, W))
    raylen = np.zeros(SHAPE, np.float32)
    raylen[:, y0:y0 + wy, x0:x0 + wx] = raylen_w
    jd = JDyn(raycast_new_update_rule=new_rule)
    want = np.asarray(j_ray_update(JConfig(), jd.as_arrays(), jnp.asarray(vals),
                                   jnp.asarray(raylen), jnp.asarray(had),
                                   jnp.float32(its_diff)))

    changed = want != vals
    assert changed.sum() > 100
    assert np.array_equal(got != vals, changed)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * abs(dyn.score_ray))
    if window == "windowed":  # outside the window nothing is touched
        outside = np.ones(SHAPE, bool)
        outside[:, y0:y0 + wy, x0:x0 + wx] = False
        assert np.array_equal(got[outside], vals[outside])


def test_ray_update_its_diff_strengthens_the_update():
    """its_diff = N compensates N skipped scans: the same raylen moves a
    voxel further toward score_ray under its_diff 2 than under 1."""
    rng = np.random.default_rng(7)
    grid = GridSpec(ORIGIN, SHAPE, VS)
    op = rng.random(SHAPE) < 0.03
    vals = np.full(SHAPE, -100.0, np.float32)
    R = _rot(0.3)
    pos = np.array([0.5, 0.2, 2.0], np.float32)
    out = []
    for its in (1.0, 2.0):
        out.append(tr.raycast_update_(
            grid, torch.from_numpy(vals.copy()), torch.from_numpy(op), torch.from_numpy(op),
            pos, torch.from_numpy(R), ray_ema(VoFODConfig(), DynParams(), its),
            max_distance=9.0, vertical_fov=FOV, v_rays=16, h_rays=64).numpy())
    moved = out[0] != vals
    assert moved.sum() > 100
    assert np.array_equal(out[1] != vals, moved)
    assert np.all(out[1][moved] < out[0][moved])
