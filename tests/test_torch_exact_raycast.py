"""K12 parity: the exact DDA raycast and the exact ray stage (the plain
versions) against vofod_tpu.

Tolerances, with their reasons:

* ``raycast_dda`` on the same starts, directions, lengths and gate:
  bit-equal.  The plain version walks with the JAX function's float32
  arithmetic and adds its emissions with ``index_add_``, which on the CPU
  adds sequentially in (step, ray) order as the JAX scatter does.  Against
  the float64 per-ray oracle ``tests/oracles.py dda_raylen_np``: rtol 1e-4,
  atol 1e-4, the bound tests/test_raycast.py holds the JAX function to.
* the exact ray stage (range sanitizer, world rays, lengths, the pixel gate,
  the DDA and the ray EMA on the full grid) against the JAX step's ray
  stage: JAX rotates the LUT with an XLA dot (``lut_dirs @ rot.T``, run at
  HIGHEST precision here, as tests/test_torch_raycast.py runs its gate),
  the port in the fixed order of ``geometry.rotate``, so a direction or start
  may differ in its last bit and a chord by a few float32 ulps.  Bounds:
  the set of changed voxels equal; the grid within 1e-5 x |score_ray|
  (K5b's bound; measured max |Δ| 9.2e-5 score units, one or two float32
  ulps of values up to 800).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import dda_raylen_np
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.ops import raycast as jr
from vofod_tpu.pipeline.state import ScanInput as JScan
from vofod_tpu.pipeline.step import _make_step_fn as j_make_step_fn
from vofod_tpu.sensor import make_lut as j_make_lut
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops import raycast as tr
from vofod_tpu_torch.pipeline.step import exact_rays, ray_ema
from vofod_tpu_torch.sensor import RANGE_TO_METERS, make_lut

SHAPE, VS, ORIGIN = (12, 30, 40), 0.5, (-10.0, -7.5, -1.0)
MAX_LEN = 8.0
GRID_TOL_REL = 1e-5


def _rays(case: str, seed: int = 0):
    """(starts, dirs, lengths, valid) of one case; starts inside the grid."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(ORIGIN) + 0.3, np.array(ORIGIN) + np.array(SHAPE[::-1]) * VS - 0.3
    R = 512
    starts = rng.uniform(lo, hi, (R, 3))
    dirs = rng.standard_normal((R, 3))
    lengths = rng.uniform(0.2, MAX_LEN, R)
    if case == "axis":  # exactly along +-x, +-y, +-z: two zero components
        dirs = np.repeat(np.concatenate([np.eye(3), -np.eye(3)]), R // 6 + 1, axis=0)[:R]
    elif case == "faces":  # from near each face, out through it
        axis, sign = np.arange(R) % 3, np.where(np.arange(R) % 6 < 3, 1.0, -1.0)
        starts[np.arange(R), axis] = np.where(sign > 0, hi[axis] - 0.2, lo[axis] + 0.2)
        dirs[np.arange(R), axis] = sign * (np.abs(dirs[np.arange(R), axis]) + 2.0)
        lengths[:] = MAX_LEN
    elif case == "lengths":  # 0 and the full max distance
        lengths = np.where(np.arange(R) % 2 == 0, 0.0, MAX_LEN)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    valid = rng.random(R) < 0.9
    return (starts.astype(np.float32), dirs.astype(np.float32), lengths.astype(np.float32),
            valid)


@pytest.mark.parametrize("case", ["random", "axis", "faces", "lengths"])
def test_dda_bit_equal_to_jax(case):
    starts, dirs, lengths, valid = _rays(case)
    want = np.asarray(jr.raycast_dda(JGrid(ORIGIN, SHAPE, VS), jnp.asarray(starts),
                                     jnp.asarray(dirs), jnp.asarray(lengths),
                                     jnp.asarray(valid), MAX_LEN))
    got = tr.raycast_dda(GridSpec(ORIGIN, SHAPE, VS), torch.from_numpy(starts),
                         torch.from_numpy(dirs), torch.from_numpy(lengths),
                         torch.from_numpy(valid), MAX_LEN)
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 100
    oracle = dda_raylen_np(SHAPE, ORIGIN, VS, starts, dirs, lengths, valid)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-4)


def _configs(**kw):
    sensor = dict(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0))
    area = ((0.0, 0.0, 4.0), (16.0, 16.0, 12.0))
    return (JConfig(sensor=JSensor(**sensor), oparea=JBox(*area), **kw),
            VoFODConfig(sensor=SensorConfig(**sensor), oparea=Box(*area), **kw))


def _pose(yaw, pitch, xyz):
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]) @ np.array(
        [[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    T[:3, 3] = xyz
    return T


def _hostile_scan(n, seed):
    """Ranges with zeros, NaN, negative and +inf values; NaN and low
    intensities; a FOV mask over a quarter of the pixels."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(500.0, 9000.0, n).astype(np.float32)
    r[rng.random(n) < 0.15] = 0.0
    r[rng.random(n) < 0.05] = np.nan
    r[rng.random(n) < 0.05] = -1000.0
    r[rng.random(n) < 0.05] = np.inf
    inten = rng.uniform(0.0, 2.0, n).astype(np.float32)
    inten[rng.random(n) < 0.05] = np.nan
    mask = (rng.random(n) > 0.25).astype(np.uint8)
    return r, inten, mask


@pytest.mark.parametrize("its_diff", [1, 2])
@pytest.mark.parametrize("new_rule", [True, False])
def test_exact_ray_stage_against_jax(new_rule, its_diff):
    """The JAX step's exact ray stage (raycast_every = its_diff, on a step
    where it fires) against the port's: exact_rays -> raycast_dda ->
    ray_ema_grid_."""
    jcfg, tcfg = _configs()
    dyn = DynParams(raycast_new_update_rule=new_rule, raycast_min_intensity=0.5)
    jdyn = JDyn(raycast_new_update_rule=new_rule, raycast_min_intensity=0.5)
    lut = j_make_lut(jcfg.sensor)
    n = jcfg.sensor.n_points
    r, inten, mask = _hostile_scan(n, 40 + its_diff)
    pose = _pose(0.4, 0.15, (0.3, -0.8, 3.2))
    rng = np.random.default_rng(7)
    vals = rng.uniform(-800.0, -10.0, tcfg.grid_shape).astype(np.float32)
    occupied = rng.random(tcfg.grid_shape) < 0.02

    _, j_ray_stage, _, _ = j_make_step_fn(jcfg, lut, raycast_mode="exact", jit=False, mask=mask,
                                          raycast_every=its_diff, _return_stages=True)
    scan = JScan(ranges_mm=jnp.asarray(r), intensity=jnp.asarray(inten), pose=jnp.asarray(pose))
    with jax.default_matmul_precision("highest"):  # the rays' dot in full float32
        want = np.asarray(j_ray_stage(scan, jdyn.as_arrays(), jnp.int32(its_diff - 1),
                                      jnp.asarray(vals), jnp.asarray(occupied), None))

    grid = GridSpec.from_config(tcfg)
    tlut = make_lut(tcfg.sensor)
    rays = exact_rays(tcfg, dyn, grid, torch.from_numpy(tlut.directions),
                      torch.from_numpy(tlut.offsets), torch.from_numpy(mask > 0),
                      torch.from_numpy(r) * RANGE_TO_METERS, torch.from_numpy(inten),
                      torch.from_numpy(pose))
    assert bool(rays[3].any()) and not bool(rays[3].all())  # the gate bites
    assert bool(torch.isfinite(rays[2]).all())  # NaN / inf ranges sanitised
    raylen = tr.raycast_dda(grid, *rays, tcfg.raycast_max_distance_bound)
    got = tr.ray_ema_grid_(torch.from_numpy(vals.copy()), torch.from_numpy(occupied), raylen,
                           ray_ema(tcfg, dyn, float(its_diff))).numpy()
    np.testing.assert_array_equal(got != vals, want != vals)
    assert (want != vals).sum() > 1000
    np.testing.assert_allclose(got, want, rtol=0, atol=GRID_TOL_REL * abs(dyn.score_ray))
    print(f"rule {'new' if new_rule else 'old'}, its_diff {its_diff}: grid max|d| "
          f"{np.abs(got - want).max():.3g}")


def test_exact_rays_match_jax_rays():
    """The world rays themselves: starts and directions within a float32
    ulp-level bound of the XLA dot, lengths and the gate equal."""
    jcfg, tcfg = _configs()
    lut = j_make_lut(jcfg.sensor)
    r, inten, mask = _hostile_scan(jcfg.sensor.n_points, 5)
    pose = _pose(-1.1, 0.05, (1.0, 2.0, 2.5))
    R, t = jnp.asarray(pose[:3, :3]), jnp.asarray(pose[:3, 3])
    with jax.default_matmul_precision("highest"):
        jdirs = np.asarray(jnp.asarray(lut.directions) @ R.T)
        jstarts = np.asarray(jnp.asarray(lut.offsets) @ R.T + t[None, :])
    tcfg_dyn = DynParams()
    grid = GridSpec.from_config(tcfg)
    starts, dirs, lengths, valid = exact_rays(
        tcfg, tcfg_dyn, grid, torch.from_numpy(lut.directions), torch.from_numpy(lut.offsets),
        torch.from_numpy(mask > 0), torch.from_numpy(r) * RANGE_TO_METERS,
        torch.from_numpy(inten), torch.from_numpy(pose))
    np.testing.assert_allclose(dirs.numpy(), jdirs, rtol=0, atol=2.5e-7)
    np.testing.assert_allclose(starts.numpy(), jstarts, rtol=0, atol=1e-6)
    rm = np.asarray(jnp.asarray(r) * 0.001)
    rm = np.where(np.isnan(rm) | (rm < 0), 0.0, np.minimum(rm, 4e6)).astype(np.float32)
    want_len = np.where(rm == 0, np.float32(20.0), np.minimum(rm - np.float32(0.5), 20.0))
    np.testing.assert_array_equal(lengths.numpy(), want_len.astype(np.float32))
    gate = ~(inten < 0.0) & ((mask > 0) | (rm > 0))
    in_lim = np.asarray(JGrid.from_config(jcfg).in_limits(jnp.asarray(jstarts)))
    np.testing.assert_array_equal(valid.numpy(), gate & in_lim)
