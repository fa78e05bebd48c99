"""Live-tunable stencil radii (``cfg.dynamic_radii``) in the port: the
traced-shell pools (K14), the dynamic step, and the lifted tap cap of the
static stencils.

Budgets:

* the traced pools equal vofod_tpu's ``ball_pool_*_traced`` bit for bit
  (int8 and int32; r in {1.0, 1.6, 2.0, 2.9, 3.0} index units, r² exactly
  5.0 — the shell on the boundary — and r² past the bound);
* the port's dynamic step against vofod_tpu's dynamic step over the scans
  of tests/test_dynamic_radii.py with the radii changed between scans:
  the grid within 1e-5 score units, detections under the DESIGN §9 budget
  of tests/test_torch_step.py (see ``_against_jax``).  Both run with
  raycast_mode "off": the bf16 sweep rounds differently in the two packages
  (tests/test_torch_raycast.py) and has nothing to do with the radii;
* the port's dynamic step bit-equal to the port's static step at each radius
  pair of tests/test_dynamic_radii.py, sweep raycast on;
* the static port at the 1.4 m and 1.9 m sepclusters radii (257- and
  515-tap local-sure balls) against vofod_tpu's static step, as above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.ops import morphology as jm
from vofod_tpu.pipeline.state import ScanInput as JScan, init_state as j_init_state
from vofod_tpu.pipeline.step import make_step_fn as j_make_step_fn
from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu_torch.ops import morphology as tm
from vofod_tpu_torch.pipeline.background import traced_radius
from vofod_tpu_torch.pipeline.sepclusters import traced_radii
from vofod_tpu_torch.pipeline.state import ScanInput, init_state
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.runtime.node import VoFOD
from vofod_tpu_torch.sensor import make_lut

KW = dict(background_sufficient_points_ratio=0.05, max_clusters=8, max_far_voxels=512,
          max_queries=64, explore_submap=16, confidence_submap=8)
SENSOR = dict(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0))
OPAREA = ((0.0, 0.0, 5.75), (16.0, 16.0, 11.5))
BOUNDS = dict(dynamic_radii=True, ground_points_max_distance_bound=2.0,
              sepclusters_max_bg_distance_bound=2.0)
PAIRS = [(1.5, 0.8), (1.0, 0.8), (2.0, 1.4), (1.5, 1.9)]  # tests/test_dynamic_radii.py


def _cfg(**kw):
    return VoFODConfig(sensor=SensorConfig(**SENSOR), oparea=Box(*OPAREA), **KW, **kw)


def _jcfg(**kw):
    return JConfig(sensor=JSensor(**SENSOR), oparea=JBox(*OPAREA), **KW, **kw)


def _scans(cfg, n=6):
    """tests/test_dynamic_radii.py ``_scans``: (ranges, pose) per scan."""
    lut = make_lut(cfg.sensor)
    out = []
    for i in range(n):
        th = 0.3 * i
        pose = hover_pose((np.cos(th), np.sin(th), 7.0), yaw=0.1 * i)
        scene = Scene(ground_z=0.5)
        scene.add_sphere(center=(4.0, 0.3 * np.sin(th), 9.0), radius=0.7)
        out.append((render_scan(scene, lut, pose), pose))
    return lut, out


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_traced_pools_match_jax(dtype):
    rng = np.random.default_rng(4)
    a_np = rng.integers(-50, 50, (12, 13, 14)).astype(dtype)
    a, ja = torch.as_tensor(a_np), jnp.asarray(a_np)
    r2s = [np.float32(r * r) for r in (1.0, 1.6, 2.0, 2.9, 3.0)]
    r2s += [np.float32(5.0), np.float32(20.0)]  # the boundary shell; past the bound 3
    # the JAX pools jitted once at bound 3, the radius traced as in its step
    ops = [(tm.ball_pool_min_traced, jax.jit(lambda x, r: jm.ball_pool_min_traced(x, r, 3.0)),
            "min"),
           (tm.ball_pool_max_traced, jax.jit(lambda x, r: jm.ball_pool_max_traced(x, r, 3.0)),
            "max")]
    if dtype == np.int32:
        ops.append((tm.ball_pool_sum_traced,
                    jax.jit(lambda x, r: jm.ball_pool_sum_traced(x, r, 3.0)), "sum"))
    for r2 in r2s:
        for port, ref, op in ops:
            want = np.asarray(ref(ja, jnp.float32(r2)))
            got = port(a, r2, 3.0)  # the plain form: the decomposition at the equivalent radius
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{port.__name__} r2={r2}")
            # the kernels' tap set, one shifted slice per tap
            fill = tm.INT_FILL[op][a.dtype] if op != "sum" else 0
            taps = tm.tap_pool_plain(a, tm.shell_taps(3.0, r2), op, fill)
            np.testing.assert_array_equal(taps.numpy(), want, err_msg=f"{op} taps r2={r2}")
    # the boundary shell counts: r² = 5.0 keeps the 24 offsets of |d|² = 5
    assert len(tm.shell_taps(3.0, 5.0)) - len(tm.shell_taps(3.0, 4.9)) == 24
    assert sorted(map(tuple, tm.shell_taps(3.0, 20.0))) == sorted(map(tuple, tm.ball_taps(3.0)))


def test_shell_arithmetic_is_jax_float32():
    """The shells the JAX step keeps, from its float32 radii: 0.8 m at 0.5 m
    voxels gives mdi² = 2.5600002, so shells <= 2 (19 taps) demote."""
    cfg = _cfg(**BOUNDS)
    adj_bound, mdi, adj = traced_radii(cfg, DynParams(sepclusters_max_bg_distance=0.8))
    assert adj_bound == 4.0 and mdi * mdi == np.float32(2.5600002) and adj == 2.0
    assert len(tm.shell_taps(adj_bound, mdi * mdi)) == 19
    _, mdi, adj = traced_radii(cfg, DynParams(sepclusters_max_bg_distance=1.9))
    assert len(tm.shell_taps(adj_bound + 1.0, (adj + 1) * (adj + 1))) == 515  # local sure, r 5
    _, r2 = traced_radius(cfg, DynParams(ground_points_max_distance=np.sqrt(5) * 0.5))
    assert r2 == np.float32(5.0)  # the |d|² = 5 shell is kept, as in the JAX step
    assert len(tm.shell_taps(4.0, r2)) == len(tm.ball_taps(np.sqrt(5.0))) == 57
    bound, r2 = traced_radius(cfg, DynParams(ground_points_max_distance=9.0))
    assert bound == 4.0 and r2 == np.float32(16.0)  # clamped to the bound
    no_bound = dataclasses.replace(cfg, ground_points_max_distance_bound=0.0)
    assert traced_radius(no_bound, DynParams())[0] == cfg.ground_points_max_distance / 0.5


def test_kernel_tap_limits():
    """The stencil kernels take every ball: within halo 7 (2,103 taps at
    r² < 64) in their table form, past it (halo 8, 12 and 16) in their
    wide form; the wrappers raise only for an empty set or taps past the
    given halo."""
    assert len(tm.ball_taps(4.0)) == 257 and len(tm.ball_taps(5.0)) == 515
    big = tm.ball_taps(7.99)
    assert len(big) == 2103 and kernels._taps_arg(big, 7)[0].shape == (2103, 3)
    assert not tm.is_wide(big, 7) and not tm.run_table(7.99).wide
    for r, n in ((8.0, 2109), (12.0, 7153), (16.0, 17077)):
        taps = tm.ball_taps(r)
        assert len(taps) == n and kernels._taps_arg(taps, int(r))[0].shape == (n, 3)
        assert tm.is_wide(taps, int(r)) and tm.run_table(r).wide
    with pytest.raises(ValueError, match="within its halo"):
        kernels._taps_arg(tm.ball_taps(3.0), 2)  # taps reach past the halo
    with pytest.raises(ValueError, match="non-empty"):
        kernels._taps_arg(np.zeros((0, 3), np.int32), 3)


# the JAX comparisons start from free air (below thr_frontiers) over the
# apriori plane: with the raycast off nothing else clears space, and the
# sphere must float for the detections to be compared
AIR = -900.0


def _jrun(cfg, dyns, scans):
    step = j_make_step_fn(cfg, make_lut(cfg.sensor), donate=False, raycast_mode="off")
    state = j_init_state(cfg, dyns[0])
    state = state._replace(grid=jnp.full_like(state.grid, AIR).at[1, :, :].set(jnp.inf))
    outs = []
    for (r, p), dyn in zip(scans, dyns):
        scan = JScan(jnp.asarray(r.astype(np.float32)), jnp.ones(r.size, jnp.float32),
                     jnp.asarray(p))
        state, out = step(state, scan, dyn.as_arrays())
        outs.append((np.asarray(state.grid), out.detections))
    return outs


def _trun(cfg, dyns, scans, raycast_mode):
    step = make_step_fn(cfg, make_lut(cfg.sensor), device="cpu", raycast_mode=raycast_mode)
    state = init_state(cfg, dyns[0], device="cpu")
    if raycast_mode == "off":
        state.grid.fill_(AIR)
    state.grid[1] = float("inf")
    outs = []
    for (r, p), dyn in zip(scans, dyns):
        scan = ScanInput(torch.as_tensor(r.astype(np.float32)), torch.ones(r.size), p)
        state, out = step(state, scan, dyn)
        outs.append((state.grid.clone(), out))
    return outs


# Detections against vofod_tpu: the DESIGN §9 budget of tests/test_torch_step.py
# (ids, n_points and the integer fields equal, positions within 1e-3 m,
# confidence within 0.2 %), the basis-free floats within rtol 1e-5 / atol
# 1e-6 as in tests/test_dynamic_radii.py.  The OBB axes and extents are not
# compared: the two packages' eigh bases differ on degenerate clusters.
_EXACT = ("valid", "id", "n_points", "cluster_class")
_POSITIONS = ("position", "obb_center")
_FLOATS = ("covariance", "detection_probability", "aabb_min", "aabb_max")


def _against_jax(port, ref):
    for i, ((g, out), (jg, jdet)) in enumerate(zip(port, ref)):
        g = g.numpy()
        assert np.array_equal(np.isinf(g), np.isinf(jg)), i
        fin = np.isfinite(jg)
        np.testing.assert_allclose(g[fin], jg[fin], atol=1e-5, rtol=0, err_msg=f"scan {i}")
        d = out.detections
        valid = d.valid.numpy()
        for name, check in ([(f, dict()) for f in _EXACT]
                            + [(f, dict(atol=1e-3, rtol=0)) for f in _POSITIONS]
                            + [(f, dict(rtol=1e-5, atol=1e-6)) for f in _FLOATS]
                            + [("confidence", dict(rtol=2e-3, atol=0))]):
            a, b = getattr(d, name).numpy()[valid], np.asarray(getattr(jdet, name))[valid]
            if check:
                np.testing.assert_allclose(a, b, **check, err_msg=f"scan {i}: {name}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"scan {i}: {name}")
        np.testing.assert_array_equal(valid, np.asarray(jdet.valid), err_msg=f"scan {i}")


def _radii(pairs, base):
    return [dataclasses.replace(base, ground_points_max_distance=g,
                                sepclusters_max_bg_distance=s) for g, s in pairs]


def test_dynamic_step_matches_jax():
    """Radii changed between scans: (1.5, 0.8) -> (1.0, 1.4) -> (2.0, 1.9)."""
    base = DynParams(raycast_weight_coefficient=0.5)
    dyns = _radii([(1.5, 0.8), (1.5, 0.8), (1.0, 1.4), (1.0, 1.4), (2.0, 1.9), (2.0, 1.9)],
                  base)
    _, scans = _scans(_cfg())
    jdyns = [JDyn(**dataclasses.asdict(d)) for d in dyns]
    port = _trun(_cfg(**BOUNDS), dyns, scans, "off")
    _against_jax(port, _jrun(_jcfg(**BOUNDS), jdyns, scans))
    assert sum(int(out.detections.valid.sum()) for _, out in port) > 0


@pytest.mark.parametrize("max_bg", [1.4, 1.9])
def test_static_lifted_cap_matches_jax(max_bg):
    """Static sepclusters radii whose local-sure balls pass 256 taps (257 at
    1.4 m, 515 at 1.9 m) against the JAX static step."""
    base = DynParams(raycast_weight_coefficient=0.5)
    _, scans = _scans(_cfg())
    port = _trun(_cfg(sepclusters_max_bg_distance=max_bg), [base] * len(scans), scans, "off")
    ref = _jrun(_jcfg(sepclusters_max_bg_distance=max_bg), [JDyn(raycast_weight_coefficient=0.5)]
                * len(scans), scans)
    _against_jax(port, ref)
    assert sum(int(out.detections.valid.sum()) for _, out in port) > 0


@pytest.mark.parametrize("gpmd,max_bg", PAIRS)
def test_dynamic_equals_static_port(gpmd, max_bg):
    """dynamic(r) == static(r) in the port, bit for bit, per scan."""
    dyn = DynParams(raycast_weight_coefficient=0.5, ground_points_max_distance=gpmd,
                    sepclusters_max_bg_distance=max_bg)
    _, scans = _scans(_cfg())
    d = _trun(_cfg(**BOUNDS), [dyn] * len(scans), scans, "sweep")
    s = _trun(_cfg(ground_points_max_distance=gpmd, sepclusters_max_bg_distance=max_bg),
              [dyn] * len(scans), scans, "sweep")
    for i, ((dg, do), (sg, so)) in enumerate(zip(d, s)):
        assert torch.equal(dg, sg), f"scan {i}: grid"
        for part in ("detections", "diag"):
            a, b = getattr(do, part), getattr(so, part)
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f"scan {i}: {f.name}"


def test_update_params_rule():
    """vofod_tpu's rule: the radii move only with cfg.dynamic_radii."""
    static = VoFOD(_cfg(), DynParams(), device="cpu")
    for k, v in (("ground_points_max_distance", 2.0), ("sepclusters_max_bg_distance", 1.4)):
        with pytest.raises(ValueError, match="dynamic_radii"):
            static.update_params(**{k: v})
    static.update_params(thr_new_obstacles=-250.0)
    node = VoFOD(_cfg(**BOUNDS), DynParams(), device="cpu")
    lut, scans = _scans(node.cfg, n=2)
    node.update_params(ground_points_max_distance=1.0, sepclusters_max_bg_distance=1.4)
    node.process_scan(*scans[0][:1], None, scans[0][1])
    node.update_params(ground_points_max_distance=2.0, sepclusters_max_bg_distance=1.9)
    node.process_scan(scans[1][0], None, scans[1][1])
    assert node.dyn.sepclusters_max_bg_distance == 1.9 and node.state.step == 2
