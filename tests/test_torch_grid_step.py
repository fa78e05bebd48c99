"""The slice as a whole: the port's grid-sharded step (vofod_tpu_torch/
parallel/grid_step.py) over tests/test_grid_step.py's bit-exact scenario.

The 7 scans of ``test_bitexact_vs_unsharded`` (ground, then a floating
sphere, with the apriori ground plane, raycast weight 0.5) at the shapes of
its ``sharded_config`` (32 x 33 x 33 grid, explore halo 8):

* the sharded step at 8 shards (height 4: the explore and detection halos
  take two hops) and at 2 shards is BIT-EQUAL to the port's dense step on
  every scan: grid, safe, the carried scalars, every diagnostic and every
  detection field;
* so is it at 2 shards under each other option of the sweep path
  (raycast_every, the ungated sweep, no raycast, a FOV mask);
* the port's dense step against JAX's dense step with the tolerances of
  tests/test_torch_step.py (integer diagnostics equal; detections: count,
  ids and n_points equal, positions within 1e-3 m), at least one detection
  found, but for what the scenario's ray weight moves.  The grid: within 2.5 score
  units, and 0.75 at the 99.9th percentile (measured 2.05 and 0.68 after
  the 7 scans).  tests/test_torch_step.py's 0.5 is for the default ray
  weight 0.003; this scenario's 0.5 makes each scan's ray EMA step ~167
  times larger, so the bf16 transmittance rounding (tests/
  test_torch_raycast.py) moves the grid that much more, scan after scan.
  So n_bg_voxels (voxels over thr_new_obstacles on the map before the
  scan) may differ by the voxels within 2.5 of that threshold (measured 8
  of them at scan 4), and the confidence, exp(-sum(1 - v / score_ray) /
  n_points) over the detection window, is held to 1 % relative (0.2 % in
  tests/test_torch_step.py; measured 0.37 %); every other diagnostic is
  equal;
* a grid that does not split into shards of at least 2 planes is refused,
  as is an exact-census leaf that does not divide the shard height, and a
  process with jax refused runs the sharded sweep step, the sharded exact
  step, the transposed z cones and the prebinned, dynamic-radii and
  sequential-explore sharded steps (tests/test_torch_grid_modes.py holds
  those three modes to the dense step).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu.pipeline.state import ScanInput as JScan, init_state as jinit_state
from vofod_tpu.pipeline.step import make_step_fn as jmake_step_fn
from vofod_tpu.sensor import make_lut as jmake_lut
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.grid_step import (
    gather_state, init_grid_sharded_state, make_grid_sharded_step, shard_state)
from vofod_tpu_torch.pipeline.state import ScanInput, init_state
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.sensor import make_lut

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(background_sufficient_points_ratio=0.05, max_clusters=8, max_far_voxels=512,
          max_queries=64, explore_submap=16, confidence_submap=8)
SENSOR = dict(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0))
BOX = ((0.0, 0.0, 7.75), (16.0, 16.0, 15.5))
DIAG_FIELDS = ("n_bg_voxels", "bg_sufficient", "sure_bg_sufficient", "n_occupied", "n_far",
               "far_overflow", "cc_converged", "cc_iters", "sep_converged", "n_detections")
# at the scenario's ray weight 0.5: see the module docstring
CONF_RTOL, GRID_ATOL, GRID_P999 = 1e-2, 2.5, 0.75
STATE_FIELDS = ("grid", "safe", "det_counter", "sure_bg_sufficient", "bg_sufficient")


def _cfg(nz_box=BOX, **kw) -> VoFODConfig:
    return VoFODConfig(sensor=SensorConfig(**SENSOR), oparea=Box(*nz_box), **{**KW, **kw})


@pytest.fixture(scope="module")
def scenario():
    """The scans (numpy ranges), the pose and the LUTs of both packages."""
    jcfg = JConfig(sensor=JSensor(**SENSOR), oparea=JBox(*BOX), **KW)
    jlut = jmake_lut(jcfg.sensor)
    pose = hover_pose((0.0, 0.0, 6.0))
    ground, target = Scene(ground_z=0.5), Scene(ground_z=0.5)
    target.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
    ranges = [render_scan(ground, jlut, pose)] * 4 + [render_scan(target, jlut, pose)] * 3
    return jcfg, jlut, make_lut(_cfg().sensor), pose, ranges


def _port_scan(r, pose) -> ScanInput:
    return ScanInput(ranges_mm=torch.from_numpy(r.astype(np.float32)),
                     intensity=torch.ones(r.size), pose=np.asarray(pose, np.float32))


def _port_start(cfg, dyn):
    st = init_state(cfg, dyn, device="cpu")
    st.grid[1] = 0.0  # the apriori ground plane, as tests/test_grid_step.py
    return st


@pytest.fixture(scope="module")
def jax_run(scenario):
    jcfg, jlut, _, pose, ranges = scenario
    dyn = JDyn(raycast_weight_coefficient=0.5)
    step = jmake_step_fn(jcfg, jlut, donate=False)
    st = jinit_state(jcfg, dyn)
    st = st._replace(grid=st.grid.at[1].set(0.0))
    out = []
    for r in ranges:
        scan = JScan(ranges_mm=jnp.asarray(r.astype(np.float32)),
                     intensity=jnp.ones(r.size, jnp.float32), pose=jnp.asarray(pose))
        st, o = step(st, scan, dyn.as_arrays())
        out.append(dict(
            diag={f: int(getattr(o.diag, f)) for f in DIAG_FIELDS},
            dets={f: np.asarray(getattr(o.detections, f)) for f in o.detections._fields},
            grid=np.asarray(st.grid)))
    return out


def _port_run(scenario, n_shards=None, **step_kw):
    """The port's step over the scenario, dense (``n_shards`` None) or
    grid-sharded (the state gathered after each scan): every scan's state,
    diagnostics and detections.  ``step_kw``: make_step_fn's options."""
    _, _, lut, pose, ranges = scenario
    cfg, dyn = _cfg(), DynParams(raycast_weight_coefficient=0.5)
    if n_shards is None:
        step = make_step_fn(cfg, lut, device="cpu", **step_kw)
        st = _port_start(cfg, dyn)
    else:
        comm = LocalComm(n_shards, ["cpu"], timeout=120.0)
        step = make_grid_sharded_step(cfg, lut, comm, **step_kw)
        st = shard_state(_port_start(cfg, dyn), comm)
        assert [tuple(s.grid.shape) for s in st] == [(32 // n_shards, 33, 33)] * n_shards
    out = []
    for k, r in enumerate(ranges):
        st, o = step(st, _port_scan(r, pose), dyn)
        got = st if n_shards is None else gather_state(st)
        assert got.step == k + 1
        out.append(dict(
            state={f: getattr(got, f).clone() for f in STATE_FIELDS},
            diag={f.name: getattr(o.diag, f.name).clone() for f in dataclasses.fields(o.diag)},
            detections={f.name: getattr(o.detections, f.name).clone()
                        for f in dataclasses.fields(o.detections)}))
    return out


def _assert_bitequal(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        for part, fields in w.items():
            for f, v in fields.items():
                assert torch.equal(g[part][f], v), f"scan {k}: {part}.{f}"


@pytest.fixture(scope="module")
def dense_run(scenario):
    """The port's dense step: every scan's state, diagnostics and
    detections."""
    return _port_run(scenario)


def test_dense_port_matches_jax(jax_run, dense_run):
    """The reference the sharded step is held to, against JAX's dense step
    (tests/test_torch_step.py's tolerances, the grid's and n_bg_voxels' as
    the module docstring states)."""
    n_dets = 0
    thr = DynParams().thr_new_obstacles
    prev = None  # JAX's map before the scan: n_bg_voxels counts it
    for k, (j, p) in enumerate(zip(jax_run, dense_run)):
        diag = {f: int(p["diag"][f]) for f in DIAG_FIELDS}
        near = 0 if prev is None else int((np.abs(prev - thr) <= GRID_ATOL).sum())
        assert abs(diag.pop("n_bg_voxels") - j["diag"]["n_bg_voxels"]) <= near, f"scan {k}"
        assert diag == {f: v for f, v in j["diag"].items() if f != "n_bg_voxels"}, f"scan {k}"
        prev = j["grid"]
        pv, jv = p["detections"]["valid"].numpy(), j["dets"]["valid"]
        assert np.array_equal(pv, jv), f"scan {k}"
        for f in ("id", "n_points"):
            assert np.array_equal(p["detections"][f].numpy()[pv], j["dets"][f][jv]), \
                f"scan {k}: {f}"
        np.testing.assert_allclose(p["detections"]["position"].numpy()[pv],
                                   j["dets"]["position"][jv], atol=1e-3, rtol=0)
        np.testing.assert_allclose(p["detections"]["confidence"].numpy()[pv],
                                   j["dets"]["confidence"][jv], rtol=CONF_RTOL, atol=0)
        grid = p["state"]["grid"].numpy()
        fin = np.isfinite(j["grid"])
        assert np.array_equal(fin, np.isfinite(grid)), f"scan {k}"
        d = np.abs(grid[fin] - j["grid"][fin])
        assert d.max() <= GRID_ATOL and np.quantile(d, 0.999) <= GRID_P999, f"scan {k}"
        n_dets += int(pv.sum())
    assert n_dets >= 1  # the floating target is found


@pytest.mark.parametrize("n_shards", [8, 2])
def test_sharded_bitexact_vs_dense(scenario, dense_run, n_shards):
    """Every scan of the sharded step equals the dense step's bit for bit."""
    got = _port_run(scenario, n_shards)
    _assert_bitequal(got, dense_run)
    assert sum(int(o["detections"]["valid"].sum()) for o in got) >= 1


# make_step_fn's other options of the sweep path, which the sharded step takes
_OPTIONS = {
    "raycast_every_2": dict(raycast_every=2),
    "ungated_sweep": dict(raycast_gate=False),
    "raycast_off": dict(raycast_mode="off"),
    "fov_mask": dict(mask=np.arange(SENSOR["vertical_rays"] * SENSOR["horizontal_rays"]) % 3 > 0),
}


@pytest.mark.parametrize("option", list(_OPTIONS))
def test_sharded_options_bitexact_vs_dense(scenario, option):
    """Under each option, every scan of the sharded step (2 shards) equals
    the dense step's under the same option bit for bit."""
    _assert_bitequal(_port_run(scenario, 2, **_OPTIONS[option]),
                     _port_run(scenario, **_OPTIONS[option]))


def test_init_and_gather_state():
    cfg, dyn = _cfg(), DynParams()
    comm = LocalComm(4, ["cpu"])
    states = init_grid_sharded_state(cfg, dyn, comm)
    whole = init_state(cfg, dyn, device="cpu")
    got = gather_state(states)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got, f), getattr(whole, f))
    assert gather_state(shard_state(got, comm)).grid.shape == whole.grid.shape


_REFUSED = {
    "indivisible_nz": (dict(nz_box=((0.0, 0.0, 7.5), (16.0, 16.0, 15.0))), 8, {},
                       ValueError, "divisible"),
    "shard_height_1": ({}, 32, {}, ValueError, "< 2 planes"),
    "exact_census_leaf": (dict(sepclusters_exact_census=True, sepclusters_max_bg_distance=2.0),
                          8, {}, ValueError, "coarse leaf 3 must divide the shard height 4"),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_refused_configs(scenario, case):
    """A grid the shards cannot split, or an exact-census leaf that does not
    tile a shard, raises."""
    cfg_kw, n, step_kw, exc, match = _REFUSED[case]
    with pytest.raises(exc, match=match):
        make_grid_sharded_step(_cfg(**cfg_kw), scenario[2], LocalComm(n, ["cpu"]), **step_kw)


_NO_JAX = textwrap.dedent(
    """
    import importlib.abc, sys

    class RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name in ("jax", "jaxlib", "vofod_tpu") or name.startswith(
                    ("jax.", "jaxlib.", "vofod_tpu.")):
                raise ImportError(f"refused here: {name}")
            return None

    sys.meta_path.insert(0, RefuseJax())
    import numpy as np
    import torch
    import vofod_tpu_torch.parallel
    from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
    from vofod_tpu_torch.io.binner import HostBinner
    from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
    from vofod_tpu_torch.parallel.comm import LocalComm
    from vofod_tpu_torch.parallel.grid_step import (
        gather_state, init_grid_sharded_state, make_grid_sharded_step)
    from vofod_tpu_torch.ops.raycast import cone_sweep_z_transposed, raycast_dda_slab
    from vofod_tpu_torch.pipeline.sepclusters import quirk_sure_counts_sharded
    from vofod_tpu_torch.pipeline.state import ScanInput
    from vofod_tpu_torch.sensor import make_lut

    torch.set_num_threads(1)
    cfg = VoFODConfig(sensor=SensorConfig(vertical_rays=8, horizontal_rays=32),
                      oparea=Box((0.0, 0.0, 3.75), (8.0, 8.0, 7.5)), max_clusters=4,
                      max_far_voxels=64, max_queries=16, explore_submap=8, confidence_submap=8)
    lut = make_lut(cfg.sensor)
    comm = LocalComm(2, ["cpu"])
    step = make_grid_sharded_step(cfg, lut, comm)
    states = init_grid_sharded_state(cfg, DynParams(), comm)
    scene = Scene(ground_z=0.0)
    scene.add_sphere((2.0, 1.0, 3.0), 0.5)
    pose = hover_pose((0.0, 0.0, 2.0))
    r = render_scan(scene, lut, pose)
    scan = ScanInput(ranges_mm=torch.from_numpy(r.astype(np.float32)),
                     intensity=torch.ones(r.size), pose=pose.astype(np.float32))
    states, out = step(states, scan, DynParams())
    assert gather_state(states).step == 1
    # the reference-exact sharded step, and the transposed z cones
    xcfg = VoFODConfig(**{**cfg.__dict__, "sepclusters_exact_census": True,
                          "compat_counted_indexing": True, "compat_hascloseto_bounds": True})
    xstep = make_grid_sharded_step(xcfg, lut, comm, raycast_mode="exact")
    xstates, xout = xstep(init_grid_sharded_state(xcfg, DynParams(), comm), scan, DynParams())
    assert int(xout.diag.sep_sweeps) > 0
    tstep = make_grid_sharded_step(cfg, lut, comm, zcone_mode="transpose")
    tstates, tout = tstep(init_grid_sharded_state(cfg, DynParams(), comm), scan, DynParams())
    assert torch.equal(gather_state(tstates).grid, gather_state(states).grid)
    # the prebinned ingest on slabs, live-tunable radii, the sequential explore
    pstep = make_grid_sharded_step(cfg, lut, comm, frontend_mode="prebinned")
    pscan = HostBinner(cfg, lut).bin(r, pose).to_device("cpu")
    pstates, _ = pstep(init_grid_sharded_state(cfg, DynParams(), comm), pscan, DynParams())
    assert torch.equal(gather_state(pstates).grid, gather_state(states).grid)
    dcfg = VoFODConfig(**{**cfg.__dict__, "dynamic_radii": True,
                          "ground_points_max_distance_bound": 2.0,
                          "sepclusters_max_bg_distance_bound": 2.0})
    dyn = DynParams(ground_points_max_distance=1.0, sepclusters_max_bg_distance=1.5)
    dstep = make_grid_sharded_step(dcfg, lut, comm)
    dstates, dout = dstep(init_grid_sharded_state(dcfg, dyn, comm), scan, dyn)
    assert int(dout.diag.n_occupied) == int(out.diag.n_occupied)
    scfg = VoFODConfig(**{**cfg.__dict__, "sequential_explore": True})
    sstep = make_grid_sharded_step(scfg, lut, comm)
    sstates, sout = sstep(init_grid_sharded_state(scfg, DynParams(), comm), scan, DynParams())
    assert gather_state(sstates).step == 1
    assert not any(m.split(".")[0] in ("jax", "vofod_tpu") for m in sys.modules)
    print("NO_JAX_OK", int(out.diag.n_occupied))
    """
)


def test_sharded_step_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout
    assert int(res.stdout.split("NO_JAX_OK")[1].split()[0]) > 0
