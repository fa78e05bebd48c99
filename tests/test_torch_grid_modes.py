"""The grid-sharded step's last three modes (vofod_tpu_torch/parallel/
grid_step.py): the prebinned ingest on slabs (K15a), live-tunable radii at
the static halo (K14) and the sequential explore over z shards (K15b-7a/b/c),
at the shapes of tests/test_torch_grid_step.py (32 x 33 x 33 grid, explore
halo 8: two hops at 8 shards).

* (a) Each mode's sharded step at 8 and 2 shards is BIT-EQUAL to the port's
  dense step on every scan of JAX's own scenario for it (tests/
  test_grid_step.py: the prebinned ingest's 3 ground + 2 target scans
  through the port's HostBinner, the sequential explore's 4 + 3 scans, the
  dynamic radii's 3 + 3 scans with their radius schedule): grid, safe,
  the carried scalars, every diagnostic and every detection field.  So is
  the reference-exact path with the sequential explore at 2 shards.
* (b) K15b-7's plain versions under ZShardOps (the sharded classify on
  slabs, 2 and 8 shards) give the port's dense classify (K7s's plain
  version) and the JAX sequential classify bit for bit — grid, classes,
  demoted set and write count — on the adversarial scene of
  tests/test_sequential_demotion.py laid in the (x, z) plane, so that the
  carved escape straddles the shards' seams, and on the seeded fields of
  tests/test_torch_sequential_explore.py.  The JAX classify is jitted once.
* (c) The slice as a whole: the port's sharded sequential and dynamic
  steps against JAX's DENSE step of the same mode, with the tolerances of
  tests/test_torch_grid_step.py (integer diagnostics equal but n_bg_voxels,
  within the voxels that lie within 2.5 of thr_new_obstacles on JAX's map
  before the scan; detections: valid, ids and n_points equal, positions
  within 1e-3 m, confidence within 1 % relative; the grid within 2.5 score
  units, 0.75 at the 99.9th percentile: the bf16 sweep's rounding at this
  scenario's ray weight 0.5).  JAX's slow-tier tests/test_grid_step.py
  pins its own sharded step to its dense one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sequential_demotion import CARVED, scene_dyn
from tests.test_torch_grid_step import (
    BOX, CONF_RTOL, DIAG_FIELDS, GRID_ATOL, GRID_P999, KW, SENSOR, STATE_FIELDS, _assert_bitequal,
    _cfg, _port_scan, _port_start)
from tests.test_torch_sequential_explore import CASES, CFG, DYN, SHAPE, VOXEL, _field
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu.pipeline.classify import CLS_MAV, classify as j_classify
from vofod_tpu.pipeline.state import ScanInput as JScan, init_state as jinit_state
from vofod_tpu.pipeline.step import make_step_fn as jmake_step_fn
from vofod_tpu.sensor import make_lut as jmake_lut
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.io.binner import HostBinner
from vofod_tpu_torch.ops.components import SENTINEL
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.gridops import ZShardOps
from vofod_tpu_torch.parallel.grid_step import gather_state, make_grid_sharded_step, shard_state
from vofod_tpu_torch.pipeline.classify import classify
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.sensor import make_lut

DYNAMIC = dict(dynamic_radii=True, ground_points_max_distance_bound=2.0,
               sepclusters_max_bg_distance_bound=2.0)
RADII = [(1.5, 0.8), (1.5, 0.8), (1.0, 1.4), (2.0, 1.9), (1.5, 0.8), (1.0, 1.9)]
EXACT_SEQ = dict(sequential_explore=True, sepclusters_exact_census=True,
                 compat_counted_indexing=True)
BASE_DYN = dict(raycast_weight_coefficient=0.5)


@pytest.fixture(scope="module")
def scenes():
    """The scans of JAX's scenarios as numpy ranges: n ground scans, then
    target scans, from the hover pose."""
    jlut = jmake_lut(JSensor(**SENSOR))
    pose = hover_pose((0.0, 0.0, 6.0))
    ground, target = Scene(ground_z=0.5), Scene(ground_z=0.5)
    target.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
    g, t = render_scan(ground, jlut, pose), render_scan(target, jlut, pose)
    return jlut, make_lut(_cfg().sensor), pose, lambda n_g, n_t: [g] * n_g + [t] * n_t


# mode: (config, make_step_fn options, (ground, target) scans, radii per scan)
MODES = {
    "prebinned": ({}, dict(frontend_mode="prebinned"), (3, 2), None),
    "sequential": (dict(sequential_explore=True), {}, (4, 3), None),
    "dynamic": (DYNAMIC, {}, (3, 3), RADII),
    "exact_sequential": (EXACT_SEQ, dict(raycast_mode="exact"), (4, 3), None),
}


def _dyns(mode):
    radii = MODES[mode][3]
    base = DynParams(**BASE_DYN)
    if radii is None:
        return None, base
    return [dataclasses.replace(base, ground_points_max_distance=g,
                                sepclusters_max_bg_distance=s) for g, s in radii], base


def _port_run(scenes, mode, n_shards=None):
    """The port's step of ``mode`` over its scenario, dense (``n_shards``
    None) or grid-sharded (the state gathered after each scan): every
    scan's state, diagnostics and detections."""
    _, lut, pose, make = scenes
    cfg_kw, step_kw, counts, _ = MODES[mode]
    cfg = _cfg(**cfg_kw)
    per_scan, base = _dyns(mode)
    ranges = make(*counts)
    st = _port_start(cfg, base)
    if n_shards is None:
        step = make_step_fn(cfg, lut, device="cpu", **step_kw)
    else:
        comm = LocalComm(n_shards, ["cpu"], timeout=120.0)
        step = make_grid_sharded_step(cfg, lut, comm, **step_kw)
        st = shard_state(st, comm)
    binner = HostBinner(cfg, lut) if mode == "prebinned" else None
    out = []
    for k, r in enumerate(ranges):
        if binner is None:
            scan = _port_scan(r, pose)
        else:
            # the sharded step uploads each shard's slab of the host grid
            scan = binner.bin(r, pose).to_device("cpu")
        dyn = base if per_scan is None else per_scan[k]
        st, o = step(st, scan, dyn)
        got = st if n_shards is None else gather_state(st)
        out.append(dict(
            state={f: getattr(got, f).clone() for f in STATE_FIELDS},
            diag={f.name: getattr(o.diag, f.name).clone() for f in dataclasses.fields(o.diag)},
            detections={f.name: getattr(o.detections, f.name).clone()
                        for f in dataclasses.fields(o.detections)}))
    return out


@pytest.fixture(scope="module")
def runs(scenes):
    """The port's runs by (mode, shards or None), each made once."""
    cache = {}

    def get(mode, n_shards=None):
        if (mode, n_shards) not in cache:
            cache[mode, n_shards] = _port_run(scenes, mode, n_shards)
        return cache[mode, n_shards]

    return get


_SHARDED = [(m, n) for m in ("prebinned", "sequential", "dynamic") for n in (8, 2)] + [
    ("exact_sequential", 2)]


@pytest.mark.parametrize("mode,n_shards", _SHARDED)
def test_sharded_mode_bitexact_vs_dense(runs, mode, n_shards):
    """(a) Every scan of the sharded step equals the dense step's bit for
    bit, and the scenario exercises the mode."""
    got = runs(mode, n_shards)
    _assert_bitequal(got, runs(mode))
    assert sum(int(o["detections"]["valid"].sum()) for o in got) >= 1
    if mode.endswith("sequential"):  # explore failures demoted voxels
        assert sum(int(o["diag"]["n_demoted"]) for o in got) > 0
    if mode == "exact_sequential":
        assert all(int(o["diag"]["sep_sweeps"]) > 0 for o in got)


# ---- (b) K15b-7's plain versions under ZShardOps ---------------------------------

SCENE_BASE = (5, 8, 5)  # (x, y, z): the escape climbs z 5 -> 10 across the seams


def _scene():
    """tests/test_sequential_demotion.py's scene in the 16^3 grid with the
    relative (x, y) cells laid at (x, z): A and B at z = 5, the corridor
    to B's escape up to z = 10, across the seam at z = 8 (2 shards) and
    those at 6, 8 and 10 (8 shards).  Returns (vals, far, labels,
    sensor_pos) and the scene's dyn."""
    dyn = scene_dyn()
    vals = np.full(SHAPE, np.float32(dyn.score_ray), np.float32)
    bx, by, bz = SCENE_BASE
    for x, z in CARVED:
        vals[bz + z, by, bx + x] = np.float32(dyn.score_unknown)
    far = np.zeros(SHAPE, bool)
    labels = np.full(SHAPE, SENTINEL, np.int32)
    members = [(bz * SHAPE[1] + by) * SHAPE[2] + bx + dx for dx in (0, 2)]
    for dx in (0, 2):
        far[bz, by, bx + dx] = True
        labels[bz, by, bx + dx] = min(members)
    sensor = (np.array([bx + 4, by + 2, bz + 2], np.float32) * VOXEL).astype(np.float32)
    return (vals, far, labels, sensor), dyn


def _case(name):
    """(vals, far, labels, sensor_pos) and the JAX dyn of a (b) case."""
    if name == "scene":
        return _scene()
    seed, sensor = CASES[name]
    return (*_field(seed), sensor), JDyn(**DYN)


@pytest.fixture(scope="module")
def jax_classify():
    """The JAX sequential classify on the 16^3 grid, compiled once for
    every case (the dyn is traced)."""
    jcfg = JConfig(**CFG)
    grid = JGrid((0.0, 0.0, 0.0), SHAPE, VOXEL)
    t = jnp.bool_(True)
    return jax.jit(lambda dyn, v, f, lab, s: j_classify(jcfg, dyn, grid, v, f, lab, t, s, t, t))


def _port_classify(args, dyn, ops=None, comm=None):
    """The port's classify: dense, or on the shards' slabs with ``ops``
    (the grid gathered; the replicated outputs are shard 0's)."""
    cfg = VoFODConfig(**CFG)
    grid = GridSpec((0.0, 0.0, 0.0), SHAPE, VOXEL)
    vals, far, labels, sensor = (torch.from_numpy(np.asarray(a)) for a in args)
    t = torch.tensor(True)
    if ops is None:
        return classify(cfg, dyn, grid, vals, far, labels, t, sensor, t, t)
    nzl = SHAPE[0] // comm.n

    def shard(rank):
        sl = slice(rank * nzl, (rank + 1) * nzl)
        return classify(cfg, dyn, grid, vals[sl], far[sl], labels[sl], t, sensor, t, t, ops)

    outs = comm.run(shard)
    return dataclasses.replace(outs[0], grid=torch.cat([o.grid for o in outs]))


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("name", ["scene"] + list(CASES))
def test_sequential_stack_plain_sharded(jax_classify, name, n_shards):
    """(b) The sharded sequential classify (K15b-7a/b/c's plain versions)
    against the port's dense one (K7s's plain version) and JAX's."""
    args, jdyn = _case(name)
    dyn = DynParams(**dataclasses.asdict(jdyn))
    comm = LocalComm(n_shards, ["cpu"], timeout=120.0)
    got = _port_classify(args, dyn, ZShardOps(comm, n_shards), comm)
    dense = _port_classify(args, dyn)
    jo = jax_classify(jdyn.as_arrays(), *(jnp.asarray(a) for a in args))
    for f in ("grid", "cluster_valid", "cluster_class", "n_demoted", "n_queries"):
        assert torch.equal(getattr(got, f), getattr(dense, f)), f
    for f in ("grid", "cluster_valid", "cluster_class", "n_points", "reps"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(jo, f))), f
    changed = got.grid.numpy() != args[0]
    assert int(got.n_demoted) == int(changed.sum())  # each demoted voxel written once
    if name == "scene":  # A's failure cut B's escape: floating, every cell demoted
        k = int(np.argmax(got.cluster_valid.numpy()))
        assert int(got.cluster_class[k]) == CLS_MAV and int(got.n_demoted) == len(CARVED)


# ---- (c) the slice against JAX's dense step ---------------------------------------


def _jax_run(scenes, mode):
    jlut, _, pose, make = scenes
    cfg_kw, _, counts, _ = MODES[mode]
    jcfg = JConfig(sensor=JSensor(**SENSOR), oparea=JBox(*BOX), **{**KW, **cfg_kw})
    per_scan, _ = _dyns(mode)
    base = JDyn(**BASE_DYN)
    step = jmake_step_fn(jcfg, jlut, donate=False)
    st = jinit_state(jcfg, base)
    st = st._replace(grid=st.grid.at[1].set(0.0))
    out = []
    for k, r in enumerate(make(*counts)):
        dyn = base if per_scan is None else JDyn(**dataclasses.asdict(per_scan[k]))
        scan = JScan(ranges_mm=jnp.asarray(r.astype(np.float32)),
                     intensity=jnp.ones(r.size, jnp.float32), pose=jnp.asarray(pose))
        prev = np.asarray(st.grid)
        st, o = step(st, scan, dyn.as_arrays())
        out.append(dict(prev=prev, grid=np.asarray(st.grid),
                        diag={f: int(getattr(o.diag, f)) for f in DIAG_FIELDS},
                        dets={f: np.asarray(getattr(o.detections, f))
                              for f in o.detections._fields}))
    return out


@pytest.mark.parametrize("mode", ["sequential", "dynamic"])
def test_sharded_mode_against_jax_dense(scenes, runs, mode):
    """(c) The port's sharded step (2 shards) against JAX's dense step of
    the same mode, under the tolerances of the module docstring."""
    thr = DynParams().thr_new_obstacles
    n_dets = 0
    for k, (j, p) in enumerate(zip(_jax_run(scenes, mode), runs(mode, 2))):
        diag = {f: int(p["diag"][f]) for f in DIAG_FIELDS}
        near = int((np.abs(j["prev"] - thr) <= GRID_ATOL).sum()) if k else 0
        assert abs(diag.pop("n_bg_voxels") - j["diag"]["n_bg_voxels"]) <= near, f"scan {k}"
        assert diag == {f: v for f, v in j["diag"].items() if f != "n_bg_voxels"}, f"scan {k}"
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
    assert n_dets >= 1
