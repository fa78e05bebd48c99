"""The reference-exact grid-sharded step and the transposed z cones of the
port (vofod_tpu_torch/parallel/) on CPU shards, against JAX's ZShardOps in
a jitted ``shard_map`` on the 8-device CPU mesh and against the port's
dense step, at the shapes of tests/test_grid_step.py's ``sharded_config``
(32 x 33 x 33 grid; 8 shards of 4 planes, or 2 of 16).

Tolerances, with their reasons:

* ``LocalComm.all_to_all``, the sharded label components (labels,
  ``converged``, the sweep count, a capped case), the sharded census, the
  sharded quirk counts: integer and selection arithmetic, bit-equal to JAX's
  sharded primitives and to the port's dense ones.
* the sharded DDA (K15b-6c's plain version): bit-equal to JAX's dense DDA
  and to the port's dense one: each adds a voxel's chords in float32 in
  the walk's (step, ray) order, and dropping the chords of other slabs
  reorders none of a voxel's own.  JAX's sharded DDA is not: its scatter,
  with the other slabs' chords as weight-0 adds at the slab's edge ids,
  adds some voxels' chords in another order (measured: 787 of 34,848
  voxels, max |d| 9.5e-7, on these rays), so it is held within
  DDA_ATOL = 1e-5.
* the transposed z cones: T bit-equal to the port's dense K4 plain version
  and to the pipelined cones; the raylen against JAX's transposed sweep
  within tests/test_torch_gridops.py's bf16 bounds (per voxel 2^-4, 2^-5
  at the 99.9th percentile, max |d| <= 2e-3 x max raylen): the two
  frameworks round the bf16 carry at different points.
* the whole step over tests/test_grid_step.py's 6-scan exact scenario
  (ground, then a floating sphere; the apriori ground plane; ray weight
  0.5), exact census + counted indexing + exact DDA, then with the
  hasCloseTo box too, and the sweep step with the transposed z cones: at 8
  and 2 shards, bit-equal to the port's dense step on every scan (state,
  every diagnostic, every detection field).  The sharded box is held to the
  dense step, not to JAX's sharded step, which pools it on the bare slab.
* the port's dense exact step against JAX's dense exact step: integer and
  bool diagnostics equal; detections equal in count, id and n_points,
  positions within 1e-3 m, confidence within 0.2 % and the grid within
  1e-2 score units (tests/test_torch_exact_step.py's budgets; measured max
  |d| 3.7e-4 after the 6 scans: the last-bit chord differences of the two
  frameworks' ray rotations, riding the ray EMA).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu.ops.raycast import raycast_dda as jraycast_dda
from vofod_tpu.parallel.grid_step import make_grid_mesh
from vofod_tpu.parallel.gridops import ZShardOps as JZShardOps
from vofod_tpu.pipeline.sepclusters import _quirk_sure_counts_sharded
from vofod_tpu.pipeline.state import ScanInput as JScan, init_state as jinit_state
from vofod_tpu.pipeline.step import make_step_fn as jmake_step_fn
from vofod_tpu.sensor import make_lut as jmake_lut
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.components import label_components
from vofod_tpu_torch.ops.morphology import hascloseto_pool_any
from vofod_tpu_torch.ops.raycast import (
    RayConsts, RayEma, cone_sweep_plain, ray_window_plain, raycast_dda_plain,
    raycast_dda_slab, sweep_zsharded)
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.gridops import DENSE, ZShardOps
from vofod_tpu_torch.parallel.grid_step import gather_state, make_grid_sharded_step, shard_state
from vofod_tpu_torch.pipeline.background import split_and_update
from vofod_tpu_torch.pipeline.sepclusters import (
    quirk_sure_counts_plain, quirk_sure_counts_sharded, run_sepclusters_exact)
from vofod_tpu_torch.pipeline.state import ScanInput, init_state
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.sensor import make_lut

N = 8
SPEC = P("grid", None, None)
KW = dict(background_sufficient_points_ratio=0.05, max_clusters=8, max_far_voxels=512,
          max_queries=64, explore_submap=16, confidence_submap=8)
SENSOR = dict(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0))
BOX = ((0.0, 0.0, 7.75), (16.0, 16.0, 15.5))
EXACT = dict(sepclusters_exact_census=True, compat_counted_indexing=True)
BOXED = dict(EXACT, compat_hascloseto_bounds=True)
SWEEP_RTOL, SWEEP_RTOL_P999, SWEEP_MAX = 2.0**-4, 2.0**-5, 2e-3  # tests/test_torch_gridops.py
GRID_ATOL = 1e-2  # tests/test_torch_exact_step.py
DDA_ATOL = 1e-5  # JAX's sharded DDA against its dense one: see the module docstring
DIAG_FIELDS = ("n_bg_voxels", "bg_sufficient", "sure_bg_sufficient", "n_occupied", "n_far",
               "far_overflow", "cc_converged", "cc_iters", "sep_converged", "n_detections")
STATE_FIELDS = ("grid", "safe", "det_counter", "sure_bg_sufficient", "bg_sufficient")
COARSE = (32, 12, 12)
CAP = 3  # the capped label sweeps


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == N
    return make_grid_mesh(N)


@pytest.fixture(scope="module")
def comm():
    return LocalComm(N, ["cpu"], timeout=120.0)


def _shards(x: np.ndarray, n: int = N):
    nzl = x.shape[0] // n
    return [torch.from_numpy(np.array(x[i * nzl:(i + 1) * nzl])) for i in range(n)]


def _cfg(**kw) -> VoFODConfig:
    return VoFODConfig(sensor=SensorConfig(**SENSOR), oparea=Box(*BOX), **{**KW, **kw})


def _jcfg(**kw) -> JConfig:
    return JConfig(sensor=JSensor(**SENSOR), oparea=JBox(*BOX), **{**KW, **kw})


# ---- the primitives against JAX's ZShardOps (one program) ----------------------


def _rays(grid: GridSpec, seed: int = 0, R: int = 512):
    """(starts inside the grid, unit directions, lengths, valid) as numpy."""
    rng = np.random.default_rng(seed)
    lo = np.array(grid.origin) + 0.3
    hi = np.array(grid.origin) + np.array(grid.shape[::-1]) * grid.voxel_size - 0.3
    dirs = rng.standard_normal((R, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (rng.uniform(lo, hi, (R, 3)).astype(np.float32), dirs.astype(np.float32),
            rng.uniform(0.2, 8.0, R).astype(np.float32), rng.random(R) < 0.9)


@pytest.fixture(scope="module")
def prims():
    """The primitives' inputs: a coarse occupancy that needs many label
    sweeps, census values, quirk grids, rays."""
    rng = np.random.default_rng(21)
    grid = GridSpec.from_config(_cfg())
    return dict(
        a2a=rng.integers(-99, 99, (32, 16, 8)).astype(np.int32),
        occ=rng.random(COARSE) < 0.3,
        vals=rng.integers(0, 4, COARSE).astype(np.int32),
        bg=rng.random(COARSE) < 0.4,
        sure=rng.random(COARSE) < 0.5,
        rays=_rays(grid),
    )


@pytest.fixture(scope="module")
def jax_prims(mesh, prims):
    """JAX's sharded primitives on ``prims``, one jitted shard_map."""
    jops = JZShardOps("grid", N)
    jgrid = JGrid.from_config(_jcfg())
    ncv = int(np.prod(COARSE))
    rays = [jnp.asarray(a) for a in prims["rays"]]

    def body(a2a, occ, vals, bg, sure):
        labels, conv = jops.label_components(occ, 2.0, 128)
        capped, cconv = jops.label_components(occ, 2.0, CAP)
        census = jnp.where(occ, jops.label_census(labels, jnp.where(occ, vals, 0), ncv), 0)
        return (lax.all_to_all(a2a, "grid", 1, 0, tiled=True),
                lax.all_to_all(a2a, "grid", 1, 2, tiled=True),
                labels, conv, capped, cconv, census,
                _quirk_sure_counts_sharded(bg, sure, 1, "grid", N),
                _quirk_sure_counts_sharded(bg, sure, 2, "grid", N),
                jops.raycast_dda(jgrid, *rays, 8.0))

    out = (SPEC, SPEC, SPEC, P(), SPEC, P(), SPEC, SPEC, SPEC, SPEC)
    args = [jnp.asarray(prims[k]) for k in ("a2a", "occ", "vals", "bg", "sure")]
    res = jax.jit(shard_map(body, mesh=mesh, in_specs=(SPEC,) * 5, out_specs=out,
                            check_vma=False))(*args)
    names = ("a2a_10", "a2a_12", "labels", "conv", "capped_labels", "capped_conv", "census",
             "quirk_1", "quirk_2", "dda")
    out = {k: np.array(v) for k, v in zip(names, res)}  # writable copies
    out["dda_dense"] = np.asarray(jax.jit(lambda *a: jraycast_dda(jgrid, *a, 8.0))(*rays))
    return out


@pytest.mark.parametrize("split,concat", [(1, 0), (1, 2)])
def test_all_to_all_matches_jax(comm, prims, jax_prims, split, concat):
    """JAX's tiled all_to_all: shard i gets block i of every shard's split,
    in rank order; n - 1 copies per shard (its own block is not copied)."""
    slabs = _shards(prims["a2a"])
    comm.reset_copies()
    got = comm.run(lambda rank: comm.all_to_all(slabs[rank], split, concat))
    assert comm.copies == N * (N - 1)
    want = np.split(jax_prims[f"a2a_{split}{concat}"], N)
    for rank in range(N):
        np.testing.assert_array_equal(got[rank].numpy(), want[rank])


@pytest.mark.parametrize("max_iters", [128, CAP], ids=["fixpoint", "capped"])
def test_label_components_sharded(comm, prims, jax_prims, max_iters):
    """Global flat ids, halo'd K2 sweeps to the global fixpoint: labels and
    ``converged`` equal JAX's sharded while_loop's, and labels, converged
    and the sweep count equal the port's dense labelling, also when the cap
    stops the sweeps first."""
    occ = prims["occ"]
    ops = ZShardOps(comm, N)
    slabs = _shards(occ)
    out = comm.run(lambda rank: ops.label_components(slabs[rank], 2.0, max_iters))
    labels = torch.cat([o[0] for o in out])
    d_labels, d_conv, d_sweeps = label_components(torch.from_numpy(occ), 2.0, max_iters)
    assert torch.equal(labels, d_labels)
    key = "" if max_iters == 128 else "capped_"
    np.testing.assert_array_equal(labels.numpy(), jax_prims[key + "labels"])
    for _, conv, sweeps in out:
        assert bool(conv) == bool(d_conv) == bool(jax_prims[key + "conv"])
        assert int(sweeps) == int(d_sweeps)
    if max_iters == CAP:  # the cap binds
        assert not bool(d_conv) and int(d_sweeps) == CAP
    else:  # the fixpoint takes many sweeps
        assert bool(d_conv) and int(d_sweeps) > 2 * CAP


def test_label_census_sharded(comm, prims, jax_prims):
    """K15b-6a's plain version around the psum: the census JAX's sharded
    label_census reads back, and the flags (any occupied, any sure) OR-ed
    over the shards, equal the dense K13a's."""
    occ, vals = prims["occ"], prims["vals"]
    ops = ZShardOps(comm, N)
    labels = _shards(jax_prims["labels"])
    o, v = _shards(occ), _shards(vals)
    ncv = int(np.prod(COARSE))
    out = comm.run(lambda rank: ops.label_census(labels[rank], v[rank], o[rank], ncv, 5.0))
    cell = torch.cat([c for c, _ in out])
    np.testing.assert_array_equal(cell.numpy(), jax_prims["census"])
    d_cell, d_flags = DENSE.label_census(torch.from_numpy(jax_prims["labels"]),
                                         torch.from_numpy(vals), torch.from_numpy(occ), ncv, 5.0)
    assert torch.equal(cell, d_cell)
    for _, flags in out:
        assert torch.equal(flags, d_flags)
    assert bool(d_flags[1]) and int((d_cell >= 5).sum()) > 0


@pytest.mark.parametrize("lsz", [1, 2])
def test_quirk_counts_sharded(comm, prims, jax_prims, lsz):
    """K15b-6b's plain version (gathered column sums, a psum'd rank table):
    JAX's sharded quirk counts and the port's dense K13b plain version."""
    bg, sure = prims["bg"], prims["sure"]
    b, s = _shards(bg), _shards(sure)
    got = torch.cat(comm.run(lambda rank: quirk_sure_counts_sharded(b[rank], s[rank], lsz,
                                                                    comm)))
    np.testing.assert_array_equal(got.numpy(), jax_prims[f"quirk_{lsz}"])
    assert torch.equal(got, quirk_sure_counts_plain(torch.from_numpy(bg), torch.from_numpy(sure),
                                                    lsz))


def test_dda_sharded(comm, prims, jax_prims):
    """K15b-6c's plain version: every shard walks every ray and keeps its
    slab's chords; equal to the dense rows, JAX's and the port's, and to
    JAX's sharded DDA within DDA_ATOL."""
    grid = GridSpec.from_config(_cfg())
    rays = [torch.from_numpy(a) for a in prims["rays"]]
    ops = ZShardOps(comm, N)
    got = torch.cat(comm.run(lambda rank: raycast_dda_slab(grid, *rays, 8.0,
                                                           ops.slab(grid.nz))))
    np.testing.assert_array_equal(got.numpy(), jax_prims["dda_dense"])
    assert torch.equal(got, raycast_dda_plain(grid, *rays, 8.0))
    np.testing.assert_allclose(got.numpy(), jax_prims["dda"], rtol=0, atol=DDA_ATOL)
    assert int((got > 0).sum()) > 1000


@pytest.mark.parametrize("new_rule", [True, False], ids=["new_rule", "old_rule"])
def test_dda_update_sharded(comm, prims, new_rule):
    """The exact raycast through ``ops``: the slab's DDA and K12's EMA, the
    old rule's max over the shards, equal the dense update."""
    grid = GridSpec.from_config(_cfg())
    rng = np.random.default_rng(31)
    vals = rng.uniform(-900.0, 0.0, grid.shape).astype(np.float32)
    had = rng.random(grid.shape) < 0.05
    rays = [torch.from_numpy(a) for a in prims["rays"]]
    ema = RayEma(new_rule, 0.25, 1.0, 0.5, -1000.0)
    want = DENSE.raycast_dda_update_(grid, torch.from_numpy(vals.copy()), torch.from_numpy(had),
                                     *rays, 8.0, ema)
    ops = ZShardOps(comm, N)
    v, h = _shards(vals), _shards(had)
    got = torch.cat(comm.run(lambda rank: ops.raycast_dda_update_(
        grid, v[rank].clone(), h[rank], *rays, 8.0, ema)))
    assert torch.equal(got, want)
    assert int((got != torch.from_numpy(vals)).sum()) > 1000


@pytest.mark.parametrize("quirk", [False, True], ids=["census", "counted_indexing"])
@pytest.mark.parametrize("max_bg", [0.8, 1.5], ids=["leaf1_halo1", "leaf2_halo3"])
def test_run_sepclusters_exact_sharded(comm, max_bg, quirk):
    """The exact sepclusters stage on the slabs (components, census, quirk
    counts, and K13c on the coarse arrays with the neighbours' rows through
    its z window) equals the dense stage: grid, safe, sure_sufficient,
    converged and the sweep count.  At 1.5 m the leaf is 2 and the ball's
    3 rows need 2 coarse rows of halo, past the slab's 2: two hops."""
    rng = np.random.default_rng(41)
    cfg = _cfg(sepclusters_exact_census=True, compat_counted_indexing=quirk,
               sepclusters_max_bg_distance=max_bg)
    dyn = DynParams()
    shape = cfg.grid_shape
    # a sure ground block under sparse unsure background, seams everywhere
    vals = np.where(rng.random(shape) < 0.01, -100.0, -800.0).astype(np.float32)
    vals[:3] = 500.0
    prev = torch.tensor(False)
    want = run_sepclusters_exact(cfg, dyn, torch.from_numpy(vals), 3.0, prev)
    ops = ZShardOps(comm, N)
    v = _shards(vals)
    out = comm.run(lambda rank: run_sepclusters_exact(cfg, dyn, v[rank], 3.0, prev, ops=ops))
    assert torch.equal(torch.cat([o.grid for o in out]), want.grid)
    assert torch.equal(torch.cat([o.safe for o in out]), want.safe)
    for o in out:
        for f in ("sure_bg_sufficient", "converged", "label_sweeps"):
            assert torch.equal(getattr(o, f), getattr(want, f)), f
    assert int((want.grid != torch.from_numpy(vals)).sum()) > 100 and bool(want.safe.any())


def test_hascloseto_split_sharded(comm):
    """The hasCloseTo box's close/far split on the slabs, with its halo of
    ceil(r) rows, equals the dense split on a sparse map whose seeds cross
    the seams (pooled on the bare slabs, the box would miss some)."""
    rng = np.random.default_rng(51)
    cfg, dyn = _cfg(compat_hascloseto_bounds=True), DynParams()
    shape = cfg.grid_shape
    vals = np.where(rng.random(shape) < 0.005, 10.0, -1000.0).astype(np.float32)
    counts = (rng.random(shape) < 0.003).astype(np.int32)
    prev = torch.tensor(True)
    want = split_and_update(cfg, dyn, torch.from_numpy(vals), torch.from_numpy(counts), prev)
    ops = ZShardOps(comm, N)
    v, c = _shards(vals), _shards(counts)
    out = comm.run(lambda rank: split_and_update(cfg, dyn, v[rank], c[rank], prev, ops))
    for f in ("grid", "close", "far", "labels"):
        assert torch.equal(torch.cat([getattr(o, f) for o in out]), getattr(want, f)), f
    bare = torch.cat([hascloseto_pool_any(torch.from_numpy(x.numpy() > -300.0), 3.0)
                      for x in v])
    assert int((bare != hascloseto_pool_any(torch.from_numpy(vals > -300.0), 3.0)).sum()) > 0


# ---- the transposed z cones (K15b-4b) ------------------------------------------


@pytest.fixture(scope="module")
def sweep_case():
    grid = GridSpec.from_config(_cfg())
    blockers = np.random.default_rng(3).random(grid.shape) < 0.03
    return grid, blockers, np.array([1.0, -2.0, 9.0], np.float32)


@pytest.fixture(scope="module")
def jax_transposed(mesh, sweep_case):
    """JAX's transposed sharded sweep at tests/test_grid_step.py's bounds
    (None, 5.0), one program."""
    _, blockers, origin = sweep_case
    jcfg = _jcfg()
    jgrid = JGrid.from_config(jcfg)
    jops = JZShardOps("grid", N, zcone_mode="transpose")
    rot = jnp.eye(3, dtype=jnp.float32)

    def body(b):
        return tuple(jops.raycast_sweep(
            jgrid, b, jnp.asarray(origin), rot,
            max_distance=jnp.float32(20.0 if bound is None else bound),
            vertical_fov=jcfg.sensor.vertical_fov, v_rays=SENSOR["vertical_rays"],
            h_rays=SENSOR["horizontal_rays"], max_distance_bound=bound) for bound in (None, 5.0))

    res = jax.jit(shard_map(body, mesh=mesh, in_specs=(SPEC,), out_specs=(SPEC, SPEC),
                            check_vma=False))(jnp.asarray(blockers))
    return {None: np.asarray(res[0]), 5.0: np.asarray(res[1])}


def _sweep(comm, grid, blockers, origin, bound, mode):
    slabs = _shards(blockers, comm.n)
    out = comm.run(lambda rank: sweep_zsharded(grid, slabs[rank], origin, comm, bound, mode))
    _, x0, y0, rel_x, rel_y, _ = out[0]
    return (torch.cat([o[0] for o in out], dim=1), x0, y0, rel_x, rel_y,
            torch.cat([o[5] for o in out]))


@pytest.mark.parametrize("bound", [None, 5.0, 3.0], ids=["full_frame", "bound5", "bound3"])
def test_transposed_cones(comm, sweep_case, jax_transposed, bound):
    """ny = 33 over 8 shards: 5 rows each, the last 7 padded and pinned (at
    3.0 m the 29-row window pads 3).  T equals the dense K4 plain version
    and the pipelined cones bit for bit; the raylen is within the bf16
    bounds of JAX's transposed sweep."""
    grid, blockers, origin = sweep_case
    T6, x0, y0, rel_x, rel_y, rel_z = _sweep(comm, grid, blockers, origin, bound, "transpose")
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    assert (wy, wx) == ((29, 29) if bound == 3.0 else (33, 33))
    opw = torch.from_numpy(blockers)[:, y0:y0 + wy, x0:x0 + wx]
    assert torch.equal(T6, cone_sweep_plain(opw, rel_x, rel_y, rel_z))
    assert torch.equal(T6[4:], _sweep(comm, grid, blockers, origin, bound, "pipelined")[0][4:])
    if bound not in jax_transposed:
        return
    dist = 20.0 if bound is None else bound
    c = RayConsts.make(grid.voxel_size, dist, SENSOR["vertical_fov"], SENSOR["vertical_rays"],
                       SENSOR["horizontal_rays"])
    got = np.zeros(grid.shape, np.float32)
    got[:, y0:y0 + wy, x0:x0 + wx] = ray_window_plain(T6, None, rel_x, rel_y, rel_z,
                                                      torch.eye(3), c).numpy()
    want = jax_transposed[bound]
    assert np.array_equal(got > 0, want > 0) and (want > 0).sum() > 100
    d = np.abs(got - want)
    nz = want > 0
    assert np.all(d <= SWEEP_RTOL * np.abs(want))
    assert np.quantile(d[nz] / want[nz], 0.999) <= SWEEP_RTOL_P999
    assert d.max() <= SWEEP_MAX * want.max()


def test_transposed_cones_need_two_rows():
    """A shard needs 2 rows of the window's y for the 4-tap halo."""
    grid = GridSpec((0.0, 0.0, 0.0), (16, 5, 6), 0.5)
    slabs = [torch.zeros((2, 5, 6), dtype=torch.bool)] * N
    c8 = LocalComm(N, ["cpu"])
    origin = np.array([1.0, 1.0, 1.0], np.float32)
    with pytest.raises(ValueError, match=">= 2"):
        c8.run(lambda rank: sweep_zsharded(grid, slabs[rank], origin, c8, None, "transpose"))


# ---- the whole step -------------------------------------------------------------


@pytest.fixture(scope="module")
def scenario():
    """tests/test_grid_step.py test_exact_modes_bitexact_vs_unsharded's 6
    scans (numpy ranges), the pose and the port's LUT."""
    jlut = jmake_lut(_jcfg().sensor)
    pose = hover_pose((0.0, 0.0, 6.0))
    ground, target = Scene(ground_z=0.5), Scene(ground_z=0.5)
    target.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
    ranges = [render_scan(ground, jlut, pose)] * 4 + [render_scan(target, jlut, pose)] * 2
    return jlut, make_lut(_cfg().sensor), pose, ranges


def _port_run(scenario, cfg_kw, n_shards=None, **step_kw):
    """The port's step over the scenario, dense (``n_shards`` None) or
    grid-sharded (the state gathered after each scan)."""
    _, lut, pose, ranges = scenario
    cfg, dyn = _cfg(**cfg_kw), DynParams(raycast_weight_coefficient=0.5)
    st = init_state(cfg, dyn, device="cpu")
    st.grid[1] = 0.0  # the apriori ground plane, as tests/test_grid_step.py
    if n_shards is None:
        step = make_step_fn(cfg, lut, device="cpu", **step_kw)
    else:
        comm = LocalComm(n_shards, ["cpu"], timeout=120.0)
        step = make_grid_sharded_step(cfg, lut, comm, **step_kw)
        st = shard_state(st, comm)
    out = []
    for r in ranges:
        scan = ScanInput(ranges_mm=torch.from_numpy(r.astype(np.float32)),
                         intensity=torch.ones(r.size), pose=np.asarray(pose, np.float32))
        st, o = step(st, scan, dyn)
        got = st if n_shards is None else gather_state(st)
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


_MODES = {"exact": (EXACT, dict(raycast_mode="exact")),
          "exact_box": (BOXED, dict(raycast_mode="exact")),
          "transposed": ({}, {})}


@pytest.fixture(scope="module")
def dense_runs(scenario):
    return {m: _port_run(scenario, cfg_kw, **kw) for m, (cfg_kw, kw) in _MODES.items()}


@pytest.fixture(scope="module")
def sharded_runs(scenario):
    """The sharded step's runs by (mode, shards), each made once."""
    cache = {}

    def get(mode, n_shards):
        if (mode, n_shards) not in cache:
            cfg_kw, kw = _MODES[mode]
            kw = dict(zcone_mode="transpose") if mode == "transposed" else kw
            cache[mode, n_shards] = _port_run(scenario, cfg_kw, n_shards, **kw)
        return cache[mode, n_shards]

    return get


def test_dense_exact_matches_jax(scenario, dense_runs):
    """The reference the sharded exact step is held to, against JAX's dense
    exact step with the box (the tolerances of the module docstring)."""
    jlut, _, pose, ranges = scenario
    dyn = JDyn(raycast_weight_coefficient=0.5)
    step = jmake_step_fn(_jcfg(**BOXED), jlut, donate=False, raycast_mode="exact")
    st = jinit_state(_jcfg(**BOXED), dyn)
    st = st._replace(grid=st.grid.at[1].set(0.0))
    n_dets = 0
    for k, (r, p) in enumerate(zip(ranges, dense_runs["exact_box"])):
        scan = JScan(ranges_mm=jnp.asarray(r.astype(np.float32)),
                     intensity=jnp.ones(r.size, jnp.float32), pose=jnp.asarray(pose))
        st, o = step(st, scan, dyn.as_arrays())
        assert {f: int(p["diag"][f]) for f in DIAG_FIELDS} == {
            f: int(getattr(o.diag, f)) for f in DIAG_FIELDS}, f"scan {k}"
        pv, jv = p["detections"]["valid"].numpy(), np.asarray(o.detections.valid)
        assert np.array_equal(pv, jv), f"scan {k}"
        for f in ("id", "n_points"):
            assert np.array_equal(p["detections"][f].numpy()[pv],
                                  np.asarray(getattr(o.detections, f))[jv]), f"scan {k}: {f}"
        np.testing.assert_allclose(p["detections"]["position"].numpy()[pv],
                                   np.asarray(o.detections.position)[jv], atol=1e-3, rtol=0)
        np.testing.assert_allclose(p["detections"]["confidence"].numpy()[pv],
                                   np.asarray(o.detections.confidence)[jv], rtol=2e-3, atol=0)
        jg, pg = np.asarray(st.grid), p["state"]["grid"].numpy()
        fin = np.isfinite(jg)
        assert np.array_equal(fin, np.isfinite(pg)), f"scan {k}"
        assert np.abs(pg[fin] - jg[fin]).max() <= GRID_ATOL, f"scan {k}"
        n_dets += int(pv.sum())
    assert n_dets >= 1  # the floating target is found


@pytest.mark.parametrize("n_shards", [8, 2])
@pytest.mark.parametrize("mode", list(_MODES))
def test_sharded_step_bitexact_vs_dense(dense_runs, sharded_runs, mode, n_shards):
    """Every scan of the sharded step equals the dense step's bit for bit:
    the exact census with the counted indexing and the exact DDA, the same
    with the hasCloseTo box, and the sweep with the transposed z cones."""
    got = sharded_runs(mode, n_shards)
    _assert_bitequal(got, dense_runs[mode])
    assert sum(int(o["detections"]["valid"].sum()) for o in got) >= 1
    if mode != "transposed":  # the exact census ran and counted its sweeps
        assert all(int(o["diag"]["sep_sweeps"]) > 0 for o in got)


def test_transposed_step_matches_pipelined(scenario, sharded_runs):
    """At 2 shards the transposed and the pipelined z cones give the same
    step on every scan."""
    _assert_bitequal(sharded_runs("transposed", 2), _port_run(scenario, {}, 2))
