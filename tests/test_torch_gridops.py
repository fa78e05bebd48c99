"""The grid-sharded primitives of the port (vofod_tpu_torch/parallel/gridops.py
ZShardOps over a LocalComm of 8 CPU shards) against the JAX package's
ZShardOps run in ``shard_map`` on the 8-device CPU mesh, at the shapes of
tests/test_grid_step.py's ``sharded_config`` (32 x 33 x 33 grid, shard
height 4, explore halo 8: the multi-hop exchange runs).

Tolerances: the halo exchange, the fold, the compaction merge and the
demotion are integer / selection / min arithmetic, bit-equal.  The sharded
sweep's T is bit-equal to the port's dense K4 plain version; its raylen
against JAX's sweep carries the per-voxel bf16 bounds of
tests/test_torch_raycast.py (the two frameworks round the bf16 carry at
different points), and max |d| <= 2e-3 x max raylen (measured 1.29e-3 at
this sensor placement).  Each JAX program is compiled once per module.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, SensorConfig as JSensor, VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.ops import raycast as jr
from vofod_tpu.parallel.grid_step import make_grid_mesh
from vofod_tpu.parallel.gridops import DENSE as JDENSE, ZShardOps as JZShardOps
from vofod_tpu_torch.config import Box, SensorConfig, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.components import SENTINEL, label_components, sweeps_plain
from vofod_tpu_torch.ops.compaction import masked_compact
from vofod_tpu_torch.ops.explore import _pack_rows
from vofod_tpu_torch.ops.raycast import (
    RayConsts, RayEma, cone_sweep_plain, ray_window_plain, raycast_update_,
    raycast_update_zsharded, sweep_zsharded)
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.gridops import DENSE, ZShardOps

N = 8
KW = dict(background_sufficient_points_ratio=0.05, max_clusters=8, max_far_voxels=512,
          max_queries=64, explore_submap=16, confidence_submap=8)
SWEEP_RTOL, SWEEP_RTOL_P999 = 2.0**-4, 2.0**-5  # tests/test_torch_raycast.py
HALO_R = (2, 4, 6, 40)  # <= nzl, == nzl, between nzl and 2 nzl, past every shard
FOLD_R = (1, 2, 5, 8)
SPEC = P("grid", None, None)


def _configs():
    sensor = dict(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0))
    box = ((0.0, 0.0, 7.75), (16.0, 16.0, 15.5))
    return (JConfig(sensor=JSensor(**sensor), oparea=JBox(*box), **KW),
            VoFODConfig(sensor=SensorConfig(**sensor), oparea=Box(*box), **KW))


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == N
    return make_grid_mesh(N)


@pytest.fixture(scope="module")
def comm():
    return LocalComm(N, ["cpu"], timeout=60.0)


def _shards(x: np.ndarray):
    nzl = x.shape[0] // N
    return [torch.from_numpy(np.ascontiguousarray(x[i * nzl:(i + 1) * nzl])) for i in range(N)]


def _jax_sharded(mesh, fn, *args, out=SPEC):
    """``fn`` in shard_map over the mesh, jitted: one compile (shard_map
    run eagerly dispatches each op over the devices, ~10 times slower)."""
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=tuple(SPEC for _ in args), out_specs=out,
                             check_vma=False))(*args)


# ---- LocalComm ----------------------------------------------------------------


def test_collectives_in_rank_order(comm):
    """psum adds in rank order (a float sum whose order shows), all_gather
    stacks in rank order, ppermute follows its pairs, any / pmax reduce."""
    vals = [1e8, 1.0, -1e8, 1.0, 0.5, 0.25, 3.0, -7.0]

    def shard(rank):
        x = torch.tensor([vals[rank]], dtype=torch.float32)
        s = comm.psum(x)
        g = comm.all_gather(torch.tensor([rank, 10 * rank]))
        up = comm.ppermute(torch.tensor([rank]), [(i, i + 1) for i in range(N - 1)])
        anyv = comm.any(torch.tensor(rank == 5))
        mx = comm.pmax(torch.tensor(rank * 3 % 7))
        return s, g, up, anyv, mx

    out = comm.run(shard)
    want = np.float32(0.0)
    for v in vals:
        want = np.float32(want + np.float32(v))
    for rank, (s, g, up, anyv, mx) in enumerate(out):
        assert s.item() == want  # ((1e8 + 1) - 1e8) + ... in float32
        assert g.tolist() == [[i, 10 * i] for i in range(N)]
        assert (up is None) if rank == 0 else up.item() == rank - 1
        assert bool(anyv) and mx.item() == max(i * 3 % 7 for i in range(N))


def test_failing_shard_raises_without_hanging():
    """A shard that raises breaks the others' wait at once: run raises its
    exception, well within the timeout."""
    comm = LocalComm(4, ["cpu"], timeout=30.0)

    def shard(rank):
        comm.psum(torch.ones(1))
        if rank == 2:
            raise RuntimeError("shard 2 failed")
        comm.psum(torch.ones(1))  # the others wait here for shard 2
        return rank

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        comm.run(shard)
    assert time.perf_counter() - t0 < 10.0
    assert comm.run(lambda rank: rank) == [0, 1, 2, 3]  # usable again


def test_stuck_shard_times_out():
    """A shard that never reaches the collective the others wait at makes
    run raise within its timeout."""
    comm = LocalComm(2, ["cpu"], timeout=1.0)
    release = threading.Event()

    def shard(rank):
        if rank == 0:
            release.wait(5.0)
        return comm.psum(torch.ones(1))

    t0 = time.perf_counter()
    with pytest.raises((threading.BrokenBarrierError, TimeoutError)):
        comm.run(shard)
    release.set()
    assert time.perf_counter() - t0 < 4.0


def test_cpu_and_cuda_shards_refused():
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        LocalComm(2, ["cpu", "cuda"])
    with pytest.raises(ValueError, match="zcone_mode"):
        ZShardOps(LocalComm(2, ["cpu"]), 2, zcone_mode="bogus")


# ---- halo exchange / fold (K15b-1, K15b-2) -------------------------------------


def _global_ext(g: np.ndarray, z0: int, r: int, fill) -> np.ndarray:
    """The definition of the exchange: the grid's rows [z0 - r, z0 + 4 + r),
    ``fill`` past its edges."""
    pad = np.full((r,) + g.shape[1:], fill, g.dtype)
    return np.concatenate([pad, g, pad])[z0:z0 + 4 + 2 * r]


@pytest.fixture(scope="module")
def halo_grids():
    rng = np.random.default_rng(11)
    return {
        "f32": (rng.uniform(-5.0, 5.0, (32, 6, 7)).astype(np.float32), -1e30),
        "int32": (rng.integers(-100, 100, (32, 6, 7)).astype(np.int32), SENTINEL),
        "int8": (rng.integers(-3, 3, (32, 6, 7)).astype(np.int8), 0),
        "bool": (rng.random((32, 6, 7)) < 0.5, False),
    }


@pytest.fixture(scope="module")
def jax_halos(mesh, halo_grids):
    """JAX's sharded f32 exchange at r <= nzl, nzl < r < 2 nzl and r past
    every shard (one program)."""
    g, fill = halo_grids["f32"]
    ops = JZShardOps("grid", N)
    rs = (2, 6, 40)
    res = _jax_sharded(mesh, lambda x: tuple(ops.halo_exchange(x, r, jnp.float32(fill))
                                             for r in rs), jnp.asarray(g),
                       out=tuple(SPEC for _ in rs))
    return {r: np.asarray(a) for r, a in zip(rs, res)}


@pytest.mark.parametrize("r", HALO_R)
@pytest.mark.parametrize("dtype", ["f32", "int32", "int8", "bool"])
def test_halo_exchange(comm, halo_grids, jax_halos, dtype, r):
    """K15b-1's plain version through the exchange: every shard's extended
    slab is the grid's rows around it (multi-hop past the shard height, the
    fill past the global edges), and the same as JAX's sharded exchange."""
    g, fill = halo_grids[dtype]
    ops = ZShardOps(comm, N)
    slabs = _shards(g)
    got = comm.run(lambda rank: ops.halo_exchange(slabs[rank], r, fill))
    jax_out = np.split(jax_halos[r], N) if dtype == "f32" and r in jax_halos else None
    for rank in range(N):
        np.testing.assert_array_equal(got[rank].numpy(), _global_ext(g, 4 * rank, r, fill))
        if jax_out is not None:
            np.testing.assert_array_equal(got[rank].numpy(), jax_out[rank])


@pytest.fixture(scope="module")
def jax_folds(mesh):
    g = np.arange(32 * 4 * 4, dtype=np.float32).reshape(32, 4, 4) + 100.0
    ops = JZShardOps("grid", N)
    rs = (2, 5)

    def body(local):
        idx = jax.lax.axis_index("grid").astype(jnp.float32)
        return tuple(ops.halo_fold_min(
            jnp.minimum(ops.halo_exchange(local, r, jnp.float32(jnp.inf)), 50.0 - idx), r)
            for r in rs)

    res = _jax_sharded(mesh, body, jnp.asarray(g), out=tuple(SPEC for _ in rs))
    return g, {r: np.asarray(a) for r, a in zip(rs, res)}


@pytest.mark.parametrize("r", FOLD_R)
def test_halo_fold_min_cross_shard(comm, jax_folds, r):
    """tests/test_grid_step.py test_halo_fold_min_cross_shard: every shard
    stamps 50 - rank over its halo-extended view; the fold must min the
    stamps back from both sides, for every hop count and with the head and
    tail ranges overlapping (r >= shard height / 2)."""
    g, want_jax = jax_folds
    ops = ZShardOps(comm, N)
    slabs = _shards(g)

    def shard(rank):
        ext = ops.halo_exchange(slabs[rank], r, float("inf"))
        return ops.halo_fold_min(torch.minimum(ext, torch.tensor(50.0 - rank)), r)

    got = torch.cat(comm.run(shard)).numpy()
    want = g.copy()
    for i in range(N):
        want[max(0, 4 * i - r):4 * i + 4 + r] = np.minimum(want[max(0, 4 * i - r):4 * i + 4 + r],
                                                          50.0 - i)
    np.testing.assert_array_equal(got, want)
    if r in want_jax:
        np.testing.assert_array_equal(got, want_jax[r])


# ---- compaction merge, lookup, scatter ------------------------------------------


COMPACT_CASES = {"merge": (0.01, 64), "overflow_prefix": (0.4, 32)}


@pytest.fixture(scope="module")
def compact_cases(mesh):
    """The masks, and JAX's sharded compaction of the overflowing one (its
    merge and its prefix at once; one program)."""
    rng = np.random.default_rng(5)
    masks = {k: rng.random((32, 12, 12)) < p for k, (p, _) in COMPACT_CASES.items()}
    jops = JZShardOps("grid", N)
    cap = COMPACT_CASES["overflow_prefix"][1]
    res = _jax_sharded(mesh, lambda m: jops.compact(m, cap),
                       jnp.asarray(masks["overflow_prefix"]), out=(P(), P(), P()))
    return masks, [np.asarray(a) for a in res]


@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_merge(comm, compact_cases, case):
    """The per-shard K6 + merge equals the dense compaction, and JAX's
    sharded compact when the total overflows the capacity (the global
    prefix: each shard's part of it is a prefix of its own list)."""
    masks, jax_overflow = compact_cases
    mask, cap = masks[case], COMPACT_CASES[case][1]
    ops = ZShardOps(comm, N)
    slabs = _shards(mask)
    got = comm.run(lambda rank: ops.compact(slabs[rank], cap))[3]  # replicated
    dense = masked_compact(torch.from_numpy(mask), cap)
    for g, d in zip(got, dense):
        np.testing.assert_array_equal(g.numpy(), d.numpy())
    assert (int(got[2]) > cap) == (case == "overflow_prefix")
    if case == "overflow_prefix":
        for g, w in zip(got, jax_overflow):
            np.testing.assert_array_equal(g.numpy(), w)


def test_lookup_and_scatter_match_dense(comm):
    rng = np.random.default_rng(6)
    grid = GridSpec((0.0, 0.0, 0.0), (32, 5, 6), 0.5)
    dense = torch.from_numpy(rng.integers(0, 1000, grid.shape).astype(np.int32))
    fids = torch.from_numpy(rng.integers(0, grid.n_voxels, 200).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 3, 200).astype(np.int32))
    ops = ZShardOps(comm, N)
    slabs = _shards(dense.numpy())
    out = comm.run(lambda rank: (ops.lookup(slabs[rank], fids), ops.scatter_add(grid, fids, w)))
    assert torch.equal(out[0][0], DENSE.lookup(dense, fids))
    assert torch.equal(torch.cat([s for _, s in out]), DENSE.scatter_add(grid, fids, w))


# ---- label sweeps (K2 with the interior flag) ----------------------------------


@pytest.mark.parametrize("until_fixpoint", [False, True], ids=["fixed_sweeps", "gated"])
def test_sharded_sweeps_match_dense(comm, until_fixpoint):
    """The sharded K2 sweeps (halo per sweep, change flag over the interior
    rows, OR over the shards) give the dense labels AND the dense per-sweep
    flags: a flag over the halo rows would see changes the dense sweep does
    not, and move cc_iters / converged."""
    rng = np.random.default_rng(8)
    occ = torch.from_numpy(rng.random((32, 10, 10)) < 0.2)
    ops = ZShardOps(comm, N)
    slabs = _shards(occ.numpy())
    keys = torch.where(occ, torch.arange(occ.numel(), dtype=torch.int32).reshape(occ.shape),
                       SENTINEL)
    kslabs = _shards(keys.numpy())
    out = comm.run(lambda rank: ops.sweeps(kslabs[rank], slabs[rank], 3.0, 24, until_fixpoint))
    want, wflags = sweeps_plain(keys, occ, 3.0, 24, until_fixpoint)
    assert torch.equal(torch.cat([k for k, _ in out]), want)
    for _, flags in out:
        assert torch.equal(flags, wflags)
    assert bool(wflags[0]) and not bool(wflags[-1])  # the run converges inside the cap
    if until_fixpoint:  # the gated form is label_components' (the exact census's)
        lab, conv, n_run = label_components(occ, 3.0, 24)
        assert torch.equal(lab, want) and bool(conv)


def test_sharded_seeded_labels_and_reach_match_dense(comm):
    rng = np.random.default_rng(9)
    occ = torch.from_numpy(rng.random((32, 9, 9)) < 0.3)
    seed = torch.from_numpy(rng.random((32, 9, 9)) < 0.05)
    ops = ZShardOps(comm, N)
    o, s = _shards(occ.numpy()), _shards(seed.numpy())
    out = comm.run(lambda rank: (ops.label_seeded(o[rank], s[rank], 3.0, 4),
                                 ops.propagate_reach(o[rank], s[rank], 2.0, 8)))
    lab, reach, conv, iters = DENSE.label_seeded(occ, seed, 3.0, 4)
    safe, sconv = DENSE.propagate_reach(occ, seed, 2.0, 8)
    assert torch.equal(torch.cat([x[0][0] for x in out]), lab)
    assert torch.equal(torch.cat([x[0][1] for x in out]), reach)
    assert torch.equal(torch.cat([x[1][0] for x in out]), safe)
    for (_, _, c, it), (_, sc) in out:
        assert bool(c) == bool(conv) and int(it) == int(iters) and bool(sc) == bool(sconv)
    assert int(iters) == 4 and not bool(conv)  # the cap binds: the iteration count matters


# ---- demotion across shard boundaries (K8 + K15b-2) -------------------------------


def test_demote_spans_shard_boundaries(mesh, comm):
    """tests/test_grid_step.py test_demote_spans_shard_boundaries: demotion
    submaps (S = 16, halo 8 > shard height 4) reaching shards two hops away
    on both sides of the owner, folded back with K15b-2: equal to JAX's
    sharded and dense demotions."""
    rng = np.random.default_rng(42)
    nz, ny, nx, S, pad = 32, 16, 16, 16, 8
    vals = rng.uniform(0.5, 1.5, (nz, ny, nx)).astype(np.float32)
    q = np.array([[8, 7, 20], [7, 9, 6], [8, 8, 27]], np.int32)  # x, y, z
    corners = np.stack([q[:, 2] - pad, q[:, 1] - pad, q[:, 0] - pad], 1).astype(np.int32)
    reached = rng.random((3, S, S, S)) < 0.3
    demote = np.array([True, True, False])
    thr = 0.25
    jops = JZShardOps("grid", N)
    want = np.asarray(_jax_sharded(
        mesh, lambda v: jops.demote(v, jnp.asarray(reached), jnp.asarray(corners),
                              jnp.asarray(demote), jnp.float32(thr)), jnp.asarray(vals)))
    dense = np.asarray(jax.jit(JDENSE.demote)(jnp.asarray(vals), jnp.asarray(reached),
                                              jnp.asarray(corners), jnp.asarray(demote),
                                              jnp.float32(thr)))
    np.testing.assert_array_equal(want, dense)
    # K8's decision: query q in slot q, nothing connected, the gate = demote
    bits = _pack_rows(torch.from_numpy(reached))
    eye = torch.eye(3, dtype=torch.bool)
    args = (bits, torch.from_numpy(corners), eye, torch.zeros(3, dtype=torch.bool),
            torch.ones(3, dtype=torch.bool), torch.from_numpy(demote), torch.tensor(False), thr)
    ops = ZShardOps(comm, N)
    slabs = _shards(vals)
    out = comm.run(lambda rank: ops.demote(slabs[rank], *args))
    got = torch.cat([g for g, _, _ in out]).numpy()
    np.testing.assert_array_equal(got, want)
    _, n_dense, conn_dense = DENSE.demote(torch.from_numpy(vals), *args)
    assert all(int(n) == int(n_dense) > 0 for _, n, _ in out)
    assert all(torch.equal(c, conn_dense) and not c.any() for _, _, c in out)
    assert len(np.unique(np.nonzero(got != vals)[0] // 4)) >= 4  # landed past the owners


# ---- the sharded sweep (K15b-3, K15b-4a) -----------------------------------------


@pytest.mark.parametrize("bound", [None, 3.0], ids=["full_frame", "windowed"])
def test_sweep_zsharded_pipelined(comm, bound):
    """The port's sharded sweep on 8 shards, with and without the window
    bound (3 m crops the 33 x 33 frame to 29 x 29): T bit-equal to its dense
    K4 plain version on the same window.  With the window, raylen within
    the bf16 bounds of tests/test_torch_raycast.py of JAX's sweep (its dense
    one: tests/test_grid_step.py holds JAX's pipelined sharded sweep
    bit-equal to it, and compiling that takes minutes here); the full
    frame's port-against-JAX bound is tests/test_torch_raycast.py's, on the
    dense T this one equals bit for bit."""
    jcfg, cfg = _configs()
    jgrid, grid = JGrid.from_config(jcfg), GridSpec.from_config(cfg)
    blockers = np.random.default_rng(3).random(grid.shape) < 0.03
    origin = np.array([1.0, -2.0, 9.0], np.float32)
    rot = np.eye(3, dtype=np.float32)
    dist = bound if bound is not None else 20.0
    kw = dict(vertical_fov=cfg.sensor.vertical_fov, v_rays=cfg.sensor.vertical_rays,
              h_rays=cfg.sensor.horizontal_rays, max_distance_bound=bound)
    slabs = _shards(blockers)
    out = comm.run(lambda rank: sweep_zsharded(grid, slabs[rank], origin, comm, bound))
    T6 = torch.cat([o[0] for o in out], dim=1)
    _, x0, y0, rel_x, rel_y, _ = out[0]
    rel_z = torch.cat([o[5] for o in out])
    wy, wx = rel_y.shape[0], rel_x.shape[0]
    opw = torch.from_numpy(blockers)[:, y0:y0 + wy, x0:x0 + wx]
    assert torch.equal(T6, cone_sweep_plain(opw, rel_x, rel_y, rel_z))
    if bound is None:
        return
    assert (wx, wy) == (29, 29)
    want = np.asarray(jax.jit(lambda b: jr.raycast_sweep(
        jgrid, b, jnp.asarray(origin), jnp.asarray(rot), max_distance=jnp.float32(dist),
        **kw))(jnp.asarray(blockers)))
    c = RayConsts.make(grid.voxel_size, dist, cfg.sensor.vertical_fov, cfg.sensor.vertical_rays,
                       cfg.sensor.horizontal_rays)
    got = np.zeros(grid.shape, np.float32)
    got[:, y0:y0 + wy, x0:x0 + wx] = ray_window_plain(T6, None, rel_x, rel_y, rel_z,
                                                      torch.from_numpy(rot), c).numpy()
    assert np.array_equal(got > 0, want > 0) and (want > 0).sum() > 100
    d = np.abs(got - want)
    nz = want > 0
    assert np.all(d <= SWEEP_RTOL * np.abs(want))
    assert np.quantile(d[nz] / want[nz], 0.999) <= SWEEP_RTOL_P999
    # max |d| = 1.29e-3 x max raylen at this sensor placement: the bound is
    # 2e-3 (1e-3 in tests/test_torch_raycast.py, calibrated on its own
    # placements, where it measured 3.6e-4)
    assert d.max() <= 2e-3 * want.max()


def test_sweep_zsharded_non_square_window(comm):
    """x and y cones of different lengths (a 16 x 12 m area): the plain
    K15b-3 steps its two cone pairs apart; T still equals the dense K4's."""
    grid = GridSpec((0.0, 0.0, 0.0), (16, 25, 33), 0.5)
    blockers = torch.from_numpy(np.random.default_rng(4).random(grid.shape) < 0.04)
    origin = np.array([7.3, 5.1, 3.9], np.float32)
    c4 = LocalComm(4, ["cpu"])
    slabs = [blockers[4 * i:4 * i + 4] for i in range(4)]
    out = c4.run(lambda rank: sweep_zsharded(grid, slabs[rank], origin, c4, None))
    T6 = torch.cat([o[0] for o in out], dim=1)
    _, x0, y0, rel_x, rel_y, _ = out[0]
    rel_z = torch.cat([o[5] for o in out])
    assert (rel_x.shape[0], rel_y.shape[0]) == (33, 25)
    assert torch.equal(T6, cone_sweep_plain(blockers, rel_x, rel_y, rel_z))


@pytest.mark.parametrize("new_rule", [True, False], ids=["new_rule", "old_rule"])
def test_sharded_ray_update_matches_dense(comm, new_rule):
    """The sharded sweep + K5b on the slabs equals the dense K4 + K5b; under
    the old rule the window's max is taken over the shards (``gmax``)."""
    _, cfg = _configs()
    grid = GridSpec.from_config(cfg)
    rng = np.random.default_rng(12)
    blockers = torch.from_numpy(rng.random(grid.shape) < 0.03)
    vals = torch.from_numpy(rng.uniform(-900.0, 0.0, grid.shape).astype(np.float32))
    origin = np.array([1.0, -2.0, 9.0], np.float32)
    rot = torch.eye(3)
    ema = RayEma(new_rule, 0.25, 1.0, 0.5, -1000.0)
    kw = dict(max_distance=6.0, vertical_fov=cfg.sensor.vertical_fov,
              v_rays=cfg.sensor.vertical_rays, h_rays=cfg.sensor.horizontal_rays,
              max_distance_bound=6.0)
    want = raycast_update_(grid, vals.clone(), blockers, blockers, origin, rot, ema, **kw)
    slabs, vslabs = _shards(blockers.numpy()), _shards(vals.numpy())
    got = torch.cat(comm.run(lambda rank: raycast_update_zsharded(
        grid, vslabs[rank].clone(), slabs[rank], slabs[rank], origin, rot, ema, comm=comm,
        **kw)))
    assert torch.equal(got, want)
    assert int((got != vals).sum()) > 1000


def test_launch_counter_under_threads():
    """kernels.LAUNCHES is shared by the shards' threads: its updates take a
    lock, so none is lost under a short switch interval."""
    import sys

    from vofod_tpu_torch import kernels

    before = kernels.launch_counts()["halo_fold_min"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels._count("halo_fold_min")
                                                    for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads)
        assert kernels.launch_counts()["halo_fold_min"] - before == 16 * 2000
    finally:  # the counts are the process's: leave them as found for later modules
        with kernels._count_lock:
            kernels.LAUNCHES["halo_fold_min"] = before
