"""The port's 2-D streams x grid fleet (vofod_tpu_torch/parallel/grid_step.py
``make_fleet_grid_step``, runtime/fleet.py ``FleetVoFOD(grid_shards > 1)``,
the ``streams_zshards`` checkpoint layout, ``serve_fleet --grid-shards``)
against JAX's 2-D fleet and against the port's dense and 1-D grid steps, at
a small size on the CPU with ``LocalComm`` shards.

* Against ``vofod_tpu.parallel.grid_step.make_fleet_grid_step`` on a 2 x 4
  virtual mesh (built and run once for the module, in a thread started
  with it, so that XLA compiles it while the port-only tests run; the
  tests that compare with it come last), at tests/test_grid_step.py's
  ``sharded_config`` (32 x 33 x 33 grid), the port at 4 shards with the 4
  streams of tests/test_fleet_grid.py's ``_stream_scans``: per stream and
  tick the budgets of tests/test_torch_step.py ``_compare``.  Those budgets
  are set for the default ray weight, so both fleets run at it, from one
  learned map carried into both (a port node's state after the apriori
  plane and 4 empty scans at ray weight 0.5): from a cold map, or one
  learned at the default weight, the default weight detects nothing in 6
  ticks, and at weight 0.5 each scan's ray EMA moves the grid past
  ``_compare``'s budgets (tests/test_torch_grid_step.py).  The JAX state
  after 4 ticks is carried in through ``fleet_grid_state_from_numpy`` and
  the port's continuation held to the same budgets.
* Within the port, bit-equal per stream: the 2-D step against the dense
  step and the 1-D grid step (4 shards) on the same run; the prebinned 2-D
  step against the dense prebinned step; a port of
  ``test_diverging_schedule_lockstep`` (streams 2 and 3 leave the area on
  odd scans and start from a later step counter).
* The runtime wrapper: a port of ``test_fleet_runtime_grid_shards`` (the
  apriori plane stamped into every slab, a detection near (6, 0, 5) on
  stream 0 only, the ids of ``process_local_scans``) from a map learned by
  a node and carried in; a null scan, ``reset_stream`` +
  ``load_apriori_map(stream=)`` each held to a fresh node, and one packed
  readback a tick.
* Refusals (``sequential_explore``, as JAX; a batch or shard count that
  does not match the state; a grid that does not split), the checkpoint
  layout onto another z split and onto the 1-shard fleet's streams and
  back, and ``serve_fleet --grid-shards 4`` in-process.
"""

import dataclasses
import json
import logging
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_fleet_grid import B, N_SCANS, _batched_scan, _stream_scans
from tests.test_grid_step import sharded_config
from tests.test_torch_step import CONF_RTOL, DIAG_FIELDS, GRID_ATOL, _compare
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import DynParams as JDyn
from vofod_tpu.parallel.grid_step import init_fleet_grid_state as jinit_fleet
from vofod_tpu.parallel.grid_step import make_fleet_grid_mesh
from vofod_tpu.parallel.grid_step import make_fleet_grid_step as jmake_fleet
from vofod_tpu.pipeline.state import VoFODState as JState
from vofod_tpu.sensor import make_lut as jmake_lut
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.io.binner import HostBinner
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.grid_step import (
    fleet_grid_state_from_numpy, fleet_grid_state_to_numpy, gather_state, init_fleet_grid_state,
    make_fleet_grid_step, make_grid_sharded_step, shard_state)
from vofod_tpu_torch.parallel.sharding import batched_state_to_numpy, init_batched_state
from vofod_tpu_torch.pipeline.state import ScanInput, init_state, state_from_numpy
from vofod_tpu_torch.pipeline.state import state_to_numpy
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.runtime import checkpoint as ck
from vofod_tpu_torch.runtime import fleet as fleet_mod
from vofod_tpu_torch.runtime.fleet import FleetVoFOD
from vofod_tpu_torch.runtime.node import VoFOD
from vofod_tpu_torch.sensor import make_lut
from vofod_tpu_torch.tools import serve_fleet

SHARDS = 4
N_WARM, WARM_WEIGHT = 4, 0.5
CARRY_AT = 4  # the JAX state after ticks 0-3
STATE_FIELDS = ("grid", "safe", "det_counter", "step", "sure_bg_sufficient", "bg_sufficient")
SHARDED_KW = dict(background_sufficient_points_ratio=0.05, max_clusters=8, max_far_voxels=512,
                  max_queries=64, explore_submap=16, confidence_submap=8)
TINY_KW = dict(background_sufficient_points_ratio=0.05, max_clusters=4, max_far_voxels=128,
               max_queries=32, explore_submap=8, confidence_submap=8)


def _cfg(**kw) -> VoFODConfig:
    """The port's copy of tests/test_grid_step.py's ``sharded_config``."""
    return VoFODConfig(
        sensor=SensorConfig(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)),
        oparea=Box((0.0, 0.0, 7.75), (16.0, 16.0, 15.5)), **{**SHARDED_KW, **kw})


def _tiny_cfg() -> VoFODConfig:
    """8 x 32 rays over an 8 x 8 x 7.5 m area: a 16 x 17 x 17 grid."""
    return VoFODConfig(sensor=SensorConfig(vertical_rays=8, horizontal_rays=32,
                                           vertical_fov=np.deg2rad(90.0)),
                       oparea=Box((0.0, 0.0, 3.75), (8.0, 8.0, 7.5)), **TINY_KW)


def _scans(streams, t: int) -> ScanInput:
    r = torch.from_numpy(np.stack([streams[b][t][0] for b in range(len(streams))])
                         .astype(np.float32))
    p = np.stack([streams[b][t][1] for b in range(len(streams))]).astype(np.float32)
    return ScanInput(ranges_mm=r, intensity=torch.ones_like(r), pose=p)


def _one(streams, b: int, t: int) -> ScanInput:
    r = torch.from_numpy(streams[b][t][0].astype(np.float32))
    return ScanInput(ranges_mm=r, intensity=torch.ones_like(r),
                     pose=np.asarray(streams[b][t][1], np.float32))


def _dets(det: dict, b: int | None = None) -> list:
    """_compare's detection records from detection arrays (row b of a batch)."""
    row = {k: (v if b is None else v[b]) for k, v in det.items()}
    return [(int(row["id"][k]), int(row["n_points"][k]), np.array(row["position"][k]),
             float(row["confidence"][k])) for k in range(row["valid"].shape[0])
            if row["valid"][k]]


def _port_out(out) -> dict:
    """A port StepOutput as numpy: {"diag": {...}, "det": {...}}."""
    return dict(diag={f.name: getattr(out.diag, f.name).numpy()
                      for f in dataclasses.fields(out.diag)},
                det={f.name: getattr(out.detections, f.name).numpy()
                     for f in dataclasses.fields(out.detections)})


def _record(out: dict, grid: np.ndarray) -> dict:
    return dict(diag={f: int(out["diag"][f]) for f in DIAG_FIELDS}, dets=_dets(out["det"]),
                grid=np.array(grid, np.float32))


@pytest.fixture(scope="module")
def scen():
    """The streams' scans (numpy), both LUTs, and the learned map every
    stream starts from, in the batched numpy layout."""
    jcfg = sharded_config()
    streams = _stream_scans(jcfg, jmake_lut(jcfg.sensor))
    cfg = _cfg()
    lut = make_lut(cfg.sensor)
    step = make_step_fn(cfg, lut, device="cpu")
    warm = init_state(cfg, DynParams(), device="cpu")
    warm.grid[1] = 0.0  # the apriori ground plane, as tests/test_fleet_grid.py
    pose = hover_pose((0.0, 0.0, 6.0))
    empty = render_scan(Scene(ground_z=0.5), lut, pose)
    for _ in range(N_WARM):
        warm, _ = step(warm, _one([[(empty, pose)]], 0, 0),
                       DynParams(raycast_weight_coefficient=WARM_WEIGHT))
    one = state_to_numpy(warm)
    return dict(jcfg=jcfg, streams=streams, cfg=cfg, lut=lut,
                warm={k: np.stack([v] * B) for k, v in one.items()})


def _jax_fleet_run(scen):
    """JAX's 2-D fleet on the 2 x 4 mesh through the 6 ticks from the learned
    map: per tick its per-stream records, and its state after CARRY_AT
    ticks (numpy, batched layout)."""
    jcfg, streams = scen["jcfg"], scen["streams"]
    mesh = make_fleet_grid_mesh(2, SHARDS)
    jlut = jmake_lut(jcfg.sensor)
    step = jmake_fleet(jcfg, jlut, mesh)
    st = jinit_fleet(jcfg, JDyn(), B, mesh)
    st = JState(**{f: jax.device_put(jnp.asarray(scen["warm"][f]), getattr(st, f).sharding)
                   for f in st._fields})
    recs, carried = [], None
    for t in range(N_SCANS):
        if t == CARRY_AT:
            carried = {k: np.array(v) for k, v in jax.device_get(st)._asdict().items()}
        st, out = step(st, _batched_scan(streams, t), JDyn().as_arrays())
        grid = np.asarray(st.grid)
        diag = {f: np.asarray(getattr(out.diag, f)) for f in out.diag._fields}
        det = {f: np.asarray(getattr(out.detections, f)) for f in out.detections._fields}
        recs.append([dict(diag={f: int(diag[f][b]) for f in DIAG_FIELDS}, dets=_dets(det, b),
                          grid=grid[b]) for b in range(B)])
    return recs, carried


@pytest.fixture(scope="module", autouse=True)
def jax_future(scen):
    """JAX's 2-D fleet (:func:`_jax_fleet_run`), built and run once for the
    module's comparisons, in a thread started with the module: XLA compiles
    it (~50 s on this CPU) while the port-only tests run, and the tests
    that compare with it come last."""
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="jax-fleet") as pool:
        yield pool.submit(_jax_fleet_run, scen)


@pytest.fixture(scope="module")
def jax_run(jax_future):
    return jax_future.result()


@pytest.fixture(scope="module")
def port_run(scen):
    """The port's 2-D step over LocalComm(4) through the same ticks: per tick
    the per-stream outputs and the state in the batched numpy layout."""
    comm = LocalComm(SHARDS, ["cpu"])
    step = make_fleet_grid_step(scen["cfg"], scen["lut"], comm)
    states = fleet_grid_state_from_numpy(scen["warm"], comm)
    outs_by_tick, states_by_tick = [], []
    for t in range(N_SCANS):
        states, outs = step(states, _scans(scen["streams"], t), DynParams())
        outs_by_tick.append([_port_out(o) for o in outs])
        states_by_tick.append(fleet_grid_state_to_numpy(states))
    return outs_by_tick, states_by_tick


def _per_stream(scen, step, start):
    """One stream at a time through a single-stream step (dense or 1-D grid)
    from ``start(b)``: per tick the outputs and the states as numpy."""
    outs, states = [[None] * B for _ in range(N_SCANS)], [[None] * B for _ in range(N_SCANS)]
    for b in range(B):
        st = start(b)
        for t in range(N_SCANS):
            st, out = step(st, _one(scen["streams"], b, t), DynParams())
            outs[t][b] = _port_out(out)
            states[t][b] = state_to_numpy(st if not isinstance(st, list) else gather_state(st))
    return outs, states


@pytest.fixture(scope="module")
def dense_run(scen):
    step = make_step_fn(scen["cfg"], scen["lut"], device="cpu")
    return _per_stream(scen, step, lambda b: state_from_numpy(
        {k: v[b] for k, v in scen["warm"].items()}, "cpu"))


@pytest.fixture(scope="module")
def grid1d_run(scen):
    comm = LocalComm(SHARDS, ["cpu"])
    step = make_grid_sharded_step(scen["cfg"], scen["lut"], comm)
    return _per_stream(scen, step, lambda b: shard_state(state_from_numpy(
        {k: v[b] for k, v in scen["warm"].items()}, "cpu"), comm))


def _same_tick(a_out: dict, a_state: dict, b_out: dict, b_state: dict, what: str) -> None:
    for f in STATE_FIELDS:
        assert np.array_equal(a_state[f], b_state[f]), f"{what}: state.{f}"
    for part in ("diag", "det"):
        for f, v in a_out[part].items():
            assert np.array_equal(v, b_out[part][f]), f"{what}: {part}.{f}"


@pytest.mark.parametrize("stream", range(B))
@pytest.mark.parametrize("ref", ["dense", "grid1d"])
def test_bit_equal_to_single_stream_steps(port_run, dense_run, grid1d_run, ref, stream):
    """Each stream of the 2-D step equals the dense step and the 1-D grid
    step on that stream's scans, bit for bit, on every tick: the whole
    state, every diagnostic and every detection field."""
    outs, states = port_run
    r_outs, r_states = dense_run if ref == "dense" else grid1d_run
    for t in range(N_SCANS):
        _same_tick(outs[t][stream], {f: v[stream] for f, v in states[t].items()},
                   r_outs[t][stream], r_states[t][stream], f"{ref} tick {t}")


@pytest.fixture(scope="module")
def prebinned_run(scen):
    """The prebinned 2-D step (2 shards) and the dense prebinned step on 3
    ticks of host-binned scans: per tick and stream (2-D, dense) records."""
    cfg, lut, streams = scen["cfg"], scen["lut"], scen["streams"]
    hb = HostBinner(cfg, lut)
    comm = LocalComm(2, ["cpu"])
    step = make_fleet_grid_step(cfg, lut, comm, frontend_mode="prebinned")
    dense = make_step_fn(cfg, lut, device="cpu", frontend_mode="prebinned")
    states = fleet_grid_state_from_numpy(scen["warm"], comm)
    refs = [state_from_numpy({k: v[b] for k, v in scen["warm"].items()}, "cpu")
            for b in range(B)]
    out = []
    for t in range(3):
        bins = [hb.bin(streams[b][t][0], streams[b][t][1]).to_device("cpu") for b in range(B)]
        events = []
        states, outs = step(states, bins, DynParams(), upload_events=events)
        assert events == []  # CPU shards record no copy events
        now = fleet_grid_state_to_numpy(states)
        tick = []
        for b in range(B):
            refs[b], r = dense(refs[b], bins[b], DynParams())
            tick.append(((_port_out(outs[b]), {f: v[b] for f, v in now.items()}),
                         (_port_out(r), state_to_numpy(refs[b]))))
        out.append(tick)
    return out


@pytest.mark.parametrize("stream", range(B))
def test_prebinned_bit_equal_to_dense(prebinned_run, stream):
    """Each shard uploads only its slab of every stream's packed grid; each
    stream equals the dense prebinned step bit for bit."""
    for t, tick in enumerate(prebinned_run):
        (a_out, a_st), (b_out, b_st) = tick[stream]
        _same_tick(a_out, a_st, b_out, b_st, f"prebinned tick {t}")


@pytest.fixture(scope="module")
def diverging_run(scen):
    """tests/test_fleet_grid.py ``test_diverging_schedule_lockstep`` on the
    port (2 shards): streams 2 and 3 fly out of the area on odd scans and
    start from a later step counter, so raycast and sepclusters run on other
    ticks than streams 0 and 1'."""
    cfg, lut = _cfg(sepclusters_every=8), scen["lut"]
    dyn = DynParams(raycast_weight_coefficient=0.5)
    far = hover_pose((-40.0, 0.0, 6.0))
    far_scan = render_scan(Scene(ground_z=0.5), lut, far)
    streams = [list(s) for s in scen["streams"]]
    for b in (2, 3):
        streams[b] = [(far_scan, far) if t % 2 else streams[b][t] for t in range(N_SCANS)]
    step0 = [0, 0, cfg.sepclusters_every - 2, cfg.sepclusters_every - 2]
    comm = LocalComm(2, ["cpu"])
    step = make_fleet_grid_step(cfg, lut, comm)
    dense = make_step_fn(cfg, lut, device="cpu")
    states = init_fleet_grid_state(cfg, dyn, B, comm)
    refs = [init_state(cfg, dyn, device="cpu") for _ in range(B)]
    for b in range(B):
        refs[b].grid[1] = 0.0
        refs[b].step = step0[b]
        for sh in states[b]:
            sh.step = step0[b]
        states[b][0].grid[1] = 0.0
    out = []
    for t in range(N_SCANS):
        states, outs = step(states, _scans(streams, t), dyn)
        now = fleet_grid_state_to_numpy(states)
        tick = []
        for b in range(B):
            refs[b], r = dense(refs[b], _one(streams, b, t), dyn)
            tick.append(((_port_out(outs[b]), {f: v[b] for f, v in now.items()}),
                         (_port_out(r), state_to_numpy(refs[b]))))
        out.append(tick)
    return out, step0, cfg


@pytest.mark.parametrize("stream", range(B))
def test_diverging_schedule_lockstep(diverging_run, stream):
    """Streams whose raycast and sepclusters schedules diverge neither hang
    the shards' collectives nor perturb each other: each stream bit-equal
    to its dense step on every tick."""
    out, step0, cfg = diverging_run
    for t, tick in enumerate(out):
        (a_out, a_st), (b_out, b_st) = tick[stream]
        _same_tick(a_out, a_st, b_out, b_st, f"tick {t}")
    # the two groups fire sepclusters on different ticks within this run
    assert step0[0] % cfg.sepclusters_every == 0 != step0[2] % cfg.sepclusters_every
    assert step0[2] + N_SCANS > cfg.sepclusters_every >= N_SCANS
    assert int(out[-1][stream][0][1]["step"]) == step0[stream] + N_SCANS


def test_fleet_runtime_grid_shards():
    """tests/test_fleet_grid.py ``test_fleet_runtime_grid_shards`` on the
    port: FleetVoFOD(grid_shards=4) stamps the apriori plane into every
    slab as a node stamps its grid; from the map a node learned over 40
    empty scans (carried in with fleet_grid_state_from_numpy), a target in
    stream 0 only is detected near (6, 0, 5); process_local_scans returns
    both stream ids and the next detection id."""
    cfg = VoFODConfig(
        sensor=SensorConfig(vertical_rays=24, horizontal_rays=128,
                            vertical_fov=np.deg2rad(90.0)),
        oparea=Box((0.0, 0.0, 3.75), (30.0, 30.0, 15.5)),  # nz = 32
        background_sufficient_points_ratio=0.05, max_clusters=8, max_far_voxels=512,
        max_queries=64, explore_submap=16, confidence_submap=8)
    fleet = FleetVoFOD(cfg, DynParams(), n_streams=2, device="cpu", grid_shards=4)
    assert fleet.local_streams == [0, 1] and len(fleet.state) == 2
    assert all(len(s) == 4 and s[0].grid.shape == (8, 61, 61) for s in fleet.state)
    xs = np.arange(-5.0, 5.0, 0.4)
    gx, gy = np.meshgrid(xs, xs)
    plane = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)
    node = VoFOD(cfg, DynParams(), device="cpu")
    assert fleet.load_apriori_map(plane) == node.load_apriori_map(plane) > 0
    for s in fleet.state:
        assert torch.equal(gather_state(s).grid, node.state.grid)
    pose = hover_pose((0.0, 0.0, 3.0))
    empty = render_scan(Scene(ground_z=0.0), node.lut, pose)
    for _ in range(40):
        node.process_scan(empty, None, pose)
    fleet.state = fleet_grid_state_from_numpy(batched_state_to_numpy([node.state] * 2),
                                              fleet.comm)
    sc = Scene(ground_z=0.0)
    sc.add_sphere(center=(6.0, 0.0, 5.0), radius=0.5)
    tgt = render_scan(sc, node.lut, pose)
    poses = np.tile(pose, (2, 1, 1))
    mixed = np.stack([tgt, empty])
    msgs = None
    for _ in range(4):
        msgs = fleet.process_scans(mixed, poses)
    assert len(msgs[0].detections) == 1
    pos = np.array(msgs[0].detections[0].position)
    assert np.linalg.norm(pos - [6.0, 0.0, 5.0]) < 1.0
    assert len(msgs[1].detections) == 0
    local = fleet.process_local_scans(mixed, poses, stamp=1.0)
    assert sorted(local) == [0, 1]
    assert len(local[0].detections) == 1
    assert local[0].detections[0].id == msgs[0].detections[0].id + 1
    assert len(local[1].detections) == 0 and local[1].header.frame_id == "stream1"


def _tiny_tick(lut, k: int):
    """(ranges [2, N], poses [2, 4, 4]) of tick k: each stream its own
    target, moving with k."""
    rs, ps = [], []
    for b in range(2):
        sc = Scene(ground_z=0.0)
        sc.add_sphere(center=(2.0 + 0.1 * b + 0.05 * k, 0.3 * b - 0.45, 3.0), radius=0.8)
        p = hover_pose((0.05 * b, -0.05 * b, 3.0 + 0.02 * k), yaw=0.05 * b)
        rs.append(render_scan(sc, lut, p))
        ps.append(p)
    return np.stack(rs), np.stack(ps).astype(np.float32)


def _tiny_plane():
    xs = np.arange(-3.0, 3.0, 0.4)
    gx, gy = np.meshgrid(xs, xs)
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)


def test_null_scan_reset_and_one_readback(caplog, monkeypatch):
    """On a 2-shard 2-D fleet of 2 streams with the apriori plane: a NaN
    rotation on stream 1 at tick 2 is a null scan (equal to a node stepped
    on zero ranges and the sentinel pose; n_pose_rejected [0, 1]; logged);
    reset_stream(0) + load_apriori_map(plane, stream=0) before tick 3 is a
    fresh node with the plane (its step counter restarted); every tick
    each stream equals its node bit for bit, and each tick makes one
    packed readback."""
    calls = []
    real = fleet_mod._readback
    monkeypatch.setattr(fleet_mod, "_readback", lambda buf: calls.append(1) or real(buf))
    cfg, plane = _tiny_cfg(), _tiny_plane()
    fleet = FleetVoFOD(cfg, DynParams(), n_streams=2, device="cpu", grid_shards=2)
    fleet.load_apriori_map(plane)
    nodes = [VoFOD(cfg, DynParams(), device="cpu") for _ in range(2)]
    for n in nodes:
        n.load_apriori_map(plane)
    sentinel = np.eye(4, dtype=np.float32)
    sentinel[:3, 3] = np.asarray(cfg.oparea.lo, np.float32) - 1.0e6
    with caplog.at_level(logging.WARNING, logger="vofod_tpu_torch.fleet"):
        for k in range(5):
            if k == 3:
                fleet.reset_stream(0)
                fleet.load_apriori_map(plane, stream=0)
                nodes[0] = VoFOD(cfg, DynParams(), device="cpu")
                nodes[0].load_apriori_map(plane)
                assert torch.equal(gather_state(fleet.state[0]).grid, nodes[0].state.grid)
                assert [s[0].step for s in fleet.state] == [0, 3]
            r, p = _tiny_tick(fleet.lut, k)
            if k == 2:
                p[1, :3, :3] = np.nan
            msgs = fleet.process_scans(r, p)
            assert len(calls) == k + 1
            for b, node in enumerate(nodes):
                rb, pb = (np.zeros_like(r[b]), sentinel) if not np.isfinite(p[b]).all() \
                    else (r[b], p[b])
                msg = node.process_scan(rb, None, pb)
                assert msgs[b].detections == msg.detections, f"tick {k} stream {b}"
                for f in dataclasses.fields(node.last_diag):
                    assert np.array_equal(getattr(fleet.last_diag, f.name)[b],
                                          getattr(node.last_diag, f.name)), f.name
                st = gather_state(fleet.state[b])
                for f in STATE_FIELDS:
                    x, y = getattr(st, f), getattr(node.state, f)
                    assert x == y if f == "step" else torch.equal(x, y), f"tick {k}: {f}"
    assert list(fleet.n_pose_rejected) == [0, 1]
    assert sum("non-finite pose" in m for m in caplog.messages) == 1
    assert not torch.isnan(gather_state(fleet.state[1]).grid).any()
    assert [s[0].step for s in fleet.state] == [2, 5]
    with pytest.raises(IndexError):
        fleet.reset_stream(2)


def test_refusals():
    """The sequential explore is refused as JAX refuses it; a batch or a
    stream's shard count that does not match the state raises; a grid that
    does not split into the shards is refused."""
    cfg, lut = _tiny_cfg(), make_lut(_tiny_cfg().sensor)
    comm = LocalComm(2, ["cpu"])
    with pytest.raises(ValueError, match="sequential_explore"):
        make_fleet_grid_step(dataclasses.replace(cfg, sequential_explore=True), lut, comm)
    with pytest.raises(ValueError, match="sequential_explore"):
        FleetVoFOD(dataclasses.replace(cfg, sequential_explore=True), n_streams=2,
                   device="cpu", grid_shards=2)
    with pytest.raises(ValueError, match="not divisible"):
        make_fleet_grid_step(cfg, lut, LocalComm(3, ["cpu"]))
    step = make_fleet_grid_step(cfg, lut, comm)
    states = init_fleet_grid_state(cfg, DynParams(), 3, comm)
    r, p = _tiny_tick(lut, 0)
    rt = torch.as_tensor(r, dtype=torch.float32)
    two = ScanInput(ranges_mm=rt, intensity=torch.ones_like(rt), pose=p)
    with pytest.raises(ValueError, match="3 stream states for a batch of 2"):
        step(states, two, DynParams())
    with pytest.raises(ValueError, match="2 shard states"):
        step([states[0], states[1][:1]], two, DynParams())
    pre = make_fleet_grid_step(cfg, lut, comm, frontend_mode="prebinned")
    hb = HostBinner(cfg, lut)
    with pytest.raises(ValueError, match="batch of 1"):
        pre(states[:2], [hb.bin(r[0], p[0]).to_device("cpu")], DynParams())


def _scribbled(cfg, comm, seed: int):
    """A 2-D state of 2 streams with distinct content in every field."""
    rng = np.random.default_rng(seed)
    shape = (2,) + cfg.grid_shape
    arrays = dict(grid=rng.normal(size=shape).astype(np.float32), safe=rng.random(shape) > 0.5,
                  det_counter=np.array([7, 8], np.int32), step=np.array([9, 9], np.int32),
                  sure_bg_sufficient=np.array([True, False]), bg_sufficient=np.array([False, True]))
    return arrays, fleet_grid_state_from_numpy(arrays, comm)


def _same_np(a: dict, b: dict) -> None:
    for k, v in a.items():
        assert v.dtype == b[k].dtype and np.array_equal(v, b[k]), k


def test_checkpoint_layout_roundtrips(tmp_path):
    """``streams_zshards``: one NPZ a (stream, slab), the manifest's stream
    count and slab bounds; restored onto another z split, onto the 1-shard
    fleet's streams, and a ``streams`` checkpoint onto the 2-D state, all
    bit-equal; SnapshotManager and AsyncSaver take the layout."""
    cfg = _tiny_cfg()
    comm4, comm2 = LocalComm(4, ["cpu"]), LocalComm(2, ["cpu"])
    arrays, state = _scribbled(cfg, comm4, 3)
    p = str(tmp_path / "fleet2d")
    ck.save_state(p, state, layout="streams_zshards")
    m = ck.read_manifest(p)
    assert m["layout"] == "streams_zshards" and m["streams"] == 2
    assert m["grid_shape"] == list(cfg.grid_shape)
    assert [(e["name"], e["stream"], e["z0"], e["z1"]) for e in m["files"]] == [
        (f"stream_{b:03d}_shard_{i:03d}.npz", b, 4 * i, 4 * i + 4)
        for b in range(2) for i in range(4)]
    onto2 = ck.restore_state(p, init_fleet_grid_state(cfg, DynParams(), 2, comm2))
    assert [len(s) for s in onto2] == [2, 2]
    _same_np(fleet_grid_state_to_numpy(onto2), arrays)
    flat = ck.restore_state(p, init_batched_state(cfg, DynParams(), 2, device="cpu"))
    _same_np(batched_state_to_numpy(flat), arrays)
    q = str(tmp_path / "streams")
    ck.save_state(q, flat, layout="streams")
    back = ck.restore_state(q, init_fleet_grid_state(cfg, DynParams(), 2, comm4))
    _same_np(fleet_grid_state_to_numpy(back), arrays)
    with pytest.raises(ValueError, match="2 streams"):
        ck.restore_state(p, init_fleet_grid_state(cfg, DynParams(), 3, comm2))
    with pytest.raises(ValueError, match="streams"):
        ck.restore_state(p, init_state(cfg, device="cpu"))
    with pytest.raises(ValueError, match="streams_zshards"):
        ck.save_state(str(tmp_path / "x"), state)
    with ck.SnapshotManager(str(tmp_path / "mgr"), max_to_keep=1) as mgr:
        mgr.save(9, state, layout="streams_zshards")
        _same_np(fleet_grid_state_to_numpy(
            mgr.restore(init_fleet_grid_state(cfg, DynParams(), 2, comm2))), arrays)
    with ck.AsyncSaver() as saver:
        saver.save(str(tmp_path / "async"), state, layout="streams_zshards")
        saver.wait()
    _same_np(fleet_grid_state_to_numpy(ck.restore_state(
        str(tmp_path / "async"), init_fleet_grid_state(cfg, DynParams(), 2, comm4))), arrays)


def test_serve_fleet_grid_shards_cli(tmp_path, capsys, monkeypatch):
    """serve_fleet --grid-shards 4 --device cpu --sim --ticks 3 --json
    in-process, on a 16-plane grid: it builds the 2-D fleet and serves 3
    ticks of 2 streams."""
    files = {"det.yaml": "voxel_map: {voxel_size: 0.5}\n",
             "sen.yaml": "sensor: {vertical_fov_angle: 90.0, vertical_rays: 8, "
                         "horizontal_rays: 32}\n",
             "map.yaml": "operation_area:\n  offset: {x: 0.0, y: 0.0, z: 3.75}\n"
                         "  size: {x: 10.0, y: 10.0, z: 7.5}\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    built = []

    class Recorded(fleet_mod.FleetVoFOD):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(fleet_mod, "FleetVoFOD", Recorded)
    rc = serve_fleet.main([
        "--grid-shards", "4", "--device", "cpu", "--sim", "--ticks", "3", "--json",
        "--streams", "2", "--rate", "100", "--small-capacities",
        "--config", str(tmp_path / "det.yaml"), "--sensor", str(tmp_path / "sen.yaml"),
        "--map", str(tmp_path / "map.yaml")])
    assert rc == 0
    out = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.out.strip().splitlines()]
    summary = [ln for ln in lines if ln.get("summary")]
    assert len(summary) == 1 and summary[0]["ticks"] == 3 and summary[0]["streams"] == 2
    assert [ln["tick"] for ln in lines if "latency_ms" in ln] == [1, 2, 3]
    assert "3 ticks x 2 local streams" in out.err
    (fleet,) = built
    assert fleet.grid_shards == 4 and fleet.comm.n == 4
    assert all(len(s) == 4 and s[0].step == 3 for s in fleet.state)


# against JAX's 2-D fleet: last, once its run (started with the module) is in
@pytest.mark.parametrize("stream", range(B))
def test_against_jax_fleet_grid(jax_run, port_run, stream):
    """Every tick of one stream within _compare's budgets of JAX's 2-D fleet."""
    ref, _ = jax_run
    outs, states = port_run
    dmax = 0.0
    for t in range(N_SCANS):
        port = _record(outs[t][stream], states[t]["grid"][stream])
        dmax = max(dmax, _compare(port, ref[t][stream], t))
    assert dmax <= GRID_ATOL and CONF_RTOL > 0


def test_scenario_detects(jax_run, port_run):
    """Non-vacuity: both fleets detect the staggered targets, on more than
    one stream, and the streams' maps differ."""
    ref, _ = jax_run
    outs, states = port_run
    jax_dets = {b for tick in ref for b, r in enumerate(tick) if r["dets"]}
    port_dets = {b for tick in outs for b, o in enumerate(tick) if o["det"]["valid"].any()}
    assert len(jax_dets) >= 2 and port_dets == jax_dets, (jax_dets, port_dets)
    g = states[-1]["grid"]
    assert not np.array_equal(g[0], g[1])


def test_state_carried_from_jax_fleet_grid(scen, jax_run):
    """JAX's 2-D state after CARRY_AT ticks carried in with
    fleet_grid_state_from_numpy: the round trip is exact, and the port's
    continuation stays within _compare's budgets of JAX's ticks."""
    ref, carried = jax_run
    comm = LocalComm(SHARDS, ["cpu"])
    states = fleet_grid_state_from_numpy(carried, comm)
    back = fleet_grid_state_to_numpy(states)
    for f, v in carried.items():
        assert np.array_equal(back[f], v) and back[f].dtype == v.dtype, f
    assert back["step"].tolist() == [N_WARM + CARRY_AT] * B
    step = make_fleet_grid_step(scen["cfg"], scen["lut"], comm)
    for t in range(CARRY_AT, N_SCANS):
        states, outs = step(states, _scans(scen["streams"], t), DynParams())
        grid = fleet_grid_state_to_numpy(states)["grid"]
        for b in range(B):
            _compare(_record(_port_out(outs[b]), grid[b]), ref[t][b], t)
