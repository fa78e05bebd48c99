"""The port's multi-stream fleet against the JAX fleet and against B
independent port nodes, at a small size on the CPU.

Config of tests/test_fleet.py's reset test (8 x 32 rays, an 8 x 8 x 8 m
area; background ratio 0.05 as its other tests), 4 streams, every stream
starting from one learned map (a port node's state after the apriori plane
and 30 empty scans, carried into both fleets: at 8 x 32 rays nothing is
detected in the first tens of scans of a cold map).  One script of 10
ticks drives both fleets: a different target and pose per stream, a NaN
rotation on stream 2 at tick 3 (a null scan), ``reset_stream(1)`` and
``load_apriori_map(plane, stream=1)`` before tick 7, and from tick 4 an
intensity image that gates every pixel of stream 3 under
``raycast_min_intensity`` (ticks 0-3 pass no intensity).

* Against ``vofod_tpu.runtime.fleet.FleetVoFOD`` (one JAX fleet on two
  virtual devices, compiled once for the module): per stream and tick the
  budgets of tests/test_torch_step.py ``_compare`` (diagnostics equal; ids
  and n_points equal, positions within 1e-3 m, confidence within
  ``CONF_RTOL``; finite masks equal, the grid within ``GRID_ATOL``) and
  ``n_pose_rejected`` equal; the JAX fleet's state carried in after tick 5
  with ``batched_state_from_numpy`` and the port's continuation held to
  the same budgets.
* Within the port, bit-equal: the fleet against 4 single-stream nodes fed
  the same scans (the null scan a direct step on zero ranges and the
  sentinel pose, the reset a fresh node with the plane stamped), ports of
  tests/test_fleet.py's reset test and tests/test_hostile_inputs.py's
  ``TestFleetLevel``, and one packed readback a tick.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.test_torch_step import CONF_RTOL, DIAG_FIELDS, GRID_ATOL, _compare
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.parallel.sharding import make_mesh
from vofod_tpu.pipeline.state import VoFODState as JState
from vofod_tpu.runtime.fleet import FleetVoFOD as JFleet
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu_torch.parallel.sharding import (
    batched_state_from_numpy, batched_state_to_numpy, init_batched_state, make_batched_step)
from vofod_tpu_torch.pipeline.state import ScanInput, init_state
from vofod_tpu_torch.runtime import fleet as fleet_mod
from vofod_tpu_torch.runtime.fleet import FleetVoFOD
from vofod_tpu_torch.runtime.node import VoFOD

B = 4
N_TICKS = 10
NAN_TICK, NAN_STREAM = 3, 2
RESET_TICK, RESET_STREAM = 7, 1
GATE_FROM, GATED_STREAM = 4, 3
CARRY_AT = 6  # the JAX state after ticks 0-5
MIN_INTENSITY = 0.5
N_WARM = 30
KW = dict(background_sufficient_points_ratio=0.05, max_clusters=4, max_far_voxels=128,
          max_queries=32, explore_submap=8, confidence_submap=8)
STATE_FIELDS = ("grid", "safe", "det_counter", "step", "sure_bg_sufficient", "bg_sufficient")


def _cfg(jax_side: bool = False):
    S, Bx, C = (JSensor, JBox, JConfig) if jax_side else (SensorConfig, Box, VoFODConfig)
    return C(sensor=S(vertical_rays=8, horizontal_rays=32, vertical_fov=np.deg2rad(90.0)),
             oparea=Bx((0.0, 0.0, 4.0), (8.0, 8.0, 8.0)), **KW)


def _dyn(jax_side: bool = False):
    return dataclasses.replace(JDyn() if jax_side else DynParams(),
                               raycast_min_intensity=MIN_INTENSITY)


def _plane():
    xs = np.arange(-3.0, 3.0, 0.4)
    gx, gy = np.meshgrid(xs, xs)
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)


def _tick_inputs(lut, k: int, poison: bool = True):
    """(ranges [B, N], poses [B, 4, 4], intensity [B, N] or None) of tick k:
    each stream its own scene and pose, the target moving with k; with
    ``poison`` the script's NaN rotation at NAN_TICK."""
    rs, ps = [], []
    for b in range(B):
        sc = Scene(ground_z=0.0)
        sc.add_sphere(center=(2.0 + 0.1 * b + 0.02 * k, 0.3 * b - 0.45, 3.0),
                      radius=1.0 - 0.05 * b)
        p = hover_pose((0.05 * b, -0.05 * b, 3.0 + 0.02 * k), yaw=0.05 * b)
        rs.append(render_scan(sc, lut, p))
        ps.append(p)
    poses = np.stack(ps).astype(np.float32)
    if poison and k == NAN_TICK:
        poses[NAN_STREAM, :3, :3] = np.nan  # finite translation, NaN rotation
    inten = None
    if k >= GATE_FROM:
        inten = np.ones((B, rs[0].size), np.float32)
        inten[GATED_STREAM] = 0.1  # every pixel under the gate
    return np.stack(rs), poses, inten


def _drive(fleet, lut, ticks, grid_of, start=0):
    """Run the script's ticks [start, ticks) on a fleet (either package);
    returns per tick a list of per-stream records for ``_compare``."""
    out = []
    for k in range(start, ticks):
        if k == RESET_TICK:
            fleet.reset_stream(RESET_STREAM)
            fleet.load_apriori_map(_plane(), stream=RESET_STREAM)
        r, p, inten = _tick_inputs(lut, k)
        msgs = fleet.process_scans(r, p, stamp=0.1 * k, intensity=inten)
        d = fleet.last_diag
        grids = grid_of(fleet)
        out.append([dict(
            diag={f: int(np.asarray(getattr(d, f))[b]) for f in DIAG_FIELDS},
            dets=[(x.id, x.n_points, np.array(x.position), x.confidence)
                  for x in msgs[b].detections],
            grid=np.array(grids[b], np.float32),
            rejected=int(fleet.n_pose_rejected[b])) for b in range(B)])
    return out


def _port_grids(fleet):
    return [s.grid.numpy() for s in fleet.state]


@pytest.fixture(scope="module")
def warm():
    """The learned map every stream starts from: a port node's state after
    the apriori plane and N_WARM empty scans, as JAX's batched numpy layout."""
    node = VoFOD(_cfg(), _dyn(), device="cpu")
    node.load_apriori_map(_plane())
    pose = hover_pose((0.0, 0.0, 3.0))
    empty = render_scan(Scene(ground_z=0.0), node.lut, pose)
    for _ in range(N_WARM):
        node.process_scan(empty, None, pose)
    return batched_state_to_numpy([node.state] * B)


@pytest.fixture(scope="module")
def jax_run(warm):
    """The JAX fleet through the script from the learned map: its records
    and its state after CARRY_AT ticks (numpy, batched layout)."""
    fleet = JFleet(_cfg(True), _dyn(True), n_streams=B, mesh=make_mesh(2))
    sharded = NamedSharding(fleet.mesh, P("data"))
    fleet.state = JState(**{k: jax.device_put(v, sharded) for k, v in warm.items()})
    first = _drive(fleet, fleet.lut, CARRY_AT, lambda f: np.asarray(jax.device_get(f.state.grid)))
    carried = {k: np.array(v) for k, v in jax.device_get(fleet.state)._asdict().items()}
    rest = _drive(fleet, fleet.lut, N_TICKS, lambda f: np.asarray(jax.device_get(f.state.grid)),
                  start=CARRY_AT)
    return first + rest, carried, np.array(fleet.n_pose_rejected)


def _port_fleet(warm=None):
    """A port fleet with the plane stamped, or from the learned map."""
    fleet = FleetVoFOD(_cfg(), _dyn(), n_streams=B, device="cpu")
    if warm is None:
        fleet.load_apriori_map(_plane())
    else:
        fleet.state = batched_state_from_numpy(warm, "cpu")
    return fleet


@pytest.fixture(scope="module")
def port_run(warm):
    fleet = _port_fleet(warm)
    return _drive(fleet, fleet.lut, N_TICKS, _port_grids), fleet


@pytest.mark.parametrize("stream", range(B))
def test_fleet_against_jax_fleet(jax_run, port_run, stream):
    """Every tick of one stream within the parity budgets, through the null
    scan, the reset, the per-stream apriori map and the intensity gate."""
    ref, _, _ = jax_run
    port, _ = port_run
    dmax = 0.0
    for k in range(N_TICKS):
        p, r = port[k][stream], ref[k][stream]
        assert p["rejected"] == r["rejected"], f"tick {k}"
        dmax = max(dmax, _compare(p, r, k))
    assert dmax <= GRID_ATOL and CONF_RTOL > 0


def test_fleet_script_exercises_its_events(warm, jax_run, port_run):
    """The script does what it says: one null scan, a reset stream that
    restarts its counters, a gated stream whose map differs from the
    ungated ones', and detections to compare."""
    ref, _, rejected = jax_run
    port, fleet = port_run
    assert list(rejected) == list(fleet.n_pose_rejected) == [0, 0, 1, 0]
    steps = [N_WARM + N_TICKS, N_TICKS - RESET_TICK, N_WARM + N_TICKS, N_WARM + N_TICKS]
    assert [s.step for s in fleet.state] == steps
    with_dets = {b for tick in ref for b, r in enumerate(tick) if r["dets"]}
    assert {0, RESET_STREAM} <= with_dets, with_dets
    # the gate is live: the same scans without the intensity image end
    # elsewhere
    node = VoFOD(_cfg(), _dyn(), device="cpu")
    node.state = batched_state_from_numpy(warm, "cpu")[GATED_STREAM]
    for k in range(N_TICKS):
        r, p, _ = _tick_inputs(node.lut, k)
        node.process_scan(r[GATED_STREAM], None, p[GATED_STREAM])
    assert not np.array_equal(node.state.grid.numpy(), port[-1][GATED_STREAM]["grid"])
    assert not np.isnan(port[-1][NAN_STREAM]["grid"]).any()


def test_state_carried_from_jax_fleet(jax_run):
    """The JAX fleet's state after CARRY_AT ticks, carried in with
    batched_state_from_numpy: the round trip is exact, and the port's
    continuation stays within the budgets."""
    ref, carried, _ = jax_run
    fleet = FleetVoFOD(_cfg(), _dyn(), n_streams=B, device="cpu")
    fleet.state = batched_state_from_numpy(carried, "cpu")
    back = batched_state_to_numpy(fleet.state)
    for f, v in carried.items():
        assert np.array_equal(back[f], v) and back[f].dtype == v.dtype, f
    assert [s.step for s in fleet.state] == [N_WARM + CARRY_AT] * B
    port = _drive(fleet, fleet.lut, N_TICKS, _port_grids, start=CARRY_AT)
    for k in range(CARRY_AT, N_TICKS):
        for b in range(B):
            _compare(port[k - CARRY_AT][b], ref[k][b], k)


def _node_records(lut, warm):
    """The script through 4 single-stream port nodes from the learned map:
    the null scan as a direct step on zero ranges and the sentinel pose, the
    reset as a fresh node with the plane stamped.  Per tick: (messages,
    diagnostics, states)."""
    nodes = [VoFOD(_cfg(), _dyn(), device="cpu") for _ in range(B)]
    for n, st in zip(nodes, batched_state_from_numpy(warm, "cpu")):
        n.state = st
    sentinel = np.eye(4, dtype=np.float32)
    sentinel[:3, 3] = np.asarray(_cfg().oparea.lo, np.float32) - 1.0e6
    out = []
    for k in range(N_TICKS):
        if k == RESET_TICK:
            nodes[RESET_STREAM] = VoFOD(_cfg(), _dyn(), device="cpu")
            nodes[RESET_STREAM].load_apriori_map(_plane())
        r, p, inten = _tick_inputs(lut, k)
        tick = []
        for b, node in enumerate(nodes):
            rb, pb = r[b], p[b]
            if not np.isfinite(pb).all():
                rb, pb = np.zeros_like(rb), sentinel
            msg = node.process_scan(rb, None if inten is None else inten[b], pb)
            tick.append((msg.detections, node.last_diag,
                         {f: getattr(node.state, f) for f in STATE_FIELDS}))
        out.append(tick)
    return out


def _same_state(a, b, what):
    for f in STATE_FIELDS:
        x, y = getattr(a, f), b[f]
        assert (x == y if f == "step" else torch.equal(x, y)), f"{what}: state.{f}"


@pytest.fixture(scope="module")
def node_run(warm):
    return _node_records(_port_fleet().lut, warm)


@pytest.mark.parametrize("stream", range(B))
def test_fleet_bit_equal_to_single_stream_nodes(warm, node_run, stream):
    """Each stream of the fleet equals its own single-stream node bit for
    bit on every tick: detections, every diagnostic and the whole state."""
    fleet = _port_fleet(warm)
    nodes = node_run
    for k in range(N_TICKS):
        if k == RESET_TICK:
            fleet.reset_stream(RESET_STREAM)
            fleet.load_apriori_map(_plane(), stream=RESET_STREAM)
        r, p, inten = _tick_inputs(fleet.lut, k)
        msgs = fleet.process_scans(r, p, intensity=inten)
        dets, diag, state = nodes[k][stream]
        assert msgs[stream].detections == dets, f"tick {k}"
        assert msgs[stream].header.frame_id == f"stream{stream}"
        for f in dataclasses.fields(diag):
            assert np.array_equal(getattr(fleet.last_diag, f.name)[stream],
                                  getattr(diag, f.name)), f"tick {k}: diag.{f.name}"
        _same_state(fleet.state[stream], state, f"tick {k}")


class _FakeClock:
    """Stands in for the fleet module's ``time``: the test moves it."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def time(self) -> float:
        return self.now


def test_null_scan_stream(caplog, monkeypatch):
    """tests/test_hostile_inputs.py TestFleetLevel on the port: a NaN
    rotation makes that stream's tick a null scan, equal to a direct step
    on zero ranges and the sentinel pose; the stream stays NaN-free, every
    other stream is bit-unaffected, the rejection is counted per stream and
    logged once per throttle period.  The throttle reads a clock that the
    test advances, so the count does not depend on the host's speed."""
    clock = _FakeClock()
    monkeypatch.setattr(fleet_mod, "time", clock)
    lut = _port_fleet().lut
    runs = {}
    for poisoned in (True, False):
        fleet = _port_fleet()
        with caplog.at_level(logging.WARNING, logger="vofod_tpu_torch.fleet"):
            for k in range(NAN_TICK + 2):
                r, p, _ = _tick_inputs(lut, k, poison=poisoned)
                if poisoned and k == NAN_TICK + 1:
                    p[NAN_STREAM, 0, 3] = np.inf  # a second bad tick within the period
                msgs = fleet.process_scans(r, p)
                assert len(msgs) == B
                clock.now += 0.1 * fleet.pose_warn_period
        runs[poisoned] = fleet
    a, b = runs[True], runs[False]
    assert list(a.n_pose_rejected) == [0, 0, 2, 0] and list(b.n_pose_rejected) == [0] * B
    assert sum("non-finite pose" in m for m in caplog.messages) == 1
    assert not torch.isnan(a.state[NAN_STREAM].grid).any()
    for s in range(B):
        if s != NAN_STREAM:
            _same_state(a.state[s], vars(b.state[s]), f"stream {s}")
    assert not torch.equal(a.state[NAN_STREAM].grid, b.state[NAN_STREAM].grid)
    assert a.state[NAN_STREAM].step == b.state[NAN_STREAM].step  # counters advance

    # a bad tick once the period has passed logs a second line
    clock.now += a.pose_warn_period
    r, p, _ = _tick_inputs(lut, NAN_TICK + 2)
    p[NAN_STREAM, 1, 3] = np.nan
    with caplog.at_level(logging.WARNING, logger="vofod_tpu_torch.fleet"):
        a.process_scans(r, p)
    assert list(a.n_pose_rejected) == [0, 0, 3, 0]
    assert sum("non-finite pose" in m for m in caplog.messages) == 2

    # the null tick alone: the same as a direct step on the sentinel scan
    fleet, node = _port_fleet(), VoFOD(_cfg(), _dyn(), device="cpu")
    node.load_apriori_map(_plane())
    sentinel = np.eye(4, dtype=np.float32)
    sentinel[:3, 3] = np.asarray(_cfg().oparea.lo, np.float32) - 1.0e6
    for k in range(NAN_TICK + 1):
        r, p, _ = _tick_inputs(lut, k)
        fleet.process_scans(r, p)
        if k == NAN_TICK:
            node.process_scan(np.zeros_like(r[NAN_STREAM]), None, sentinel)
        else:
            node.process_scan(r[NAN_STREAM], None, p[NAN_STREAM])
    _same_state(fleet.state[NAN_STREAM], vars(node.state), "null scan")


def test_reset_stream_cold_starts_one_detector():
    """tests/test_fleet.py's reset test on the port: reset_stream(i) puts
    stream i back to init_state bit for bit, leaves the other streams
    untouched, restarts i's step counter; intensity-less ticks reuse one
    cached all-ones buffer."""
    fleet = _port_fleet()
    n_warm = 5
    for k in range(n_warm):
        r, p, _ = _tick_inputs(fleet.lut, k % NAN_TICK)
        fleet.process_scans(r, p)
    before = [{f: getattr(s, f) if f == "step" else getattr(s, f).clone() for f in STATE_FIELDS}
              for s in fleet.state]
    fleet.reset_stream(3)
    fresh = vars(init_state(_cfg(), _dyn(), device="cpu"))
    _same_state(fleet.state[3], fresh, "reset stream")
    for s in range(3):
        _same_state(fleet.state[s], before[s], f"stream {s}")
    assert fleet.state[3].step == 0 and fleet.state[0].step == n_warm
    r, p, _ = _tick_inputs(fleet.lut, 0)
    fleet.process_scans(r, p)
    assert [s.step for s in fleet.state] == [n_warm + 1] * 3 + [1]
    cached = fleet._ones_dev
    assert cached is not None and cached.shape == (B, r.shape[1])
    fleet.process_scans(r, p)
    assert fleet._ones_dev is cached
    fleet.reset_stream()
    for s in range(B):
        _same_state(fleet.state[s], fresh, f"reset all, stream {s}")
    with pytest.raises(IndexError):
        fleet.reset_stream(B)


def test_apriori_map_on_one_stream():
    """load_apriori_map(stream=i) stamps stream i's map only, at the
    single-stream node's voxels."""
    fleet = FleetVoFOD(_cfg(), _dyn(), n_streams=B, device="cpu")
    node = VoFOD(_cfg(), _dyn(), device="cpu")
    n = fleet.load_apriori_map(_plane(), stream=2)
    assert n == node.load_apriori_map(_plane()) > 0
    assert torch.equal(fleet.state[2].grid, node.state.grid)
    fresh = init_state(_cfg(), _dyn(), device="cpu").grid
    for s in (0, 1, 3):
        assert torch.equal(fleet.state[s].grid, fresh)


def test_one_packed_readback_a_tick(monkeypatch):
    """All streams' diagnostics and detections come back in one packed
    device-to-host copy a tick; ``last_diag`` holds [B] arrays."""
    calls = []
    real = fleet_mod._readback

    def counting(buf):
        calls.append(buf.numel())
        return real(buf)

    monkeypatch.setattr(fleet_mod, "_readback", counting)
    fleet = _port_fleet()
    for k in range(3):
        r, p, inten = _tick_inputs(fleet.lut, k + GATE_FROM)
        fleet.process_scans(r, p, intensity=inten)
        assert len(calls) == k + 1
    assert all(np.asarray(getattr(fleet.last_diag, f)).shape == (B,) for f in DIAG_FIELDS)
    assert len(set(calls)) == 1


def test_batched_step_and_state_layout():
    """make_batched_step runs each stream's row through the single-stream
    step; the batched numpy form is JAX's layout ([B, ...], step [B])."""
    cfg, dyn = _cfg(), _dyn()
    lut = _port_fleet().lut
    states = init_batched_state(cfg, dyn, 2, device="cpu")
    step = make_batched_step(cfg, lut, device="cpu")
    r, p, _ = _tick_inputs(lut, 0)
    r = torch.as_tensor(r[:2], dtype=torch.float32)
    scans = ScanInput(ranges_mm=r, intensity=torch.ones_like(r), pose=p[:2])
    states, outs = step(states, scans, dyn)
    assert len(outs) == 2 and [s.step for s in states] == [1, 1]
    arrs = batched_state_to_numpy(states)
    assert arrs["grid"].shape == (2,) + cfg.grid_shape and arrs["grid"].dtype == np.float32
    assert arrs["step"].shape == (2,) and arrs["step"].dtype == np.int32
    assert arrs["det_counter"].shape == (2,) and arrs["safe"].dtype == np.bool_
    with pytest.raises(ValueError, match="stream states"):
        step(states[:1], scans, dyn)


@pytest.mark.parametrize("kw,err", [
    (dict(grid_shards=2), ValueError),
    (dict(frontend_mode="prebinned"), ValueError),
    (dict(device="cuda"), RuntimeError),
])
def test_fleet_refuses(monkeypatch, kw, err):
    """A 2-D fleet whose grid (17 planes) does not split into the shards,
    and the prebinned ingest, are refused; a CUDA fleet where there is no
    CUDA raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {"device": "cpu", **kw}
    with pytest.raises(err):
        FleetVoFOD(_cfg(), _dyn(), n_streams=2, **kw)


# --- a null scan on a cold map: the port's fleet against JAX's ----------------
# A 2-stream fleet from a cold map (the apriori plane only), at 16 x 64 rays
# over a 16 x 16 x 7.5 m area, with a 12-scan cycle in the spirit of
# bench.py's (ground, a structure, a target orbiting above the sensor's own
# arc), stream b from scan 3 b, a NaN rotation on stream 1 at tick 4, for 20
# ticks.  At the default ray weight this size learns too slowly to detect in
# 20 ticks, so both fleets run at 10 times it (0.03): stream 1 first
# detects at tick 6 without the null scan and at tick 7 with it, in both
# packages.  Detection ids and n_points are equal tick for tick; positions
# within 1 cm and confidences within 1 % (measured 7 mm and <0.1 %: the
# larger ray weight moves the grid's bf16 rounding further, as in
# tests/test_torch_grid_step.py).
REPLAY_TICKS, REPLAY_NAN, REPLAY_WEIGHT, REPLAY_CYCLE = 20, (4, 1), 0.03, 12
REPLAY_POS_ATOL, REPLAY_CONF_RTOL = 1e-2, 1e-2


def _replay_cfg(jax_side: bool = False):
    S, Bx, C = (JSensor, JBox, JConfig) if jax_side else (SensorConfig, Box, VoFODConfig)
    return C(sensor=S(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)),
             oparea=Bx((0.0, 0.0, 3.75), (16.0, 16.0, 7.5)), max_clusters=8, max_far_voxels=512,
             max_queries=64, explore_submap=16, confidence_submap=8)


def _replay_cycle(lut):
    out = []
    for k in range(REPLAY_CYCLE):
        a = 2.0 * np.pi * k / REPLAY_CYCLE
        sc = Scene(ground_z=0.25)
        sc.add_box((5.0, 3.0, 0.25), (6.0, 4.0, 3.5))
        sc.add_sphere(center=(-3.0 + np.cos(a), -1.5 + np.sin(a), 4.5), radius=0.5)
        p = hover_pose((1.5 + 0.5 * np.cos(a), 0.5 * np.sin(a), 2.5 + 0.1 * np.sin(2 * a)),
                       yaw=0.1 * np.sin(a))
        out.append((render_scan(sc, lut, p), p))
    return out


def _replay(fleet, cycle, null: bool):
    """The replay's ticks on a fleet (either package): per tick and stream
    the detections (id, n_points, position, confidence)."""
    xs = np.arange(-6.0, 6.0, 0.4)
    gx, gy = np.meshgrid(xs, xs)
    fleet.load_apriori_map(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 0.25)], axis=1))
    out = []
    for k in range(REPLAY_TICKS):
        idx = [(3 * b + k) % REPLAY_CYCLE for b in range(2)]
        r = np.stack([cycle[i][0] for i in idx])
        p = np.stack([cycle[i][1] for i in idx]).astype(np.float32)
        if null and k == REPLAY_NAN[0]:
            p[REPLAY_NAN[1], :3, :3] = np.nan
        msgs = fleet.process_scans(r, p)
        out.append([[(d.id, d.n_points, np.array(d.position), d.confidence) for d in m.detections]
                    for m in msgs])
    return out, [int(x) for x in fleet.n_pose_rejected]


def test_null_scan_cold_start_against_jax():
    """A null scan before a cold stream's first detection: the port's fleet
    detects on the same ticks as JAX's fleet, with the same ids and
    n_points; the null scan costs stream 1 its one tick (first detection 7
    against 6 without it), in both packages."""
    port = FleetVoFOD(_replay_cfg(), DynParams(raycast_weight_coefficient=REPLAY_WEIGHT),
                      n_streams=2, device="cpu")
    cycle = _replay_cycle(port.lut)
    got, rejected = _replay(port, cycle, null=True)
    jfleet = JFleet(_replay_cfg(True), JDyn(raycast_weight_coefficient=REPLAY_WEIGHT),
                    n_streams=2, mesh=make_mesh(2))
    want, jrejected = _replay(jfleet, cycle, null=True)
    assert rejected == jrejected == [0, 1]
    for k, (a, b) in enumerate(zip(got, want)):
        for s in range(2):
            assert [d[:2] for d in a[s]] == [d[:2] for d in b[s]], f"tick {k} stream {s}"
            for x, y in zip(a[s], b[s]):
                np.testing.assert_allclose(x[2], y[2], atol=REPLAY_POS_ATOL, rtol=0)
                np.testing.assert_allclose(x[3], y[3], rtol=REPLAY_CONF_RTOL, atol=0)
    clean, _ = _replay(FleetVoFOD(_replay_cfg(), DynParams(
        raycast_weight_coefficient=REPLAY_WEIGHT), n_streams=2, device="cpu"), cycle, null=False)
    first = [[next(k for k, t in enumerate(run) if t[s]) for s in range(2)]
             for run in (clean, got, want)]
    assert first == [[7, 6], [7, 7], [7, 7]], first
