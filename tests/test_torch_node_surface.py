"""The node's runtime surface against the JAX node, at a small size.

The port's node (``vofod_tpu_torch.runtime.node.VoFOD`` on the CPU) and the
JAX node (``vofod_tpu.runtime.node.VoFOD``) are put in the same state (a
few port scans, carried over as numpy arrays), then:

* ``process_rangefinder`` under both validity rules: the same return
  values and the grid bit-equal (the one-voxel ``(v + score_point) / 2`` in
  float32), out-of-area and invalid ranges rejected;
* NPZ snapshots written by each package and read by the other, field for
  field with their dtypes;
* ``export_voxels`` equal;
* ``replay`` of a small NPZ equal to ``process_scan`` scan for scan;
* ``check_consistency`` true on a rendered scan, false on a perturbed one;
* ``profile_stages`` bit-equal to the fused node, with three routine
  durations and their START/END events;
* the ``trace_dir`` window writes its trace, also when it closes early, and
  the profiler stops even when writing the trace raises;
* the raw upload's staging bit-equal to the former per-scan conversion;
* the ingest probe's dict keys.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.pipeline.state import VoFODState as JState
from vofod_tpu.runtime.node import NodeOptions as JOptions, VoFOD as JNode
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.io.binner import probe_ingest_mode
from vofod_tpu_torch.io.msgs import ProfilingInfo
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan, save_scans_npz
from vofod_tpu_torch.io.staging import HostStaging
from vofod_tpu_torch.pipeline.state import state_to_numpy
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD

KW = dict(max_clusters=4, max_far_voxels=64, max_queries=16, explore_submap=8,
          confidence_submap=8)
SENSOR = dict(vertical_rays=8, horizontal_rays=32)
AREA = ((0.0, 0.0, 3.0), (8.0, 8.0, 6.0))
N_SCANS = 4


def _cfg(**change):
    return VoFODConfig(sensor=SensorConfig(**SENSOR), oparea=Box(*AREA), **KW, **change)


def _jcfg(**change):
    return JConfig(sensor=JSensor(**SENSOR), oparea=JBox(*AREA), **KW, **change)


def _scans(lut, n=N_SCANS):
    scene = Scene(ground_z=0.0)
    scene.add_box((5.0, 5.0, 0.0), (6.0, 6.0, 2.0))
    scene.add_sphere((2.0, 1.0, 3.0), 0.5)
    out = []
    for k in range(n):
        pose = hover_pose((1.0 + 0.1 * k, 1.0, 2.0 + 0.05 * k), yaw=0.1 * k)
        out.append((render_scan(scene, lut, pose), pose))
    return out


def _node(options=None, **change):
    node = VoFOD(_cfg(**change), DynParams(), options, device="cpu")
    for r, p in _scans(node.lut):
        node.process_scan(r, None, p)
    return node


@pytest.fixture(scope="module")
def scanned():
    return _node()


def _same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for f in a:
        x, y = np.asarray(a[f]), np.asarray(b[f])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f


def _jax_node(port, **change) -> JNode:
    j = JNode(_jcfg(**change), JDyn(), JOptions())
    arrays = state_to_numpy(port.state)
    j.state = JState(**{k: jnp.asarray(np.array(v)) for k, v in arrays.items()})
    j._host_step = port.state.step
    return j


@pytest.mark.parametrize("compat", [False, True])
def test_rangefinder_against_jax(scanned, compat):
    port = VoFOD(_cfg(compat_rangefinder_validity=compat), DynParams(), device="cpu")
    port.state = dataclasses.replace(scanned.state, grid=scanned.state.grid.clone())
    j = _jax_node(port, compat_rangefinder_validity=compat)
    pose = hover_pose((3.0, 4.0, 4.0))
    pose[:3, :3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)  # x axis down
    calls = [  # (range, min, max): valid; too short; too long (below the area);
        # reversed limits; valid
        (1.3, 0.1, 10.0), (2.7, 0.1, 10.0), (0.05, 0.1, 10.0), (12.0, 0.1, 10.0),
        (5.0, 8.0, 2.0), (3.3, 0.1, 10.0),
    ]
    got = []
    for rng, lo, hi in calls:
        a = port.process_rangefinder(rng, lo, hi, pose)
        b = j.process_rangefinder(rng, lo, hi, pose)
        assert a == b, (rng, lo, hi)
        got.append(a)
        assert np.array_equal(port.state.grid.numpy(), np.asarray(j.state.grid)), (rng, lo, hi)
    # the && quirk accepts a range outside the limits (only the 12 m hit then
    # falls outside the area)
    assert got == [True, True, compat, False, False, True]
    # one voxel per accepted hit, by the float32 formula
    changed = port.state.grid.numpy() != scanned.state.grid.numpy()
    assert 1 <= int(changed.sum()) <= sum(got)
    # out of the area: rejected, nothing written
    before = port.state.grid.clone()
    assert not port.process_rangefinder(1.0, 0.1, 10.0, hover_pose((30.0, 30.0, 4.0)))
    assert torch.equal(before, port.state.grid)


def test_rangefinder_float32_update(scanned):
    port = VoFOD(_cfg(), DynParams(score_point=-0.7), device="cpu")
    port.state = dataclasses.replace(scanned.state, grid=scanned.state.grid.clone())
    before = port.state.grid.numpy().copy()
    assert port.process_rangefinder(1.0, 0.1, 10.0, hover_pose((3.0, 4.0, 4.0)))
    after = port.state.grid.numpy()
    (idx,) = zip(*np.nonzero(after != before))
    assert after[idx] == (before[idx] + np.float32(-0.7)) / np.float32(2.0)


def test_snapshots_across_packages(scanned, tmp_path):
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    scanned.save_snapshot(port_path)
    j = JNode(_jcfg(), JDyn(), JOptions())
    j.load_snapshot(port_path)
    _same_state(state_to_numpy(scanned.state), jax.device_get(j.state)._asdict())
    assert j._host_step == scanned.state.step
    j.save_snapshot(jax_path)
    back = VoFOD(_cfg(), DynParams(), device="cpu")
    back.load_snapshot(jax_path)
    _same_state(state_to_numpy(back.state), state_to_numpy(scanned.state))
    with np.load(jax_path) as zj, np.load(port_path) as zp:
        _same_state(dict(zj), dict(zp))
    # any other path is a checkpoint directory (runtime/checkpoint.py): it
    # round-trips, and its dense file is an NPZ the JAX node loads
    ckpt = str(tmp_path / "ckpt_dir")
    back.save_snapshot(ckpt)
    again = VoFOD(_cfg(), DynParams(), device="cpu")
    again.load_snapshot(ckpt)
    _same_state(state_to_numpy(again.state), state_to_numpy(scanned.state))
    j2 = JNode(_jcfg(), JDyn(), JOptions())
    j2.load_snapshot(str(tmp_path / "ckpt_dir" / "state.npz"))
    _same_state(state_to_numpy(scanned.state), jax.device_get(j2.state)._asdict())
    assert j2._host_step == scanned.state.step


@pytest.mark.parametrize("above", [True, False])
def test_export_voxels_against_jax(scanned, above):
    j = _jax_node(scanned)
    thr = float(np.median(scanned.state.grid.numpy()))  # the rays lowered half the voxels
    a, b = scanned.export_voxels(thr, above), j.export_voxels(thr, above)
    assert a.dtype == b.dtype and np.array_equal(a, b) and len(a) > 0


def test_replay_equals_process_scan(tmp_path):
    a = VoFOD(_cfg(), DynParams(), device="cpu")
    scans = _scans(a.lut)
    rng = np.random.default_rng(2)
    inten = rng.random((len(scans), a.cfg.sensor.n_points)).astype(np.float32)
    path = str(tmp_path / "rec.npz")
    save_scans_npz(path, np.stack([r for r, _ in scans]), np.stack([p for _, p in scans]),
                   intensity=inten)
    seen = []
    replayed = a.replay(path, before_scan=seen.append)
    b = VoFOD(_cfg(), DynParams(), device="cpu")
    direct = [b.process_scan(r, inten[k], p, 0.1 * k) for k, (r, p) in enumerate(scans)]
    assert seen == list(range(len(scans)))
    assert replayed == direct
    assert torch.equal(a.state.grid, b.state.grid)


@pytest.mark.parametrize("perturb", [False, True])
def test_check_consistency(perturb):
    from vofod_tpu.sensor import check_sensor_params as j_check

    node = VoFOD(_cfg(), DynParams(), NodeOptions(check_consistency=True), device="cpu")
    (r, p), = _scans(node.lut, 1)
    pts = node.lut.directions * (r.astype(np.float32) * 1e-3)[:, None] + node.lut.offsets
    if perturb:
        pts[np.argmax(r)] += np.float32(0.01)  # 1 cm off the LUT's ray
    node.process_scan(r, None, p, points_xyz=pts)
    assert node._sensor_checked and node._sensor_params_ok == (not perturb)
    assert node._sensor_params_ok == j_check(node.lut, pts, r)


def test_profile_stages_bit_equal_to_fused():
    fused = VoFOD(_cfg(), DynParams(), device="cpu")
    staged = VoFOD(_cfg(), DynParams(), NodeOptions(profile_stages=True), device="cpu")
    for r, p in _scans(fused.lut):
        assert fused.process_scan(r, None, p) == staged.process_scan(r, None, p)
        _same_state(state_to_numpy(fused.state), state_to_numpy(staged.state))
        for f in dataclasses.fields(fused.last_diag):
            assert np.array_equal(getattr(fused.last_diag, f.name),
                                  getattr(staged.last_diag, f.name)), f.name
        assert set(staged.last_stage_ms) == {"cnc", "raycasting", "sepbgclusters"}
        assert all(v > 0 for v in staged.last_stage_ms.values()), staged.last_stage_ms
    ev = staged.profiling.events
    routines = [e.routine_id for e in ev[::2]]
    assert routines == [ProfilingInfo.ROUTINE_CNC, ProfilingInfo.ROUTINE_RAYCASTING,
                        ProfilingInfo.ROUTINE_SEPBGCLUSTERS] * N_SCANS
    assert [e.event_type for e in ev] == [0, 1] * (3 * N_SCANS)
    assert all(b.stamp >= a.stamp for a, b in zip(ev, ev[1:]))
    # the fused node times CNC and marks the other two routines, as the JAX node
    assert [e.routine_id for e in fused.profiling.events[::2]] == routines


def test_trace_window(tmp_path):
    node = VoFOD(_cfg(), DynParams(),
                 NodeOptions(trace_dir=str(tmp_path / "w"), trace_skip=1, trace_scans=2),
                 device="cpu")
    states = []
    for r, p in _scans(node.lut, 3):
        node.process_scan(r, None, p)
        states.append(node._trace_state)
    assert states == ["pending", "on", "done"]
    assert os.path.getsize(node.trace_path) > 0 and not torch.autograd._profiler_enabled()
    # a recording shorter than the window: replay writes the trace
    early = VoFOD(_cfg(), DynParams(),
                  NodeOptions(trace_dir=str(tmp_path / "e"), trace_skip=0, trace_scans=10),
                  device="cpu")
    scans = _scans(early.lut, 1)
    path = str(tmp_path / "rec.npz")
    save_scans_npz(path, np.stack([r for r, _ in scans]), np.stack([p for _, p in scans]))
    early.replay(path)
    assert early._trace_state == "done" and os.path.getsize(early.trace_path) > 0


def test_trace_stops_when_writing_raises(tmp_path, monkeypatch):
    node = VoFOD(_cfg(), DynParams(),
                 NodeOptions(trace_dir=str(tmp_path), trace_skip=0, trace_scans=5), device="cpu")
    (r, p), = _scans(node.lut, 1)
    node.process_scan(r, None, p)
    assert node._trace_state == "on" and torch.autograd._profiler_enabled()

    def fail(self, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", fail)
    with pytest.raises(OSError):
        node.close_trace()
    assert node._trace_state == "done" and not torch.autograd._profiler_enabled()
    node.close_trace()  # idempotent


def test_raw_staging_equals_former_upload():
    """The raw path's staging (io/staging.py) gives the tensors the former
    ``torch.from_numpy(a.astype(np.float32))`` gave, for integer and float
    ranges and a float64 intensity; the two sets alternate, and a scan's
    tensors are not overwritten by the next scans."""
    node = VoFOD(_cfg(), DynParams(), device="cpu")
    n = node.cfg.sensor.n_points
    rng = np.random.default_rng(9)
    pose = np.eye(4, dtype=np.float32)
    inputs = [
        (rng.integers(0, 2**32 - 1, n, dtype=np.uint32), rng.random(n)),
        (rng.integers(0, 90000, n, dtype=np.uint32).astype(np.float64) + 0.37, None),
        (np.where(rng.random(n) < 0.1, np.nan, rng.random(n) * 1e4), rng.random(n) * 3.0),
    ]
    scans = [node._raw_scan(r, i, pose) for r, i in inputs]
    for (r, i), scan in zip(inputs, scans):
        former_r = torch.from_numpy(np.ascontiguousarray(r, np.float32))
        assert torch.equal(scan.ranges_mm, former_r) or (
            torch.equal(scan.ranges_mm.isnan(), former_r.isnan())
            and torch.equal(scan.ranges_mm.nan_to_num(), former_r.nan_to_num()))
        former_i = (torch.ones(n) if i is None
                    else torch.from_numpy(np.asarray(i, np.float32).reshape(-1)))
        assert torch.equal(scan.intensity, former_i)
    assert node._staging.turn == 1  # three scans: sets 0, 1, 0
    st = HostStaging(((3, torch.float32),), "cpu")
    assert not any(t.is_pinned() for s in st.sets for t in s)


def test_probe_keys():
    cfg = _cfg()
    node = VoFOD(cfg, DynParams(), device="cpu")
    for with_intensity in (True, False):
        mode, d = probe_ingest_mode(cfg, node.lut, None, "cpu", with_intensity=with_intensity)
        assert mode in ("raw", "prebinned")
        assert set(d) == {"t_raw_upload_ms", "t_prebinned_upload_ms", "t_host_bin_ms",
                          "scatter_ms", "scatter_from", "raw_bytes", "prebinned_bytes",
                          "device", "native_binner"}
        assert "mean of 10 warm" in d["scatter_from"]
        assert d["raw_bytes"] == cfg.sensor.n_points * 4 * (2 if with_intensity else 1)
        assert all(d[k] > 0 for k in ("t_raw_upload_ms", "t_prebinned_upload_ms",
                                      "t_host_bin_ms", "scatter_ms"))
