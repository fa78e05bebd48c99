"""The prebinned ingest of the port: its host binner, the K15a frontend, the
prebinned step and the ingest probe, against vofod_tpu and against the
port's raw path.

Budgets (all bit-equal):

* the port's HostBinner, native and numpy, equals vofod_tpu's (native and
  numpy) on the same ranges, pose, intensity and mask: packed grid, active
  mask and both counts — hostile floats (NaN, negative, +inf ranges) and
  the clamp at 63 included;
* ``run_frontend_prebinned`` equals vofod_tpu's on the same binned scan;
* the native binner's counts (clamped to 63) and blockers equal the raw
  frontend's (K3's plain version + the airframe blockers);
* the prebinned step equals the raw step over 8 scans: grid, every
  detection field and every diagnostic;
* ``choose_ingest`` follows vofod_tpu's rule.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, SensorConfig as JSensor, VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.io import binner as jbinner
from vofod_tpu.pipeline.frontend import run_frontend_prebinned as j_run_frontend_prebinned
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.io import binner, native
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu_torch.pipeline.frontend import run_frontend, run_frontend_prebinned, unpack
from vofod_tpu_torch.pipeline.state import ScanInput, init_state
from vofod_tpu_torch.pipeline.step import make_step_fn
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD
from vofod_tpu_torch.sensor import make_lut

KW = dict(background_sufficient_points_ratio=0.05, max_clusters=8, max_far_voxels=512,
          max_queries=64, explore_submap=16, confidence_submap=8)
SENSOR = dict(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0))
OPAREA = ((0.0, 0.0, 5.75), (16.0, 16.0, 11.5))


def _cfgs(**kw):
    """The same small config in both packages (tests/test_binner.py's)."""
    d = dict(KW, **kw)
    t = VoFODConfig(sensor=SensorConfig(**SENSOR), oparea=Box(*OPAREA), **d)
    jd = {k: (JBox(v.offset, v.size) if isinstance(v, Box) else v) for k, v in d.items()}
    j = JConfig(sensor=JSensor(**SENSOR), oparea=JBox(*OPAREA), **jd)
    return t, j


def _scans(cfg, n=6):
    lut = make_lut(cfg.sensor)
    out = []
    for i in range(n):
        th = 0.3 * i
        pose = hover_pose((np.cos(th), np.sin(th), 7.0), yaw=0.12 * i)
        scene = Scene(ground_z=0.5)
        scene.add_box((4.5, -5.5, 0.0), (6.5, -3.5, 2.0))
        scene.add_sphere(center=(4.0, 0.4 * np.sin(th), 9.0), radius=0.7)
        out.append((render_scan(scene, lut, pose), pose))
    return lut, out


def _hostile(ranges: np.ndarray, seed: int) -> np.ndarray:
    """Float ranges with NaN, negative and +inf entries sprinkled in."""
    rng = np.random.default_rng(seed)
    r = ranges.astype(np.float32)
    idx = rng.permutation(r.size)
    r[idx[:20]] = np.nan
    r[idx[20:40]] = -5.0
    r[idx[40:60]] = np.inf
    return r


def _cases(cfg):
    """(ranges, pose, intensity, min_intensity) cases of one scene sequence."""
    lut, scans = _scans(cfg)
    inten = np.random.default_rng(1).random(cfg.sensor.n_points).astype(np.float32)
    inten[::7] = np.nan
    out = [(r, p, None, 0.0) for r, p in scans[:3]]
    out += [(_hostile(r, k), p, inten, 0.4) for k, (r, p) in enumerate(scans[3:])]
    return lut, out


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.packed), np.asarray(b.packed))
    np.testing.assert_array_equal(np.asarray(a.active), np.asarray(b.active))
    assert (a.n_valid_points, a.n_exclude_hits) == (b.n_valid_points, b.n_exclude_hits)


@pytest.mark.parametrize("use_native", [True, False])
def test_host_binner_matches_jax(use_native):
    """Every port binner against every vofod_tpu binner, with a FOV mask."""
    cfg, jcfg = _cfgs()
    lut, cases = _cases(cfg)
    mask = (np.random.default_rng(2).random(cfg.sensor.n_points) > 0.2).astype(np.uint8)
    port = binner.HostBinner(cfg, lut, mask=mask, use_native=use_native)
    refs = [jbinner.HostBinner(jcfg, lut, mask=mask, use_native=n) for n in (True, False)]
    assert port.native == use_native and refs[0].native and not refs[1].native
    for r, p, inten, mi in cases:
        got = port.bin(r, p, intensity=inten, min_intensity=mi)
        for ref in refs:
            _same(got, ref.bin(r, p, intensity=inten, min_intensity=mi))


def test_clamp_at_63_matches_jax():
    """All 1,024 returns within 0.1 m of the sensor: a few voxels of more
    than 63 points each, clamped to 63 in the packed grid."""
    far_box = Box((50.0, 50.0, 50.0), (1.0, 1.0, 1.0))  # no airframe exclusion
    cfg, jcfg = _cfgs(exclude_box=far_box)
    lut = make_lut(cfg.sensor)
    ranges = np.full(cfg.sensor.n_points, 100, np.uint32)
    pose = hover_pose((3.1, 2.9, 7.1))
    got = binner.HostBinner(cfg, lut).bin(ranges, pose)
    for n in (True, False):
        _same(got, jbinner.HostBinner(jcfg, lut, use_native=n).bin(ranges, pose))
    counts = got.packed & 0x3F
    assert counts.max() == 63 and got.n_valid_points == cfg.sensor.n_points
    assert (got.packed[counts > 0] >= 0x80).all()
    np.testing.assert_array_equal(
        got.packed, binner.HostBinner(cfg, lut, use_native=False).bin(ranges, pose).packed)


def test_frontend_prebinned_matches_jax():
    cfg, jcfg = _cfgs()
    lut, cases = _cases(cfg)
    hb = binner.HostBinner(cfg, lut)
    jgrid = JGrid.from_config(jcfg)
    for r, p, inten, mi in cases:
        b = hb.bin(r, p, intensity=inten, min_intensity=mi)
        fe = run_frontend_prebinned(b.to_device("cpu"))
        jb = jbinner.BinnedScan(b.packed, b.active, b.pose, b.n_valid_points, b.n_exclude_hits)
        jfe = j_run_frontend_prebinned(jcfg, jgrid, jb.to_device())
        np.testing.assert_array_equal(fe.counts.numpy(), np.asarray(jfe.counts))
        np.testing.assert_array_equal(fe.blockers.numpy(), np.asarray(jfe.blockers))
        assert int(fe.n_valid_points) == int(jfe.n_valid_points)
        assert int(fe.n_exclude_hits) == int(jfe.n_exclude_hits)
    packed = torch.arange(256, dtype=torch.uint8).reshape(4, 8, 8)
    counts, blockers = unpack(packed)
    assert torch.equal(counts, (torch.arange(256) % 64).to(torch.int32).reshape(4, 8, 8))
    assert torch.equal(blockers, (torch.arange(256) >= 128).reshape(4, 8, 8))


@pytest.mark.parametrize("use_native", [True, False])
def test_host_binner_matches_raw_frontend(use_native):
    """The host bin equals the port's raw frontend on the same scan: counts
    up to the 6-bit clamp, blockers (airframe hits included), point count."""
    cfg, _ = _cfgs()
    lut, scans = _scans(cfg)
    grid = GridSpec.from_config(cfg)
    dirs, offs = torch.as_tensor(lut.directions), torch.as_tensor(lut.offsets)
    hb = binner.HostBinner(cfg, lut, use_native=use_native)
    for r, p in scans:
        pre = run_frontend_prebinned(hb.bin(r, p).to_device("cpu"))
        raw = run_frontend(cfg, grid, dirs, offs, torch.as_tensor(r.astype(np.float32)),
                           torch.as_tensor(p))
        assert torch.equal(pre.counts, raw.counts.clamp(max=63))
        assert torch.equal(pre.blockers, raw.blockers)
        assert int(pre.n_valid_points) == int(raw.n_valid_points)
        assert int(pre.n_exclude_hits) == int(raw.n_exclude_hits)


def test_prebinned_step_matches_raw_step():
    """8 scans: the prebinned step is a drop-in for the raw one — the grid,
    every detection field and every diagnostic bit-equal."""
    cfg, _ = _cfgs()
    lut, scans = _scans(cfg, n=8)
    dyn = DynParams(raycast_weight_coefficient=0.5)
    hb = binner.HostBinner(cfg, lut)
    raw = make_step_fn(cfg, lut, device="cpu")
    pre = make_step_fn(cfg, lut, device="cpu", frontend_mode="prebinned")
    states = []
    for _ in range(2):
        s = init_state(cfg, dyn, device="cpu")
        s.grid[1] = float("inf")
        states.append(s)
    s_raw, s_pre = states
    n_dets = 0
    for i, (r, p) in enumerate(scans):
        ones = torch.ones(r.size)
        s_raw, o_raw = raw(s_raw, ScanInput(torch.as_tensor(r.astype(np.float32)), ones, p), dyn)
        s_pre, o_pre = pre(s_pre, hb.bin(r, p).to_device("cpu"), dyn)
        assert torch.equal(s_pre.grid, s_raw.grid), f"scan {i}: grid"
        assert torch.equal(s_pre.safe, s_raw.safe), f"scan {i}: safe"
        for part in ("detections", "diag"):
            a, b = getattr(o_pre, part), getattr(o_raw, part)
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f"scan {i}: {f.name}"
        n_dets += int(o_raw.detections.valid.sum())
    assert n_dets >= 1  # the sequence detects the floating sphere


def test_choose_ingest_matches_jax():
    vals = (0.0, 0.05, 0.15, 1.1, 1.5, 2.0, 31.0, 95.0)
    for up_raw in vals:
        for up_pre in vals:
            for t_bin in vals:
                for scatter in (0.063, 1.5, 2.0):
                    assert binner.choose_ingest(up_raw, up_pre, t_bin, scatter) == \
                        jbinner.choose_ingest(up_raw, up_pre, t_bin, scatter_ms=scatter)


def test_node_auto_resolves_and_builds_ingest():
    cfg, _ = _cfgs()
    node = VoFOD(cfg, DynParams(), NodeOptions(frontend_mode="auto"), device="cpu")
    assert node.options.frontend_mode in ("raw", "prebinned")
    d = node.ingest_probe
    for k in ("t_raw_upload_ms", "t_prebinned_upload_ms", "t_host_bin_ms", "scatter_ms"):
        assert d[k] > 0, k
    # the node prices the raw upload with the intensity it uploads with a scan
    assert d["raw_bytes"] == cfg.sensor.n_points * 4 * 2 and d["native_binner"]
    # the picked mode built the matching ingest
    assert (node._binner is not None) == (node.options.frontend_mode == "prebinned")
    pre = VoFOD(cfg, DynParams(), NodeOptions(frontend_mode="prebinned"), device="cpu")
    assert pre._binner.native
    _, scans = _scans(cfg, n=2)
    for r, p in scans:
        pre.process_scan(r, None, p)
    assert pre.state.step == 2 and int(pre.last_diag.n_occupied) > 0
    with pytest.raises(ValueError, match="frontend_mode"):
        VoFOD(cfg, DynParams(), NodeOptions(frontend_mode="host"), device="cpu")


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No quiet numpy fallback: a binner without its compiler raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    cfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        binner.HostBinner(cfg, make_lut(cfg.sensor))
