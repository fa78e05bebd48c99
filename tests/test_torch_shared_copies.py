"""The PyTorch port's copies of framework-neutral modules equal their originals.

The port cannot import vofod_tpu where it runs (importing any vofod_tpu
module loads JAX), so it carries numpy copies of the config, sensor
(with the Ouster metadata parser and destagger), scan-source,
angular-gate, host-binner, message, profiling, LZ4 and rosbag code.  These tests hold each copy to its
original, check that the port imports no JAX at all, and that asking for a
CUDA device without one raises instead of running on the CPU.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from vofod_tpu import config as jcfg
from vofod_tpu import sensor as jsensor
from vofod_tpu.io import binner as jbinner
from vofod_tpu.io import lz4_lite as jlz4
from vofod_tpu.io import msgs as jmsgs
from vofod_tpu.io import rosbag_lite as jrb
from vofod_tpu.io import scan_source as jsrc
from vofod_tpu.ops import raycast as jray
from vofod_tpu.runtime import profiling as jprof
from vofod_tpu_torch import config as tcfg
from vofod_tpu_torch import kernels
from vofod_tpu_torch import sensor as tsensor
from vofod_tpu_torch.io import binner as tbinner
from vofod_tpu_torch.io import lz4_lite as tlz4
from vofod_tpu_torch.io import msgs as tmsgs
from vofod_tpu_torch.io import rosbag_lite as trb
from vofod_tpu_torch.io import scan_source as tsrc
from vofod_tpu_torch.ops import raycast as tray
from vofod_tpu_torch.runtime import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gradient_angles(H):
    u = np.linspace(-1.0, 1.0, H)
    alt = -45.0 * np.sign(u) * np.abs(u) ** 1.3
    az = 3.0 * np.sin(np.linspace(0, 2 * np.pi, H))
    return az, alt


DICTS = dict(
    detection={
        "voxel_map": {"voxel_size": 0.4},
        "ground_points_max_distance": 1.2,
        "exclude_box": {"offset": {"x": 0.1, "y": 0.0, "z": -0.5},
                        "size": {"x": 2.0, "y": 2.0, "z": 1.0}},
        "separate_cluster_removal_period": 0.2,
    },
    sensor={"sensor": {"vertical_rays": 64, "horizontal_rays": 512,
                       "vertical_fov_angle": 45.0}},
    apriori={"apriori_map": {"tf": {"yaw": 10.0, "x": 1.0},
                             "sim_correction": {"z": 0.5}},
             "operation_area": {"offset": {"x": 1.0, "y": 2.0, "z": -1.0},
                                "size": {"x": 30.0, "y": 20.0, "z": 10.0}}},
)


@pytest.mark.parametrize("which", ["default", "from_dicts"])
def test_config_copy_matches(which):
    if which == "default":
        j, t = jcfg.VoFODConfig(), tcfg.VoFODConfig()
    else:
        j = jcfg.VoFODConfig.from_dicts(DICTS["detection"], DICTS["sensor"], DICTS["apriori"])
        t = tcfg.VoFODConfig.from_dicts(DICTS["detection"], DICTS["sensor"], DICTS["apriori"])
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.grid_shape == t.grid_shape
    assert j.grid_origin == t.grid_origin
    assert j.background_min_sufficient_pts == t.background_min_sufficient_pts


def test_dynparams_copy_matches():
    assert dataclasses.asdict(jcfg.DynParams()) == dataclasses.asdict(tcfg.DynParams())
    d = {"voxel_map": {"scores": {"ray": -900.0}}, "raycast": {"pause": True}}
    assert dataclasses.asdict(jcfg.DynParams.from_yaml_dict(d)) == dataclasses.asdict(
        tcfg.DynParams.from_yaml_dict(d)
    )
    # as_tensors: the same float32 / bool values as the JAX as_arrays
    ja = jcfg.DynParams().as_arrays()
    ta = tcfg.DynParams().as_tensors("cpu")
    for f in dataclasses.fields(ta):
        jv, tv = np.asarray(getattr(ja, f.name)), getattr(ta, f.name).numpy()
        assert jv.dtype == tv.dtype and jv == tv, f.name


@pytest.mark.parametrize("kind", ["simulation", "ouster_gradient", "ouster_from_config"])
def test_lut_copy_bytes_equal(kind):
    if kind == "simulation":
        j = jsensor.make_lut_simulation(128, 32, np.deg2rad(90.0))
        t = tsensor.make_lut_simulation(128, 32, np.deg2rad(90.0))
    elif kind == "ouster_gradient":
        az, alt = _gradient_angles(32)
        j = jsensor.make_lut_ouster(256, 32, az, alt, 15.806)
        t = tsensor.make_lut_ouster(256, 32, az, alt, 15.806)
    else:
        az, alt = _gradient_angles(16)
        kw = dict(vertical_rays=16, horizontal_rays=64, simulation=False,
                  beam_azimuth_angles_deg=tuple(az), beam_altitude_angles_deg=tuple(alt))
        j = jsensor.make_lut(jcfg.SensorConfig(**kw))
        t = tsensor.make_lut(tcfg.SensorConfig(**kw))
    assert j.directions.tobytes() == t.directions.tobytes()
    assert j.offsets.tobytes() == t.offsets.tobytes()
    assert (j.height, j.width) == (t.height, t.width)
    assert tsensor.RANGE_TO_METERS == jsensor.RANGE_TO_METERS


@pytest.mark.parametrize("mangle", [False, True])
def test_load_mask_copy_matches(tmp_path, mangle):
    rng = np.random.default_rng(3)
    m = (rng.random((8, 32)) > 0.3).astype(np.uint8)
    path = str(tmp_path / "mask.npy")
    np.save(path, m)
    shift = rng.integers(0, 32, 8)
    j = jsensor.load_mask(path, 32, 8, pixel_shift_by_row=shift, mangle=mangle)
    t = tsensor.load_mask(path, 32, 8, pixel_shift_by_row=shift, mangle=mangle)
    assert np.array_equal(j, t)
    assert np.array_equal(jsensor.load_mask("", 32, 8), tsensor.load_mask("", 32, 8))


@pytest.mark.parametrize("kind", ["simulation", "ouster_gradient"])
def test_angular_gate_copy_matches(kind):
    if kind == "simulation":
        lut = tsensor.make_lut_simulation(1024, 128, np.deg2rad(90.0))
    else:
        az, alt = _gradient_angles(64)
        lut = tsensor.make_lut_ouster(512, 64, az, alt, 15.806)
    j, t = jray.make_angular_gate(lut), tray.make_angular_gate(lut)
    assert j._fields == t._fields
    for f in j._fields:
        a, b = getattr(j, f), getattr(t, f)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert np.array_equal(a, b), f
        else:
            assert a == b, f


def test_scan_source_copy_matches():
    lut = tsensor.make_lut_simulation(256, 32, np.deg2rad(90.0))
    for k in range(3):
        js, ts = jsrc.Scene(ground_z=-1.0), tsrc.Scene(ground_z=-1.0)
        for s in (js, ts):
            s.add_box((5.0, 3.0, -1.0), (7.0, 5.0, 2.0 + k))
            s.add_sphere((-4.0, 2.0, 3.0 + k), 0.5)
        jp = jsrc.hover_pose((1.0, 2.0, 3.0 + 0.1 * k), yaw=0.2 * k)
        tp = tsrc.hover_pose((1.0, 2.0, 3.0 + 0.1 * k), yaw=0.2 * k)
        assert np.array_equal(jp, tp)
        assert np.array_equal(jsrc.render_scan(js, lut, jp), tsrc.render_scan(ts, lut, tp))


@pytest.mark.parametrize("perturb", [0.0, 5e-4, 2e-3])
def test_check_sensor_params_copy_matches(perturb):
    lut = tsensor.make_lut_simulation(64, 16, np.deg2rad(90.0))
    scene = tsrc.Scene(ground_z=-1.0)
    scene.add_box((5.0, 3.0, -1.0), (7.0, 5.0, 3.0))
    r = tsrc.render_scan(scene, lut, tsrc.hover_pose((0.0, 0.0, 1.0)))
    pts = lut.directions * (r * 1e-3)[:, None] + lut.offsets
    pts[np.argmax(r)] += perturb
    pts[0] = np.nan  # a non-finite point is not checked
    assert tsensor.check_sensor_params(lut, pts, r) == jsensor.check_sensor_params(lut, pts, r)
    assert tsensor.check_sensor_params(lut, pts, r) == (perturb < 1e-3)
    zero = np.zeros_like(r)
    assert tsensor.check_sensor_params(lut, pts, zero) == jsensor.check_sensor_params(lut, pts, zero)


@pytest.mark.parametrize("with_intensity", [False, True])
def test_scans_npz_copy_matches(tmp_path, with_intensity):
    rng = np.random.default_rng(1)
    ranges = rng.integers(0, 9000, (3, 64), dtype=np.uint32)
    poses = np.stack([tsrc.hover_pose((k, 0.0, 1.0)) for k in range(3)])
    inten = rng.random((3, 64)).astype(np.float32) if with_intensity else None
    paths = [str(tmp_path / "t.npz"), str(tmp_path / "j.npz")]
    tsrc.save_scans_npz(paths[0], ranges, poses, intensity=inten)
    jsrc.save_scans_npz(paths[1], ranges, poses, intensity=inten)
    for p in paths:
        a, b = tsrc.load_scans_npz(p), jsrc.load_scans_npz(p)
        for x, y in zip(a, b):
            assert (x is None and y is None) or np.array_equal(x, y)


def test_profiling_copy_matches():
    """The same calls give the same event stream (routine ids, sequence
    numbers, event types) and ScopeTimer checkpoints; ProfilingInfo's
    fields and constants are the original's."""
    assert dataclasses.asdict(tmsgs.ProfilingInfo()) == dataclasses.asdict(jmsgs.ProfilingInfo())
    for name in ("EVENT_START", "EVENT_END", "ROUTINE_CNC", "ROUTINE_SEPBGCLUSTERS",
                 "ROUTINE_RAYCASTING"):
        assert getattr(tmsgs.ProfilingInfo, name) == getattr(jmsgs.ProfilingInfo, name)
    streams = []
    for mod, msgs in ((tprof, tmsgs), (jprof, jmsgs)):
        seen = []
        s = mod.ProfilingStream()
        s.set_publisher(seen.append)
        with s.routine(msgs.ProfilingInfo.ROUTINE_CNC):
            pass
        s.start(msgs.ProfilingInfo.ROUTINE_RAYCASTING)
        s.end(msgs.ProfilingInfo.ROUTINE_RAYCASTING)
        with s.routine(msgs.ProfilingInfo.ROUTINE_CNC):
            pass
        assert seen == s.events
        streams.append([(e.routine_id, e.event_sequence, e.event_type) for e in s.events])
        t = mod.ScopeTimer("x")
        t.checkpoint("a")
        assert [c[0] for c in t.checkpoints] == ["a"] and t.total() >= t.checkpoints[0][1]
    assert streams[0] == streams[1]


@pytest.mark.parametrize("use_native", [True, False])
def test_binner_copy_matches(use_native):
    """The port's io/binner.py against vofod_tpu/io/binner.py: the same
    packed grid, active mask and counts from the same scan (a float-range
    scan with a NaN, a negative and an +inf return, an intensity gate and a
    FOV mask), and the same ingest rule."""
    jc = jcfg.VoFODConfig.from_dicts(DICTS["detection"], DICTS["sensor"], DICTS["apriori"])
    tc = tcfg.VoFODConfig.from_dicts(DICTS["detection"], DICTS["sensor"], DICTS["apriori"])
    lut = tsensor.make_lut(tc.sensor)
    scene = tsrc.Scene(ground_z=-1.0)
    scene.add_box((5.0, 3.0, -1.0), (7.0, 5.0, 3.0))
    pose = tsrc.hover_pose((1.0, 2.0, 1.5), yaw=0.3)
    r = tsrc.render_scan(scene, lut, pose).astype(np.float32)
    r[:3] = (np.nan, -1.0, np.inf)
    rng = np.random.default_rng(5)
    inten = rng.random(r.size).astype(np.float32)
    mask = (rng.random(r.size) > 0.1).astype(np.uint8)
    a = tbinner.HostBinner(tc, lut, mask=mask, use_native=use_native).bin(
        r, pose, intensity=inten, min_intensity=0.3)
    b = jbinner.HostBinner(jc, lut, mask=mask, use_native=use_native).bin(
        r, pose, intensity=inten, min_intensity=0.3)
    assert np.array_equal(a.packed, b.packed) and np.array_equal(a.active, b.active)
    assert (a.n_valid_points, a.n_exclude_hits) == (b.n_valid_points, b.n_exclude_hits)
    assert a.n_valid_points > 0 and a.active.sum() > 0
    for args in ((0.05, 0.15, 1.1, 1.5), (31.0, 95.0, 1.1, 0.06), (0.1, 0.1, 0.0, 0.0)):
        assert tbinner.choose_ingest(*args) == jbinner.choose_ingest(*args)


def _ouster_metadata(nested: bool) -> str:
    """tests/test_sensor_metadata.py's metadata: nested or flat."""
    H, W = 16, 64
    beam = {"beam_altitude_angles": list(np.linspace(22.5, -22.5, H)),
            "beam_azimuth_angles": list(np.linspace(-1.5, 1.5, H)),
            "lidar_origin_to_beam_origin_mm": 15.806}
    fmt = {"pixels_per_column": H, "columns_per_frame": W,
           "pixel_shift_by_row": [(3 * u) % W for u in range(H)]}
    intr = {"lidar_to_sensor_transform": [-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 36.18, 0, 0, 0, 1]}
    if nested:
        return json.dumps({"beam_intrinsics": beam, "lidar_data_format": fmt,
                           "lidar_intrinsics": intr})
    return json.dumps({**beam, **fmt, **intr})


@pytest.mark.parametrize("nested", [True, False])
def test_ouster_metadata_and_destagger_copies_match(nested):
    meta = _ouster_metadata(nested)
    (tc, tl, ts), (jc, jl, js) = tsensor.parse_ouster_metadata(meta), jsensor.parse_ouster_metadata(meta)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tl.directions.tobytes() == jl.directions.tobytes()
    assert tl.offsets.tobytes() == jl.offsets.tobytes()
    assert ts.dtype == js.dtype and np.array_equal(ts, js)
    img = np.random.default_rng(2).integers(0, 9000, (16, 64)).astype(np.uint32)
    assert np.array_equal(tsensor.destagger(img, ts), jsensor.destagger(img, js))
    assert not np.array_equal(tsensor.destagger(img, ts), img)


def test_lz4_and_rosbag_copies_match():
    """The LZ4 codec and the bag records' encoders give the originals'
    bytes; each decoder reads the other's."""
    rng = np.random.default_rng(4)
    data = rng.integers(0, 64, 20000, dtype=np.uint8).tobytes() + b"xyz" * 4000
    frame = tlz4.compress(data)
    assert frame == jlz4.compress(data) and tlz4.decompress(frame) == data
    assert tlz4.decompress(jlz4.compress(data)) == jlz4.decompress(frame) == data
    assert tlz4.xxh32(data) == jlz4.xxh32(data)
    kw = dict(stamp=3.25, frame_id="os_sensor", height=4, width=8,
              fields=[("range", 0, 6, 1)], point_step=4,
              data=rng.integers(0, 9000, 32).astype("<u4").tobytes())
    pc = trb.serialize_pointcloud2(**kw)
    assert pc == jrb.serialize_pointcloud2(**kw)
    a, b = trb.deserialize_pointcloud2(pc), jrb.deserialize_pointcloud2(pc)
    assert (a.stamp, a.frame_id, a.fields, a.data) == (b.stamp, b.frame_id, b.fields, b.data)
    tfs = [dict(stamp=1.5, parent="world", child="uav", txyz=(1.0, 2.0, 3.0),
                quat=(0.0, 0.0, 0.6, 0.8))]
    tf = trb.serialize_tf_message(tfs)
    assert tf == jrb.serialize_tf_message(tfs)
    assert trb.deserialize_tf_message(tf) == jrb.deserialize_tf_message(tf)
    assert (trb.MAGIC, trb.PC2_MD5, trb.TF_MD5) == (jrb.MAGIC, jrb.PC2_MD5, jrb.TF_MD5)


_NO_JAX = textwrap.dedent(
    """
    import importlib.abc, sys

    class RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"jax is refused here: {name}")
            return None

    sys.meta_path.insert(0, RefuseJax())
    import dataclasses
    import numpy as np
    import vofod_tpu_torch
    from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
    from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
    from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD

    cfg = VoFODConfig(
        sensor=SensorConfig(vertical_rays=8, horizontal_rays=32),
        oparea=Box((0.0, 0.0, 3.0), (8.0, 8.0, 6.0)),
        max_clusters=4, max_far_voxels=64, max_queries=16,
        explore_submap=8, confidence_submap=8,
    )
    node = VoFOD(cfg, DynParams(), device="cpu")
    scene = Scene(ground_z=0.0)
    scene.add_sphere((2.0, 1.0, 3.0), 0.5)
    for k in range(2):
        pose = hover_pose((0.0, 0.0, 2.0 + 0.1 * k))
        node.process_scan(render_scan(scene, node.lut, pose), None, pose)
    assert node.state.step == 2
    # one prebinned step (the native host binner) and one dynamic-radii step
    pre = VoFOD(cfg, DynParams(), NodeOptions(frontend_mode="prebinned"), device="cpu")
    dyn_cfg = dataclasses.replace(cfg, dynamic_radii=True, ground_points_max_distance_bound=2.0,
                                  sepclusters_max_bg_distance_bound=2.0)
    dyn = VoFOD(dyn_cfg, DynParams(), device="cpu")
    dyn.update_params(ground_points_max_distance=1.0, sepclusters_max_bg_distance=1.9)
    pose = hover_pose((0.0, 0.0, 2.0))
    for extra in (pre, dyn):
        extra.process_scan(render_scan(scene, node.lut, pose), None, pose)
        assert extra.state.step == 1 and int(extra.last_diag.n_occupied) > 0
    assert pre._binner.native
    # the sequential explore with the exact census, and the node surface
    seq_cfg = dataclasses.replace(cfg, sequential_explore=True, sepclusters_exact_census=True,
                                  compat_hascloseto_bounds=True)
    seq = VoFOD(seq_cfg, DynParams(), NodeOptions(raycast_mode="exact", profile_stages=True),
                device="cpu")
    seq.process_scan(render_scan(scene, node.lut, pose), None, pose)
    assert set(seq.last_stage_ms) == {"cnc", "raycasting", "sepbgclusters"}
    assert seq.process_rangefinder(1.0, 0.1, 10.0, pose)
    # the serving modules: the scan ring, the streaming runtime, the
    # streams' step, the fleet and its CLI
    from vofod_tpu_torch.io.scan_queue import ScanQueue
    from vofod_tpu_torch.parallel import sharding
    from vofod_tpu_torch.runtime.fleet import FleetVoFOD
    from vofod_tpu_torch.runtime.stream import StreamRunner
    from vofod_tpu_torch.tools import serve_fleet
    scan = render_scan(scene, node.lut, pose)
    q = ScanQueue(scan.size, capacity=2)
    assert q.push(scan, pose) and np.array_equal(q.pop()[0], scan)
    fleet = FleetVoFOD(cfg, DynParams(), n_streams=2, device="cpu")
    fleet.load_apriori_map(np.zeros((1, 3)), stream=1)
    assert len(fleet.process_scans(np.stack([scan] * 2), np.stack([pose] * 2))) == 2
    assert sharding.batched_state_to_numpy(fleet.state)["step"].tolist() == [1, 1]
    assert callable(StreamRunner.start) and callable(serve_fleet.main)
    # the 2-D streams x grid fleet: 2 ticks of 2 streams on 2 grid shards
    from vofod_tpu_torch.parallel import grid_step
    from vofod_tpu_torch.runtime import fleet as fleet_mod
    cfg2 = dataclasses.replace(cfg, oparea=Box((0.0, 0.0, 3.75), (8.0, 8.0, 7.5)))
    fleet2 = fleet_mod.FleetVoFOD(cfg2, DynParams(), n_streams=2, device="cpu", grid_shards=2)
    for _ in range(2):
        assert len(fleet2.process_scans(np.stack([scan] * 2), np.stack([pose] * 2))) == 2
    assert grid_step.fleet_grid_state_to_numpy(fleet2.state)["step"].tolist() == [2, 2]
    assert callable(fleet_mod.initialize_multihost)
    # the runtime surface: a tiny bag through the detect CLI on the CPU,
    # a checkpoint directory, the mask creator and the other modules
    import contextlib, io, json, os, tempfile
    from vofod_tpu_torch.io import lz4_lite, pc_loader, rosbag_lite
    from vofod_tpu_torch.pipeline.step import StagedStep
    from vofod_tpu_torch.runtime import (checkpoint, mask_creator, param_watch, ros_adapter,
                                         viz)
    from vofod_tpu_torch.sensor import destagger, parse_ouster_metadata
    from vofod_tpu_torch.tools import bag_to_npz, create_mask, detect
    tmp = tempfile.mkdtemp()
    bag = os.path.join(tmp, "tiny.bag")
    with rosbag_lite.BagWriter(bag, compression="lz4") as w:
        for k in range(2):
            pose = hover_pose((0.0, 0.0, 2.0 + 0.1 * k))
            t, q = pose[:3, 3], (0.0, 0.0, 0.0, 1.0)
            w.write_tf("/tf", float(k), [dict(stamp=float(k), parent="world", child="os_sensor",
                                              txyz=tuple(float(v) for v in t), quat=q)])
            r = render_scan(scene, node.lut, pose).astype("<u4")
            w.write_pointcloud2("/os_cloud_node/points", float(k), frame_id="os_sensor",
                                height=8, width=32, fields=[("range", 0, 6, 1)], point_step=4,
                                data=r.tobytes())
    sen, area = os.path.join(tmp, "sensor.yaml"), os.path.join(tmp, "map.yaml")
    with open(sen, "w") as f:
        f.write("sensor: {vertical_rays: 8, horizontal_rays: 32}\\n")
    with open(area, "w") as f:
        f.write("operation_area: {offset: {x: 4.0, y: 4.0, z: 0.0}, "
                "size: {x: 8.0, y: 8.0, z: 6.0}}\\n")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = detect.main(["--scans", bag, "--sensor", sen, "--map", area, "--small-capacities",
                          "--json", "--device", "cpu", "--save-state", os.path.join(tmp, "ck")])
    assert rc == 0 and len(out.getvalue().splitlines()) == 2
    assert checkpoint.read_manifest(os.path.join(tmp, "ck"))["layout"] == "dense"
    mc = mask_creator.MaskCreator(8, 32, device="cpu")
    mc.add_scan(scan)
    assert mc.mask().shape == (8, 32)
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    print("NO_JAX_OK", int(node.last_diag.n_occupied))
    """
)


def test_port_imports_no_jax_and_runs():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout
    assert int(res.stdout.split("NO_JAX_OK")[1].split()[0]) > 0


def test_cuda_request_without_cuda_raises(monkeypatch):
    """No fallback: a CUDA node where CUDA is absent raises; it never runs on
    the CPU instead."""
    from vofod_tpu_torch.runtime.node import VoFOD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VoFOD(device="cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, not a switch to the plain versions."""
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch only on CUDA tensors; a CPU tensor never reaches
    them through the ops modules, and directly it is refused."""
    a = torch.zeros((4, 4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels._require(a, "ball_pool input", torch.int8)
    g = torch.zeros((4, 4, 4))
    b = torch.zeros((4, 4, 4), dtype=torch.bool)
    i = torch.zeros((4, 4, 4), dtype=torch.int32)
    k3, k1 = torch.zeros((2, 3)), torch.zeros(2, dtype=torch.int32)
    calls = [
        lambda: kernels.gate_faces(torch.zeros((4, 8), dtype=torch.bool), torch.zeros((6, 3)),
                                   torch.eye(3), None, (1, 1, 4, 8), np.zeros(9, np.float32)),
        lambda: kernels.ray_update(g, b, torch.zeros((6, 4, 4, 4)), None, torch.zeros(4),
                                   torch.zeros(4), torch.zeros(4), torch.eye(3), 0, 0,
                                   (0.5,) * 6, None),
        lambda: kernels.detect(g, b, i, k3, k3, k1, k1, k1, k3, torch.zeros(3),
                               torch.zeros((), dtype=torch.int32), 4, (0.0,) * 3, 2.0,
                               (1.0,) * 5),
        lambda: kernels.point_ema(g, i, b, 0.0, -740.0),
        lambda: kernels.demote_ema(g, b, b, torch.ones((), dtype=torch.bool),
                                   np.zeros((1, 3), np.int32), 0, 0.5, -500.0),
        lambda: kernels.dda(torch.zeros((2, 3)), torch.zeros((2, 3)), torch.zeros(2),
                            torch.zeros(2, dtype=torch.bool), (4, 4, 4),
                            np.zeros(6, np.float32), 8),
        lambda: kernels.ray_ema(g, b, g, None),
        lambda: kernels.label_census(i, i, b, 64, 24.0),
        lambda: kernels.quirk_counts(b, b, 1),
        lambda: kernels.unpack(torch.zeros((4, 4, 4), dtype=torch.uint8)),
        lambda: kernels.shell_pool(a, np.zeros((1, 3), np.int32), 0, "max", 0),
        lambda: kernels.explore_sequential_(g, k1, k1, k1, torch.zeros(2, dtype=torch.bool), k1,
                                            k1, torch.zeros((2, 3), dtype=torch.bool), k1,
                                            torch.zeros((), dtype=torch.bool), -750.0, -300.0,
                                            4, 96),
        lambda: kernels.exact_demote_ema(g, b, i, torch.zeros(2, dtype=torch.bool),
                                         torch.zeros((), dtype=torch.bool), 1,
                                         np.zeros((1, 3), np.int32), 0, 24.0, 0.5, -1000.0,
                                         -300.0),
        lambda: kernels.propagate_sweeps(i, b.view(torch.uint8), np.zeros((1, 3), np.int32),
                                         0, 8),
        lambda: kernels.cone_sweep(b.view(torch.uint8), torch.zeros(4), torch.zeros(4),
                                   torch.zeros(4)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(v == 0 for v in kernels.launch_counts().values())
