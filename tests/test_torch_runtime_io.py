"""The port's bag, cloud and runtime modules against their JAX counterparts.

Small inputs made from a seed with numpy go through both packages:

* I/O and conversion: ``lz4_lite`` frames and ``rosbag_lite`` bags
  byte-equal to vofod_tpu's for the same messages in all three chunk
  compressions, either package's bag read by the other; ``pc_loader``'s
  native parser against its numpy parser and JAX's; ``convert_bag``'s NPZ
  equal to JAX's on tests/test_rosbag_ingest.py's fixture (destaggered).
* Runtime modules: the ROS converters and JSON payloads, the viz markers
  on one grid, ``MaskCreator``, ``ParamWatcher`` in the eight cases of
  tests/test_param_watch.py, and ``RosNode`` / ``RosMaskCreator`` on
  tests/test_ros_node.py's stubbed rospy.

Everything is bit-equal (the conversions are host numpy in both packages).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.test_rosbag_ingest import fixture_bag  # noqa: F401
from tests.test_ros_node import H as RH, W as RW, _pc_msg, ros_stub  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu import config as jcfg
from vofod_tpu.io import lz4_lite as jlz4
from vofod_tpu.io import msgs as jmsgs
from vofod_tpu.io import pc_loader as jpc
from vofod_tpu.io import rosbag_lite as jrb
from vofod_tpu.runtime import mask_creator as jmask
from vofod_tpu.runtime import param_watch as jpw
from vofod_tpu.runtime import ros_adapter as jros
from vofod_tpu.runtime import viz as jviz
from vofod_tpu.runtime.node import VoFOD as JNode
from vofod_tpu.tools import bag_to_npz as jb2n
from vofod_tpu_torch import config as tcfg
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.io import lz4_lite as tlz4
from vofod_tpu_torch.io import msgs as tmsgs
from vofod_tpu_torch.io import native
from vofod_tpu_torch.io import pc_loader as tpc
from vofod_tpu_torch.io import rosbag_lite as trb
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu_torch.runtime import mask_creator as tmask
from vofod_tpu_torch.runtime import param_watch as tpw
from vofod_tpu_torch.runtime import ros_adapter as tros
from vofod_tpu_torch.runtime import viz as tviz
from vofod_tpu_torch.runtime.node import VoFOD
from vofod_tpu_torch.sensor import make_lut
from vofod_tpu_torch.tools import bag_to_npz as tb2n


def _payloads():
    rng = np.random.default_rng(11)
    return {
        "empty": b"",
        "random": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
        "ranges": rng.integers(0, 9000, 4096).astype("<u4").tobytes(),
        "repeats": b"abcdefgh" * 3000 + bytes(range(256)) * 7,
    }


@pytest.mark.parametrize("name", sorted(_payloads()))
def test_lz4_frames_equal_to_jax(name):
    data = _payloads()[name]
    frame = tlz4.compress(data)
    assert frame == jlz4.compress(data)
    assert tlz4.decompress(frame) == data == jlz4.decompress(frame)
    assert tlz4.xxh32(data, 7) == jlz4.xxh32(data, 7)


def _write_bag(mod, path, compression, rng_seed=5):
    rng = np.random.default_rng(rng_seed)
    with mod.BagWriter(path, compression=compression) as w:
        w.write_tf("/tf_static", 0.0, [dict(stamp=0.0, parent="uav", child="os_sensor",
                                            txyz=(0.1, 0.0, -0.05), quat=(0.0, 0.0, 0.0, 1.0))])
        for k in range(3):
            t = 10.0 + 0.1 * k
            w.write_tf("/tf", t, [dict(stamp=t, parent="world", child="uav",
                                       txyz=tuple(rng.normal(size=3)),
                                       quat=(0.0, 0.0, np.sin(0.1 * k), np.cos(0.1 * k)))])
            pts = np.zeros((RH * RW, 8), np.uint8)
            pts[:, :4] = rng.integers(0, 20000, RH * RW).astype("<u4").reshape(-1, 1).view(np.uint8)
            pts[:, 4:] = rng.random(RH * RW).astype("<f4").reshape(-1, 1).view(np.uint8)
            w.write_pointcloud2("/os_cloud_node/points", t, frame_id="os_sensor", height=RH,
                                width=RW, fields=[("range", 0, 6, 1), ("intensity", 4, 7, 1)],
                                point_step=8, data=pts.tobytes())


def _messages(mod, path):
    out = []
    for m in mod.read_bag(path):
        if m.msg_type == mod.TF_TYPE:
            body = [(d["stamp"], d["parent"], d["child"], tuple(d["txyz"]), tuple(d["quat"]))
                    for d in m.msg]
        else:
            pc = m.msg
            body = (pc.stamp, pc.frame_id, pc.height, pc.width, pc.data,
                    pc.extract(("range",))["range"].tobytes())
        out.append((m.topic, m.msg_type, body))
    return out


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_bytes_equal_and_cross_read(tmp_path, compression):
    tp, jp = str(tmp_path / "port.bag"), str(tmp_path / "jax.bag")
    _write_bag(trb, tp, compression)
    _write_bag(jrb, jp, compression)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    want = _messages(jrb, jp)
    assert len(want) == 7
    assert _messages(trb, jp) == want  # the port reads JAX's bag
    assert _messages(jrb, tp) == want  # and JAX reads the port's


def _cloud_file(tmp_path, suffix, header):
    rng = np.random.default_rng(2)
    pts = rng.normal(scale=20.0, size=(257, 3)).astype(np.float32)
    path = str(tmp_path / f"cloud{suffix}")
    with open(path, "w") as f:
        if header:
            f.write(f"{len(pts)}\n")
        for x, y, z in pts:
            f.write(f"{x} {y} {z} 0.5 extra\n\n")  # extras ignored, blank lines skipped
    return path


@pytest.mark.parametrize("suffix,header", [(".pts", True), (".pts", False), (".txt", False)])
def test_pc_loader_native_against_numpy_and_jax(tmp_path, suffix, header):
    path = _cloud_file(tmp_path, suffix, header)
    got = tpc.load_cloud(path)
    assert got.shape == (257, 3) and got.dtype == np.float32
    assert np.array_equal(got, tpc.load_cloud(path, use_native=False))
    assert np.array_equal(got, jpc.load_cloud(path, use_native=False))
    out_t, out_j = str(tmp_path / f"t{suffix}"), str(tmp_path / f"j{suffix}")
    tpc.save_cloud(out_t, got)
    jpc.save_cloud(out_j, got)
    with open(out_t) as a, open(out_j) as b:
        assert a.read() == b.read()


def test_pc_loader_errors(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        tpc.load_cloud(str(tmp_path / "absent.pts"))
    bad = str(tmp_path / "bad.txt")
    with open(bad, "w") as f:
        f.write("1 2 3\n4 5\n")
    with pytest.raises(ValueError):
        tpc.load_cloud(bad, use_native=False)
    # no fallback: a native library that cannot be built raises
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tpc.load_cloud(_cloud_file(tmp_path, ".txt", False))


def test_convert_bag_equal_to_jax(fixture_bag, tmp_path):  # noqa: F811
    bag_path, meta_path, ranges_true, poses_true = fixture_bag
    outs = {}
    for name, mod in (("port", tb2n), ("jax", jb2n)):
        p = str(tmp_path / f"{name}.npz")
        n = mod.convert_bag(bag_path, p, "/os_cloud_node/points", do_destagger=True,
                            metadata_json=meta_path)
        assert n == 20
        with np.load(p) as z:
            outs[name] = dict(z)
    assert sorted(outs["port"]) == sorted(outs["jax"])
    for k, v in outs["jax"].items():
        assert outs["port"][k].dtype == v.dtype and np.array_equal(outs["port"][k], v), k
    assert np.array_equal(outs["port"]["ranges"], ranges_true)
    np.testing.assert_allclose(outs["port"]["poses"], poses_true, atol=1e-6)


def test_bag_conversion_math_equal_to_jax():
    rng = np.random.default_rng(4)
    xyz = rng.normal(scale=10.0, size=(4 * 8, 3))
    xyz[3] = np.nan
    shift = rng.integers(0, 8, 4)
    for fields in ({"xyz": xyz}, {"range": rng.integers(0, 9000, 32).astype(np.uint32)}):
        for dd in (False, True):
            a = tb2n.organized_cloud_to_scan(fields, 4, 8, shift, dd)
            assert np.array_equal(a, jb2n.organized_cloud_to_scan(fields, 4, 8, shift, dd))
    tfs = [dict(stamp=float(s), parent=p, child=c, txyz=tuple(rng.normal(size=3)),
                quat=tuple(q / np.linalg.norm(q)))
           for s, p, c, q in ((0, "world", "uav", rng.normal(size=4)),
                              (1, "world", "uav", rng.normal(size=4)),
                              (0, "/uav", "sensor", rng.normal(size=4)))]
    a, b = tb2n.accumulate_tf(tfs, "world", "sensor"), jb2n.accumulate_tf(tfs, "world", "sensor")
    for t in (-1.0, 0.5, 1.0, 3.0):
        assert np.array_equal(a.lookup(t), b.lookup(t))
    with pytest.raises(ValueError, match="no TF chain"):
        tb2n.accumulate_tf(tfs, "world", "camera")


def test_ros_converters_and_json_equal_to_jax():
    rng = np.random.default_rng(8)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    assert np.array_equal(tros.quat_to_matrix(*q), jros.quat_to_matrix(*q))
    assert np.array_equal(tros.transform_to_pose(1.0, -2.0, 3.5, *q),
                          jros.transform_to_pose(1.0, -2.0, 3.5, *q))
    xyz = rng.normal(scale=5.0, size=(32, 3))
    xyz[0] = np.inf
    for fields in ({"xyz": xyz}, {"range": rng.integers(0, 9000, 32)}):
        assert np.array_equal(tros.pointcloud2_to_ranges(fields, 4, 8),
                              jros.pointcloud2_to_ranges(fields, 4, 8))
    payloads = []
    for m, ros in ((tmsgs, tros), (jmsgs, jros)):
        dets = m.Detections(header=m.Header(12.5, "world"), detections=[
            m.Detection(id=3, confidence=0.25, n_points=7, position=(1.0, 2.0, 3.0),
                        detection_probability=0.5)])
        st = m.Status(detection_enabled=True, detection_active=False)
        ev = m.ProfilingInfo(stamp=1.5, routine_id=2, event_sequence=4, event_type=1)
        payloads.append((ros.detections_to_json(dets), ros.status_to_json(st, 3.0),
                         ros.profiling_event_to_json(ev)))
    assert payloads[0] == payloads[1]
    assert json.loads(payloads[0][0])["detections"][0]["id"] == 3


def _marker_tuple(m):
    return (m.kind, m.ns, m.scale, m.points.tobytes(), m.colors.tobytes())


def test_viz_markers_equal_to_jax(tmp_path):
    cfg = tcfg.VoFODConfig(sensor=tcfg.SensorConfig(vertical_rays=8, horizontal_rays=32),
                           oparea=tcfg.Box((0.0, 0.0, 3.0), (8.0, 8.0, 6.0)))
    gs = GridSpec.from_config(cfg)
    rng = np.random.default_rng(6)
    grid = rng.normal(scale=400.0, size=cfg.grid_shape).astype(np.float32)
    dyn = tcfg.DynParams()
    yaml_path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                             "visualization.yaml")
    tv, jv = tviz.load_viz_config(yaml_path), jviz.load_viz_config(yaml_path)
    assert (tv.vmap, tv.vflags) == (jv.vmap, jv.vflags)
    assert tviz.load_viz_config(None).vmap == jviz.load_viz_config(None).vmap
    K = 4
    det = type("Det", (), dict(
        cluster_class=np.array([1, 2, 0, 0], np.int32), valid=np.array([1, 1, 0, 0], bool),
        n_points=np.array([5, 3, 2, 0], np.int32),
        obb_axes=np.stack([np.eye(3, dtype=np.float32)] * K),
        obb_extent=rng.random((K, 3)).astype(np.float32),
        obb_center=rng.normal(size=(K, 3)).astype(np.float32)))
    tdet = type("TDet", (), {k: torch.as_tensor(v) for k, v in vars(det).items()
                             if not k.startswith("_")})
    lut = make_lut(cfg.sensor)
    ranges = rng.integers(0, 9000, lut.directions.shape[0]).astype(np.uint32)
    pose = hover_pose((1.0, 2.0, 3.0), yaw=0.4)
    for vals in (grid, torch.from_numpy(grid)):  # numpy, or a tensor read back once
        ms = [tviz.voxel_markers(vals, gs, tv.vmap_thresholds(dyn)),
              tviz.frontier_markers(vals, gs, float(dyn.thr_frontiers),
                                    float(dyn.thr_new_obstacles), color=tv.vmap["frontiers"]),
              tviz.border_marker(gs), tviz.cluster_obb_markers(tdet),
              tviz.lidar_ray_markers(lut, ranges, pose, stride=16)]
        js = [jviz.voxel_markers(grid, gs, jv.vmap_thresholds(dyn)),
              jviz.frontier_markers(grid, gs, float(dyn.thr_frontiers),
                                    float(dyn.thr_new_obstacles), color=jv.vmap["frontiers"]),
              jviz.border_marker(gs), jviz.cluster_obb_markers(det),
              jviz.lidar_ray_markers(lut, ranges, pose, stride=16)]
        assert [_marker_tuple(m) for m in ms] == [_marker_tuple(m) for m in js]
    assert len(ms[0].points) > 0 and len(ms[3].points) == 3 * 24
    tviz.save_markers_npz(str(tmp_path / "t.npz"), ms)
    jviz.save_markers_npz(str(tmp_path / "j.npz"), js)
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert tviz.hsv_to_rgb(200.0, 0.5, 0.8) == jviz.hsv_to_rgb(200.0, 0.5, 0.8)


def test_mask_creator_against_jax(tmp_path):
    rng = np.random.default_rng(9)
    t, j = tmask.MaskCreator(8, 32, device="cpu"), jmask.MaskCreator(8, 32)
    for k in range(5):
        r = rng.integers(1, 9000, 256).astype(np.uint32)
        r[rng.random(256) < 0.05] = 0
        if k == 2:
            r[:3] = np.uint32(2**31 + 5)  # past int32: still a return
        t.add_scan(r)
        j.add_scan(r)
    assert t.n_scans == j.n_scans == 5
    assert np.array_equal(t.mask(), j.mask()) and t.mask().dtype == np.uint8
    assert 0 < int((t.mask() == 0).sum()) < 256 and t.mask()[0, :3].all()
    t.save(str(tmp_path / "t.npy"))
    j.save(str(tmp_path / "j.npy"))
    assert np.array_equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))
    with pytest.raises(ValueError, match="size"):
        t.add_scan(np.zeros(10, np.uint32))
    t.reset()
    assert t.n_scans == 0 and t.mask().all()


def test_mask_creator_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmask.MaskCreator(8, 32)


# --------------------------------------------------------------------------------- params


def _pw_nodes(**cfg_kw):
    """A port node and a JAX node of tests/test_param_watch.py's config."""
    kw = dict(max_clusters=4, max_far_voxels=128, max_queries=32, explore_submap=8,
              confidence_submap=8, **cfg_kw)
    nodes = []
    for cfg_mod, make in ((tcfg, lambda c, d: VoFOD(c, d, device="cpu")),
                          (jcfg, lambda c, d: JNode(c, d))):
        cfg = cfg_mod.VoFODConfig(
            sensor=cfg_mod.SensorConfig(vertical_rays=8, horizontal_rays=32,
                                        vertical_fov=np.deg2rad(90.0)),
            oparea=cfg_mod.Box((0.0, 0.0, 5.0), (10.0, 10.0, 10.0)), **kw)
        nodes.append(make(cfg, cfg_mod.DynParams()))
    return nodes


_MTIME = [1.7e9]


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    # poll() keys on mtime: set a new one, never sleep
    _MTIME[0] += 1.0
    os.utime(path, (_MTIME[0], _MTIME[0]))


def _pw_initial(p, w, nodes, log):
    _write(p, "classification: {max_size: 5.0}\n")
    assert w.poll() == {"cls_max_size": 5.0}


def _pw_unchanged(p, w, nodes, log):
    _write(p, "classification: {max_size: 5.0}\n")
    w.poll()
    assert w.poll() is None and w.n_applied == 1


def _pw_delta(p, w, nodes, log):
    _write(p, "raycast: {pause: false}\n")
    w.poll()
    _write(p, "raycast: {pause: true, max_distance: 15.0}\n")
    assert w.poll() == {"raycast_pause": True, "raycast_max_distance": 15.0}
    assert w.n_applied == 1


def _pw_static_radius(p, w, nodes, log):
    _write(p, "ground_points_max_distance: 2.5\nclassification: {max_size: 4.0}\n")
    assert w.poll() == {"cls_max_size": 4.0}
    assert w.node.dyn.ground_points_max_distance == 1.5
    assert any("dynamic_radii" in m for m in log())


def _pw_dynamic_radius(p, w, nodes, log):
    _write(p, "ground_points_max_distance: 1.0\n")
    assert w.poll() == {"ground_points_max_distance": 1.0}


def _pw_malformed(p, w, nodes, log):
    _write(p, "classification: {max_size: 5.0}\n")
    w.poll()
    _write(p, "classification: {max_size: [unclosed\n")
    assert w.poll() is None and w.node.dyn.cls_max_size == 5.0
    assert any("unparsable" in m for m in log())
    _write(p, "classification: {max_size: 6.0}\n")
    assert w.poll() == {"cls_max_size": 6.0}


def _pw_partial(p, w, nodes, log):
    w.node.update_params(cls_max_size=5.0, thr_new_obstacles=0.42)
    _write(p, "raycast: {pause: true}\n")
    assert w.poll() == {"raycast_pause": True}
    assert (w.node.dyn.cls_max_size, w.node.dyn.thr_new_obstacles) == (5.0, 0.42)


def _pw_missing(p, w, nodes, log):
    assert w.poll() is None


PW_CASES = dict(initial=_pw_initial, unchanged=_pw_unchanged, delta=_pw_delta,
                static_radius=_pw_static_radius, dynamic_radius=_pw_dynamic_radius,
                malformed=_pw_malformed, partial=_pw_partial, missing=_pw_missing)


@pytest.mark.parametrize("case", sorted(PW_CASES))
def test_param_watcher_cases_against_jax(tmp_path, caplog, case):
    """tests/test_param_watch.py's eight cases through the port's watcher on
    a port node, and the same edits through JAX's watcher on a JAX node:
    the same changes returned and the same live parameters after each."""
    results = []
    nodes = _pw_nodes(dynamic_radii=case == "dynamic_radius")
    for node, watcher_cls, pkg in zip(nodes, (tpw.ParamWatcher, jpw.ParamWatcher),
                                      ("port", "jax")):
        p = str(tmp_path / f"{pkg}.yaml")
        w = watcher_cls(node, p)
        caplog.clear()
        with caplog.at_level("WARNING"):
            PW_CASES[case](p, w, node, lambda: [r.getMessage() for r in caplog.records])
        results.append((dataclasses.asdict(node.dyn), w.n_applied))
    assert results[0] == results[1]


# ------------------------------------------------------------------------------ ROS nodes


def _ros_port_node():
    cfg = tcfg.VoFODConfig(
        sensor=tcfg.SensorConfig(vertical_rays=RH, horizontal_rays=RW,
                                 vertical_fov=np.deg2rad(90.0)),
        oparea=tcfg.Box((0.0, 0.0, 5.75), (16.0, 16.0, 11.5)),
        background_sufficient_points_ratio=0.05, max_clusters=8, max_far_voxels=512,
        max_queries=64, explore_submap=16, confidence_submap=8)
    det = VoFOD(cfg, tcfg.DynParams(raycast_weight_coefficient=0.5), device="cpu")
    xs = np.arange(-7.5, 8.0, 0.5)
    gx, gy = np.meshgrid(xs, xs)
    det.load_apriori_map(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 0.5)], axis=1))
    return det


def test_ros_node_wire_surface(ros_stub):  # noqa: F811
    tros.RosNode(_ros_port_node(), remap={"~pointcloud": "/uav1/os_cloud_nodelet/points"},
                 topic_suffix="_")
    assert set(ros_stub.subs) == {"/uav1/os_cloud_nodelet/points", "~height_rangefinder"}
    assert set(ros_stub.srvs) == {"~reset"}
    for topic in ("~detections_json_", "~status_json_", "~profiling_info_json_",
                  "~detections_mks_", "~background_pc_", "~sure_air_pc_"):
        assert topic in ros_stub.pubs, topic
    assert ros_stub.timers


def test_ros_node_detections_equal_direct_node(ros_stub):  # noqa: F811
    """tests/test_ros_node.py's scan sequence through the port's RosNode
    publishes, scan for scan, the JSON of a port node stepped directly."""
    node = tros.RosNode(_ros_port_node())
    direct = _ros_port_node()
    cb = ros_stub.subs["~pointcloud"]
    lut = make_lut(direct.cfg.sensor)
    pose = hover_pose((0.0, 0.0, 7.0))  # the stub's TF
    ground, target = Scene(ground_z=0.5), Scene(ground_z=0.5)
    target.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
    want = []
    for k in range(9):
        r = render_scan(ground if k < 6 else target, lut, pose)
        cb(_pc_msg(r, stamp=float(k)))
        want.append(tros.detections_to_json(direct.process_scan(r, None, pose, float(k))))
    got = [m.data for m in ros_stub.pubs["~detections_json"].published]
    assert got == want
    last = json.loads(got[-1])
    assert len(last["detections"]) == 1 and abs(last["detections"][0]["position"][2] - 9.0) < 1.0
    assert ros_stub.pubs["~detections_mks"].published[-1].markers
    ros_stub.timers[0][1](None)  # the status timer: status + both debug clouds
    assert json.loads(ros_stub.pubs["~status_json"].published[-1].data)["detection_enabled"]
    assert ros_stub.pubs["~background_pc"].published and ros_stub.pubs["~sure_air_pc"].published
    assert ros_stub.pubs["~profiling_info_json"].published
    assert ros_stub.srvs["~reset"](None).success and node.det.state.step == 0


def test_ros_node_tf_failure_drops_scan(ros_stub, monkeypatch):  # noqa: F811
    import tf2_ros

    node = tros.RosNode(_ros_port_node())
    monkeypatch.setattr(tf2_ros.Buffer, "lookup_transform",
                        lambda self, *a: (_ for _ in ()).throw(RuntimeError("no tf")))
    ros_stub.subs["~pointcloud"](_pc_msg(np.zeros(RH * RW, np.uint32)))
    assert node.tf_failures == 1 and ros_stub.warnings
    assert not ros_stub.pubs["~detections_json"].published


def test_ros_mask_creator_against_jax(ros_stub, tmp_path):  # noqa: F811
    """RosMaskCreator on the port's MaskCreator and on JAX's, fed the same
    clouds: the same mono8 image, and the ~save / ~reset services."""
    path = str(tmp_path / "mask.npy")
    imgs = []
    for mc in (tmask.MaskCreator(RH, RW, device="cpu"), jmask.MaskCreator(RH, RW)):
        mod = tros if isinstance(mc, tmask.MaskCreator) else jros
        ros_stub.subs.clear()
        ros_stub.srvs.clear()
        node = mod.RosMaskCreator(mc, mask_fname=path)
        rng = np.random.default_rng(1)
        for _ in range(3):
            r = rng.integers(1, 9000, RH * RW).astype(np.uint32)
            r[rng.random(RH * RW) < 0.05] = 0
            ros_stub.subs["~pointcloud"](_pc_msg(r))
        ros_stub.timers[-1][1](None)
        img = ros_stub.pubs["~mask"].published[-1]
        assert (img.height, img.width, img.encoding, img.step) == (RH, RW, "mono8", RW)
        imgs.append(img.data)
        assert ros_stub.srvs["~save"](None).success
        assert np.array_equal(np.load(path), node.mc.mask())
        assert ros_stub.srvs["~reset"](None).success and node.mc.n_scans == 0
    assert imgs[0] == imgs[1]
    assert set(np.frombuffer(imgs[0], np.uint8)) == {0, 255}
