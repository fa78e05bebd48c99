"""The slice as a whole: the port's detect and create_mask CLIs against
JAX's, on the CPU, and ``StagedStep`` against the fused step.

* ``vofod_tpu_torch.tools.detect --device cpu`` and
  ``vofod_tpu.tools.detect`` on tests/test_rosbag_ingest.py's bag (20
  staggered scans with intensity, a TF chain, a target from scan 8):
  ids and ``n_points`` equal, positions within 1e-3 m, confidence within
  0.2 % (the budget of tests/test_torch_step.py); the port CLI's lines
  bit-equal to a port node stepped directly on the converted NPZ.
* Every other flag of the port's CLI on the converted NPZ's first 10
  scans: checkpoint
  directories (``--save-state`` / ``--load-state``), markers with a viz
  config, a FOV mask, the raycast and frontend modes, and a watched params
  file whose edit before scan 3 equals ``update_params`` at scan 3.
* ``create_mask``'s ``.npy`` equal to JAX's tool's.
* ``StagedStep`` bit-equal to the fused step over a scan sequence.
* With no GPU, the CLIs' default device raises.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from tests.test_rosbag_ingest import H, W, fixture_bag  # noqa: F401
from tests.test_torch_step import CONF_RTOL
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.tools import create_mask as jmask_cli
from vofod_tpu.tools import detect as jdetect
from vofod_tpu_torch.config import load_config
from vofod_tpu_torch.io.pc_loader import load_cloud, save_cloud
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, load_scans_npz, render_scan
from vofod_tpu_torch.pipeline.state import ScanInput, init_state, state_to_numpy
from vofod_tpu_torch.pipeline.step import StagedStep, make_step_fn
from vofod_tpu_torch.runtime import node as node_mod
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD
from vofod_tpu_torch.tools import bag_to_npz
from vofod_tpu_torch.tools import create_mask as tmask_cli
from vofod_tpu_torch.tools import detect as tdetect


@pytest.fixture(scope="module")
def inputs(fixture_bag, tmp_path_factory):  # noqa: F811
    """The bag, its metadata, the YAMLs of tests/test_rosbag_ingest.py's
    CLI test, the ground cloud, and the bag converted to NPZ."""
    bag_path, meta_path, _, _ = fixture_bag
    tmp = tmp_path_factory.mktemp("cli")
    files = dict(bag=bag_path, meta=meta_path, det=str(tmp / "det.yaml"),
                 sen=str(tmp / "sen.yaml"), map=str(tmp / "map.yaml"),
                 cloud=str(tmp / "ground.pts"), npz=str(tmp / "scans.npz"), tmp=str(tmp))
    with open(files["det"], "w") as f:
        f.write("background_sufficient_points_ratio: 0.05\nraycast: {weight_coefficient: 0.5}\n")
    with open(files["sen"], "w") as f:
        f.write("sensor: {vertical_fov_angle: 90.0, vertical_rays: 16, horizontal_rays: 64}\n")
    with open(files["map"], "w") as f:
        f.write("operation_area:\n  offset: {x: 0.0, y: 0.0, z: 0.0}\n"
                "  size: {x: 16.0, y: 16.0, z: 11.5}\n")
    xs = np.arange(-7.5, 8.0, 0.5)
    gx, gy = np.meshgrid(xs, xs)
    save_cloud(files["cloud"], np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 0.5)], 1))
    bag_to_npz.convert_bag(bag_path, files["npz"], "/os_cloud_node/points", do_destagger=True,
                           metadata_json=meta_path)
    # the flag tests replay scans 0-9 (the target is detected from scan 8)
    files["short"] = str(tmp / "short.npz")
    with np.load(files["npz"]) as z:
        np.savez(files["short"], **{k: v[:10] for k, v in z.items()})
    return files


def _common(f):
    return ["--config", f["det"], "--sensor", f["sen"], "--map", f["map"],
            "--apriori-cloud", f["cloud"], "--small-capacities", "--json"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def _direct_node(f, stamp=True, **opt):
    """A port node built as the CLI builds it, for stepping directly."""
    cfg, dyn = load_config(f["det"], f["sen"], f["map"])
    cfg = dataclasses.replace(cfg, max_clusters=8, max_far_voxels=512, max_queries=64,
                              explore_submap=16, confidence_submap=8)
    node = VoFOD(cfg, dyn, NodeOptions(throttle_period=cfg.throttle_period, **opt),
                 device="cpu")
    if stamp:
        node.load_apriori_map(load_cloud(f["cloud"]))
    return node


def _json_lines(msgs):
    """The CLI's --json lines of these messages, as parsed back."""
    return [json.loads(tdetect.json_line(m)) for m in msgs]


def test_detect_cli_against_jax_cli(inputs):
    f = inputs
    argv = ["--scans", f["bag"], "--pointcloud-topic", "/os_cloud_node/points",
            "--metadata", f["meta"], *_common(f)]
    port = _run(tdetect.main, argv + ["--device", "cpu"])
    ref = _run(jdetect.main, argv)
    assert len(port) == len(ref) == 20
    n_det = 0
    for k, (a, b) in enumerate(zip(port, ref)):
        assert a["stamp"] == b["stamp"]
        assert [(d["id"], d["n_points"]) for d in a["detections"]] == [
            (d["id"], d["n_points"]) for d in b["detections"]], f"scan {k}"
        for da, db in zip(a["detections"], b["detections"]):
            np.testing.assert_allclose(da["position"], db["position"], atol=1e-3)
            np.testing.assert_allclose(da["confidence"], db["confidence"], rtol=CONF_RTOL)
            n_det += 1
    assert n_det >= 5 and not any(m["detections"] for m in port[:8])
    # the CLI's lines are a port node's, stepped directly on the converted NPZ
    assert port == _json_lines(_direct_node(f).replay(f["npz"]))


@pytest.mark.parametrize("mode", ["exact", "off", "prebinned", "auto", "mask"])
def test_detect_cli_modes_equal_direct_node(inputs, tmp_path, mode):
    """The raycast / frontend / mask flags: the CLI equals a node built with
    the same options."""
    f = inputs
    flags, opt = [], {}
    if mode in ("exact", "off"):
        flags, opt = ["--raycast", mode], dict(raycast_mode=mode)
    elif mode in ("prebinned", "auto"):
        flags, opt = ["--frontend", mode], dict(frontend_mode=mode)
    else:
        mask = (np.random.default_rng(3).random((H, W)) > 0.2).astype(np.uint8)
        np.save(str(tmp_path / "mask.npy"), mask)
        flags = ["--mask", str(tmp_path / "mask.npy"), "--mask-mangle"]
        opt = dict(mask_path=str(tmp_path / "mask.npy"), mask_mangle=True)
    got = _run(tdetect.main, ["--scans", f["short"], *_common(f), "--device", "cpu", *flags])
    assert got == _json_lines(_direct_node(f, **opt).replay(f["short"]))


def test_detect_cli_state_markers_and_params(inputs, tmp_path, monkeypatch):
    """--save-state / --load-state as checkpoint directories, --markers
    with --viz-config, and --watch-params: the file's edit before scan 3
    equals update_params at scan 3."""
    f = inputs
    params = str(tmp_path / "params.yaml")
    with open(params, "w") as fp:
        fp.write("classification: {max_size: 5.0}\n")
    real_replay = node_mod.VoFOD.replay

    def replay(self, path, intensity=None, before_scan=None):
        def edit_then_poll(k):
            if k == 3:
                with open(params, "w") as fp:
                    fp.write("classification: {max_size: 5.0}\nraycast: {max_distance: 9.0}\n")
                os.utime(params, (2.0e9, 2.0e9))
            before_scan(k)
        return real_replay(self, path, intensity, edit_then_poll)

    monkeypatch.setattr(node_mod.VoFOD, "replay", replay)
    ckpt, markers = str(tmp_path / "ckpt"), str(tmp_path / "markers.npz")
    viz = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                       "visualization.yaml")
    got = _run(tdetect.main, ["--scans", f["short"], *_common(f), "--device", "cpu",
                              "--save-state", ckpt, "--markers", markers, "--viz-config", viz,
                              "--watch-params", params])
    monkeypatch.setattr(node_mod.VoFOD, "replay", real_replay)
    direct = _direct_node(f)
    direct.update_params(cls_max_size=5.0)

    def at3(k):
        if k == 3:
            direct.update_params(raycast_max_distance=9.0)

    assert got == _json_lines(direct.replay(f["short"], before_scan=at3))
    assert os.path.exists(os.path.join(ckpt, "manifest.json"))
    resumed = VoFOD(direct.cfg, direct.dyn, device="cpu")
    resumed.load_snapshot(ckpt)
    want = state_to_numpy(direct.state)
    assert all(np.array_equal(v, want[k]) for k, v in state_to_numpy(resumed.state).items())
    with np.load(markers) as z:
        assert any(k.endswith("voxel_map_cubes_points") for k in z.files) and len(z.files) == 6
    # --load-state resumes from the directory: the next pass over the scans
    # equals the direct node continuing
    again = _run(tdetect.main, ["--scans", f["short"], "--config", f["det"], "--sensor", f["sen"],
                                "--map", f["map"], "--small-capacities", "--json",
                                "--device", "cpu", "--load-state", ckpt])
    cont = _direct_node(f, stamp=False)
    cont.load_snapshot(ckpt)
    assert again == _json_lines(cont.replay(f["short"]))


def test_create_mask_cli_against_jax(inputs, tmp_path):
    f = inputs
    outs = [str(tmp_path / "port.npy"), str(tmp_path / "jax.npy")]
    assert tmask_cli.main(["--scans", f["npz"], "--out", outs[0], "--rays", f"{H}x{W}",
                           "--device", "cpu"]) == 0
    assert jmask_cli.main(["--scans", f["npz"], "--out", outs[1], "--rays", f"{H}x{W}"]) == 0
    a, b = np.load(outs[0]), np.load(outs[1])
    ranges = load_scans_npz(f["npz"])[0]
    want = np.logical_and.reduce(ranges > 0, axis=0).reshape(H, W).astype(np.uint8)
    assert np.array_equal(a, b) and np.array_equal(a, want) and 0 < int((a == 0).sum())


def test_clis_default_to_cuda_and_refuse_without_it(inputs, tmp_path, monkeypatch):
    f = inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdetect.main(["--scans", f["npz"], *_common(f)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmask_cli.main(["--scans", f["npz"], "--out", str(tmp_path / "m.npy")])


def test_staged_step_bit_equal_to_fused(inputs):
    """tests/test_staged_step.py on the port: the same scans (a live param
    change included) through make_step_fn and StagedStep give the same
    state and outputs bit for bit; the stage contexts open and close in
    routine order and every routine is timed."""
    node = _direct_node(inputs)
    cfg, lut = node.cfg, node.lut
    fused = make_step_fn(cfg, lut, device="cpu", raycast_every=2)
    staged = StagedStep(cfg, lut, device="cpu", raycast_every=2)
    sf, ss = init_state(cfg, node.dyn, device="cpu"), init_state(cfg, node.dyn, device="cpu")
    sf.grid[1].fill_(float("inf"))
    ss.grid[1].fill_(float("inf"))
    seen = []

    @contextlib.contextmanager
    def ctx(name):
        seen.append(("enter", name))
        yield
        seen.append(("exit", name))

    for i in range(10):
        scene = Scene(ground_z=0.5)
        if i >= 5:
            scene.add_sphere(center=(4.0 - 0.1 * i, 0.0, 9.0), radius=0.7)
        pose = hover_pose((1.2 * np.cos(0.2 * i), 1.2 * np.sin(0.2 * i), 7.0), yaw=0.05 * i)
        r = torch.from_numpy(render_scan(scene, lut, pose).astype(np.float32))
        scan = ScanInput(ranges_mm=r, intensity=torch.ones_like(r), pose=pose)
        dyn = dataclasses.replace(node.dyn, raycast_weight_coefficient=0.31 if i >= 6 else 0.5)
        sf, of = fused(sf, scan, dyn)
        seen.clear()
        ss, os_ = staged(ss, scan, dyn, stage_ctx=ctx)
        assert seen == [(e, n) for n in ("cnc", "raycasting", "sepbgclusters")
                        for e in ("enter", "exit")]
        assert set(staged.last_timings) == {"cnc", "raycasting", "sepbgclusters"}
        want, got = state_to_numpy(sf), state_to_numpy(ss)
        assert all(np.array_equal(v, got[k]) for k, v in want.items()), f"scan {i}"
        for part in ("detections", "diag"):
            a, b = getattr(of, part), getattr(os_, part)
            for fld in dataclasses.fields(a):
                assert torch.equal(getattr(a, fld.name), getattr(b, fld.name)), (i, fld.name)
    assert int(sf.det_counter) > 0 and sf.step == 10
