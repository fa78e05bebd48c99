"""The port's serving modules on the CPU: the native scan ring against
vofod_tpu's, the streaming runtime at pipeline depths 0, 1 and 3 (a port of
tests/test_stream.py), and the fleet serving CLI (tests/test_cli_tools.py's
recordings and YAML configs) against a directly driven fleet, with the
flags it refuses.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.io.scan_queue import ScanQueue as JScanQueue
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig, load_config
from vofod_tpu_torch.io.scan_queue import ScanQueue
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan, save_scans_npz
from vofod_tpu_torch.parallel.sharding import batched_state_from_numpy, batched_state_to_numpy
from vofod_tpu_torch.runtime import fleet as fleet_mod
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD
from vofod_tpu_torch.runtime.stream import StreamRunner
from vofod_tpu_torch.sensor import make_lut_simulation
from vofod_tpu_torch.tools import serve_fleet


def _frames(n_points: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        r = rng.integers(0, 90_000, n_points, dtype=np.uint32)
        inten = None if k % 3 == 1 else rng.random(n_points).astype(np.float32)
        pose = rng.normal(size=(4, 4)).astype(np.float32)
        out.append((r, pose, inten))
    return out


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_scan_queue_matches_jax(capacity):
    """The same frames pushed and popped in the same order give the same
    acceptances, sizes, drop counts and popped frames (intensity None stored
    as all-ones), through the ring's wrap-around."""
    n = 96
    ours, theirs = ScanQueue(n, capacity), JScanQueue(n, capacity)
    frames = _frames(n, 3 * capacity + 2, seed=capacity)
    popped = [[], []]
    for k, (r, p, i) in enumerate(frames):
        assert ours.push(r, p, intensity=i) == theirs.push(r, p, intensity=i), k
        assert len(ours) == len(theirs) and ours.dropped == theirs.dropped, k
        if k % 3 == 2:  # a consumer that falls behind
            for q, got in zip((ours, theirs), popped):
                got.append(q.pop())
    for q, got in zip((ours, theirs), popped):
        while (f := q.pop()) is not None:
            got.append(f)
        got.append(q.pop())
    assert ours.dropped == theirs.dropped > 0
    assert len(popped[0]) == len(popped[1])
    for a, b in zip(*popped):
        if a is None or b is None:
            assert a is None and b is None
            continue
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    accepted = [f for f in popped[0] if f is not None]
    assert all(f[0].dtype == np.uint32 and f[2].shape == (4, 4) for f in accepted)
    # a frame without an intensity channel comes out all-ones
    r, p, _ = frames[0]
    assert ours.push(r, p) and theirs.push(r, p)
    a, b = ours.pop(), theirs.pop()
    assert np.array_equal(a[1], np.ones(n, np.float32)) and np.array_equal(a[1], b[1])


def test_scan_queue_keeps_order_across_threads():
    """One producer thread, one consumer: every accepted frame comes out
    once, in push order, and the accepted plus the dropped are all frames."""
    n, total = 64, 200
    q = ScanQueue(n, capacity=4)
    got = []

    def produce():
        for k in range(total):
            q.push(np.full(n, k, np.uint32), np.eye(4))

    t = threading.Thread(target=produce)
    t.start()
    deadline = time.time() + 30
    while (t.is_alive() or len(q)) and time.time() < deadline:
        f = q.pop()
        if f is not None:
            got.append(int(f[0][0]))
    t.join(timeout=30)
    assert not t.is_alive()
    assert got == sorted(got) and len(set(got)) == len(got)
    assert len(got) + q.dropped == total


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_stream_processes_and_drops(depth):
    """tests/test_stream.py on the port's node: every pushed-and-accepted
    scan is processed, drops are accounted, the status callback runs."""
    cfg = VoFODConfig(
        sensor=SensorConfig(vertical_rays=8, horizontal_rays=32),
        oparea=Box((0, 0, 4), (10.0, 10.0, 10.0)),
        max_clusters=4, max_far_voxels=128, max_queries=32,
        explore_submap=8, confidence_submap=8,
    )
    node = VoFOD(cfg, DynParams(), NodeOptions(raycast_mode="off"), device="cpu")
    pose = hover_pose((0.0, 0.0, 3.0))
    ranges = render_scan(Scene(ground_z=0.0), node.lut, pose)
    node.process_scan(ranges, None, pose)

    got, statuses = [], []
    runner = StreamRunner(
        node,
        on_detections=got.append,
        on_status=statuses.append,
        status_period_s=0.02,
        pipeline_depth=depth,
    ).start()
    N = 25

    def produce():
        for _ in range(N):
            runner.push(ranges, pose)
            time.sleep(0.002)

    t = threading.Thread(target=produce)
    t.start()
    t.join(timeout=60)
    runner.drain()
    runner.stop()
    assert not t.is_alive() and runner._thread is None
    assert runner.stats.processed + runner.stats.dropped == N
    assert runner.stats.processed == len(got) >= 1
    assert len(statuses) >= 1
    assert node.state.step == runner.stats.processed + 1


# --- the fleet serving CLI ----------------------------------------------------

N_STREAMS, N_TICKS = 8, 3
TARGET = ((2.0, 0.0, 3.0), 1.0)  # a sphere the learned map below detects


def _yamls(tmp_path):
    """tests/test_cli_tools.py's detection, sensor and map YAML files."""
    files = {
        "det.yaml": "voxel_map: {voxel_size: 0.5}\nbackground_sufficient_points_ratio: 0.05\n",
        "sen.yaml": "sensor: {vertical_fov_angle: 90.0, vertical_rays: 8, "
                    "horizontal_rays: 32}\n",
        "map.yaml": "operation_area:\n  offset: {x: 0.0, y: 0.0, z: -1.0}\n"
                    "  size: {x: 10.0, y: 10.0, z: 10.0}\n",
    }
    paths = {}
    for name, text in files.items():
        paths[name] = str(tmp_path / name)
        with open(paths[name], "w") as f:
            f.write(text)
    return paths


def _cli_config(paths):
    cfg, dyn = load_config(paths["det.yaml"], paths["sen.yaml"], paths["map.yaml"])
    return dataclasses.replace(cfg, max_clusters=8, max_far_voxels=512, max_queries=64,
                               explore_submap=16, confidence_submap=8), dyn


def _recordings(tmp_path, n=4):
    """Two recordings of n identical frames each (a target; the empty
    ground): whichever frame the lockstep consumer takes is the same."""
    lut = make_lut_simulation(32, 8, np.deg2rad(90.0))
    pose = hover_pose((0.0, 0.0, 3.0))
    out = []
    for name, target in (("target.npz", True), ("empty.npz", False)):
        sc = Scene(ground_z=0.0)
        if target:
            sc.add_sphere(center=TARGET[0], radius=TARGET[1])
        r = render_scan(sc, lut, pose)
        out.append(str(tmp_path / name))
        save_scans_npz(out[-1], np.stack([r] * n), np.stack([pose] * n))
    return out, pose


def _learned_map(cfg, dyn):
    """A node's state after an apriori plane and 30 empty scans, for every
    stream (a cold map detects nothing in a few ticks)."""
    node = VoFOD(cfg, dyn, device="cpu")
    xs = np.arange(-3.0, 3.0, 0.4)
    gx, gy = np.meshgrid(xs, xs)
    node.load_apriori_map(np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1))
    pose = hover_pose((0.0, 0.0, 3.0))
    empty = render_scan(Scene(ground_z=0.0), node.lut, pose)
    for _ in range(30):
        node.process_scan(empty, None, pose)
    return batched_state_to_numpy([node.state] * N_STREAMS)


def test_serve_fleet_cli_matches_direct_fleet(tmp_path, capsys, monkeypatch):
    """serve_fleet on the CPU: 8 streams round-robined over two recordings,
    N_TICKS lockstep ticks from a learned map; its JSON detection records
    equal those of a FleetVoFOD driven directly with the same frames, the
    summary counts the ticks, and stderr keeps the "N ticks x B local
    streams" line."""
    paths = _yamls(tmp_path)
    (target, empty), pose = _recordings(tmp_path)
    cfg, dyn = _cli_config(paths)
    warm = _learned_map(cfg, dyn)

    class LearnedFleet(fleet_mod.FleetVoFOD):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.state = batched_state_from_numpy(warm, self.device)

    monkeypatch.setattr(fleet_mod, "FleetVoFOD", LearnedFleet)
    rc = serve_fleet.main([
        "--streams", str(N_STREAMS), "--scans", f"{target},{empty}", "--ticks", str(N_TICKS),
        "--loop", "--rate", "200", "--config", paths["det.yaml"], "--sensor",
        paths["sen.yaml"], "--map", paths["map.yaml"], "--small-capacities", "--json",
        "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr()
    assert f"{N_TICKS} ticks x {N_STREAMS} local streams" in out.err
    lines = [json.loads(ln) for ln in out.out.strip().splitlines()]
    summary = [ln for ln in lines if ln.get("summary")]
    assert len(summary) == 1 and summary[0]["ticks"] == N_TICKS
    assert summary[0]["streams"] == N_STREAMS
    assert [ln["tick"] for ln in lines if "latency_ms" in ln] == list(range(1, N_TICKS + 1))
    got = [ln for ln in lines if "stream" in ln]

    fleet = LearnedFleet(cfg, dyn, n_streams=N_STREAMS, device="cpu")
    frames = {p: np.load(p)["ranges"][0] for p in (target, empty)}
    ranges = np.stack([frames[(target, empty)[b % 2]] for b in range(N_STREAMS)])
    want = []
    for tick in range(1, N_TICKS + 1):
        msgs = fleet.process_local_scans(ranges, np.stack([pose] * N_STREAMS))
        for b, msg in sorted(msgs.items()):
            for d in msg.detections:
                want.append({"tick": tick, "stream": b, "id": d.id,
                             "position": list(d.position), "confidence": d.confidence,
                             "detection_probability": d.detection_probability})
    assert got == want
    assert {r["stream"] for r in got} == set(range(0, N_STREAMS, 2))  # the target's streams


@pytest.mark.parametrize("flags,says", [
    (["--coordinator", "head:1234"], "torch.distributed"),
    (["--num-processes", "2"], "torch.distributed"),
    (["--process-id", "0"], "torch.distributed"),
    (["--streams", "auto"], "bench"),
    (["--grid-shards", "2"], "2-D"),
])
def test_serve_fleet_refuses_what_waits(flags, says, capsys):
    """Each ends in an argument error (exit code 2) that says why, before
    any fleet is built or any process group joined: --coordinator without
    --ticks, --num-processes or --process-id without --coordinator,
    --streams auto (it waits for the bench's stream knee) and --grid-shards
    2 on the flagship grid's 51 planes."""
    with pytest.raises(SystemExit) as ei:
        serve_fleet.main(["--sim", "--device", "cpu", *flags])
    assert ei.value.code == 2
    assert says in capsys.readouterr().err
