"""The port's fleet served by two processes (runtime/fleet.py
``initialize_multihost``, ``FleetVoFOD.local_streams`` /
``process_local_scans``; tools/serve_fleet.py ``--coordinator``) on the CPU.

Two subprocesses, each with jax imports refused, join a gloo group on
127.0.0.1 and hold ``FleetVoFOD(n_streams=4, device="cpu")`` with 1 and
with 2 grid shards, every stream from one learned map: process 0 serves
streams [0, 1], process 1 streams [2, 3], and every stream's detections,
diagnostics, pose rejections and final state over 3 ticks (a NaN rotation
on stream 3 at tick 1) are bit-equal to a single-process fleet of 4
streams fed the same scans.  A fleet whose ``n_streams`` differs between
the processes raises on both, within the timeout; the serving CLI runs
across two processes, each reporting only its own streams, and refuses
``--coordinator`` without ``--ticks``.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu_torch.runtime.fleet import FleetVoFOD
from vofod_tpu_torch.tools import serve_fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

# the fleet, its scans and its records: run by the workers and by this
# process alike
_COMMON = textwrap.dedent(
    """
    import dataclasses
    import numpy as np
    from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
    from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan

    N_STREAMS, N_TICKS, NAN = 4, 3, (1, 3)

    def cfg():
        return VoFODConfig(
            sensor=SensorConfig(vertical_rays=8, horizontal_rays=32,
                                vertical_fov=np.deg2rad(90.0)),
            oparea=Box((0.0, 0.0, 3.75), (8.0, 8.0, 7.5)),
            background_sufficient_points_ratio=0.05, max_clusters=4, max_far_voxels=128,
            max_queries=32, explore_submap=8, confidence_submap=8)

    def plane():
        xs = np.arange(-3.0, 3.0, 0.4)
        gx, gy = np.meshgrid(xs, xs)
        return np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)

    def tick(lut, k):
        rs, ps = [], []
        for b in range(N_STREAMS):
            sc = Scene(ground_z=0.0)
            sc.add_sphere(center=(2.0 + 0.1 * b + 0.05 * k, 0.3 * b - 0.45, 3.0),
                          radius=0.9 - 0.05 * b)
            p = hover_pose((0.05 * b, -0.05 * b, 3.0 + 0.02 * k), yaw=0.05 * b)
            rs.append(render_scan(sc, lut, p))
            ps.append(p)
        poses = np.stack(ps).astype(np.float32)
        if k == NAN[0]:
            poses[NAN[1], :3, :3] = np.nan
        return np.stack(rs), poses

    def records(fleet, msgs):
        # {global stream: (detections, diagnostics)} of one tick
        d = fleet.last_diag
        return {b: ([dataclasses.astuple(x) for x in m.detections],
                    {f.name: np.asarray(getattr(d, f.name))[i].tolist()
                     for f in dataclasses.fields(d)})
                for i, (b, m) in enumerate(msgs.items())}

    def warm():
        # the learned map every stream starts from: a node's state after the
        # apriori plane and 30 empty scans (a cold map detects nothing in a
        # few ticks at 8 x 32 rays)
        from vofod_tpu_torch.pipeline.state import state_to_numpy
        from vofod_tpu_torch.runtime.node import VoFOD
        node = VoFOD(cfg(), DynParams(), device="cpu")
        node.load_apriori_map(plane())
        pose = hover_pose((0.0, 0.0, 3.0))
        empty = render_scan(Scene(ground_z=0.0), node.lut, pose)
        for _ in range(30):
            node.process_scan(empty, None, pose)
        return state_to_numpy(node.state)

    def run(fleet, local_only, learned):
        rows = {k: np.stack([v] * fleet.n_local) for k, v in learned.items()}
        fleet.state = (batched_state_from_numpy(rows, "cpu") if fleet.comm is None
                       else fleet_grid_state_from_numpy(rows, fleet.comm))
        out = []
        for k in range(N_TICKS):
            r, p = tick(fleet.lut, k)
            if local_only:
                ids = fleet.local_streams
                msgs = fleet.process_local_scans(r[ids], p[ids], stamp=0.1 * k)
            else:
                msgs = dict(enumerate(fleet.process_scans(r, p, stamp=0.1 * k)))
            out.append(records(fleet, msgs))
        states = fleet.state if fleet.comm is None else [
            gather_state(s) for s in fleet.state]
        final = {b: {f: (v if f == "step" else v.numpy().copy())
                     for f, v in vars(s).items()}
                 for b, s in zip(fleet.local_streams, states)}
        return dict(local=fleet.local_streams, ticks=out, final=final,
                    rejected=fleet.n_pose_rejected.tolist())

    from vofod_tpu_torch.parallel.grid_step import fleet_grid_state_from_numpy, gather_state
    from vofod_tpu_torch.parallel.sharding import batched_state_from_numpy
    """
)

_WORKER = textwrap.dedent(
    """
    import importlib.abc, pickle, sys
    from datetime import timedelta

    class RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"jax is refused here: {name}")
            return None

    sys.meta_path.insert(0, RefuseJax())
    rank, port, mode, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    import torch
    torch.set_num_threads(1)
    from vofod_tpu_torch.runtime.fleet import FleetVoFOD, initialize_multihost
    """
) + _COMMON + textwrap.dedent(
    """
    initialize_multihost(f"127.0.0.1:{port}", 2, rank, timeout=timedelta(seconds=60))
    if mode == "mismatch":
        try:
            FleetVoFOD(cfg(), DynParams(), n_streams=4 + 2 * rank, device="cpu")
        except ValueError as e:
            print("MISMATCH", e, flush=True)
            # join the group's threads before the interpreter exits: a
            # joinable one left to the exit aborts the process
            torch.distributed.destroy_process_group()
            sys.exit(3)
        sys.exit(0)
    res, learned = {}, warm()
    for shards in (1, 2):
        fleet = FleetVoFOD(cfg(), DynParams(), n_streams=N_STREAMS, device="cpu",
                           grid_shards=shards)
        try:
            fleet.process_scans(*tick(fleet.lut, 0))
        except RuntimeError as e:
            assert "process_local_scans" in str(e)
        else:
            raise AssertionError("process_scans ran in a 2-process fleet")
        res[shards] = run(fleet, local_only=True, learned=learned)
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print("WORKER_OK", rank, flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair(args_of) -> list[tuple[int, str, str]]:
    """Start two processes (``args_of(rank)`` their command), wait for both
    within TIMEOUT; returns (exit code, stdout, stderr) of each.  A process
    still running at the timeout is killed and fails the test."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(args_of(rank), cwd=REPO, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for rank in range(2)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _ns() -> dict:
    ns = {}
    exec(_COMMON, ns)
    return ns


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("procs")
    port = _free_port()
    paths = [str(tmp / f"rank{r}.pkl") for r in range(2)]
    got = _pair(lambda r: [sys.executable, "-c", _WORKER, str(r), str(port), "fleet", paths[r]])
    for r, (rc, o, e) in enumerate(got):
        assert rc == 0 and f"WORKER_OK {r}" in o, f"rank {r}: rc {rc}\n{e[-4000:]}"
    res = []
    for p in paths:
        with open(p, "rb") as f:
            res.append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def single():
    ns = _ns()
    learned = ns["warm"]()
    return {shards: ns["run"](FleetVoFOD(ns["cfg"](), ns["DynParams"](), n_streams=4,
                                         device="cpu", grid_shards=shards), local_only=False,
                              learned=learned)
            for shards in (1, 2)}


@pytest.mark.parametrize("shards", [1, 2])
def test_two_processes_equal_one(workers, single, shards):
    """Each process serves its block of streams; every stream's records and
    final state equal the single-process fleet's bit for bit."""
    one = single[shards]
    assert [w[shards]["local"] for w in workers] == [[0, 1], [2, 3]]
    assert one["local"] == [0, 1, 2, 3]
    for w in workers:
        run = w[shards]
        for k, tick in enumerate(run["ticks"]):
            assert sorted(tick) == run["local"]
            for b, rec in tick.items():
                assert rec == one["ticks"][k][b], f"tick {k}, stream {b}"
        for b, st in run["final"].items():
            for f, v in st.items():
                want = one["final"][b][f]
                assert (v == want if f == "step" else np.array_equal(v, want)), (b, f)
    # the null scan is counted on its own process, by global stream id
    assert workers[0][shards]["rejected"] == [0, 0, 0, 0]
    assert workers[1][shards]["rejected"] == one["rejected"] == [0, 0, 0, 1]
    assert any(rec[0] for tick in one["ticks"] for rec in tick.values())


def test_mismatched_fleets_raise_on_both(tmp_path):
    """n_streams 4 on one process and 6 on the other: both raise at
    construction (exit 3 here), neither hangs."""
    port = _free_port()
    got = _pair(lambda r: [sys.executable, "-c", _WORKER, str(r), str(port), "mismatch",
                           str(tmp_path / "unused")])
    for r, (rc, o, e) in enumerate(got):
        assert rc == 3 and "MISMATCH" in o and "built another fleet" in o, \
            f"rank {r}: rc {rc}\n{o[-2000:]}\n{e[-4000:]}"


def test_serve_fleet_across_two_processes(tmp_path):
    """serve_fleet --coordinator in two processes (4 simulated streams, 2
    ticks): each exits 0 and reports its own 2 streams only."""
    files = {"det.yaml": "voxel_map: {voxel_size: 0.5}\n",
             "sen.yaml": "sensor: {vertical_fov_angle: 90.0, vertical_rays: 8, "
                         "horizontal_rays: 32}\n",
             "map.yaml": "operation_area:\n  offset: {x: 0.0, y: 0.0, z: 3.75}\n"
                         "  size: {x: 10.0, y: 10.0, z: 7.5}\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    port = _free_port()
    got = _pair(lambda r: [
        sys.executable, "-m", "vofod_tpu_torch.tools.serve_fleet", "--streams", "4", "--sim",
        "--ticks", "2", "--rate", "50", "--json", "--device", "cpu", "--small-capacities",
        "--config", str(tmp_path / "det.yaml"), "--sensor", str(tmp_path / "sen.yaml"),
        "--map", str(tmp_path / "map.yaml"), "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", "2", "--process-id", str(r)])
    for r, (rc, o, e) in enumerate(got):
        assert rc == 0, f"rank {r}: rc {rc}\n{e[-4000:]}"
        lines = [json.loads(ln) for ln in o.splitlines() if ln.startswith("{")]
        summary = [ln for ln in lines if ln.get("summary")]
        assert len(summary) == 1 and summary[0]["ticks"] == 2 and summary[0]["streams"] == 2
        assert {ln["stream"] for ln in lines if "stream" in ln} <= {2 * r, 2 * r + 1}
        assert "2 ticks x 2 local streams" in e


def test_coordinator_needs_ticks(capsys):
    """--coordinator without --ticks ends in the argument error (exit code
    2) before any process group is joined."""
    with pytest.raises(SystemExit) as ei:
        serve_fleet.main(["--sim", "--device", "cpu", "--coordinator", "127.0.0.1:1",
                          "--num-processes", "2", "--process-id", "0"])
    assert ei.value.code == 2
    assert "--ticks is required with --coordinator" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()
