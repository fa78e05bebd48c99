"""The grid axis across processes (vofod_tpu_torch/parallel/comm.py
``ProcessComm``; parallel/grid_step.py over it; runtime/fleet.py
``grid_shards_per_process=1``; runtime/checkpoint.py's collective save and
restore; tools/serve_fleet.py ``--grid-shards-per-process``) on the CPU.

Four worker processes, each with jax imports refused, join a gloo group on
127.0.0.1 (tests/test_torch_multiprocess.py's plumbing and its 8 x 32-ray
config: a 16 x 17 x 17 grid), one grid shard each, and every check is
against the same work in this one process over ``LocalComm``:

* every collective (``all_gather``, ``psum`` of float32 values spread over
  seven decades, so the order of the adds matters, a 0-d ``psum``,
  ``pmax``, ``any``, ``all_to_all`` of bfloat16, and one ``ppermutes`` call
  of six items: a cycle, a shift, a single pair, a cycle of two hops, with
  shapes and dtypes that differ between senders, then a 3-byte bool item
  and a float32 one to the same peer) over groups of 4 and of 2 shards,
  bit-equal to ``LocalComm(n, ["cpu"])`` on the same seeded inputs;
* the grid step (4 processes; and 2 with the transposed z cones, in both
  stream groups) over 4 scans from a learned map: every diagnostic and
  detection field and the gathered state bit-equal to the in-process grid
  step and to the dense step, and within tests/test_torch_step.py
  ``_compare``'s budgets of JAX's grid step on its 4-device CPU mesh;
* ``FleetVoFOD(n_streams=4, grid_shards=2, grid_shards_per_process=1)``:
  two stream groups of two processes, local streams [0, 1] and [2, 3] on
  both processes of a group, over 4 ticks (a NaN rotation on stream 3 at
  tick 1): records and final states bit-equal to a one-process 2-D fleet;
* the state after tick 1 saved by the processes in the ``streams_zshards``
  layout (each its own files, process 0 the manifest) and restored onto a
  one-process 2-D fleet and a 1-shard fleet, and a one-process fleet's
  checkpoint restored onto the processes, each reading its slabs only:
  every continuation equal to the uninterrupted run;
* a ``grid_shards_per_process`` that differs between the processes raises
  on all of them; a value other than ``grid_shards`` or 1 is refused;
* a rank that raises inside the step makes every other rank raise within
  the comm's 5 s timeout (it stays alive, so no closed socket tells them);
* ``serve_fleet --grid-shards 2 --grid-shards-per-process 1`` in two
  processes; its argument checks.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_step import _compare
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.parallel.grid_step import make_grid_mesh
from vofod_tpu.parallel.grid_step import make_grid_sharded_step as jmake_grid_step
from vofod_tpu.parallel.grid_step import shard_state as jshard_state
from vofod_tpu.pipeline.state import ScanInput as JScan
from vofod_tpu.pipeline.state import VoFODState as JState
from vofod_tpu.sensor import make_lut as jmake_lut
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.parallel.grid_step import init_grid_sharded_state
from vofod_tpu_torch.parallel.sharding import batched_state_to_numpy, init_batched_state
from vofod_tpu_torch.pipeline.state import init_state
from vofod_tpu_torch.runtime import checkpoint as ck
from vofod_tpu_torch.runtime.fleet import FleetVoFOD
from vofod_tpu_torch.tools import serve_fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
N_PROCS = 4
FAIL_TIMEOUT = 5.0  # the comm timeout of the failing-rank case

# run by the workers and by this process alike
_COMMON = textwrap.dedent(
    """
    import dataclasses
    import numpy as np
    import torch
    from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
    from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
    from vofod_tpu_torch.parallel.comm import LocalComm
    from vofod_tpu_torch.parallel.grid_step import (
        fleet_grid_state_from_numpy, fleet_grid_state_to_numpy, gather_state,
        make_grid_sharded_step, shard_state)
    from vofod_tpu_torch.pipeline.state import ScanInput, state_from_numpy, state_to_numpy
    from vofod_tpu_torch.runtime.checkpoint import restore_state, save_state
    from vofod_tpu_torch.sensor import make_lut

    N_STREAMS, N_TICKS, NAN, SAVE_AT = 4, 4, (1, 3), 2  # SAVE_AT: the state after ticks 0-1

    def cfg():
        return VoFODConfig(
            sensor=SensorConfig(vertical_rays=8, horizontal_rays=32,
                                vertical_fov=np.deg2rad(90.0)),
            oparea=Box((0.0, 0.0, 3.75), (8.0, 8.0, 7.5)),
            background_sufficient_points_ratio=0.05, max_clusters=4, max_far_voxels=128,
            max_queries=32, explore_submap=8, confidence_submap=8)

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

    def grid_scan(lut, k):
        # stream 1's scan of tick k: the stream that detects
        r, p = tick(lut, k)
        ranges = torch.from_numpy(r[1].astype(np.float32))
        return ScanInput(ranges_mm=ranges, intensity=torch.ones_like(ranges), pose=p[1])

    def out_np(out):
        return {part: {f.name: getattr(getattr(out, part), f.name).numpy().copy()
                       for f in dataclasses.fields(getattr(out, part))}
                for part in ("diag", "detections")}

    def grid_run(comm, learned, **kw):
        # the grid step over comm on stream 1's scans: per scan the outputs
        # and the whole state
        step = make_grid_sharded_step(cfg(), step_lut(), comm, **kw)
        states = shard_state(state_from_numpy(learned, "cpu"), comm)
        out = []
        for k in range(N_TICKS):
            states, o = step(states, grid_scan(step_lut(), k), DynParams())
            out.append((out_np(o), state_to_numpy(gather_state(states, comm))))
        return out

    _LUT = []

    def step_lut():
        if not _LUT:
            _LUT.append(make_lut(cfg().sensor))
        return _LUT[0]

    def records(fleet, msgs):
        d = fleet.last_diag
        return {b: ([dataclasses.astuple(x) for x in m.detections],
                    {f.name: np.asarray(getattr(d, f.name))[i].tolist()
                     for f in dataclasses.fields(d)})
                for i, (b, m) in enumerate(msgs.items())}

    def fleet_final(fleet):
        if fleet.comm is None:
            return dict(zip(fleet.local_streams, [state_to_numpy(s) for s in fleet.state]))
        arrays = fleet_grid_state_to_numpy(fleet.state, fleet.comm)
        return {b: {f: v[i] for f, v in arrays.items()} for i, b in enumerate(fleet.local_streams)}

    def fleet_ticks(fleet, start, stop, local_only, save=None):
        # ticks [start, stop) of the script; ``save``: the checkpoint path
        # written before tick SAVE_AT
        out = []
        for k in range(start, stop):
            if k == SAVE_AT and save is not None:
                save_state(save, fleet.state, layout="streams_zshards", comm=fleet.comm,
                           streams=fleet.local_streams if local_only else None)
            r, p = tick(fleet.lut, k)
            if local_only:
                ids = fleet.local_streams
                msgs = fleet.process_local_scans(r[ids], p[ids], stamp=0.1 * k)
            else:
                msgs = dict(enumerate(fleet.process_scans(r, p, stamp=0.1 * k)))
            out.append(records(fleet, msgs))
        return out

    def learned_rows(fleet, learned):
        return {k: np.stack([v] * fleet.n_local) for k, v in learned.items()}
    """
)

_WORKER = textwrap.dedent(
    """
    import importlib.abc, os, pickle, sys, time
    from datetime import timedelta

    class RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError(f"jax is refused here: {name}")
            return None

    sys.meta_path.insert(0, RefuseJax())
    rank, n_procs, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import torch
    torch.set_num_threads(1)
    from vofod_tpu_torch.parallel.comm import ProcessComm
    from vofod_tpu_torch.runtime.fleet import FleetVoFOD, initialize_multihost
    """
) + _COMMON + textwrap.dedent(
    """
    def inputs(r, n):
        g = np.random.default_rng(100 + r)
        f = g.normal(size=(6, 5)) * 10.0 ** g.integers(-3, 4, (6, 5))
        return dict(f=torch.from_numpy(f.astype(np.float32)),
                    s=torch.tensor(float(g.normal()), dtype=torch.float32),
                    i=torch.from_numpy(g.integers(-9, 9, (4, 6)).astype(np.int32)),
                    b=torch.from_numpy(g.random((3, 4)) > 0.7),
                    h=torch.from_numpy(g.normal(size=(2 * n, 3))).to(torch.bfloat16))

    def collectives(comm, r):
        x, n = inputs(r, comm.n), comm.n
        got = [comm.all_gather(x["f"]), comm.psum(x["f"]), comm.psum(x["s"]),
               comm.pmax(x["i"]), comm.any(x["b"]), comm.all_to_all(x["h"], 0, 1)]
        got += comm.ppermutes([
            (x["f"][:1 + r % 2], [(i, (i + 1) % n) for i in range(n)]),
            (x["i"], [(i, i - 1) for i in range(1, n)]),
            (x["b"] if r == 0 else None, [(0, n - 1)]),
            (x["h"][r:], [(i, (i + 2) % n) for i in range(n)]),
            # 3 bytes, then a float32 item, to the same peer
            (x["b"][0, :3], [(i, (i + 1) % n) for i in range(n)]),
            (x["f"][r % 2], [(i, (i + 1) % n) for i in range(n)])])
        return [None if t is None else (str(t.dtype), t.float().numpy()) for t in got]

    initialize_multihost(f"127.0.0.1:{port}", n_procs, rank, timeout=timedelta(seconds=60))
    learned = dict(np.load(os.path.join(tmp, "learned.npz")))
    res = {}
    for n in (4, 2):
        pc = ProcessComm(n, device="cpu", timeout=60)
        lc = LocalComm(n, ["cpu"])
        res[("coll", n)] = (pc.run(lambda k: collectives(pc, k))[0],
                            lc.run(lambda k: collectives(lc, k))[pc.rank],
                            dict(pc.calls_by), pc.syncs)
    pc = ProcessComm(4, device="cpu")
    res["grid4"] = grid_run(pc, learned)
    save_state(os.path.join(tmp, "zshards_ckpt"), shard_state(state_from_numpy(learned, "cpu"), pc),
               layout="zshards", comm=pc)
    res["grid2t"] = grid_run(ProcessComm(2, device="cpu"), learned, zcone_mode="transpose")
    fleet = FleetVoFOD(cfg(), DynParams(), n_streams=N_STREAMS, device="cpu", grid_shards=2,
                       grid_shards_per_process=1)
    fleet.state = fleet_grid_state_from_numpy(learned_rows(fleet, learned), fleet.comm)
    res["fleet"] = dict(local=fleet.local_streams, shard=fleet.comm.rank,
                        ticks=fleet_ticks(fleet, 0, N_TICKS, True,
                                          save=os.path.join(tmp, "procs_ckpt")),
                        final=fleet_final(fleet), rejected=fleet.n_pose_rejected.tolist())
    again = FleetVoFOD(cfg(), DynParams(), n_streams=N_STREAMS, device="cpu", grid_shards=2,
                       grid_shards_per_process=1)
    again.state = restore_state(os.path.join(tmp, "one_ckpt"), again.state, comm=again.comm,
                                streams=again.local_streams)
    res["resumed"] = dict(ticks=fleet_ticks(again, SAVE_AT, N_TICKS, True),
                          final=fleet_final(again))
    try:
        FleetVoFOD(cfg(), DynParams(), n_streams=N_STREAMS, device="cpu", grid_shards=2,
                   grid_shards_per_process=1 if rank % 2 else 2)
    except ValueError as e:
        res["mismatch"] = str(e)
    # the failing rank: the last one raises inside the step's run and stays
    # alive; the others must raise within the comm's timeout
    pc = ProcessComm(n_procs, device="cpu", timeout=float(sys.argv[5]))
    step = make_grid_sharded_step(cfg(), step_lut(), pc)
    states = shard_state(state_from_numpy(learned, "cpu"), pc)
    t0 = time.perf_counter()
    try:
        if rank == n_procs - 1:
            pc.run(lambda k: 1 // 0)
        step(states, grid_scan(step_lut(), 0), DynParams())
    except Exception as e:
        res["failed"] = (type(e).__name__, str(e)[:300], time.perf_counter() - t0)
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    print("WORKER_OK", rank, flush=True)
    if rank == n_procs - 1:
        time.sleep(float(sys.argv[5]) + 2.0)
    sys.stdout.flush()
    os._exit(0)  # the group is broken by the failing case: no teardown
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args_of, n: int) -> list:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(args_of(rank), cwd=REPO, env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for rank in range(n)]


def _finish(procs) -> list[tuple[int, str, str]]:
    """Wait for every process within TIMEOUT; a process still running then
    is killed and fails the test."""
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


def _jax_cfg():
    return JConfig(sensor=JSensor(vertical_rays=8, horizontal_rays=32,
                                  vertical_fov=np.deg2rad(90.0)),
                   oparea=JBox((0.0, 0.0, 3.75), (8.0, 8.0, 7.5)),
                   background_sufficient_points_ratio=0.05, max_clusters=4, max_far_voxels=128,
                   max_queries=32, explore_submap=8, confidence_submap=8)


def _jax_grid_run(ns, learned) -> list:
    """JAX's grid step on its 4-device CPU mesh over stream 1's scans:
    per scan tests/test_torch_step.py ``_compare``'s record."""
    jcfg = _jax_cfg()
    mesh = make_grid_mesh(N_PROCS)
    step = jmake_grid_step(jcfg, jmake_lut(jcfg.sensor), mesh)
    st = jshard_state(JState(**{k: jnp.asarray(v) for k, v in learned.items()}), mesh)
    out = []
    for k in range(ns["N_TICKS"]):
        r, p = ns["tick"](ns["step_lut"](), k)
        scan = JScan(ranges_mm=jnp.asarray(r[1], jnp.float32),
                     intensity=jnp.ones(r[1].shape, jnp.float32), pose=jnp.asarray(p[1]))
        st, o = step(st, scan, JDyn().as_arrays())
        out.append(_record({"diag": {f: np.asarray(getattr(o.diag, f)) for f in o.diag._fields},
                            "detections": {f: np.asarray(getattr(o.detections, f))
                                           for f in o.detections._fields}},
                           np.asarray(st.grid)))
    return out


def _record(out: dict, grid: np.ndarray) -> dict:
    from tests.test_torch_step import DIAG_FIELDS

    d = out["detections"]
    return dict(diag={f: int(out["diag"][f]) for f in DIAG_FIELDS},
                dets=[(int(d["id"][k]), int(d["n_points"][k]), np.array(d["position"][k]),
                       float(d["confidence"][k])) for k in range(d["valid"].shape[0])
                      if d["valid"][k]],
                grid=np.array(grid, np.float32))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("grid_procs")


@pytest.fixture(scope="module")
def single(tmp):
    """This process's side: the learned map (a node's state after the
    apriori plane and 30 empty scans, written for the workers), the grid
    step over LocalComm(4) and LocalComm(2) (transposed), the dense step,
    and the one-process 2-D fleet (its checkpoint before tick SAVE_AT
    written for the workers)."""
    from vofod_tpu_torch.pipeline.state import state_from_numpy
    from vofod_tpu_torch.pipeline.step import make_step_fn
    from vofod_tpu_torch.runtime.node import VoFOD

    ns = _ns()
    node = VoFOD(ns["cfg"](), DynParams(), device="cpu")
    xs = np.arange(-3.0, 3.0, 0.4)
    gx, gy = np.meshgrid(xs, xs)
    node.load_apriori_map(np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1))
    pose = ns["hover_pose"]((0.0, 0.0, 3.0))
    empty = ns["render_scan"](ns["Scene"](ground_z=0.0), node.lut, pose)
    for _ in range(30):
        node.process_scan(empty, None, pose)
    learned = ns["state_to_numpy"](node.state)
    np.savez(tmp / "learned.npz", **learned)
    dense = make_step_fn(ns["cfg"](), ns["step_lut"](), device="cpu")
    st, dense_run = state_from_numpy(learned, "cpu"), []
    for k in range(ns["N_TICKS"]):
        st, o = dense(st, ns["grid_scan"](ns["step_lut"](), k), DynParams())
        dense_run.append((ns["out_np"](o), ns["state_to_numpy"](st)))
    fleet = FleetVoFOD(ns["cfg"](), DynParams(), n_streams=4, device="cpu", grid_shards=2)
    fleet.state = ns["fleet_grid_state_from_numpy"](ns["learned_rows"](fleet, learned), fleet.comm)
    ticks = ns["fleet_ticks"](fleet, 0, ns["N_TICKS"], False, save=str(tmp / "one_ckpt"))
    return dict(ns=ns, learned=learned, dense=dense_run,
                grid4=ns["grid_run"](ns["LocalComm"](4, ["cpu"]), learned),
                grid2t=ns["grid_run"](ns["LocalComm"](2, ["cpu"]), learned,
                                      zcone_mode="transpose"),
                fleet=dict(ticks=ticks, final=ns["fleet_final"](fleet),
                           rejected=fleet.n_pose_rejected.tolist()))


@pytest.fixture(scope="module")
def workers(tmp, single):
    """The four processes' results, and JAX's grid step run here while they
    work."""
    port = _free_port()
    procs = _start(lambda r: [sys.executable, "-c", _WORKER, str(r), str(N_PROCS), str(port),
                              str(tmp), str(FAIL_TIMEOUT)], N_PROCS)
    try:
        jax_run = _jax_grid_run(single["ns"], single["learned"])
    finally:
        got = _finish(procs)
    for r, (rc, o, e) in enumerate(got):
        assert rc == 0 and f"WORKER_OK {r}" in o, f"rank {r}: rc {rc}\n{e[-4000:]}"
    res = []
    for r in range(N_PROCS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res, jax_run


def _same(a, b, what: str) -> None:
    """Nested records (dicts, lists, tuples, arrays) equal bit for bit."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), what
    else:
        assert a == b or (a != a and b != b), what


@pytest.mark.parametrize("n", [4, 2])
def test_collectives_bit_equal_to_local_comm(workers, n):
    """Every collective of ProcessComm, on each rank of a group of n, equals
    LocalComm's on the same inputs bit for bit (float sums in rank order);
    no host sync on the CPU."""
    res, _ = workers
    for r, w in enumerate(res):
        got, want, calls, syncs = w[("coll", n)]
        _same(got, want, f"rank {r}")
        assert calls == {"all_gather": 1, "psum": 2, "pmax": 1, "any": 1, "all_to_all": 1,
                         "ppermute": 1} and syncs == 0
    # the float psum is the rank-order fold of the gathered values, and on
    # these inputs another order gives another sum
    g = res[0][("coll", n)][0][0][1]  # rank 0's all_gather
    fwd, rev = g[0].copy(), g[-1].copy()
    for j in range(1, n):
        fwd, rev = fwd + g[j], rev + g[n - 1 - j]
    assert np.array_equal(fwd, res[0][("coll", n)][0][1][1])
    assert n == 2 or not np.array_equal(fwd, rev)


@pytest.mark.parametrize("case", ["grid4", "grid2t"])
def test_grid_step_across_processes(workers, single, case):
    """The grid step with one shard a process: on every rank each scan's
    diagnostics, detections and gathered state equal the in-process grid
    step's and the dense step's bit for bit."""
    res, _ = workers
    n = 4 if case == "grid4" else 2
    for r, w in enumerate(res):
        _same(w[case], single[case], f"rank {r} vs LocalComm({n})")
        _same(w[case], single["dense"], f"rank {r} vs the dense step")
    assert any(o["detections"]["valid"].any() for o, _ in single["dense"])


def test_grid_step_against_jax(workers):
    """Rank 0's grid step within _compare's budgets of JAX's grid step on
    a 4-device CPU mesh, scan for scan."""
    res, jax_run = workers
    for k, ((out, state), ref) in enumerate(zip(res[0]["grid4"], jax_run)):
        _compare(_record(out, state["grid"]), ref, k)
    assert any(r["dets"] for r in jax_run)


def test_fleet_one_shard_a_process(workers, single):
    """FleetVoFOD(grid_shards=2, grid_shards_per_process=1) over 4
    processes: both processes of a stream group serve its streams, every
    record and final state equal to the one-process 2-D fleet, the null
    scan counted on the group that serves stream 3."""
    res, _ = workers
    one = single["fleet"]
    assert [(w["fleet"]["local"], w["fleet"]["shard"]) for w in res] == [
        ([0, 1], 0), ([0, 1], 1), ([2, 3], 0), ([2, 3], 1)]
    for r, w in enumerate(res):
        run = w["fleet"]
        for k, tick in enumerate(run["ticks"]):
            _same(tick, {b: one["ticks"][k][b] for b in run["local"]}, f"rank {r} tick {k}")
        _same(run["final"], {b: one["final"][b] for b in run["local"]}, f"rank {r} final")
        assert run["rejected"] == ([0, 0, 0, 1] if r >= 2 else [0, 0, 0, 0])
    assert one["rejected"] == [0, 0, 0, 1]
    assert any(rec[0] for tick in one["ticks"] for rec in tick.values())


def test_checkpoint_across_processes(workers, single, tmp):
    """The processes' streams_zshards checkpoint (one file a stream and
    slab, written by its process) restores onto one process's 2-D fleet and
    1-shard fleet, their zshards one (the grid step's slabs) onto a dense
    state and two slabs; a one-process checkpoint restores onto the
    processes; every continuation equals the uninterrupted run."""
    res, _ = workers
    ns, one = single["ns"], single["fleet"]
    m = ck.read_manifest(str(tmp / "procs_ckpt"))
    assert m["layout"] == "streams_zshards" and m["streams"] == 4
    assert [(e["name"], e["stream"], e["z0"], e["z1"]) for e in m["files"]] == [
        (f"stream_{b:03d}_shard_{i:03d}.npz", b, 8 * i, 8 * i + 8)
        for b in range(4) for i in range(2)]
    for shards in (2, 1):
        fleet = FleetVoFOD(ns["cfg"](), DynParams(), n_streams=4, device="cpu",
                           grid_shards=shards)
        fleet.state = ck.restore_state(str(tmp / "procs_ckpt"), fleet.state)
        ticks = ns["fleet_ticks"](fleet, ns["SAVE_AT"], ns["N_TICKS"], False)
        _same(ticks, one["ticks"][ns["SAVE_AT"]:], f"{shards} shards resumed")
        _same(ns["fleet_final"](fleet), one["final"], f"{shards} shards resumed: final")
    z = str(tmp / "zshards_ckpt")
    assert [(e["name"], e["z0"], e["z1"]) for e in ck.read_manifest(z)["files"]] == [
        (f"shard_{i:03d}.npz", 4 * i, 4 * i + 4) for i in range(4)]
    dense = ns["state_to_numpy"](ck.restore_state(z, init_state(ns["cfg"](), device="cpu")))
    halves = ck.restore_state(z, init_grid_sharded_state(ns["cfg"](), DynParams(),
                                                         ns["LocalComm"](2, ["cpu"])))
    for got in (dense, ns["state_to_numpy"](ns["gather_state"](halves))):
        _same(got, {k: np.asarray(v) for k, v in single["learned"].items()}, "zshards")
    flat = ck.restore_state(str(tmp / "procs_ckpt"),
                            init_batched_state(ns["cfg"](), DynParams(), 4, device="cpu"))
    step0 = int(single["learned"]["step"])
    assert batched_state_to_numpy(flat)["step"].tolist() == [step0 + ns["SAVE_AT"]] * 4
    for r, w in enumerate(res):
        run = w["resumed"]
        for k, tick in enumerate(run["ticks"]):
            local = w["fleet"]["local"]
            _same(tick, {b: one["ticks"][ns["SAVE_AT"] + k][b] for b in local},
                  f"rank {r} resumed tick {ns['SAVE_AT'] + k}")
        _same(run["final"], {b: one["final"][b] for b in w["fleet"]["local"]},
              f"rank {r} resumed: final")


def test_layout_refusals(workers):
    """A grid_shards_per_process that differs between processes raises on
    every process; here, a value other than grid_shards or 1, and 1 with
    fewer processes than shards, are refused."""
    res, _ = workers
    for r, w in enumerate(res):
        assert "built another fleet" in w.get("mismatch", ""), f"rank {r}"
    ns = _ns()
    with pytest.raises(ValueError, match="grid_shards_per_process must be"):
        FleetVoFOD(ns["cfg"](), DynParams(), n_streams=2, device="cpu", grid_shards=2,
                   grid_shards_per_process=3)
    with pytest.raises(ValueError, match="stream groups of 2"):
        FleetVoFOD(ns["cfg"](), DynParams(), n_streams=2, device="cpu", grid_shards=2,
                   grid_shards_per_process=1)


def test_failing_rank_raises_everywhere(workers):
    """The last rank raises inside its run and stays alive: every other
    rank's step raises within the comm's timeout (plus scheduling slack),
    none hangs."""
    res, _ = workers
    assert res[-1]["failed"][0] == "ZeroDivisionError"
    for r, w in enumerate(res[:-1]):
        kind, msg, seconds = w["failed"]
        assert seconds < FAIL_TIMEOUT + 5.0, f"rank {r}: raised after {seconds} s: {msg}"
        assert kind in ("RuntimeError", "DistBackendError", "DistError"), (r, kind, msg)


def test_serve_fleet_grid_across_processes(single, tmp_path):
    """serve_fleet --grid-shards 2 --grid-shards-per-process 1 in two
    processes (2 streams, 4 ticks of a looped recording of stream 1's
    scans), resumed with --load-state from the learned map in both streams:
    both exit 0 with a summary of 2 local streams and report the same
    frames a tick; only grid shard 0 prints detections, and they equal,
    tick for tick, a one-process 2-D fleet's from that state on those
    frames, and are not empty."""
    import dataclasses

    from vofod_tpu_torch.config import load_config
    from vofod_tpu_torch.io.scan_source import save_scans_npz

    # the config of _COMMON's cfg(), but for its capacities
    files = {"det.yaml": "voxel_map: {voxel_size: 0.5}\nbackground_sufficient_points_ratio: 0.05\n",
             "sen.yaml": "sensor: {vertical_fov_angle: 90.0, vertical_rays: 8, "
                         "horizontal_rays: 32}\n",
             "map.yaml": "operation_area:\n  offset: {x: 0.0, y: 0.0, z: 0.0}\n"
                         "  size: {x: 8.0, y: 8.0, z: 7.5}\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    paths = [str(tmp_path / name) for name in files]
    cfg, dyn = load_config(*paths)
    cfg = dataclasses.replace(cfg, **serve_fleet.SMALL_CAPACITIES)
    ns = single["ns"]
    assert cfg.oparea == ns["cfg"]().oparea
    learned = ns["state_from_numpy"](single["learned"], "cpu")
    ck.save_state(str(tmp_path / "learned"), [learned] * 2, layout="streams")
    lut = ns["step_lut"]()
    rec = [ns["tick"](lut, k) for k in range(8)]
    ranges = np.stack([r[1] for r, _ in rec])
    poses = np.stack([p[1] for _, p in rec]).astype(np.float32)
    save_scans_npz(str(tmp_path / "scans.npz"), ranges, poses)
    port = _free_port()
    got = _finish(_start(lambda r: [
        sys.executable, "-m", "vofod_tpu_torch.tools.serve_fleet", "--streams", "2",
        "--scans", str(tmp_path / "scans.npz"), "--loop", "--ticks", "4", "--rate", "50",
        "--json", "--device", "cpu", "--small-capacities", "--load-state",
        str(tmp_path / "learned"),
        "--grid-shards", "2", "--grid-shards-per-process", "1",
        "--config", paths[0], "--sensor", paths[1], "--map", paths[2],
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r)],
        2))
    frames = []
    for r, (rc, o, e) in enumerate(got):
        assert rc == 0, f"rank {r}: rc {rc}\n{e[-4000:]}"
        lines = [json.loads(ln) for ln in o.splitlines() if ln.startswith("{")]
        summary = [ln for ln in lines if ln.get("summary")]
        assert len(summary) == 1 and summary[0]["ticks"] == 4 and summary[0]["streams"] == 2
        frames.append([ln["frames"] for ln in lines if "latency_ms" in ln])
        if r:
            assert not [ln for ln in lines if "stream" in ln]
        else:
            printed = [ln for ln in lines if "stream" in ln]
        assert "4 ticks x 2 local streams" in e
    assert len(frames[0]) == 4 and frames[1] == frames[0]
    fleet = FleetVoFOD(cfg, dyn, n_streams=2, device="cpu", grid_shards=2)
    fleet.state = ck.restore_state(str(tmp_path / "learned"), fleet.state)
    want = []
    for t, idx in enumerate(frames[0], start=1):
        idx = [k % len(rec) for k in idx]
        msgs = fleet.process_scans(ranges[idx], poses[idx])
        want += [json.loads(json.dumps({
            "tick": t, "stream": b, "id": d.id, "position": list(d.position),
            "confidence": d.confidence, "detection_probability": d.detection_probability}))
            for b in range(2) for d in msgs[b].detections]
    assert want and printed == want


@pytest.mark.parametrize("argv, err", [
    (["--grid-shards", "3", "--grid-shards-per-process", "2"], "must be --grid-shards"),
    (["--grid-shards", "2", "--grid-shards-per-process", "1"], "needs --coordinator"),
    (["--grid-shards", "2", "--grid-shards-per-process", "1", "--coordinator", "127.0.0.1:1",
      "--num-processes", "3", "--process-id", "0", "--ticks", "1"], "stream groups"),
])
def test_serve_fleet_refusals(capsys, argv, err):
    """The flag's checks end in the argument error (exit code 2) before any
    process group is joined."""
    with pytest.raises(SystemExit) as ei:
        serve_fleet.main(["--sim", "--device", "cpu", *argv])
    assert ei.value.code == 2
    assert err in capsys.readouterr().err
    assert not torch.distributed.is_initialized()

