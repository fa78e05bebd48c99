"""The port's checkpoint directories (vofod_tpu_torch/runtime/checkpoint.py).

The cases of tests/test_checkpoint.py on the port's own format (a manifest
and one NPZ per shard or stream; Orbax does not run where the port runs):
dense, 3-shard, cross-placement (dense onto 3 and 2 shards and back) and
fleet round trips, bit for bit; an ``AsyncSaver`` snapshot taken while
the next scans step and the node writes its grid in place equals the
state at its ``save`` call; keep-last-K; the empty directory; the node's
directory snapshot; and a JAX node loading a port checkpoint's dense file.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.runtime.node import VoFOD as JNode
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.grid_step import init_grid_sharded_state, shard_state
from vofod_tpu_torch.parallel.sharding import init_batched_state
from vofod_tpu_torch.pipeline.state import init_state, state_to_numpy
from vofod_tpu_torch.runtime import checkpoint as ck
from vofod_tpu_torch.runtime.node import VoFOD

SENSOR = dict(vertical_rays=8, horizontal_rays=32, vertical_fov=np.deg2rad(90.0))
BOX = ((0.0, 0.0, 5.75), (16.0, 16.0, 11.5))  # nz = 24: 2, 3 and 4 shards
KW = dict(max_clusters=4, max_far_voxels=128, max_queries=32, explore_submap=8,
          confidence_submap=8, background_sufficient_points_ratio=0.05)


def _cfg():
    return VoFODConfig(sensor=SensorConfig(**SENSOR), oparea=Box(*BOX), **KW)


def _scribble(state, seed=0):
    """Distinct content in every field."""
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        state,
        grid=torch.from_numpy(rng.normal(size=tuple(state.grid.shape)).astype(np.float32)),
        safe=torch.from_numpy(rng.random(tuple(state.safe.shape)) > 0.5),
        det_counter=torch.tensor(7 + seed, dtype=torch.int32),
        step=42 + seed,
        sure_bg_sufficient=torch.tensor(True),
        bg_sufficient=torch.tensor(bool(seed % 2)),
    )


def _same(a, b):
    na, nb = state_to_numpy(a), state_to_numpy(b)
    for k, v in na.items():
        assert v.dtype == nb[k].dtype and np.array_equal(v, nb[k]), k


def _dense_of(shards):
    """The shards' state as one dense state, for comparison only."""
    return dataclasses.replace(shards[0], grid=torch.cat([s.grid for s in shards]),
                               safe=torch.cat([s.safe for s in shards]))


def test_dense_roundtrip_and_overwrite(tmp_path):
    cfg = _cfg()
    p = str(tmp_path / "ckpt")
    first = _scribble(init_state(cfg, device="cpu"), 1)
    ck.save_state(p, first)
    _same(ck.restore_state(p, init_state(cfg, device="cpu")), first)
    second = _scribble(init_state(cfg, device="cpu"), 2)
    ck.save_state(p, second)  # overwrite=True by default
    _same(ck.restore_state(p, init_state(cfg, device="cpu")), second)
    with pytest.raises(FileExistsError):
        ck.save_state(p, first, overwrite=False)
    m = ck.read_manifest(p)
    assert (m["layout"], m["grid_shape"], sorted(os.listdir(p))) == (
        "dense", list(cfg.grid_shape), ["manifest.json", "state.npz"])


@pytest.mark.parametrize("n_save,n_restore", [(3, 3), (1, 3), (3, 1), (3, 2), (2, 4)])
def test_zshard_roundtrips_across_placements(tmp_path, n_save, n_restore):
    """A checkpoint of n_save z slabs (1 = dense) restores onto n_restore
    slabs (1 = dense), bit for bit; each slab is its own file."""
    cfg = _cfg()
    dense = _scribble(init_state(cfg, device="cpu"), 3)
    p = str(tmp_path / "ckpt")
    if n_save == 1:
        ck.save_state(p, dense)
    else:
        ck.save_state(p, shard_state(dense, LocalComm(n_save, ["cpu"])), layout="zshards")
        m = ck.read_manifest(p)
        nzl = cfg.grid_shape[0] // n_save
        assert m["layout"] == "zshards" and [(e["z0"], e["z1"]) for e in m["files"]] == [
            (i * nzl, (i + 1) * nzl) for i in range(n_save)]
        with np.load(os.path.join(p, m["files"][1]["name"])) as z:
            assert z["grid"].shape == (nzl, *cfg.grid_shape[1:])
    if n_restore == 1:
        got = ck.restore_state(p, init_state(cfg, device="cpu"))
        _same(got, dense)
    else:
        like = init_grid_sharded_state(cfg, DynParams(), LocalComm(n_restore, ["cpu"]))
        got = ck.restore_state(p, like)
        assert isinstance(got, list) and len(got) == n_restore
        assert [tuple(s.grid.shape) for s in got] == [tuple(s.grid.shape) for s in like]
        _same(_dense_of(got), dense)
        # and back: the restored shards save and restore onto the dense state
        q = str(tmp_path / "back")
        ck.save_state(q, got, layout="zshards")
        _same(ck.restore_state(q, init_state(cfg, device="cpu")), dense)


def test_fleet_streams_roundtrip(tmp_path):
    cfg = _cfg()
    states = [_scribble(s, 10 + i) for i, s in
              enumerate(init_batched_state(cfg, DynParams(), 3, device="cpu"))]
    p = str(tmp_path / "fleet")
    ck.save_state(p, states, layout="streams")
    got = ck.restore_state(p, init_batched_state(cfg, DynParams(), 3, device="cpu"))
    for a, b in zip(got, states):
        _same(a, b)
    assert ck.read_manifest(p)["layout"] == "streams"
    with pytest.raises(ValueError, match="streams"):
        ck.restore_state(p, init_state(cfg, device="cpu"))
    with pytest.raises(ValueError, match="streams"):
        ck.restore_state(p, init_batched_state(cfg, DynParams(), 2, device="cpu"))


def test_refusals(tmp_path):
    cfg = _cfg()
    state = init_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        ck.save_state(str(tmp_path / "a"), [state, state])
    p = str(tmp_path / "b")
    ck.save_state(p, state)
    other = init_state(dataclasses.replace(cfg, oparea=Box((0.0, 0.0, 5.75), (8.0, 8.0, 11.5))),
                       device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        ck.restore_state(p, other)
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "manifest.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not a"):
        ck.restore_state(str(tmp_path / "c"), state)


def _scans(lut, n):
    out = []
    for k in range(n):
        scene = Scene(ground_z=0.5)
        scene.add_box((5.0, 3.0, 0.0), (7.0, 5.0, 2.0 + 0.2 * k))
        pose = hover_pose((8.0 + 0.3 * k, 8.0, 7.0), yaw=0.1 * k)
        out.append((render_scan(scene, lut, pose), pose))
    return out


def _node(cfg):
    node = VoFOD(cfg, DynParams(raycast_weight_coefficient=0.5), device="cpu")
    xs = np.arange(0.25, 16.0, 0.5)
    gx, gy = np.meshgrid(xs, xs)
    node.load_apriori_map(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 0.5)], axis=1))
    return node


def test_async_save_is_the_state_at_save(tmp_path):
    """Saved at scan k while scans k+1 and k+2 step, a rangefinder return
    and an apriori stamp write the node's grid in place, and the scan
    counter moves: the restored state is the one after scan k."""
    cfg = _cfg()
    node = _node(cfg)
    scans = _scans(node.lut, 5)
    p = str(tmp_path / "async")
    with ck.AsyncSaver() as saver:
        for k, (r, pose) in enumerate(scans):
            node.process_scan(r, None, pose)
            if k == 2:
                want = {n: v.copy() for n, v in state_to_numpy(node.state).items()}
                saver.save(p, node.state)
                node.state.grid.add_(1.0)  # an in-place write right after save
                rf_pose = np.eye(4, dtype=np.float32)
                rf_pose[:3, 3] = (6.0, 8.0, 5.0)  # the rangefinder looks along +x
                assert node.process_rangefinder(2.0, 0.1, 10.0, rf_pose)
        node.load_apriori_map(np.array([[3.0, 3.0, 3.0]], np.float32))
    got = ck.restore_state(p, init_state(cfg, device="cpu"))
    assert got.step == 3 == want["step"]
    for n, v in state_to_numpy(got).items():
        assert np.array_equal(v, want[n]), n
    assert not np.array_equal(state_to_numpy(node.state)["grid"], want["grid"])


def test_snapshot_manager_keep_last_k_and_resume(tmp_path):
    """Keep 2, every 2 scans: the latest restores and 2 more scans from it
    equal an uninterrupted node bit for bit; older steps are pruned."""
    cfg = _cfg()
    run = _node(cfg)
    scans = _scans(run.lut, 8)
    saved = {}
    with ck.SnapshotManager(str(tmp_path / "mgr"), max_to_keep=2) as mgr:
        for k, (r, pose) in enumerate(scans[:6]):
            run.process_scan(r, None, pose)
            if (k + 1) % 2 == 0:
                mgr.save(run.state.step, run.state)
                saved[run.state.step] = {n: v.copy() for n, v in state_to_numpy(run.state).items()}
        assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
        with pytest.raises(FileNotFoundError):
            mgr.restore(init_state(cfg, device="cpu"), step=2)
        resumed = _node(cfg)
        resumed.state = mgr.restore(resumed.state)
        _same(resumed.state, run.state)
        at4 = state_to_numpy(mgr.restore(init_state(cfg, device="cpu"), step=4))
        assert all(np.array_equal(v, saved[4][n]) for n, v in at4.items())
    for r, pose in scans[6:]:
        a, b = run.process_scan(r, None, pose), resumed.process_scan(r, None, pose)
        assert a == b
    _same(resumed.state, run.state)


def test_empty_directory_raises(tmp_path):
    with ck.SnapshotManager(str(tmp_path / "empty")) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(init_state(_cfg(), device="cpu"))


def test_node_directory_snapshot_and_jax_reads_dense_file(tmp_path):
    cfg = _cfg()
    node = _node(cfg)
    for r, pose in _scans(node.lut, 3):
        node.process_scan(r, None, pose)
    p = str(tmp_path / "node_ckpt")
    node.save_snapshot(p)
    fresh = VoFOD(cfg, DynParams(), device="cpu")
    fresh.load_snapshot(p)
    _same(fresh.state, node.state)
    # the dense file is a node NPZ: the JAX node loads it as its own
    j = JNode(JConfig(sensor=JSensor(**SENSOR), oparea=JBox(*BOX), **KW), JDyn())
    j.load_snapshot(os.path.join(p, "state.npz"))
    want = state_to_numpy(node.state)
    for k, v in jax.device_get(j.state)._asdict().items():
        assert np.array_equal(np.asarray(v), want[k]), k
    assert j._host_step == node.state.step == 3
    # a 3-shard checkpoint restores onto the node, and the node's onto shards
    comm = LocalComm(3, ["cpu"])
    q = str(tmp_path / "shards")
    ck.save_state(q, shard_state(node.state, comm), layout="zshards")
    fresh2 = VoFOD(cfg, DynParams(), device="cpu")
    fresh2.load_snapshot(q)
    _same(fresh2.state, node.state)
    _same(_dense_of(ck.restore_state(p, init_grid_sharded_state(cfg, DynParams(), comm))),
          node.state)
