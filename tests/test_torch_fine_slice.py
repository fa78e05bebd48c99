"""The slice as a whole: fine-0125 (0.125 m voxels, every radius of
configs/detection_params.yaml kept in metres) on the CPU, at a small area.

chip_smoke.py's fine-0125 is the flagship grid (241 x 201 x 51) at a
quarter of its voxel size over a quarter of its extent.  Here the same
voxel size, radii and capacities' rule run over a 6 x 6 x 4.375 m area (49
x 49 x 36 voxels), with a 32 x 256-ray sensor (at 0.125 m voxels a sparser
fan leaves the unknown voxels between rays open to the explore, and nothing
floats) and a 0.35 m sphere hovering 3.6 m above the apriori ground (past
the 3 m explore distance).  The radii in voxels: the ground ball r 12 (K1
int8 max and K2's label sweeps past halo 7), the local sure count r 8 (K1
int32 sum past halo 7), the sepclusters reach r 7 and the demotion r 6.4;
the explore submap S = 64 covers 2 x 24 + 1.  Ray weight 0.5, as
tests/test_torch_grid_step.py, so that the sphere is confirmed floating
within a scan of its first sighting.

* the port's node (``VoFOD(..., device="cpu")``, the plain versions of
  every kernel) against vofod_tpu's node over 8 scans, under
  tests/test_torch_grid_step.py's contract at ray weight 0.5: integer
  diagnostics equal (n_bg_voxels within the voxels that lie within the
  grid tolerance of its threshold), the detections' ids and n_points
  equal, positions within 1e-3 m, confidence within 1 % relative; the
  grid within 2.5 score units and 0.75 at its 99.9th percentile (the bf16
  transmittance of the sweep raycast rounds differently in the two
  packages, tests/test_torch_raycast.py).  The detections are non-empty;
* the port's grid-sharded step at 3 shards of 12 planes (the r 12 label
  sweeps' halo takes several hops) bit-equal to the port's dense node on
  its first 3 scans (detections from the second): grid, safe and the
  carried scalars.  Its shards each run the replicated point-space work,
  ~5 s a scan here.
"""

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.runtime.node import NodeOptions as JOptions, VoFOD as JNode
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu_torch.ops import morphology as tm
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.grid_step import gather_state, make_grid_sharded_step, shard_state
from vofod_tpu_torch.pipeline.state import ScanInput
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD

SENSOR = dict(vertical_rays=32, horizontal_rays=256, vertical_fov=np.deg2rad(90.0))
BOX = ((0.0, 0.0, 0.25 + 4.375 / 2), (6.0, 6.0, 4.375))
# fine-0125's voxel and explore submap; capacities at this area's size (at
# most 28 far voxels and explore queries a scan here)
KW = dict(voxel_size=0.125, explore_submap=64, max_far_voxels=1024, max_queries=32,
          max_clusters=8, confidence_submap=16)
N_SCANS, GRID_SCANS, SHARDS, WEIGHT = 8, 3, 3, 0.5
DIAG_FIELDS = ("n_bg_voxels", "bg_sufficient", "sure_bg_sufficient", "n_occupied", "n_far",
               "far_overflow", "cc_converged", "cc_iters", "sep_converged", "n_detections")
CONF_RTOL, GRID_ATOL, GRID_P999 = 1e-2, 2.5, 0.75
STATE_FIELDS = ("grid", "safe", "det_counter", "sure_bg_sufficient", "bg_sufficient")


def _cfg() -> VoFODConfig:
    return VoFODConfig(sensor=SensorConfig(**SENSOR), oparea=Box(*BOX), **KW)


def _ground() -> np.ndarray:
    """The apriori ground: a plane at z 0.5 every 0.25 m under the area."""
    g = np.arange(-3.0, 3.01, 0.25)
    gx, gy = np.meshgrid(g, g)
    return np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 0.5)], 1).astype(np.float32)


@pytest.fixture(scope="module")
def scans():
    node = VoFOD(_cfg(), device="cpu")
    out = []
    for k in range(N_SCANS):
        a = 2.0 * np.pi * k / 12
        scene = Scene(ground_z=0.5)
        scene.add_sphere(center=(1.5 * np.cos(a), 1.5 * np.sin(a), 4.1), radius=0.35)
        pose = hover_pose((0.3 * np.cos(a), 0.3 * np.sin(a), 2.5))
        out.append((render_scan(scene, node.lut, pose), pose))
    return out


@pytest.fixture(scope="module")
def port_run(scans):
    """The port's node: every scan's state, diagnostics and detections."""
    node = VoFOD(_cfg(), DynParams(raycast_weight_coefficient=WEIGHT), NodeOptions(),
                 device="cpu")
    node.load_apriori_map(_ground())
    start = {f: getattr(node.state, f).clone() for f in STATE_FIELDS}
    out = []
    for r, p in scans:
        msg = node.process_scan(r, None, p)
        out.append(dict(state={f: getattr(node.state, f).clone() for f in STATE_FIELDS},
                        diag={f: int(getattr(node.last_diag, f)) for f in DIAG_FIELDS},
                        dets=msg.detections))
    return start, out


@pytest.fixture(scope="module")
def jax_run(scans):
    jcfg = JConfig(sensor=JSensor(**SENSOR), oparea=JBox(*BOX), **KW)
    node = JNode(jcfg, JDyn(raycast_weight_coefficient=WEIGHT), JOptions())
    node.load_apriori_map(_ground())
    out = []
    for r, p in scans:
        msg = node.process_scan(r, None, p)
        out.append(dict(grid=np.asarray(node.state.grid),
                        diag={f: int(getattr(node.last_diag, f)) for f in DIAG_FIELDS},
                        dets=msg.detections))
    return out


def test_fine_radii_pass_halo_7():
    """The shipped radii at 0.125 m voxels reach past halo 7 where the
    kernels' wide forms take them."""
    cfg = _cfg()
    ground = cfg.ground_points_max_distance / cfg.voxel_size
    sep = cfg.sepclusters_max_bg_distance / cfg.voxel_size
    local_sure = float(np.ceil(sep)) + 1.0
    assert (ground, local_sure, np.ceil(sep)) == (12.0, 8.0, 7.0)
    assert [len(tm.ball_taps(r)) for r in (ground, local_sure, np.ceil(sep), sep)] == [
        7153, 2109, 1419, 1045]
    assert tm.run_table(ground).wide and tm.run_table(local_sure).wide
    assert not tm.run_table(np.ceil(sep)).wide and not tm.run_table(sep).wide
    assert tm.is_wide(tm.ball_taps(ground), 12) and not tm.is_wide(tm.ball_taps(7.0), 7)
    assert cfg.explore_submap >= 2 * int(DynParams().cls_max_explore_distance / cfg.voxel_size) + 1


def test_fine_node_matches_jax(port_run, jax_run):
    (start, port), ref = port_run, jax_run
    n_dets = 0
    thr = DynParams().thr_new_obstacles
    prev = start["grid"].numpy()
    for k, (p, j) in enumerate(zip(port, ref)):
        near = int((np.abs(prev - thr) <= GRID_ATOL).sum())
        diag = dict(p["diag"])
        assert abs(diag.pop("n_bg_voxels") - j["diag"]["n_bg_voxels"]) <= near, f"scan {k}"
        assert diag == {f: v for f, v in j["diag"].items() if f != "n_bg_voxels"}, f"scan {k}"
        assert not diag["far_overflow"], f"scan {k}"
        prev = j["grid"]
        pd, jd = p["dets"], j["dets"]
        assert [(d.id, d.n_points) for d in pd] == [(d.id, d.n_points) for d in jd], f"scan {k}"
        for a, b in zip(pd, jd):
            np.testing.assert_allclose(a.position, b.position, atol=1e-3, rtol=0)
            np.testing.assert_allclose(a.confidence, b.confidence, rtol=CONF_RTOL, atol=0)
        grid = p["state"]["grid"].numpy()
        fin = np.isfinite(j["grid"])
        assert np.array_equal(fin, np.isfinite(grid)), f"scan {k}"
        d = np.abs(grid[fin] - j["grid"][fin])
        assert d.max() <= GRID_ATOL and np.quantile(d, 0.999) <= GRID_P999, f"scan {k}"
        n_dets += len(pd)
    assert n_dets >= N_SCANS // 2 and len(port[-1]["dets"]) >= 1  # the sphere is found


def test_fine_grid_step_bitequal_to_dense(scans, port_run):
    start, dense = port_run
    cfg = _cfg()
    node = VoFOD(cfg, DynParams(raycast_weight_coefficient=WEIGHT), NodeOptions(), device="cpu")
    node.load_apriori_map(_ground())
    comm = LocalComm(SHARDS, ["cpu"], timeout=300.0)
    step = make_grid_sharded_step(cfg, node.lut, comm)
    states = shard_state(node.state, comm)
    assert [tuple(s.grid.shape) for s in states] == [(12, 49, 49)] * SHARDS
    dyn = DynParams(raycast_weight_coefficient=WEIGHT)
    for k, (r, p) in enumerate(scans[:GRID_SCANS]):
        scan = ScanInput(torch.from_numpy(r.astype(np.float32)), torch.ones(r.size),
                         np.asarray(p, np.float32))
        states, out = step(states, scan, dyn)
        got = gather_state(states)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(got, f), dense[k]["state"][f]), f"scan {k}: {f}"
        assert int(out.diag.n_detections) == len(dense[k]["dets"]), f"scan {k}"
