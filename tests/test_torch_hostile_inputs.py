"""Hostile sensor inputs through the port's node, at a small size.

The contract of tests/test_hostile_inputs.py, held on
``vofod_tpu_torch.runtime.node.VoFOD`` on the CPU (the kernels' plain
versions):

* a six-scan sequence of float ranges poisoned with NaN, +inf, -inf and
  negative values, NaN intensity on a quarter of the poisoned pixels,
  leaves the grid and ``safe`` bit-equal to the sanitized sequence (NaN ->
  0, +inf -> 4e9, -inf and negatives -> 0; NaN intensity -> 1e9, which
  passes the ``intensity < min -> skip`` gate as NaN does), with no NaN in
  the grid: on the sweep, reference-exact and off raycast paths with the
  raw ingest, and on the sweep path with the prebinned one;
* a non-finite pose skips the scan: the state is untouched and
  ``n_pose_rejected`` grows by one per scan, on the raw and the prebinned
  ingest, and the node goes on working after.

``chip_smoke.py``'s phase 2-hostile runs the same sequence at the flagship
size on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_hostile_inputs import poison
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.io.scan_source import Scene, hover_pose, render_scan
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD

N_SCANS = 6
EXACT = dict(sepclusters_exact_census=True, compat_hascloseto_bounds=True,
             compat_counted_indexing=True)
# (raycast mode, ingest, config changes)
PATHS = {
    "sweep/raw": ("sweep", "raw", {}),
    "exact/raw": ("exact", "raw", EXACT),
    "sweep/prebinned": ("sweep", "prebinned", {}),
    "off/raw": ("off", "raw", {}),
}


def small_cfg(**kw):
    """tests/test_hostile_inputs.py's ``small_cfg`` in the port's config."""
    d = dict(
        sensor=SensorConfig(vertical_rays=16, horizontal_rays=64,
                            vertical_fov=np.deg2rad(90.0)),
        oparea=Box((0.0, 0.0, 5.75), (16.0, 16.0, 11.5)),
        background_sufficient_points_ratio=0.05,
        max_clusters=8,
        max_far_voxels=512,
        max_queries=64,
        explore_submap=16,
        confidence_submap=8,
    )
    d.update(kw)
    return VoFODConfig(**d)


def _node(path: str, start=None) -> VoFOD:
    """A node of the path, from a copy of ``start`` when given."""
    mode, ingest, change = PATHS[path]
    node = VoFOD(small_cfg(**change), DynParams(),
                 NodeOptions(raycast_mode=mode, frontend_mode=ingest), device="cpu")
    if start is not None:
        node.state = dataclasses.replace(start, **{
            k: v.clone() for k, v in vars(start).items() if isinstance(v, torch.Tensor)})
    return node


@pytest.fixture(scope="module")
def learned():
    """The state after three clean scans of the sweep path: a background
    for the points to land near, so that the raycast-off path's point EMA
    changes the grid too."""
    node = _node("sweep/raw")
    for i in range(3):
        pose = hover_pose((0.5 * i, 0.0, 7.0), yaw=0.2 * i)
        scene = Scene(ground_z=0.5)
        scene.add_sphere(center=(4.0, 0.0, 9.0), radius=0.7)
        node.process_scan(render_scan(scene, node.lut, pose), None, pose)
    return node.state


def hostile_scans(lut, n: int = N_SCANS):
    """tests/test_hostile_inputs.py's sequence: (poisoned ranges, poisoned
    intensity, sanitized ranges, sanitized intensity, pose) per scan."""
    out = []
    for i in range(n):
        pose = hover_pose((np.cos(0.3 * i), np.sin(0.3 * i), 7.0), yaw=0.1 * i)
        scene = Scene(ground_z=0.5)
        scene.add_sphere(center=(4.0, 0.2 * i, 9.0), radius=0.7)
        ranges = render_scan(scene, lut, pose)
        bad, sane, qs = poison(ranges, seed=100 + i)
        inten = np.full(ranges.size, 100.0, np.float32)
        inten_bad, inten_sane = inten.copy(), inten.copy()
        inten_bad[qs[0]] = np.nan
        inten_sane[qs[0]] = 1.0e9
        out.append((bad, inten_bad, sane, inten_sane, pose))
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_hostile_sequence_bitexact_vs_sanitized(path, learned):
    a, b = _node(path, learned), _node(path, learned)
    for k, (bad, inten_bad, sane, inten_sane, pose) in enumerate(hostile_scans(a.lut)):
        a.process_scan(bad, inten_bad, pose, stamp=0.1 * k)
        b.process_scan(sane, inten_sane, pose, stamp=0.1 * k)
    assert a.n_pose_rejected == b.n_pose_rejected == 0
    assert a.state.step == b.state.step == learned.step + N_SCANS
    ga, gb = a.state.grid.numpy(), b.state.grid.numpy()
    assert not np.isnan(ga).any()
    assert (ga != learned.grid.numpy()).any()  # the sequence moved the map
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(a.state.safe.numpy(), b.state.safe.numpy())


def bad_poses(pose: np.ndarray) -> list[np.ndarray]:
    """All NaN; a NaN rotation with a finite translation; an infinite
    translation."""
    rot_nan = pose.astype(np.float32).copy()
    rot_nan[:3, :3] = np.nan
    inf_pose = pose.astype(np.float32).copy()
    inf_pose[2, 3] = np.inf
    return [np.full((4, 4), np.nan, np.float32), rot_nan, inf_pose]


@pytest.mark.parametrize("path", ["sweep/raw", "sweep/prebinned"])
def test_nonfinite_pose_skips_scan(path):
    node = _node(path)
    pose = hover_pose((0.0, 0.0, 7.0))
    ranges = render_scan(Scene(ground_z=0.5), node.lut, pose)
    node.process_scan(ranges, None, pose)
    before = {k: v.clone() for k, v in vars(node.state).items() if isinstance(v, torch.Tensor)}
    step = node.state.step
    for k, p in enumerate(bad_poses(pose)):
        msg = node.process_scan(ranges, None, p, stamp=1.0 + k)
        assert msg.detections == []
        assert node.n_pose_rejected == k + 1
    assert node.state.step == step
    for k, v in before.items():
        assert torch.equal(getattr(node.state, k), v), k
    node.process_scan(ranges, None, pose)
    assert node.state.step == step + 1
