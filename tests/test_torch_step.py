"""The slice as a whole: the port's node against the golden fixture and
against the JAX node, scan for scan.

Config of tests/test_golden.py (16x64 sensor, 16x16x12 m area).  Budgets:

* the golden assertions of tests/test_golden.py, unchanged;
* integer and bool diagnostics equal on every scan (n_bg_voxels,
  n_occupied, n_far, cc_iters, n_detections and the flags);
* detections: the same count, ids and n_points, positions within 1e-3 m,
  confidence within 0.2 % relative (the DESIGN §9 budget);
* the confidence grid: max |Δ| over finite voxels <= 0.5 score units
  (measured 0.19 over these 50 scans; scores span [-1000, 0]).  The bf16
  transmittance sweep rounds differently in the two packages
  (tests/test_torch_raycast.py) and the ray EMA carries that from scan to
  scan; after a state carry-over the bound is the same.
"""

import os

import jax
import numpy as np
import pytest

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.runtime.node import NodeOptions as JOptions, VoFOD as JNode
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.pipeline.state import state_from_numpy, state_to_numpy
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_small.npz")
CARRY_AT = 20
GRID_ATOL = 0.5
CONF_RTOL = 2e-3
KW = dict(background_sufficient_points_ratio=0.05, max_clusters=4, max_far_voxels=256,
          max_queries=64, explore_submap=16, confidence_submap=8)
DIAG_FIELDS = ("n_bg_voxels", "bg_sufficient", "sure_bg_sufficient", "n_occupied", "n_far",
               "far_overflow", "cc_converged", "cc_iters", "sep_converged", "n_detections")


def _apriori():
    xs = np.arange(-4.0, 4.0, 0.5)
    gx, gy = np.meshgrid(xs, xs)
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)


def _port_node(raycast_every=1):
    cfg = VoFODConfig(
        sensor=SensorConfig(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)),
        oparea=Box((0.0, 0.0, 4.0), (16.0, 16.0, 12.0)), **KW)
    node = VoFOD(cfg, DynParams(),
                 NodeOptions(raycast_mode="sweep", raycast_every=raycast_every), device="cpu")
    node.load_apriori_map(_apriori())
    return node


def _record(node, diag, msg, grid):
    return dict(
        diag={f: int(getattr(diag, f)) for f in DIAG_FIELDS},
        dets=[(d.id, d.n_points, np.array(d.position), d.confidence) for d in msg.detections],
        grid=np.array(grid, np.float32),
    )


@pytest.fixture(scope="module")
def fixture_scans():
    z = np.load(FIXTURE)
    return z


@pytest.fixture(scope="module")
def jax_run(fixture_scans):
    z = fixture_scans
    cfg = JConfig(
        sensor=JSensor(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)),
        oparea=JBox((0.0, 0.0, 4.0), (16.0, 16.0, 12.0)), **KW)
    node = JNode(cfg, JDyn(), JOptions(raycast_mode="sweep"))
    node.load_apriori_map(_apriori())
    out, carried = [], None
    for k, (r, p) in enumerate(zip(z["ranges"], z["poses"])):
        if k == CARRY_AT:
            carried = {f: np.array(v) for f, v in jax.device_get(node.state)._asdict().items()}
        msg = node.process_scan(r, None, p)
        out.append(_record(node, node.last_diag, msg, node.state.grid))
    return out, carried


@pytest.fixture(scope="module")
def port_run(fixture_scans):
    z = fixture_scans
    node = _port_node()
    out, msgs = [], []
    for r, p in zip(z["ranges"], z["poses"]):
        msg = node.process_scan(r, None, p)
        msgs.append(msg)
        out.append(_record(node, node.last_diag, msg, node.state.grid.numpy()))
    return out, msgs, node


def _compare(port, ref, k):
    assert port["diag"] == ref["diag"], f"scan {k}"
    assert len(port["dets"]) == len(ref["dets"]), f"scan {k}"
    for (pid, pn, ppos, pc), (jid, jn, jpos, jc) in zip(port["dets"], ref["dets"]):
        assert (pid, pn) == (jid, jn), f"scan {k}"
        np.testing.assert_allclose(ppos, jpos, atol=1e-3, rtol=0)
        np.testing.assert_allclose(pc, jc, rtol=CONF_RTOL, atol=0)
    fin = np.isfinite(ref["grid"])
    assert np.array_equal(fin, np.isfinite(port["grid"])), f"scan {k}"
    dmax = float(np.abs(port["grid"][fin] - ref["grid"][fin]).max())
    assert dmax <= GRID_ATOL, f"scan {k}: grid max|d| {dmax}"
    return dmax


def test_golden_replay_port(fixture_scans, port_run):
    """(a) tests/test_golden.py's assertions, on the port."""
    z = fixture_scans
    _, msgs, node = port_run
    first = next(i for i, m in enumerate(msgs) if m.detections)
    assert first == int(z["first_detection_scan"])
    det = msgs[-1].detections
    assert len(det) == 1
    np.testing.assert_allclose(np.array(det[0].position), z["expected_position"], atol=0.26)
    assert det[0].n_points == int(z["expected_n_points"])
    np.testing.assert_allclose(det[0].confidence, float(z["expected_confidence"]), atol=0.05)
    np.testing.assert_allclose(det[0].detection_probability, float(z["expected_pdet"]), atol=1e-4)
    g = node.state.grid.numpy()
    np.testing.assert_allclose(g[np.isfinite(g)].sum(), float(z["grid_checksum"]), rtol=1e-4)


def test_scan_for_scan_against_jax(jax_run, port_run):
    """(b) every scan: diagnostics, detections and the grid."""
    ref, _ = jax_run
    port, _, _ = port_run
    assert len(port) == len(ref) == 50
    dmax = max(_compare(p, r, k) for k, (p, r) in enumerate(zip(port, ref)))
    assert sum(len(r["dets"]) for r in ref) > 0  # detections were compared
    assert dmax > 0.0  # the sweep's rounding does differ: the bound is exercised


def test_state_carry_over_from_jax(fixture_scans, jax_run):
    """(c) a JAX state after 20 scans, carried in with state_from_numpy; both
    sides run the remaining scans and agree."""
    z = fixture_scans
    ref, carried = jax_run
    node = _port_node()
    node.state = state_from_numpy(carried, "cpu")
    back = state_to_numpy(node.state)
    for f, v in carried.items():
        assert np.array_equal(back[f], v) and back[f].dtype == v.dtype, f
    assert node.state.step == CARRY_AT
    for k in range(CARRY_AT, len(z["ranges"])):
        msg = node.process_scan(z["ranges"][k], None, z["poses"][k])
        _compare(_record(node, node.last_diag, msg, node.state.grid.numpy()), ref[k], k)
    assert node.state.step == len(z["ranges"])


RAYCAST_EVERY_SCANS = 12


def test_raycast_every_against_jax(fixture_scans, port_run):
    """``raycast_every=2``: the freespace update runs on the odd steps only,
    with its_diff 2; the first 12 golden scans, port node against JAX node,
    under the budgets of test_scan_for_scan_against_jax."""
    z = fixture_scans
    cfg = JConfig(
        sensor=JSensor(vertical_rays=16, horizontal_rays=64, vertical_fov=np.deg2rad(90.0)),
        oparea=JBox((0.0, 0.0, 4.0), (16.0, 16.0, 12.0)), **KW)
    jnode = JNode(cfg, JDyn(), JOptions(raycast_mode="sweep", raycast_every=2))
    jnode.load_apriori_map(_apriori())
    node = _port_node(raycast_every=2)
    every_scan, _, _ = port_run
    grids = []
    for k in range(RAYCAST_EVERY_SCANS):
        r, p = z["ranges"][k], z["poses"][k]
        jmsg = jnode.process_scan(r, None, p)
        msg = node.process_scan(r, None, p)
        ref = _record(jnode, jnode.last_diag, jmsg, jnode.state.grid)
        _compare(_record(node, node.last_diag, msg, node.state.grid.numpy()), ref, k)
        grids.append(node.state.grid.numpy().copy())
    # the update rate differs from raycasting every scan, from the first scan
    # on (step 0 skips the raycast)
    assert not np.array_equal(grids[0], every_scan[0]["grid"])
    assert not np.array_equal(grids[-1], every_scan[RAYCAST_EVERY_SCANS - 1]["grid"])


def test_raycast_every_must_be_positive():
    with pytest.raises(ValueError, match="raycast_every"):
        _port_node(raycast_every=0)


_MODES = [  # (change, ported): the JAX step's modes and whether the port has them; the
    # combinations the JAX step refuses are refused too
    (dict(raycast_mode="exact"), True), (dict(raycast_mode="off"), True),
    (dict(frontend_mode="prebinned"), True), (dict(cfg="dynamic_radii"), True),
    (dict(cfg="compat_hascloseto_bounds"), True), (dict(cfg="compat_counted_indexing"), True),
    (dict(cfg="compat_rangefinder_validity"), True), (dict(cfg="sepclusters_exact_census"), True),
    (dict(cfg="sequential_explore"), True),
    (dict(frontend_mode="prebinned", raycast_mode="exact"), False),
    (dict(cfg=("dynamic_radii", "sepclusters_exact_census")), False),
    (dict(cfg=("dynamic_radii", "compat_hascloseto_bounds")), False),
    (dict(frontend_mode="prebinned", raycast_mode="off", cfg="dynamic_radii"), True),
    (dict(raycast_gate=False), True),
    (dict(cfg=("sequential_explore", "sepclusters_exact_census", "compat_hascloseto_bounds"),
          raycast_mode="exact"), True),
]


@pytest.mark.parametrize("change,ported", [
    pytest.param(c, p, id=f"change{i}") for i, (c, p) in enumerate(_MODES)])
def test_unported_modes_raise(change, ported):
    """Modes of the JAX step that the port does not have yet are refused,
    never silently replaced by the production path; the ported ones build."""
    import dataclasses

    from vofod_tpu_torch.pipeline.step import make_step_fn
    from vofod_tpu_torch.sensor import make_lut_simulation

    cfg = VoFODConfig(sensor=SensorConfig(vertical_rays=8, horizontal_rays=32),
                      oparea=Box((0.0, 0.0, 3.0), (8.0, 8.0, 6.0)))
    kw = {k: v for k, v in change.items() if k != "cfg"}
    flags = change.get("cfg", ())
    cfg = dataclasses.replace(cfg, **{f: True for f in ((flags,) if isinstance(flags, str)
                                                         else flags)})
    lut = make_lut_simulation(32, 8, cfg.sensor.vertical_fov)
    if ported:
        assert callable(make_step_fn(cfg, lut, device="cpu", **kw))
    else:
        with pytest.raises(NotImplementedError):
            make_step_fn(cfg, lut, device="cpu", **kw)
