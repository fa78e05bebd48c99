"""The reference-exact step as a whole: the port's node on the CPU
(``NodeOptions(raycast_mode="exact")`` with ``sepclusters_exact_census``
and the compat flags) against the framework-free oracle of the reference
nodelet (tests/ref_pipeline.py ``RefPipeline``) and against the JAX step.

Scenario: tests/test_pipeline_parity.py ``parity_config`` and
``make_scenario`` (16x64 rays, a 32x32x23 grid, 52 scans: 20 background
scans while the sensor flies an arc, then a floating sphere), the apriori
ground plane stamped +inf.  Budgets:

All with the exact census, the hasCloseTo box and the counted-indexing
quirk on (the oracle honours each).

* against RefPipeline, all 52 scans, the assertions of
  tests/test_pipeline_parity.py TestExactModeParity: per scan the same
  number of detections, positions within 1e-3 m, ids and n_points equal,
  confidence within 0.2 % and detection probability within 1e-4 relative;
  bg_sufficient, sure_bg_sufficient and n_occupied equal, n_bg_voxels
  within 2 (EMA float knife-edges);
* against the JAX step, the first 24 scans of the same run: every integer
  and bool diagnostic equal,
  detections equal in count, id and n_points, positions within 1e-3 m,
  confidence within 0.2 % (the DESIGN §9 budget); the finite grid within
  GRID_ATOL score units (measured max 5.8e-4 after 24 scans, 1.2e-3 after 6
  scans raycasting every second scan, 0 with raycast off: JAX rotates the
  rays with an XLA dot (at HIGHEST precision here), the port in a fixed
  elementwise order, and the
  last-bit chord differences ride the ray EMA from scan to scan; scores
  span [-1000, 0]; ``pytest -s`` prints them);
* ``raycast_every = 2`` and raycast "off": the first 6 scans against the
  JAX step under the same budgets.
"""

import jax
import numpy as np
import pytest
import torch

from tests.ref_pipeline import RefPipeline
from tests.test_pipeline_parity import make_scenario, parity_config, parity_dyn, run_tpu
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.runtime.node import NodeOptions, VoFOD

JAX_SCANS = 24
SHORT_SCANS = 6
GRID_ATOL = 1e-2
DIAG_FIELDS = ("n_bg_voxels", "bg_sufficient", "sure_bg_sufficient", "n_occupied", "n_far",
               "far_overflow", "cc_converged", "cc_iters", "sep_converged", "n_detections")
EXACT = dict(sepclusters_exact_census=True, compat_hascloseto_bounds=True,
             compat_counted_indexing=True)


def _port_config(jcfg) -> VoFODConfig:
    """The port's copy of a JAX parity config."""
    import dataclasses

    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name not in ("sensor", "oparea", "exclude_box")}
    return VoFODConfig(
        sensor=SensorConfig(**dataclasses.asdict(jcfg.sensor)),
        oparea=Box(jcfg.oparea.offset, jcfg.oparea.size),
        exclude_box=Box(jcfg.exclude_box.offset, jcfg.exclude_box.size), **kw)


def _port_dyn() -> DynParams:
    import dataclasses

    return DynParams(**dataclasses.asdict(parity_dyn()))


def run_port(jcfg, lut, scans, grid_at=None, **options):
    """Replay ``scans`` through the port's node on the CPU; returns
    ([(detections, diag)], node, the grid after ``grid_at`` scans)."""
    node = VoFOD(_port_config(jcfg), _port_dyn(), NodeOptions(**options), lut, device="cpu")
    node.state.grid[1, :, :] = float("inf")  # the apriori ground plane (z = 0.5 m)
    out, grid = [], None
    for k, (ranges, inten, pose) in enumerate(scans):
        if k == grid_at:
            grid = node.state.grid.numpy().copy()
        msg = node.process_scan(ranges, inten, pose)
        dets = [dict(id=d.id, position=np.array(d.position), n_points=d.n_points,
                     confidence=d.confidence, detection_probability=d.detection_probability)
                for d in msg.detections]
        out.append((dets, node.last_diag))
    if grid_at is None or grid_at == len(scans):
        grid = node.state.grid.numpy().copy()
    return out, node, grid


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for this module's long CPU replays: its small
    ops gain nothing from more, and under the tier-1 run's six workers more
    threads only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenario():
    cfg = parity_config(**EXACT)
    lut, scans = make_scenario(cfg)
    return cfg, lut, scans


@pytest.fixture(scope="module")
def oracle_run(scenario):
    cfg, lut, scans = scenario
    ref = RefPipeline(cfg, parity_dyn(), lut)
    ref.vmap[1, :, :] = np.inf  # apriori ground plane (ref :339-341)
    return [ref.step(r, i, p) for r, i, p in scans]


@pytest.fixture(scope="module")
def port_run(scenario):
    cfg, lut, scans = scenario
    return run_port(cfg, lut, scans, grid_at=JAX_SCANS, raycast_mode="exact")


def _sorted(dets):
    return sorted(dets, key=lambda d: tuple(d["position"]))


def test_detections_match_oracle(oracle_run, port_run):
    port_out = port_run[0]
    assert len(port_out) == len(oracle_run) == 52
    for i, ((odets, _), (tdets, _)) in enumerate(zip(oracle_run, port_out)):
        assert len(tdets) == len(odets), f"scan {i}: {len(tdets)} vs oracle {len(odets)}"
        for od, td in zip(_sorted(odets), _sorted(tdets)):
            np.testing.assert_allclose(td["position"], od["position"], atol=1e-3,
                                       err_msg=f"scan {i}")
            assert (td["n_points"], td["id"]) == (od["n_points"], od["id"]), f"scan {i}"
            np.testing.assert_allclose(td["confidence"], od["confidence"], rtol=2e-3)
            np.testing.assert_allclose(td["detection_probability"],
                                       od["detection_probability"], rtol=1e-4)
    first = next(i for i, (d, _) in enumerate(oracle_run) if d)
    assert first >= 20 and sum(1 for d, _ in oracle_run if d) >= 10  # a tracked target


def test_diagnostics_match_oracle(oracle_run, port_run):
    port_out, node, _ = port_run
    for i, ((_, od), (_, td)) in enumerate(zip(oracle_run, port_out)):
        assert bool(td.bg_sufficient) == od["bg_sufficient"], i
        assert bool(td.sure_bg_sufficient) == od["sure_bg_sufficient"], i
        assert int(td.n_occupied) == od["n_occupied"], i
        assert abs(int(td.n_bg_voxels) - od["n_bg_voxels"]) <= 2, i
    # the exact census ran on its schedule (sepclusters_every = 3) and
    # counted its component sweeps
    sweeps = [int(d.sep_sweeps) for _, d in port_out]
    assert all((s > 0) == (i % 3 == 0) for i, s in enumerate(sweeps)), sweeps
    assert np.isfinite(node.state.grid.numpy()[2:]).all()


def _compare(port_out, port_grid, jax_out, jax_grid, n):
    for i in range(n):
        (tdets, td), (jdets, jd) = port_out[i], jax_out[i]
        assert {f: int(getattr(td, f)) for f in DIAG_FIELDS} == {
            f: int(getattr(jd, f)) for f in DIAG_FIELDS}, f"scan {i}"
        assert len(tdets) == len(jdets), f"scan {i}"
        for t, j in zip(tdets, jdets):
            assert (t["id"], t["n_points"]) == (j["id"], j["n_points"]), f"scan {i}"
            np.testing.assert_allclose(t["position"], j["position"], atol=1e-3)
            np.testing.assert_allclose(t["confidence"], j["confidence"], rtol=2e-3)
    jg = np.asarray(jax_grid)
    assert np.array_equal(np.isfinite(jg), np.isfinite(port_grid))
    fin = np.isfinite(jg)
    dmax = float(np.abs(port_grid[fin] - jg[fin]).max())
    assert dmax <= GRID_ATOL, dmax
    return dmax


@pytest.mark.parametrize("variant", ["exact", "exact_every_2", "off"])
def test_against_jax(scenario, port_run, variant):
    """The port's step against the JAX step on the same scans: the exact
    mode (the first 24 scans of the oracle run), the exact mode raycasting
    every second scan, and no raycast (6 scans each)."""
    cfg, lut, scans = scenario
    mode = "off" if variant == "off" else "exact"
    every = 2 if variant == "exact_every_2" else 1
    n = JAX_SCANS if variant == "exact" else SHORT_SCANS
    with jax.default_matmul_precision("highest"):  # the rays' dot in full float32
        jax_out, jax_state = run_tpu(cfg, lut, scans[:n], raycast_mode=mode,
                                     raycast_every=every)
    if variant == "exact":
        port_out, _, grid = port_run
        assert sum(len(d) for d, _ in jax_out[:n]) > 0  # detections are compared
    else:
        port_out, _, grid = run_port(cfg, lut, scans[:n], raycast_mode=mode, raycast_every=every)
    dmax = _compare(port_out, grid, jax_out, jax_state.grid, n)
    print(f"{variant}: {n} scans, grid max|d| {dmax:.3g} score units")
