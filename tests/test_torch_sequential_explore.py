"""The sequential explore (``cfg.sequential_explore``, K7s) against the JAX
package, and the step options that came with it.

* The adversarial scene of tests/test_sequential_demotion.py, where a failed
  first member's demotions cut a later member's escape: the port's
  sequential classify gives the oracle's verdict (mav) and the oracle's
  demoted grid bit for bit, as the JAX classify does; the port's batched
  classify gives JAX's batched verdict (unknown) with the grid unchanged.
* Seeded random fields (several clusters, members connecting and failing),
  an overflow of the query capacity and a scan with no query: the grid,
  the classes and the demoted set bit-equal to the JAX classify; the
  port's ``n_demoted`` equals the number of changed voxels (in this mode a
  voxel is demoted at most once: demoted, it leaves the unknown band).
* The reference-exact step with the sequential explore, port against the
  JAX step, on the 12 scans of tests/test_pipeline_parity.py's scenario in
  which the target appears (both started from the port's state after 18
  scans), under the budgets of tests/test_torch_exact_step.py.
* ``make_step_fn(raycast_gate=False)``: the ungated sweep, port against the
  JAX step over 3 scans, under the budgets of tests/test_torch_step.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline_parity import make_scenario, parity_config, parity_dyn
from tests.test_sequential_demotion import BASE, CARVED, build_scene, oracle_classify
from tests.test_sequential_demotion import scene_config, scene_dyn
from tests.test_torch_exact_step import DIAG_FIELDS, GRID_ATOL, _compare, _port_config, _port_dyn
from tests.test_torch_exact_step import run_port
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import DynParams as JDyn, VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.ops.components import label_components_seeded
from vofod_tpu.pipeline.classify import CLS_MAV, CLS_UNKNOWN
from vofod_tpu.pipeline.classify import classify as j_classify
from vofod_tpu.pipeline.state import ScanInput as JScan, VoFODState as JState
from vofod_tpu.pipeline.state import init_state as j_init_state
from vofod_tpu.pipeline.step import make_step_fn as j_make_step_fn
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.pipeline.classify import classify
from vofod_tpu_torch.pipeline.state import ScanInput, init_state, state_to_numpy
from vofod_tpu_torch.pipeline.step import make_step_fn

SWEEP_GRID_ATOL = 0.5  # tests/test_torch_step.py: the bf16 sweep's rounding


def _port_classify(cfg, dyn, vals, far, labels, sensor_pos, grid_spec):
    t = torch.tensor
    return classify(cfg, dyn, grid_spec, t(vals), t(far), t(labels), t(True), t(sensor_pos),
                    t(True), t(True))


def _jax_classify(cfg, dyn, vals, far, labels, sensor_pos, grid_spec):
    return j_classify(cfg, dyn.as_arrays(), grid_spec, jnp.asarray(vals), jnp.asarray(far),
                      jnp.asarray(labels), jnp.bool_(True), jnp.asarray(sensor_pos),
                      jnp.bool_(True), jnp.bool_(True))


def _tcfg(jcfg):
    """The port's copy of a JAX config (sensor and boxes rebuilt)."""
    return _port_config(jcfg)


# --------------------------------------------------------------- the scene
# the scene's 16^3 grid and submap side 20 for every classify case, so the
# JAX classify compiles once for them
CAPACITY = dict(max_clusters=8, max_far_voxels=256, max_queries=16)


@pytest.mark.parametrize("sequential", [True, False])
def test_adversarial_scene(sequential):
    jcfg = dataclasses.replace(scene_config(), sequential_explore=sequential, **CAPACITY)
    jdyn = scene_dyn()
    vals, far, labels, members, sensor_pos = build_scene(jcfg, jdyn)
    tcfg, tdyn = _tcfg(jcfg), DynParams(**dataclasses.asdict(jdyn))
    to = _port_classify(tcfg, tdyn, vals, far, labels, sensor_pos, GridSpec.from_config(tcfg))
    jo = _jax_classify(jcfg, jdyn, vals, far, labels, sensor_pos, JGrid.from_config(jcfg))
    k = int(np.argmax(to.cluster_valid.numpy()))
    cls = int(to.cluster_class[k])
    assert cls == int(jo.cluster_class[k])
    assert np.array_equal(to.grid.numpy(), np.asarray(jo.grid))
    if sequential:
        # the reference's coupled verdict, and A's demotions: every carved cell
        _, clusters, vmap_oracle = oracle_classify(jcfg, jdyn, vals, members, sensor_pos)
        assert cls == CLS_MAV and [c["cclass"] for c in clusters] == ["mav"]
        assert np.array_equal(to.grid.numpy(), vmap_oracle)
        bx, by, bz = BASE
        for x, y in CARVED:
            assert to.grid[bz, by + y, bx + x] == np.float32(jdyn.thr_frontiers), (x, y)
        assert int(to.n_demoted) == len(CARVED)
    else:
        assert cls == CLS_UNKNOWN  # B connects on the pre-demotion grid
        assert np.array_equal(to.grid.numpy(), vals)


# ------------------------------------------------------------ random fields
SHAPE, VOXEL = (16, 16, 16), 0.5
CFG = dict(**CAPACITY, explore_submap=20, confidence_submap=8, sequential_explore=True)
DYN = dict(cls_min_points=2.0, cls_max_size=2.6, cls_max_distance=6.0,
           cls_max_explore_distance=3.0)
NEAR, FAR_AWAY = np.array([4.0, 4.0, 3.0], np.float32), np.array([40.0, 40.0, 3.0], np.float32)


def _field(seed):
    """Air / unknown / ground at about 80 / 17 / 3 % with 5-6 clumps of
    unknown far voxels, labelled by the JAX propagation."""
    rng = np.random.default_rng(seed)
    u = rng.random(SHAPE)
    vals = np.where(u < 0.80, -900.0, np.where(u < 0.97, -500.0, -100.0)).astype(np.float32)
    far = np.zeros(SHAPE, bool)
    for _ in range(rng.integers(5, 7)):
        c = rng.integers(1, np.array(SHAPE) - 1)
        for _ in range(rng.integers(2, 6)):
            z, y, x = np.clip(c + rng.integers(-1, 2, size=3), 0, np.array(SHAPE) - 1)
            far[z, y, x] = True
    vals[far] = -500.0
    labels, _, _, _ = label_components_seeded(jnp.asarray(far), jnp.zeros(SHAPE, bool), 3.0, 64)
    return vals, far, np.array(labels)


CASES = {  # name: (seed, sensor); field 2 has 19 queries, more than the 16 slots
    "field 0": (0, NEAR), "field 5": (5, NEAR), "field 6": (6, NEAR),
    "query overflow": (2, NEAR), "no query": (0, FAR_AWAY),
}
_RESULTS = {}


def _run_case(name):
    if name not in _RESULTS:
        seed, sensor = CASES[name]
        vals, far, labels = _field(seed)
        jcfg, jdyn = JConfig(**CFG), JDyn(**DYN)
        tcfg, tdyn = VoFODConfig(**CFG), DynParams(**DYN)
        origin = (0.0, 0.0, 0.0)
        to = _port_classify(tcfg, tdyn, vals, far, labels, sensor, GridSpec(origin, SHAPE, VOXEL))
        jo = _jax_classify(jcfg, jdyn, vals, far, labels, sensor, JGrid(origin, SHAPE, VOXEL))
        _RESULTS[name] = (vals, to, jo)
    return _RESULTS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_sequential_classify_against_jax(name):
    vals, to, jo = _run_case(name)
    for f in ("cluster_valid", "cluster_class", "n_points", "reps", "n_far", "far_overflow"):
        assert np.array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f))), f
    grid = to.grid.numpy()
    assert np.array_equal(grid, np.asarray(jo.grid))  # so the demoted sets are equal too
    changed = grid != vals
    assert int(to.n_demoted) == int(changed.sum())  # each demoted voxel written once
    assert (grid[changed] == np.float32(DynParams().thr_frontiers)).all()
    n_q = int(to.n_queries)
    if name == "query overflow":
        assert n_q > CFG["max_queries"] and int(to.n_demoted) == 0
    if name == "no query":
        assert n_q == 0 and int(to.n_demoted) == 0


def test_fields_connect_and_fail():
    """The three random fields hold both verdicts of gated clusters and
    demotions, so the bit-equality above covers both branches of K7s."""
    classes, demoted = [], 0
    for name in ("field 0", "field 5", "field 6"):
        _, to, _ = _run_case(name)
        classes += to.cluster_class.numpy()[to.cluster_valid.numpy()].tolist()
        demoted += int(to.n_demoted)
    assert CLS_MAV in classes and CLS_UNKNOWN in classes, classes
    assert demoted > 0


# --------------------------------------------------------- the whole step
N_LEAD, N_COMPARED = 18, 12


def test_sequential_exact_step_against_jax():
    """12 scans of the exact step with the sequential explore (the target's
    first scans: queries and demotions happen), port against JAX, both from
    the port's state after 18 scans; the budgets of test_torch_exact_step."""
    jcfg = parity_config(sepclusters_exact_census=True, compat_hascloseto_bounds=True,
                         sequential_explore=True)
    lut, scans = make_scenario(jcfg)
    _, node, _ = run_port(jcfg, lut, scans[:N_LEAD], raycast_mode="exact")
    lead = state_to_numpy(node.state)
    window = scans[N_LEAD:N_LEAD + N_COMPARED]
    port_out = []
    for ranges, inten, pose in window:
        msg = node.process_scan(ranges, inten, pose)
        port_out.append(([dict(id=d.id, position=np.array(d.position), n_points=d.n_points,
                               confidence=d.confidence) for d in msg.detections],
                         node.last_diag))
    step = j_make_step_fn(jcfg, lut, raycast_mode="exact", donate=False)
    state = JState(**{k: jnp.asarray(v) for k, v in lead.items()})
    jdyn = parity_dyn().as_arrays()
    jax_out = []
    with jax.default_matmul_precision("highest"):  # the rays' dot in full float32
        for ranges, inten, pose in window:
            state, out = step(state, JScan(jnp.asarray(ranges.astype(np.float32)),
                                           jnp.asarray(inten), jnp.asarray(pose)), jdyn)
            d = jax.device_get(out.detections)
            jax_out.append(([dict(id=int(d.id[k]), position=np.asarray(d.position[k]),
                                  n_points=int(d.n_points[k]),
                                  confidence=float(d.confidence[k]))
                             for k in range(jcfg.max_clusters) if bool(d.valid[k])],
                            jax.device_get(out.diag)))
    dmax = _compare(port_out, node.state.grid.numpy(), jax_out, state.grid, N_COMPARED)
    assert dmax <= GRID_ATOL
    n_queries = sum(int(d.n_queries) for _, d in port_out)
    n_demoted = sum(int(d.n_demoted) for _, d in port_out)
    assert n_queries > 0 and n_demoted > 0, (n_queries, n_demoted)
    assert sum(len(d) for d, _ in jax_out) > 0
    print(f"sequential exact step: {N_COMPARED} scans, {n_queries} queries, {n_demoted} "
          f"demotion writes, grid max|d| {dmax:.3g}")


# ------------------------------------------------------- the ungated sweep
N_UNGATED = 3


def test_ungated_sweep_against_jax():
    """``raycast_gate=False`` on the production sweep over 3 scans of the
    parity scenario, half the pixels with an intensity under
    raycast_min_intensity (so the gate matters): the ungated port equals the
    ungated JAX step within the sweep budget of tests/test_torch_step.py,
    integer diagnostics equal, and differs from the gated port."""
    jcfg = parity_config()
    lut, scans = make_scenario(jcfg)
    rng = np.random.default_rng(4)
    scans = [(r, np.where(rng.random(r.size) < 0.5, 0.1, 1.0).astype(np.float32), p)
             for r, _, p in scans[:N_UNGATED]]
    dyn_kw = dict(raycast_min_intensity=0.5)
    tcfg = _port_config(jcfg)
    tdyn = DynParams(**{**dataclasses.asdict(_port_dyn()), **dyn_kw})
    jdyn = JDyn(**{**dataclasses.asdict(parity_dyn()), **dyn_kw})
    runs = []
    for gate in (False, True):
        step = make_step_fn(tcfg, lut, device="cpu", raycast_gate=gate)
        st = init_state(tcfg, tdyn, device="cpu")
        st.grid[1] = float("inf")  # the apriori ground plane
        rec = []
        for r, inten, p in scans:
            st, out = step(st, ScanInput(torch.from_numpy(r.astype(np.float32)),
                                         torch.from_numpy(inten), p), tdyn)
            rec.append(({f: int(getattr(out.diag, f)) for f in DIAG_FIELDS},
                        st.grid.numpy().copy()))
        runs.append(rec)
    step = j_make_step_fn(jcfg, lut, raycast_mode="sweep", donate=False, raycast_gate=False)
    st = j_init_state(jcfg, jdyn)
    st = st._replace(grid=st.grid.at[1].set(jnp.inf))
    for k, (r, inten, p) in enumerate(scans):
        st, out = step(st, JScan(jnp.asarray(r.astype(np.float32)), jnp.asarray(inten),
                                 jnp.asarray(p)), jdyn.as_arrays())
        pd, pg = runs[0][k]
        jg = np.asarray(st.grid)
        assert pd == {f: int(getattr(out.diag, f)) for f in DIAG_FIELDS}, f"scan {k}"
        fin = np.isfinite(jg)
        assert np.array_equal(fin, np.isfinite(pg))
        assert float(np.abs(pg[fin] - jg[fin]).max()) <= SWEEP_GRID_ATOL, f"scan {k}"
    assert not np.array_equal(runs[0][-1][1], runs[1][-1][1])
