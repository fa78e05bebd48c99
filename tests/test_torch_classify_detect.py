"""Parity of classification (with explore and demotions), detection
extraction and separated-background maintenance against vofod_tpu.

Random scenes in the style of tests/test_classify_fuzz.py: an air / unknown /
ground value field with a few small far-voxel clumps, labelled by the JAX
propagation, then classified by both packages.  The parity contract:

* integers and bools bit-equal: slots, classes, point counts, reps, far
  counts and overflow, detection validity, ids and point counts, the
  demoted grid (the demotion writes min(v, thr) exactly), the sepclusters
  reach mask and flags;
* floats: positions within 1e-3 m (float32 sums in another order),
  confidence within 0.2 % relative, the sepclusters EMA within 1e-3 score
  units (float32 elementwise).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import DynParams as JDyn, VoFODConfig as JConfig
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.ops.components import label_components_seeded
from vofod_tpu.pipeline.classify import classify as j_classify
from vofod_tpu.pipeline.detect import extract_detections as j_extract
from vofod_tpu.pipeline.sepclusters import run_sepclusters as j_sep
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.compaction import masked_compact_plain
from vofod_tpu_torch.pipeline.classify import classify, cluster_stats_plain
from vofod_tpu_torch.pipeline.detect import extract_detections
from vofod_tpu_torch.pipeline.sepclusters import run_sepclusters

# the scenes' JAX reference jitted as the JAX step runs it (config and grid
# static): the seeds share one compile instead of re-running every op eagerly
j_classify_jit = jax.jit(j_classify, static_argnums=(0, 2))
j_extract_jit = jax.jit(j_extract, static_argnums=(0, 2))

SHAPE, VOXEL = (10, 12, 14), 0.5
CFG = dict(max_clusters=8, max_far_voxels=256, max_queries=128, explore_submap=16,
           confidence_submap=8)
DYN = dict(cls_min_points=2.0, cls_max_size=2.6, cls_max_distance=4.2,
           cls_max_explore_distance=1.0)
SENSOR = np.array([3.5, 3.0, 2.5], np.float32)


def _scene(seed):
    rng = np.random.default_rng(seed)
    p_air, p_unk = [(1.0, 1.0), (0.20, 0.60), (0.45, 0.85)][seed % 3]
    u = rng.random(SHAPE)
    vals = np.where(u < p_air, -900.0, np.where(u < p_unk, -500.0, -100.0)).astype(np.float32)
    far = np.zeros(SHAPE, bool)
    for _ in range(rng.integers(2, 5)):
        c = rng.integers(0, SHAPE)
        for _ in range(rng.integers(1, 6)):
            z, y, x = np.clip(c + rng.integers(-1, 2, size=3), 0, np.array(SHAPE) - 1)
            far[z, y, x] = True
    if seed % 3 == 0:
        vals[far] = -500.0  # floating unknown pockets -> mav + demotions
    labels, _, _, _ = label_components_seeded(
        jnp.asarray(far), jnp.zeros(SHAPE, bool), 3.0, 64
    )
    return vals, far, np.array(labels)


def _corner_scene(seed):
    """Floating clumps in two opposite grid corners and on an edge: their
    detection windows reach past every face of the grid, so each fill of
    the window read (0 / False / INT_MAX) is taken."""
    rng = np.random.default_rng(300 + seed)
    nz, ny, nx = SHAPE
    vals = np.full(SHAPE, -900.0, np.float32)
    far = np.zeros(SHAPE, bool)
    clumps = [[(0, 0, 0), (0, 0, 1), (1, 0, 0)],
              [(nz - 1, ny - 1, nx - 1), (nz - 1, ny - 2, nx - 1)],
              [(nz // 2, 0, nx - 1), (nz // 2 + 1, 0, nx - 1)],
              [(0, ny - 1, nx // 2)]]
    for c in rng.permutation(len(clumps)):
        for v in clumps[c]:
            far[v] = True
    vals[far] = -500.0
    labels, _, _, _ = label_components_seeded(
        jnp.asarray(far), jnp.zeros(SHAPE, bool), 3.0, 64
    )
    return vals, far, np.array(labels)


@functools.lru_cache(maxsize=None)
def _run_both(seed):
    return _run_scene(*_scene(seed), DYN)


def _run_scene(vals, far, labels, dyn_kw):
    jcfg, tcfg = JConfig(**CFG), VoFODConfig(**CFG)
    jdyn, tdyn = JDyn(**dyn_kw), DynParams(**dyn_kw)
    jg, tg = JGrid((0.0, 0.0, 0.0), SHAPE, VOXEL), GridSpec((0.0, 0.0, 0.0), SHAPE, VOXEL)
    jo = j_classify_jit(jcfg, jdyn.as_arrays(), jg, jnp.asarray(vals), jnp.asarray(far),
                    jnp.asarray(labels), jnp.bool_(True), jnp.asarray(SENSOR),
                    jnp.bool_(True), jnp.bool_(True))
    t = torch.tensor
    to = classify(tcfg, tdyn, tg, torch.from_numpy(vals), torch.from_numpy(far),
                  torch.from_numpy(labels), t(True), torch.from_numpy(SENSOR), t(True), t(True))
    jd, jc = j_extract_jit(jcfg, jdyn.as_arrays(), jg, jo.grid, jnp.asarray(labels),
                       jnp.asarray(far), jo, jnp.asarray(SENSOR), jnp.int32(5))
    td, tc = extract_detections(tcfg, tdyn, tg, to.grid, torch.from_numpy(labels),
                                torch.from_numpy(far), to, torch.from_numpy(SENSOR),
                                t(5, dtype=torch.int32))
    return jo, to, jd, td, jc, tc


SEEDS = list(range(12))


@pytest.mark.parametrize("seed", SEEDS)
def test_classify_parity(seed):
    jo, to, *_ = _run_both(seed)
    for f in ("cluster_valid", "cluster_class", "n_points", "reps", "n_far", "far_overflow"):
        assert np.array_equal(getattr(to, f).numpy(), np.asarray(getattr(jo, f))), f
    assert np.array_equal(to.grid.numpy(), np.asarray(jo.grid))  # demotions exact
    v = to.cluster_valid.numpy()
    for f in ("aabb_min", "aabb_max", "obb_center"):
        np.testing.assert_allclose(getattr(to, f).numpy()[v], np.asarray(getattr(jo, f))[v],
                                   atol=1e-3, rtol=0, err_msg=f)
    np.testing.assert_allclose(to.obb_size.numpy()[v], np.asarray(jo.obb_size)[v], atol=1e-3)


def test_classify_scenes_exercise_every_class():
    classes = set()
    demoted = 0
    for seed in SEEDS:
        jo, to, *_ = _run_both(seed)
        classes |= set(to.cluster_class.numpy()[to.cluster_valid.numpy()].tolist())
        demoted += int((to.grid.numpy() == -750.0).sum())
    assert classes == {0, 1, 2} and demoted > 0


# single voxels, collinear pairs / triples, an L, coplanar squares, a slab
_SHAPES = [
    [(0, 0, 0)], [(0, 0, 0), (0, 0, 1)], [(0, 0, 0), (0, 1, 0), (0, 2, 0)],
    [(0, 0, 0), (1, 0, 0), (2, 0, 0)], [(0, 0, 0), (0, 0, 1), (0, 1, 0)],
    [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)], [(0, y, x) for y in range(3) for x in range(3)],
    [(z, 0, x) for z in range(2) for x in range(3)], [(0, 0, 0), (1, 1, 1), (0, 1, 1), (1, 1, 0)],
]


def _cluster_scene(n_clusters, seed):
    """Far clusters of _SHAPES (shuffled, then random blobs) on a 4-voxel
    lattice; each cluster's label is its least flat id."""
    shape = (8, 20, 24)
    rng = np.random.default_rng(seed)
    far = np.zeros(shape, bool)
    labels = np.full(shape, np.iinfo(np.int32).max, np.int32)
    sites = [(z, y, x) for z in (1, 5) for y in range(1, 17, 4) for x in range(1, 21, 4)]
    order = rng.permutation(len(_SHAPES))
    for c, site in enumerate([sites[i] for i in rng.permutation(len(sites))[:n_clusters]]):
        offs = _SHAPES[order[c]] if c < len(_SHAPES) else rng.integers(0, 3, (5, 3)).tolist()
        pts = np.array(site) + np.array(offs)
        far[tuple(pts.T)] = True
        labels[tuple(pts.T)] = ((pts[:, 0] * shape[1] + pts[:, 1]) * shape[2] + pts[:, 2]).min()
    return far, labels


@pytest.mark.parametrize("n_clusters,seed", [(6, 0), (12, 1), (12, 2), (20, 3)])
def test_cluster_stats_plain_matches_the_jax_block(n_clusters, seed):
    """K9's plain version against classify.py:83-157 of the JAX package:
    more clusters than K = 8 slots (overflow), collinear, coplanar and
    single-voxel clusters.  Integers, bools and the AABB bit-equal; OBB
    floats within 1e-3 m as in test_classify_parity."""
    far, labels = _cluster_scene(n_clusters, seed)
    shape = far.shape
    vals = np.full(shape, -100.0, np.float32)
    sensor = np.array([6.0, 5.0, 2.0], np.float32)
    jcfg, jdyn = JConfig(**CFG), JDyn(**DYN)
    jo = j_classify(jcfg, jdyn.as_arrays(), JGrid((0.0, 0.0, 0.0), shape, VOXEL), jnp.asarray(vals),
                    jnp.asarray(far), jnp.asarray(labels), jnp.bool_(True), jnp.asarray(sensor),
                    jnp.bool_(True), jnp.bool_(True))
    tg = GridSpec((0.0, 0.0, 0.0), shape, VOXEL)
    fids, fvalid, ftotal = masked_compact_plain(torch.from_numpy(far), CFG["max_far_voxels"])
    st = cluster_stats_plain(DynParams(**DYN), tg, CFG["max_clusters"], fids, fvalid,
                             torch.from_numpy(labels).reshape(-1)[fids.long()],
                             torch.from_numpy(sensor),
                             torch.tensor(True))
    assert bool(st.cluster_overflow) == (n_clusters > CFG["max_clusters"])
    assert bool(st.cluster_overflow) == bool(jo.far_overflow)
    for f, jf in (("reps", "reps"), ("slot_valid", "cluster_valid"), ("npts", "n_points"),
                  ("aabb_min", "aabb_min"), ("aabb_max", "aabb_max")):
        assert np.array_equal(getattr(st, f).numpy(), np.asarray(getattr(jo, jf))), f
    v = st.slot_valid.numpy()
    assert np.array_equal(st.gated.numpy(), np.asarray(jo.cluster_class) != 0)
    assert np.array_equal(st.qgate.numpy(), st.gated.numpy())
    assert np.array_equal(st.rep_sel.numpy(), np.where(st.gated.numpy(), st.reps.numpy(), -2))
    want_mk = np.floor((np.asarray(jo.obb_size)[v] + np.float32(DYN["cls_max_explore_distance"]))
                       / np.float32(VOXEL)).astype(np.int32)
    assert np.array_equal(st.m_k.numpy()[v], want_mk)
    assert 0 < st.gated.sum() < v.sum()  # some slots pass the gates, some fail
    for f, jf in (("obb_center", "obb_center"), ("obb_extent", "obb_extent"),
                  ("obb_size", "obb_size"), ("axes", "obb_axes")):
        np.testing.assert_allclose(getattr(st, f).numpy()[v], np.asarray(getattr(jo, jf))[v],
                                   atol=1e-3, rtol=0, err_msg=f)


@pytest.mark.parametrize("seed", SEEDS)
def test_extract_detections_parity(seed):
    _, _, jd, td, jc, tc = _run_both(seed)
    _compare_detections(jd, td, jc, tc)


def _compare_detections(jd, td, jc, tc):
    valid = td.valid.numpy()
    assert np.array_equal(valid, np.asarray(jd.valid))
    assert int(tc) == int(jc)
    for f in ("id", "n_points", "cluster_class"):
        assert np.array_equal(getattr(td, f).numpy()[valid], np.asarray(getattr(jd, f))[valid]), f
    np.testing.assert_allclose(td.position.numpy()[valid], np.asarray(jd.position)[valid],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(td.confidence.numpy(), np.asarray(jd.confidence),
                               rtol=2e-3, atol=1e-12)
    np.testing.assert_allclose(td.detection_probability.numpy(),
                               np.asarray(jd.detection_probability), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(td.covariance.numpy()[valid], np.asarray(jd.covariance)[valid],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_detections_corner_windows(seed):
    """K10's plain version at the grid's faces, edges and corners: the
    classify outputs of a corner scene with the clump slots set to mav (an
    edge-touching clump is never classified floating), so the confidence of
    every window that reaches past the grid is computed and compared."""
    vals, far, labels = _corner_scene(seed)
    jo, to, *_ = _run_scene(vals, far, labels, DYN)
    K = CFG["max_clusters"]
    valid = to.cluster_valid.numpy()
    assert valid.sum() >= 4 and np.array_equal(valid, np.asarray(jo.cluster_valid))
    cls = np.where(valid, 1, 0).astype(np.int32)  # CLS_MAV
    npts = np.where(valid, to.n_points.numpy(), 0).astype(np.int32)
    jo2 = jo._replace(cluster_class=jnp.asarray(cls), n_points=jnp.asarray(npts))
    to.cluster_class, to.n_points = torch.from_numpy(cls), torch.from_numpy(npts)
    jcfg, tcfg = JConfig(**CFG), VoFODConfig(**CFG)
    jg = JGrid((0.0, 0.0, 0.0), SHAPE, VOXEL)
    tg = GridSpec((0.0, 0.0, 0.0), SHAPE, VOXEL)
    jd, jc = j_extract(jcfg, JDyn(**DYN).as_arrays(), jg, jo2.grid, jnp.asarray(labels),
                       jnp.asarray(far), jo2, jnp.asarray(SENSOR), jnp.int32(9))
    td, tc = extract_detections(tcfg, DynParams(**DYN), tg, to.grid, torch.from_numpy(labels),
                                torch.from_numpy(far), to, torch.from_numpy(SENSOR),
                                torch.tensor(9, dtype=torch.int32))
    assert int(td.valid.sum()) == int(valid.sum()) and K > int(valid.sum())
    # every window of a valid slot reaches outside the grid on some axis
    lo = np.floor(to.aabb_min.numpy()[valid] / VOXEL).astype(int) - 2
    hi = np.floor(to.aabb_max.numpy()[valid] / VOXEL).astype(int) + 2
    lim = np.array(SHAPE[::-1]) - 1
    ctr = (np.clip(lo, 0, lim) + np.clip(hi, 0, lim)) // 2
    half = CFG["confidence_submap"] // 2
    assert np.all((((ctr - half) < 0) | ((ctr + half - 1) > lim)).any(axis=1))
    assert (td.confidence.numpy()[valid] > 0).all()
    _compare_detections(jd, td, jc, tc)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_run_sepclusters_parity(seed, warm):
    rng = np.random.default_rng(100 + seed)
    shape = (12, 16, 20)
    u = rng.random(shape)
    vals = np.where(u < 0.55, -900.0, np.where(u < 0.8, -200.0, -0.05)).astype(np.float32)
    vals[:2] = 0.5  # a sure ground slab: seeds the safe set
    prev_safe = (rng.random(shape) < 0.3) if warm else np.zeros(shape, bool)
    jcfg, tcfg = JConfig(), VoFODConfig()
    jo = j_sep(jcfg, JDyn().as_arrays(), jnp.asarray(vals), jnp.asarray(prev_safe),
               jnp.float32(1.0), prev_sure=jnp.bool_(False))
    to = run_sepclusters(tcfg, DynParams(), torch.from_numpy(vals),
                         torch.from_numpy(prev_safe), 1.0, prev_sure=torch.tensor(False))
    assert np.array_equal(to.safe.numpy(), np.asarray(jo.safe))
    assert bool(to.sure_bg_sufficient) == bool(jo.sure_bg_sufficient)
    assert bool(to.converged) == bool(jo.converged)
    np.testing.assert_allclose(to.grid.numpy(), np.asarray(jo.grid), atol=1e-3, rtol=0)
    assert np.array_equal(to.grid.numpy() != vals, np.asarray(jo.grid) != vals)
