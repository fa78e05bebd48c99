"""The speculate-then-commit schedule of K7s and K15b-7b against the walk.

On the card K7s (the dense sequential explore) and K15b-7b (its walk on the
grid-sharded step's stack) flood every valid query at once on the grid
before the walk, and one block's walk floods again only the queries whose
speculative flood meets an earlier failed query's reached voxels
(csrc/explore.cu explore_spec_kernel).  Its plain model,
``ops/explore.explore_sequential_spec_plain``, is held bit-equal here to

* ``explore_sequential_plain``, the dense K7s's plain version (the grid it
  leaves, cluster_connected and the write count),
* ``explore_sequential_stack_plain``, K15b-7b's, on ``explore_cut_plain``'s
  stack of the whole grid (cluster_connected, reached, corners, demoted),
* the JAX package's sequential explore: the ``lax.scan`` body of
  vofod_tpu/pipeline/classify.py:211-267 over ``explore_to_ground`` and
  ``apply_demotions``, which also gives each query's reached voxels and
  verdict (grid, cluster_connected, write count, reached, demoted); on the
  adversarial scene of tests/test_sequential_demotion.py also the JAX
  sequential classify's grid and the oracle's,

in seeded cases: random fields at S = 16, 32 and 40 (64-bit rows) whose
query boxes overlap heavily, ``max_iters`` 1 and 8 (capped floods) and 96,
grid-edge starts, bound 0, a chain in which every query after the first is
flooded again, a field of overlapping boxes whose floods never meet (no
query flooded again), query overflow and no valid query.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tests.test_sequential_demotion import A_REL, B_REL, BASE, CARVED, build_scene
from tests.test_sequential_demotion import oracle_classify, scene_config, scene_dyn, tpu_classify
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.ops.explore import apply_demotions, explore_to_ground
from vofod_tpu_torch.config import DynParams
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.explore import (demote_direct_plain, explore_cut_plain,
                                         explore_sequential_plain, explore_sequential_spec_plain,
                                         explore_sequential_stack_plain, unpack_rows)

SHAPE, VOXEL, ORIGIN = (20, 20, 20), 0.5, (0.0, 0.0, 0.0)
Q, K = 24, 8
THR_F, THR_G = DynParams().thr_frontiers, DynParams().thr_new_obstacles
AIR, UNK, GND = THR_F - 100.0, 0.5 * (THR_F + THR_G), THR_G + 100.0


def _table(shape, flat, cluster, valid, mm, q=Q, k=K):
    """The query table of ``flat`` voxel ids (numpy), cluster slots and
    bounds, padded to ``q`` slots: qlabels the cluster's least id, as a
    component label (queries of one cluster share it)."""
    n = len(flat)
    nz, ny, nx = shape
    ids = np.zeros(q, np.int64)
    ids[:n] = flat
    qvalid = np.zeros(q, bool)
    qvalid[:n] = valid
    slot = np.full(q, -1)
    slot[:n] = cluster
    qslot = qvalid[:, None] & (slot[:, None] == np.arange(k)[None, :])
    lab = {c: min(int(f) for f, cc in zip(flat, cluster) if cc == c) for c in set(cluster)}
    qlabels = np.where(qvalid, [lab.get(int(c), 0) for c in slot], 2**31 - 1).astype(np.int32)
    m = np.zeros(q, np.int32)
    m[:n] = mm
    z, y, x = ids // (ny * nx), ids // nx % ny, ids % nx
    return dict(qx=x.astype(np.int32), qy=y.astype(np.int32), qz=z.astype(np.int32),
                qvalid=qvalid, qlabels=qlabels, qids=ids.astype(np.int32), qslot=qslot, mm=m)


def _random_case(seed, S, max_iters=96, bound0=False):
    """Air / band / ground at about 69 / 30 / 1 % inside a 10^3 block in the
    middle of the grid (air around it), near the band's percolation
    threshold; 20 queries on band voxels of its central 6^3 in 6 clusters,
    bounds 2-10: every box overlaps every other, and queries of other
    clusters share band components."""
    rng = np.random.default_rng(seed)
    vals = np.full(SHAPE, AIR, np.float32)
    u = rng.random((10, 10, 10))
    vals[5:15, 5:15, 5:15] = np.where(u < 0.69, AIR, np.where(u < 0.99, UNK, GND))
    inner = np.zeros(SHAPE, bool)
    inner[7:13, 7:13, 7:13] = True
    flat = rng.choice(np.flatnonzero((vals == UNK) & inner), 20, replace=False)
    mm = rng.integers(2, 11, 20).astype(np.int32)
    t = _table(SHAPE, flat, rng.integers(0, 6, 20), np.ones(20, bool),
               np.zeros(20, np.int32) if bound0 else mm)
    return vals, t, S, max_iters, False


def _pockets(centres, size):
    vals = np.full(SHAPE, AIR, np.float32)
    for z, y, x in centres:
        h = size // 2
        vals[z - h:z + h + 1, y - h:y + h + 1, x - h:x + h + 1] = UNK
    return vals


def _chain_case():
    """One closed 3^3 pocket of band voxels and 7 queries in it (its centre
    and face centres), each its own cluster, bound 6 (the shell at 5 lies
    past the pocket, no ground): the first query walked fails and demotes
    the pocket, and every later one's speculative flood meets it, so each is
    flooded again (from a demoted start) and fails with nothing reached."""
    vals = _pockets([(10, 10, 10)], 3)
    flat = np.array([(10 + dz) * 400 + (10 + dy) * 20 + 10 + dx
                     for dz, dy, dx in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (-1, 0, 0),
                                        (0, -1, 0), (0, 0, -1))])
    t = _table(SHAPE, flat, np.arange(7), np.ones(7, bool), np.full(7, 6, np.int32))
    return vals, t, 16, 96, False


def _disjoint_case():
    """Four closed 3^3 pockets 6 voxels apart, a query in each (its own
    cluster), bound 6: every query fails, the S = 16 boxes all overlap, but
    no flood meets another, so no query is flooded again."""
    centres = [(7, 7, 7), (7, 13, 13), (13, 7, 13), (13, 13, 7)]
    vals = _pockets(centres, 3)
    flat = np.array([z * 400 + y * 20 + x for z, y, x in centres])
    t = _table(SHAPE, flat, np.arange(4), np.ones(4, bool), np.full(4, 6, np.int32))
    return vals, t, 16, 96, False


def _edge_case():
    """Band rows along the grid's faces and an interior band slab: queries
    at grid-edge voxels (connected by definition) and interior ones, some in
    the same cluster as an edge query (skipped after it)."""
    vals = np.full(SHAPE, AIR, np.float32)
    vals[0, :, :] = UNK
    vals[:, 19, :] = UNK
    vals[8:12, 4:16, 4:16] = UNK
    flat = np.array([0 * 400 + 5 * 20 + 5, 10 * 400 + 19 * 20 + 3, 9 * 400 + 8 * 20 + 8,
                     10 * 400 + 10 * 20 + 10, 0 * 400 + 3 * 20 + 17, 11 * 400 + 14 * 20 + 6,
                     8 * 400 + 5 * 20 + 15])
    t = _table(SHAPE, flat, np.array([0, 1, 0, 2, 3, 3, 4]), np.ones(7, bool),
               np.full(7, 5, np.int32))
    return vals, t, 16, 96, False


def _overflow_case():
    vals, t, S, mi, _ = _random_case(3, 16)
    return vals, t, S, mi, True


def _none_case():
    vals, t, S, mi, _ = _random_case(3, 16)
    t = dict(t, qvalid=np.zeros(Q, bool), qslot=np.zeros((Q, K), bool))
    return vals, t, S, mi, False


CASES = {
    "random S16": lambda: _random_case(3, 16),
    "random S32": lambda: _random_case(3, 32),
    "random S40": lambda: _random_case(3, 40),
    "max_iters 1": lambda: _random_case(0, 16, max_iters=1),
    "max_iters 8": lambda: _random_case(3, 32, max_iters=8),
    "bound 0": lambda: _random_case(6, 16, bound0=True),
    "grid edge": _edge_case,
    "chain": _chain_case,
    "disjoint": _disjoint_case,
    "query overflow": _overflow_case,
    "no valid query": _none_case,
}


@functools.lru_cache(maxsize=None)
def _jax_walk(shape, S, max_iters, nq, nk):
    """The JAX package's sequential explore, the lax.scan of
    vofod_tpu/pipeline/classify.py:211-267 (one query at a time in
    jnp.lexsort((qids, qlabels)) order; skipped when invalid, its cluster
    connected or the queries overflowed; a failed query demoting its reached
    voxels at once), also giving each query's reached voxels and whether it
    failed."""
    grid = JGrid(ORIGIN, shape, VOXEL)
    one = jnp.ones((1,), jnp.bool_)

    def walk(vals, qx, qy, qz, qvalid, qlabels, qids, qslot, m_q, overflow):
        order = jnp.lexsort((qids, qlabels))

        def body(carry, j):
            vals, conn_k = carry
            jj = order[j]
            kmask = qslot[jj]

            def explore_one(args):
                vals, conn_k = args
                connected, reached, corners = explore_to_ground(
                    grid, vals, qx[jj][None], qy[jj][None], qz[jj][None], one, m_q[jj][None],
                    THR_F, THR_G, S, max_iters)
                c = connected[0]
                vals = lax.cond(c, lambda v: v,
                                lambda v: apply_demotions(v, reached, corners, one, THR_F), vals)
                return (vals, conn_k | (kmask & c)), (reached[0], ~c)

            skip = (~qvalid[jj]) | jnp.any(kmask & conn_k) | overflow
            carry, (r, failed) = lax.cond(
                skip, lambda a: (a, (jnp.zeros((S, S, S), jnp.bool_), jnp.bool_(False))),
                explore_one, (vals, conn_k))
            return carry, (jj, r, failed)

        (vals, conn), (jjs, rs, fs) = lax.scan(body, (vals, jnp.zeros((nk,), jnp.bool_)),
                                               jnp.arange(nq))
        reached = jnp.zeros((nq, S, S, S), jnp.bool_).at[jjs].set(rs)
        return vals, conn, reached, jnp.zeros((nq,), jnp.bool_).at[jjs].set(fs)

    return jax.jit(walk)


_RUNS = {}


def _run(name):
    """(model, the dense plain version's, the stack plain version's,
    JAX's) outputs of a case, made once."""
    if name in _RUNS:
        return _RUNS[name]
    if name == "adversarial scene":
        vals, t, S, mi, ov, shape = _scene()
    else:
        vals, t, S, mi, ov = CASES[name]()
        shape = SHAPE
    grid = GridSpec(ORIGIN, shape, VOXEL)
    tt = {k: torch.from_numpy(np.asarray(v)) for k, v in t.items()}
    q = (tt["qx"], tt["qy"], tt["qz"], tt["qvalid"], tt["qlabels"], tt["qids"], tt["qslot"],
         tt["mm"], torch.tensor(ov))
    tv = torch.from_numpy(vals)
    stack = explore_cut_plain(tv, *q[:4], THR_F, THR_G, S)
    conn, reached, corners, demoted, redo = explore_sequential_spec_plain(grid, stack, *q, mi)
    mg, mn = demote_direct_plain(tv.clone(), reached, corners, demoted, THR_F)
    model = dict(grid=mg, conn=conn, n_writes=mn, reached=reached, corners=corners,
                 demoted=demoted, redo=redo, valid=int(tt["qvalid"].sum()))
    dg, dc, dn = explore_sequential_plain(grid, tv.clone(), *q, THR_F, THR_G, S, mi)
    dense = dict(grid=dg, conn=dc, n_writes=dn)
    sc, sr, sco, sd = explore_sequential_stack_plain(grid, stack, *q, mi)
    stk = dict(conn=sc, reached=sr, corners=sco, demoted=sd)
    jv, jc, jr, jd = _jax_walk(shape, S, mi, Q if name != "adversarial scene" else len(t["qx"]),
                               t["qslot"].shape[1])(
        jnp.asarray(vals), *(jnp.asarray(t[k]) for k in ("qx", "qy", "qz", "qvalid", "qlabels",
                                                          "qids", "qslot", "mm")),
        jnp.bool_(ov))
    jv, jr, jd = np.asarray(jv), np.asarray(jr), np.asarray(jd)
    _RUNS[name] = (model, dense, stk, dict(grid=jv, conn=np.asarray(jc), reached=jr,
                                           demoted=jd, vals=vals))
    return _RUNS[name]


def _scene():
    """tests/test_sequential_demotion.py's adversarial scene as a query
    table: members A and B of one cluster, bound 8, submap 20."""
    cfg, dyn = scene_config(), scene_dyn()
    vals, far, labels, members, sensor_pos = build_scene(cfg, dyn)
    t = _table(cfg.grid_shape, np.array(members), np.zeros(2, int), np.ones(2, bool),
               np.full(2, 8, np.int32), q=8, k=4)
    return vals, t, cfg.explore_submap, 96, False, cfg.grid_shape


NAMES = list(CASES) + ["adversarial scene"]


@pytest.mark.parametrize("name", NAMES)
def test_model_equals_dense_plain(name):
    model, dense, _, _ = _run(name)
    for f in ("grid", "conn", "n_writes"):
        assert torch.equal(model[f], dense[f]), f


@pytest.mark.parametrize("name", NAMES)
def test_model_equals_stack_plain(name):
    model, _, stk, _ = _run(name)
    for f in ("conn", "reached", "corners", "demoted"):
        assert torch.equal(model[f], stk[f]), f


@pytest.mark.parametrize("name", NAMES)
def test_model_equals_jax(name):
    model, _, _, jx = _run(name)
    assert np.array_equal(model["grid"].numpy(), jx["grid"])
    assert np.array_equal(model["conn"].numpy(), jx["conn"])
    assert np.array_equal(model["demoted"].numpy(), jx["demoted"])
    S = model["reached"].shape[-1]
    words = model["reached"].to(torch.int64) & ((1 << S) - 1)
    dem = jx["demoted"]
    assert np.array_equal(unpack_rows(words, S).numpy()[dem], jx["reached"][dem])
    # each demoted voxel is written once (a demoted voxel leaves the band)
    changed = jx["grid"] != jx["vals"]
    assert int(model["n_writes"]) == int(changed.sum())


def test_redo_counts():
    """The chain floods every query after the first again; the disjoint
    pockets none; the random fields and the scene some, beside failures
    and connections."""
    chain, disjoint, scene = (_run(n)[0] for n in ("chain", "disjoint", "adversarial scene"))
    assert chain["redo"] == chain["valid"] - 1 == 6
    assert int(chain["demoted"].sum()) == 7 and int(chain["n_writes"]) == 27
    assert disjoint["redo"] == 0 and int(disjoint["demoted"].sum()) == 4
    assert scene["redo"] == 1 and int(scene["demoted"].sum()) == 2
    for name in ("random S16", "random S32", "random S40", "max_iters 1", "max_iters 8"):
        m = _run(name)[0]
        assert m["redo"] > 0 and bool(m["demoted"].any()) and bool(m["conn"].any()), name
    for name in ("query overflow", "no valid query"):
        m = _run(name)[0]
        assert m["redo"] == 0 and int(m["n_writes"]) == 0 and not bool(m["conn"].any())


def test_scene_against_classify_and_oracle():
    """The scene's model grid is the JAX sequential classify's and the
    oracle's: A fails and demotes every carved cell, B (flooded again from
    a demoted start) fails too."""
    model = _run("adversarial scene")[0]
    cfg = dataclasses.replace(scene_config(), sequential_explore=True)
    dyn = scene_dyn()
    vals, far, labels, members, sensor_pos = build_scene(cfg, dyn)
    _, jgrid = tpu_classify(cfg, dyn, vals, far, labels, sensor_pos)
    _, _, vmap_oracle = oracle_classify(cfg, dyn, vals, members, sensor_pos)
    grid = model["grid"].numpy()
    assert np.array_equal(grid, jgrid) and np.array_equal(grid, vmap_oracle)
    bx, by, bz = BASE
    assert all(grid[bz, by + y, bx + x] == np.float32(dyn.thr_frontiers) for x, y in CARVED)
    assert not bool(model["conn"].any()) and A_REL != B_REL
