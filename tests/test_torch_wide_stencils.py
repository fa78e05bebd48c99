"""The stencil kernels past halo 7, as their wide forms run them, on the CPU.

A tap set that reaches past halo 7 does not fit one run table (K1, K14,
K11's demotion, K13c: csrc/ball_pool.cuh) nor K2's taps by value
(csrc/propagate.cu).  On the card:

* K1's wide form cuts the set into pieces within halo 7 on every axis
  (``ops.morphology.WideTable``), runs the unchanged run-table body once a
  piece with its staging shifted by the piece's centre, and folds the
  pieces' pools with the pool's op; ``ball_pool_runs_plain`` models it;
* K2's wide form walks the taps in bands of dz x dy values staged from
  global memory (``kernels.sweep_plan``); ``sweeps_tiled_plain`` and
  ``sweeps_batch_plain`` model it (``ops.components.bands_pool_plain``,
  which reads each band's taps back from the plan's offsets as the kernel
  does).

One rule (``ops.morphology.is_wide``) sends a set to the wide forms of
both: a halo past 7, or more taps than K2's narrow form passes by value.

Held here, on seeded numpy grids and bit for bit (integer pools and
sweeps are exact in any order; the tolerance is zero):

* the pieces cover every tap of the set once, each piece within halo 7;
* K1's model against vofod_tpu ``ball_pool_{min,max,sum}`` at radius 8, 12
  and 16 (int8 and int32, grids thinner than the ball) and on traced
  shells (against the static ball they equal), and on the hasCloseTo box
  past halo 7 and a gapped set against the port's one-slice-a-tap pool;
* K2's model against vofod_tpu ``label_components_seeded`` at radius 8
  and 12 over 2 sweeps (its compile takes 2-5 s a radius, 8-20 s at 4
  sweeps) and ``propagate_reach`` at 8, 12 and 16 over 3, and the sharded
  launch's model on a halo'd slab; a plan with a wrong offset fails it;
* K11's demotion and K13c at the local-sure radius of 0.125 m voxels (r 8)
  inside the port's sepclusters stages against vofod_tpu's;
* K7 at the explore submap of 0.125 m voxels (S = 64: a row's 64 bits) and
  K8's write-back there, against vofod_tpu's explore and demotion;
* the kernels' wrappers take halo 8, 12 and 16 (no cap below the grid).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tests.test_torch_explore import _both, _assert_same, _field, _pack, _writes, FRONT
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import DynParams as JDyn, VoFODConfig as JConfig
from vofod_tpu.ops import components as jc
from vofod_tpu.ops import morphology as jm
from vofod_tpu.ops.explore import apply_demotions as j_apply
from vofod_tpu.pipeline import sepclusters as js
from vofod_tpu_torch import kernels
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.ops import components as tc
from vofod_tpu_torch.ops import morphology as tm
from vofod_tpu_torch.ops.explore import demote_floating_plain
from vofod_tpu_torch.pipeline import sepclusters as ts

I8, I32 = torch.int8, torch.int32
TILE8, TILE32 = kernels.BALL_POOL_TILE[I8], kernels.BALL_POOL_TILE[I32]
_JAX_COMBINE = {"min": jnp.minimum, "max": jnp.maximum, "sum": lax.add}


def _gapped(h: int, n: int, seed: int) -> np.ndarray:
    """n distinct taps drawn from the (2h + 1)^3 box: rows with gaps."""
    rng = np.random.default_rng(seed)
    r = np.arange(-h, h + 1)
    box = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3).astype(np.int32)
    return box[rng.permutation(len(box))[:n]]


def _grid(dtype, shape, seed, lo, hi):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(
        np.int8 if dtype == I8 else np.int32))


WIDE_SETS = ([pytest.param(r, id=f"ball-r{r}") for r in (8.0, 12.0, 16.0)]
             + [pytest.param(tm.hascloseto_taps(8.5), id="hascloseto-r8.5"),
                pytest.param(tm.Shells(12.0, 100.0), id="shells-b12-r2_100"),
                pytest.param(_gapped(9, 1500, 1), id="gapped-h9")])


@pytest.mark.parametrize("ball", WIDE_SETS)
def test_wide_table_pieces_cover_the_taps_once(ball):
    taps, halo = tm.tap_set(ball)
    table = tm.run_table(ball)
    assert table.wide and table.halo == halo > kernels.TABLE_HALO
    assert table.n_pieces == len(table.lens) == len(table.shifts) >= 2
    assert sum(table.lens) == len(table.blob)
    got = []
    for shift, piece in zip(table.shifts, table.pieces):
        assert not piece.wide and piece.halo <= kernels.TABLE_HALO
        group = kernels.BALL_RUN_GROUP
        for g in range(piece.n_groups):
            for first, end, kmask in piece.slices[piece.gslice[g]:piece.gslice[g + 1]].tolist():
                for k in range(2 * piece.halo + 1):
                    if kmask >> k & 1:
                        for dy, run in piece.rows[first:end].tolist():
                            lo, hi = piece.runs[g * group + run].tolist()
                            got += [(piece.halo - k + shift[0], dy + shift[1], dx + shift[2])
                                    for dx in range(lo, hi + 1)]
    assert sorted(got) == sorted(map(tuple, taps.tolist()))  # every tap, none twice


# (id, radius, dtype, op, fill, shape, zchunk): 0.125 m voxels' radii; the
# (9, ...) grids are thinner than the r 12 and r 16 balls
JAX_POOLS = [
    ("r8-int32-sum", 8.0, I32, "sum", 0, (12, 21, 40), 5),
    ("r8-int8-max", 8.0, I8, "max", 0, (10, 20, 70), 4),
    ("r12-int8-max-thin", 12.0, I8, "max", 0, (9, 27, 70), 3),
    ("r12-int32-min", 12.0, I32, "min", 2**31 - 1, (14, 20, 40), 14),
    ("r16-int32-min-thin", 16.0, I32, "min", 2**31 - 1, (9, 22, 36), 4),
    ("r16-int8-max", 16.0, I8, "max", -128, (12, 19, 66), 7),
]


@pytest.mark.parametrize("radius,dtype,op,fill,shape,zchunk",
                         [pytest.param(*c[1:], id=c[0]) for c in JAX_POOLS])
def test_wide_pool_model_bit_equal_to_jax(radius, dtype, op, fill, shape, zchunk):
    a = _grid(dtype, shape, seed=int(radius) + shape[0], lo=-100 if dtype == I8 else 0,
              hi=100 if dtype == I8 else 2**20)
    if op == "sum":
        a = (a > 2**19).to(I32)  # the local sure count's 0/1 input
    want = np.asarray(jm._ball_pool(jnp.asarray(a.numpy()), radius, _JAX_COMBINE[op], fill))
    tile = TILE8 if dtype == I8 else TILE32
    got = tm.ball_pool_runs_plain(a, tm.run_table(radius), op, fill, tile, zchunk)
    assert np.array_equal(got.numpy(), want)
    # the CPU path of the step (the JAX decomposition) agrees
    assert torch.equal(tm.ball_pool(a, radius, op, fill), got)


def test_wide_pool_model_traced_shells_and_hascloseto():
    """K14's shells of a 12-voxel bound kept at r² 81 are the static r 9
    ball, which vofod_tpu pools; the hasCloseTo box past halo 7 (5,832
    taps, one shift a tap in both packages) against the port's plain
    version of its tap set."""
    a = _grid(I32, (11, 20, 36), seed=3, lo=0, hi=2)
    shells = tm.Shells(12.0, 81.0)
    assert sorted(map(tuple, shells.taps.tolist())) == sorted(map(tuple, tm.ball_taps(9.0).tolist()))
    want = jm.ball_pool_sum(jnp.asarray(a.numpy()), 9.0)
    got = tm.ball_pool_runs_plain(a, tm.run_table(shells), "sum", 0, TILE32, 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    mask = torch.from_numpy(np.random.default_rng(9).random((12, 22, 40)) < 0.01).to(I8)
    taps = tm.hascloseto_taps(8.5)
    got = tm.ball_pool_runs_plain(mask, tm.run_table(taps), "max", 0, TILE8, 5)
    assert torch.equal(got, tm.tap_pool_plain(mask, taps, "max", 0)) and bool(got.any())


def test_wide_pool_model_gapped_set():
    taps = _gapped(9, 1500, 1)
    a = _grid(I32, (10, 21, 37), seed=4, lo=-2**31, hi=2**31 - 1)
    got = tm.ball_pool_runs_plain(a, tm.run_table(taps), "max", -7, TILE32, 3)
    assert torch.equal(got, tm.tap_pool_plain(a, taps, "max", -7))


def _model_sweep(init, occ, ball, n, until_fixpoint=False):
    """ops.components.sweeps through the wide form's schedule model."""
    out, flags, _ = tc.sweeps_tiled_plain(init, occ, ball, n)
    return out, flags


@functools.lru_cache(maxsize=None)
def _jax_labels(radius, n):
    rng = np.random.default_rng(int(radius))
    occ = rng.random((10, 24, 40)) < 0.04
    seed = occ & (rng.random(occ.shape) < 0.2)
    fn = jax.jit(lambda o, s: jc.label_components_seeded(o, s, radius, n))
    return occ, seed, [np.asarray(x) for x in fn(jnp.asarray(occ), jnp.asarray(seed))]


@pytest.mark.parametrize("radius", [8.0, 12.0])
def test_wide_sweeps_model_bit_equal_to_jax_labels(radius):
    n = 2
    occ, seed, want = _jax_labels(radius, n)
    got = tc.label_components_seeded(torch.from_numpy(occ), torch.from_numpy(seed), radius, n,
                                     sweep_fn=_model_sweep)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert tm.is_wide(*tm.tap_set(radius))


@pytest.mark.parametrize("radius", [8.0, 12.0, 16.0])
def test_wide_sweeps_model_bit_equal_to_jax_reach(radius):
    rng = np.random.default_rng(40 + int(radius))
    occ = rng.random((9, 26, 44)) < 0.03
    seed = occ & (rng.random(occ.shape) < 0.1)
    want = jax.jit(lambda o, s: jc.propagate_reach(o, s, radius, 3))(jnp.asarray(occ),
                                                                    jnp.asarray(seed))
    got = tc.propagate_reach(torch.from_numpy(occ), torch.from_numpy(seed), radius, 3,
                             sweep_fn=_model_sweep)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_wide_sweeps_model_decodes_the_plan():
    """The model reads each band's taps from the plan's offsets: one offset
    moved by a column pools another tap, one moved past its box raises."""
    taps, halo = tm.tap_set(8.0)
    plan = kernels.sweep_plan(taps, halo, 4)
    rng = np.random.default_rng(6)
    occ = torch.from_numpy(rng.random((9, 20, 36)) < 0.05)
    flat = torch.arange(occ.numel(), dtype=I32).reshape(occ.shape)
    keys = torch.where(occ, flat, tc.SENTINEL)
    assert torch.equal(tc.bands_pool_plain(keys, plan, "min", tc.SENTINEL),
                       tm.pool_plain(keys, 8.0, "min", tc.SENTINEL))
    sx = 32 + 2 * halo
    t = int(np.flatnonzero((plan.taps[:, 0] == 0) & (plan.taps[:, 1] == 0)
                           & (plan.taps[:, 2] == halo))[0])  # the row's last tap
    assert plan.offsets[t] % sx == 2 * halo  # the box row's last column
    for delta, ok in ((-1, True), (1, False)):
        bad = copy.copy(plan)
        bad.offsets = plan.offsets.copy()
        bad.offsets[t] += delta  # onto its neighbour's column, then past the row
        if ok:
            got = tc.bands_pool_plain(keys, bad, "min", tc.SENTINEL)
            assert not torch.equal(got, tm.pool_plain(keys, 8.0, "min", tc.SENTINEL))
        else:
            with pytest.raises(ValueError, match="past its box"):
                tc.bands_pool_plain(keys, bad, "min", tc.SENTINEL)


def test_one_wideness_rule():
    """A set takes the same form in K1 (its table) and K2: wide past halo
    7 even where its taps reach 7, and past 2,112 taps within halo 7 (the
    15^3 box: one piece); the pieces' pool equals the one-slice-a-tap
    pool."""
    ball7 = tm.ball_taps(7.5)
    assert int(np.abs(ball7).max()) == 7
    assert not tm.is_wide(ball7, 7) and not tm.run_table(ball7, 7).wide
    assert tm.is_wide(ball7, 8) and tm.run_table(ball7, 8).wide
    r = np.arange(-7, 8)
    box = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3).astype(np.int32)
    table = tm.run_table(box)
    assert len(box) > kernels.TAP_STRUCT and tm.is_wide(box, 7)
    assert table.wide and table.n_pieces == 1
    a = _grid(I8, (9, 18, 40), seed=8, lo=-100, hi=100)
    got = tm.ball_pool_runs_plain(a, table, "max", 0, TILE8, 3)
    assert torch.equal(got, tm.tap_pool_plain(a, box, "max", 0))


def test_pool_combines_ignore_the_cut():
    """The bound's count of combines a voxel: a narrow table of one group
    counts it the same; the wide ball's cut takes several times more."""
    for ball in (3.0, 5.0, 7.99, tm.hascloseto_taps(3.0)):
        table = tm.run_table(ball)
        assert table.n_groups == 1
        assert tm.pool_combines(tm.tap_set(ball)[0]) == table.combines()
    # r 12: the chain to 12 (24), 210 slice rows (dz and -dz shared), 25
    # accumulators
    assert tm.pool_combines(tm.ball_taps(12.0)) == 24 + 210 + 25
    assert tm.run_table(12.0).combines() > 5 * tm.pool_combines(tm.ball_taps(12.0))


def test_wide_sweeps_batch_model_on_a_slab():
    """The sharded launch's model (a halo'd slab, rows losing ``grow`` a
    sweep) on the wide form: its interior equals the dense sweeps'."""
    rng = np.random.default_rng(5)
    occ = torch.from_numpy(rng.random((8, 20, 36)) < 0.05)
    flat = torch.arange(occ.numel(), dtype=torch.int32).reshape(occ.shape)
    keys = torch.where(occ, flat, tc.SENTINEL)
    want, wflags = tc.sweeps_plain(keys, occ, 8.0, 2)
    halo = 2 * 8
    ext = torch.nn.functional.pad(keys, (0, 0, 0, 0, halo, halo), value=tc.SENTINEL)
    occ_ext = torch.nn.functional.pad(occ, (0, 0, 0, 0, halo, halo))
    b0, b1 = ext.clone(), torch.full_like(ext, tc.SENTINEL)
    changed, tiles = torch.zeros(2, dtype=I32), torch.zeros(2, dtype=I32)
    tc.sweeps_batch_plain(b0, b1, occ_ext, 8.0, changed, tiles, 0, 2, grow=8,
                          rows=(halo, halo + 8))
    assert torch.equal(b0[halo:halo + 8], want)
    assert torch.equal(changed.bool(), wflags)


# ---- K11's demotion and K13c at the local-sure radius of 0.125 m voxels ----

SHAPE = (20, 22, 26)


def _scene(seed):
    """Air, a sure slab in one corner and unsafe background specks beyond
    every radius here."""
    rng = np.random.default_rng(seed)
    vals = np.full(SHAPE, -900.0, np.float32)
    vals[:2, :6, :6] = 0.5
    far = vals[12:, 14:, 17:]
    far[rng.random(far.shape) < 0.1] = -200.0
    return vals


@pytest.mark.parametrize("zchunk", [3, 20])
def test_wide_demotion_in_the_stage_bit_equal_to_jax(zchunk, monkeypatch):
    """max_bg_distance 1.0 m at 0.125 m voxels: the demotion ball is r 8
    (2,109 taps, halo 8), the local sure count r 9."""
    kw = dict(voxel_size=0.125, sepclusters_max_bg_distance=1.0)
    vals = _scene(7)
    prev_safe = np.zeros(SHAPE, bool)
    jo = js.run_sepclusters(JConfig(**kw), JDyn().as_arrays(), jnp.asarray(vals),
                            jnp.asarray(prev_safe), jnp.float32(2.0), prev_sure=jnp.bool_(False))
    calls = []

    def model(v, b, s, sure, ball, w1, c):
        got = ts.demote_ema_runs_plain(v, b, s, sure, ball, w1, c, zchunk)
        assert torch.equal(got, ts.demote_ema_plain(v, b, s, sure, ball, w1, c))
        calls.append(tm.run_table(ball).wide)
        return got

    monkeypatch.setattr(ts, "demote_ema", model)
    out = ts.run_sepclusters(VoFODConfig(**kw), DynParams(), torch.from_numpy(vals),
                             torch.from_numpy(prev_safe), 2.0, torch.tensor(False))
    assert calls == [True]
    np.testing.assert_array_equal(out.grid.numpy(), np.asarray(jo.grid))
    np.testing.assert_array_equal(out.safe.numpy(), np.asarray(jo.safe))
    assert bool(out.sure_bg_sufficient) and (np.asarray(jo.grid) != vals).any()


@pytest.mark.parametrize("lsz,zchunk", [(1, 4), (2, 20)])
def test_wide_exact_demotion_bit_equal_to_plain(lsz, zchunk):
    """K13c's model at r 8 (the ball past halo 7) against its plain version
    on random coarse cells, leaf sizes 1 and 2."""
    rng = np.random.default_rng(lsz)
    vals = torch.from_numpy(rng.uniform(-1000.0, 0.0, SHAPE).astype(np.float32))
    cshape = tuple(-(-n // lsz) for n in SHAPE)
    occ_c = torch.from_numpy(rng.random(cshape) < 0.05)
    census = torch.from_numpy(rng.integers(0, 10, cshape).astype(np.int32))
    args = (vals, occ_c, census, torch.tensor([True, True]), torch.tensor(False), lsz, 8.0,
            5.0, 0.9, -500.0, -300.0)
    got = ts.exact_demote_runs_plain(*args, None, zchunk)
    want = ts.exact_demote_ema_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[0] != vals).any())


def test_wide_exact_demotion_in_the_stage_bit_equal_to_jax(monkeypatch):
    """The exact census at 0.125 m voxels with max_bg_distance 1.0 m (leaf
    7, the demotion ball r 8) in the port's stage on K13c's model against
    vofod_tpu's."""
    kw = dict(voxel_size=0.125, sepclusters_exact_census=True, sepclusters_max_bg_distance=1.0)
    shape = (36, 22, 26)  # coarse rows 3-5 lie past the sure slab's cluster
    vals = np.full(shape, -740.0, np.float32)
    vals[0:2, 1:6, 1:7] = 0.0
    rng = np.random.default_rng(3)
    vals[22:][rng.random((shape[0] - 22,) + shape[1:]) < 0.01] = -200.0
    jo = js.run_sepclusters_exact(JConfig(**kw), JDyn().as_arrays(), jnp.asarray(vals),
                                  jnp.zeros(shape, bool), jnp.float32(2.0),
                                  prev_sure=jnp.bool_(False))
    calls = []
    real = ts.exact_demote_ema

    def model(*args, **kwargs):
        calls.append(tm.run_table(args[6]).wide)
        got = ts.exact_demote_runs_plain(*args, 5)
        for g, w in zip(got, real(*args)):
            assert torch.equal(g, w)
        return got

    monkeypatch.setattr(ts, "exact_demote_ema", model)
    out = ts.run_sepclusters_exact(VoFODConfig(**kw), DynParams(), torch.from_numpy(vals), 2.0,
                                   torch.tensor(False))
    assert calls == [True]
    np.testing.assert_array_equal(out.grid.numpy(), np.asarray(jo.grid))
    np.testing.assert_array_equal(out.safe.numpy(), np.asarray(jo.safe))
    assert (np.asarray(jo.grid) != vals).any()


# ---- K7 / K8 at S = 64 ----

@pytest.mark.parametrize("S,shape,seed", [(64, (40, 44, 70), 0), (63, (20, 70, 66), 1)])
def test_explore_submap_64_matches_jax(S, shape, seed):
    """The explore submap of 0.125 m voxels (2 x 24 + 1 <= S = 64): rows of
    all 64 bits, queries at the grid's x edges."""
    vals = _field(shape, seed, p=(0.45, 0.47, 0.08))
    rng = np.random.default_rng(100 + seed)
    Q = 6
    qx, qy, qz = (rng.integers(0, n, Q) for n in shape[::-1])
    qx[:2] = [0, shape[2] - 1]
    qvalid = rng.random(Q) < 0.8
    bounds = rng.integers(0, S, Q)
    j, t = _both(vals, qx, qy, qz, qvalid, bounds, S)
    _assert_same(j, t, qvalid)


def test_demotion_write_back_submap_64_matches_jax():
    """K8's plain version at S = 64 (a row mask of all 64 bits) against JAX."""
    shape, S, K = (30, 40, 70), 64, 3
    vals = _field(shape, 11, p=(0.3, 0.68, 0.02))
    Q = 4
    qx, qy, qz = np.array([32, 3, 60, 40]), np.array([20, 5, 30, 22]), np.array([15, 2, 20, 16])
    qvalid = np.ones(Q, bool)
    bounds = np.array([24, 10, 20, 5])
    j, _ = _both(vals, qx, qy, qz, qvalid, bounds, S)
    connected, reached, corners = j
    qslot = np.zeros((Q, K), bool)
    qslot[np.arange(Q), np.arange(Q) % K] = True
    qgate = np.ones(K, bool)
    cc = np.any(qslot & connected[:, None], axis=0)
    demote = qvalid & np.any(qslot & (qgate & ~cc)[None, :], axis=1)
    want = np.asarray(j_apply(jnp.asarray(vals), jnp.asarray(reached), jnp.asarray(corners),
                              jnp.asarray(demote), jnp.float32(FRONT)))
    got, n, conn = demote_floating_plain(
        torch.from_numpy(vals), torch.from_numpy(_pack(reached)), torch.from_numpy(corners),
        torch.from_numpy(qslot), torch.from_numpy(connected), torch.from_numpy(qvalid),
        torch.from_numpy(qgate), torch.tensor(False), FRONT)
    assert np.array_equal(got.numpy(), want)
    assert int(n) == _writes(reached, corners, demote, shape)
    assert np.array_equal(conn.numpy(), cc)


# ---- the wrappers take any radius ----

@pytest.mark.parametrize("radius", [8.0, 12.0, 16.0])
def test_wrappers_take_any_halo(radius):
    taps, halo = tm.tap_set(radius)
    assert halo == int(radius) and kernels._taps_arg(taps, halo)[0].shape == taps.shape
    assert tm.run_table(radius).wide and tm.is_wide(taps, halo)
    for itemsize in (1, 4):
        plan = kernels.sweep_plan(taps, halo, itemsize)
        assert sorted(map(tuple, plan.taps.tolist())) == sorted(map(tuple, taps.tolist()))
        box = (32 + 2 * halo) * (8 + plan.by - 1) * (4 + plan.bz - 1) * itemsize
        assert -(-box // 16) * 16 + 4 * plan.max_taps <= kernels.K2_WIDE_SMEM
