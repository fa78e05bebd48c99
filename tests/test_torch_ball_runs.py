"""K1's run table and the plain model of the kernel's schedule, on the CPU.

On the card K1 (and K14, and the hasCloseTo box) pools each staged input
row once per distinct x-run ``(lo, hi)`` of the tap set and combines one
run pool per (dz, dy) row into the accumulator of the output plane the row
feeds, streaming column tiles along chunks of z (csrc/ball_pool.cu).  Here
the run table (``ops.morphology.run_table``) is held to cover its tap set
exactly once, and the schedule's plain model (``ball_pool_runs_plain``,
given the kernel's tiles and z chunks or others) bit-equal to
``tap_pool_plain`` and to the JAX package's pools on the same seeded numpy
grids.  Integer pools are exact: the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.ops import morphology as jm
from vofod_tpu_torch import kernels
from vofod_tpu_torch.ops import morphology as tm

I8, I32 = torch.int8, torch.int32
TILE8, TILE32 = kernels.BALL_POOL_TILE[I8], kernels.BALL_POOL_TILE[I32]


def _gapped(h: int, n: int, seed: int) -> np.ndarray:
    """n distinct taps drawn from the (2h + 1)^3 box: rows with gaps."""
    rng = np.random.default_rng(seed)
    box = np.array([(z, y, x) for z in range(-h, h + 1) for y in range(-h, h + 1)
                    for x in range(-h, h + 1)], np.int32)
    return box[rng.permutation(len(box))[:n]]


def _sorted(taps) -> list:
    return sorted(map(tuple, np.asarray(taps).reshape(-1, 3).tolist()))


def _covered_taps(table) -> np.ndarray:
    """The taps a run table's slices cover, one per (accumulator, row, dx)."""
    out, group = [], kernels.BALL_RUN_GROUP
    for g in range(table.n_groups):
        for first, end, kmask in table.slices[table.gslice[g]:table.gslice[g + 1]].tolist():
            for k in range(15):
                if kmask >> k & 1:
                    for dy, run in table.rows[first:end].tolist():
                        lo, hi = table.runs[g * group + run].tolist()
                        out += [(table.halo - k, dy, dx) for dx in range(lo, hi + 1)]
    return np.asarray(out, np.int32).reshape(-1, 3)


BALLS = [1.0, 1.6, 2.0, 3.0, 3.9, 4.0, 5.0, 7.99]
SHELLS = [(2.0, 1.0), (2.0, 2.0), (2.0, 4.0), (4.0, 2.5600002), (4.0, 9.0), (4.0, 16.0)]
GAPPED = [(2, 20, 1), (3, 100, 2), (5, 400, 3), (7, 2112, 4)]
TAP_SETS = ([pytest.param(r, id=f"ball-r{r}") for r in BALLS]
            + [pytest.param(tm.hascloseto_taps(r), id=f"hascloseto-r{r}") for r in (1.5, 3.0)]
            + [pytest.param(tm.Shells(b, r2), id=f"shells-b{b}-r2_{r2:g}") for b, r2 in SHELLS]
            + [pytest.param(_gapped(*g), id=f"gapped-h{g[0]}-{g[1]}") for g in GAPPED])


@pytest.mark.parametrize("ball", TAP_SETS)
def test_run_table_covers_the_taps_once(ball):
    taps, halo = tm.tap_set(ball)
    table = tm.run_table(ball)
    assert table.halo == halo
    assert _sorted(_covered_taps(table)) == _sorted(taps)  # every tap, none twice
    group = kernels.BALL_RUN_GROUP
    runs = table.runs.tolist()
    assert len({(lo, hi) for lo, hi in runs}) == len(runs)  # each pair pooled once
    assert all(-halo <= lo <= hi <= halo for lo, hi in runs)
    for g in range(table.n_groups):
        pairs = runs[g * group:(g + 1) * group]
        # the chain pools every symmetric pair of the group, and only those
        assert sorted((w, i) for w, i in enumerate(table.sym[g].tolist()) if i >= 0) == sorted(
            (hi, i) for i, (lo, hi) in enumerate(pairs) if lo == -hi)
        slices = table.slices[table.gslice[g]:table.gslice[g + 1]].tolist()
        seen = 0
        for first, end, kmask in slices:
            assert 0 < kmask < 1 << (2 * halo + 1) and not seen & kmask  # one slice a dz
            seen |= kmask
            rows = table.rows[first:end]
            assert (np.abs(rows[:, 0]) <= halo).all() and (rows[:, 1] < len(pairs)).all()
        keys = [tuple(map(tuple, table.rows[f:e].tolist())) for f, e, _ in slices]
        assert len(set(keys)) == len(keys)  # equal slices are kept once
    if not isinstance(ball, np.ndarray) or len(taps) in (len(tm.hascloseto_taps(1.5)),
                                                        len(tm.hascloseto_taps(3.0))):
        # balls, shells and the box: one run per (dz, dy) row
        assert len(tm.x_runs(taps)) == len({(dz, dy) for dz, dy, _ in taps.tolist()})


def test_run_table_shapes():
    """Radius 3: 4 nested symmetric pairs on one chain (6 combines), 4
    slices of 18 rows for 7 planes (the ball's dz and -dz slices are equal:
    29 rows, 123 taps); the hasCloseTo box's full rows miss their +3 end, so
    its dz = -3 slice has no +3 twin; a gapped row gets several runs; the pairs
    beyond 8 take a second group; a ball past halo 7 takes pieces."""
    r3 = tm.run_table(3.0)
    assert r3.runs.tolist() == [[0, 0], [-1, 1], [-2, 2], [-3, 3]]
    assert r3.sym[0, :4].tolist() == [0, 1, 2, 3] and len(r3.slices) == 4
    assert len(r3.rows) == 18 and r3.combines() == 6 + 18 + 7
    assert len(tm.x_runs(tm.ball_taps(3.0))) == 29
    box = tm.run_table(tm.hascloseto_taps(3.0))
    assert [-3, 2] in box.runs.tolist() and [-3, 3] not in box.runs.tolist()
    assert sorted(box.slices[:, 2].tolist()) == [8, 20, 34, 64]  # dz 0, +-1, +-2, -3 alone
    gap = tm.run_table(np.array([(0, 0, -3), (0, 0, -2), (0, 0, 1), (0, 0, 3)], np.int32))
    assert sorted(map(tuple, gap.runs.tolist())) == [(-3, -2), (1, 1), (3, 3)]
    assert len(gap.rows) == 3 and (gap.sym < 0).all()
    assert tm.run_table(_gapped(3, 100, 2)).n_groups > 1
    with pytest.raises(ValueError, match="repeat"):
        tm.run_table(np.array([(0, 0, 0), (0, 0, 0)], np.int32))
    # past halo 7 the table is the wide form's pieces, each within halo 7
    for r, pieces in ((8.0, 12), (12.0, 12), (16.0, 27)):
        wide = tm.run_table(r)
        assert wide.wide and wide.halo == int(r) and wide.n_pieces == pieces
        assert max(p.halo for p in wide.pieces) <= 7


@pytest.mark.parametrize("tile,zchunk", [
    (TILE8, 1), (TILE8, 2), (TILE8, 5), (TILE32, 3), (TILE32, 7), ((4, 8), 13)])
def test_schedule_model_any_tile_and_chunk(tile, zchunk):
    """The card picks the z chunk from its occupancy at each launch
    (csrc/ball_pool.cu auto_zchunk): every chunk length, from one plane to
    the whole grid, and every tile gives the same pool."""
    a = _grid(I32, (13, 19, 37), seed=zchunk, lo=-50, hi=50)
    want = tm.tap_pool_plain(a, tm.ball_taps(3.0), "min", 9)
    got = tm.ball_pool_runs_plain(a, tm.run_table(3.0), "min", 9, tile, zchunk)
    assert torch.equal(got, want)


def _grid(dtype, shape, seed, lo, hi):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(
        np.int8 if dtype == I8 else np.int32))


# (id, dtype, op, fill, value range, shape, ball, tile, zchunk)
MODEL_CASES = [
    ("int8-max-fill0-over-negatives", I8, "max", 0, (-128, 0), (9, 21, 70), 3.0, TILE8, 4),
    ("int8-min-fill5", I8, "min", 5, (0, 128), (7, 19, 40), 2.0, TILE8, 3),
    ("int8-max-identity-fill", I8, "max", -128, (-128, 128), (6, 17, 66), 1.6, TILE8, 12),
    ("int8-min-r1", I8, "min", 127, (-128, 128), (5, 9, 11), 1.0, (4, 8), 2),
    ("int32-min-fill5", I32, "min", 5, (0, 2**31 - 1), (11, 18, 37), 3.0, TILE32, 5),
    ("int32-max-fill0-over-negatives", I32, "max", 0, (-2**31, 0), (8, 20, 35), 2.0, TILE32, 3),
    ("int32-sum-wraps", I32, "sum", 0, (2**30, 2**30 + 2**20), (7, 18, 34), 3.0, TILE32, 4),
    ("int32-sum-fill7", I32, "sum", 7, (0, 2), (6, 17, 33), 3.0, TILE32, 12),
    ("nz3-below-2h+1", I32, "sum", 0, (0, 100), (3, 20, 33), 3.0, TILE32, 12),
    ("nz1", I8, "max", 0, (-5, 5), (1, 18, 70), 3.0, TILE8, 12),
    ("23-plane-slab", I32, "sum", 0, (0, 2), (23, 19, 40), 3.0, TILE32, 12),
    ("23-plane-slab-int8", I8, "max", 0, (-3, 2), (23, 17, 66), 3.0, TILE8, 12),
    ("small-tiles-chunks", I32, "min", 2**31 - 1, (0, 1000), (10, 13, 21), 3.0, (4, 8), 2),
    ("hascloseto-box", I8, "max", 0, (0, 2), (8, 19, 40), tm.hascloseto_taps(3.0), TILE8, 3),
    ("shells-b4-r2_9", I32, "sum", 0, (0, 2), (9, 18, 35), tm.Shells(4.0, 9.0), TILE32, 4),
    ("gapped-h3-two-groups", I32, "sum", 3, (2**30, 2**31 - 1), (8, 18, 36), _gapped(3, 100, 2),
     TILE32, 5),
    ("gapped-h3-int8", I8, "min", 5, (0, 128), (7, 17, 67), _gapped(3, 60, 5), TILE8, 3),
    ("gapped-h5", I32, "max", -7, (-2**31, 2**31 - 1), (6, 12, 19), _gapped(5, 300, 6), (4, 8),
     20),
]


@pytest.mark.parametrize("dtype,op,fill,vals,shape,ball,tile,zchunk",
                         [pytest.param(*c[1:], id=c[0]) for c in MODEL_CASES])
def test_schedule_model_bit_equal_to_tap_pool(dtype, op, fill, vals, shape, ball, tile, zchunk):
    a = _grid(dtype, shape, seed=len(shape) + shape[2], lo=vals[0], hi=vals[1])
    taps, _ = tm.tap_set(ball)
    got = tm.ball_pool_runs_plain(a, tm.run_table(ball), op, fill, tile, zchunk)
    want = tm.tap_pool_plain(a, taps, op, fill)
    assert got.dtype == want.dtype and torch.equal(got, want)


_JAX_COMBINE = {"min": jnp.minimum, "max": jnp.maximum, "sum": lax.add}


@pytest.mark.parametrize("radius,op,fill,dtype", [
    (1.6, "max", 0, I8), (3.0, "max", 0, I8), (3.0, "min", 5, I8),
    (3.0, "sum", 0, I32), (2.0, "min", 2**31 - 1, I32)])
def test_schedule_model_bit_equal_to_jax_ball_pool(radius, op, fill, dtype):
    a = _grid(dtype, (9, 19, 37), seed=int(radius * 10), lo=-100 if dtype == I8 else 0,
              hi=100)
    want = np.asarray(jm._ball_pool(jnp.asarray(a.numpy()), radius, _JAX_COMBINE[op], fill))
    tile = TILE8 if dtype == I8 else TILE32
    got = tm.ball_pool_runs_plain(a, tm.run_table(radius), op, fill, tile, 4)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bound,r2,op", [(2.0, 2.0, "sum"), (2.0, 1.0, "max")])
def test_schedule_model_bit_equal_to_jax_traced(bound, r2, op):
    a = _grid(I32 if op == "sum" else I8, (8, 17, 35), seed=3, lo=0, hi=2)
    if op == "sum":
        want = jm.ball_pool_sum_traced(jnp.asarray(a.numpy()), jnp.float32(r2), bound)
    else:
        want = jm.ball_pool_max_traced(jnp.asarray(a.numpy()), jnp.float32(r2), bound, fill=0)
    tile = TILE32 if op == "sum" else TILE8
    got = tm.ball_pool_runs_plain(a, tm.run_table(tm.Shells(bound, r2)), op, 0, tile, 3)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("radius", [1.5, 2.0])
def test_schedule_model_bit_equal_to_jax_hascloseto(radius):
    mask = np.random.default_rng(9).random((9, 18, 36)) < 0.05
    want = np.asarray(jm.hascloseto_pool_any(jnp.asarray(mask), radius))
    got = tm.ball_pool_runs_plain(torch.from_numpy(mask.astype(np.int8)),
                                  tm.run_table(tm.hascloseto_taps(radius)), "max", 0, TILE8, 4) > 0
    assert np.array_equal(got.numpy(), want)
