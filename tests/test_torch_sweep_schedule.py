"""The persistent K2 launch's schedule, modelled on the CPU.

On the card every sweep of one ``ops/components.sweeps`` call runs in one
cooperative launch that recomputes, after sweep 0, only the tiles within
the ball's reach of a tile that changed in the sweep before, and stops at
the first sweep that changed nothing.  ``sweeps_tiled_plain`` is the plain
model of that schedule: here it is held bit-equal (grid and per-sweep
flags) to ``sweeps_plain``, its tiles computed per sweep to a count taken
independently from the full sequence of sweeps, and, through the label
functions, to the JAX package (labels, reach, ``converged``, ``iters``).
Small seeded grids whose sizes are not multiples of the tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.ops import components as jc
from vofod_tpu_torch.ops import components as tc
from vofod_tpu_torch.ops.morphology import Shells, tap_set

SHAPE = (11, 29, 70)  # 3 x 4 x 3 tiles of 4 x 8 x 32, none of them whole on every axis
SHELLS = Shells(3.0, 5.0)  # a K14 tap set: the shells of bound 3 kept at r^2 <= 5


def _scene(seed: int, shape=SHAPE) -> np.ndarray:
    """A few blobs and rods in an empty grid, so that most tiles settle."""
    rng = np.random.default_rng(seed)
    occ = np.zeros(shape, bool)
    nz, ny, nx = shape
    for _ in range(4):
        z, y, x = (int(rng.integers(0, s)) for s in shape)
        occ[z:z + 2, y:y + 3, x:x + 4] = rng.random((len(range(z, min(z + 2, nz))),
                                                    len(range(y, min(y + 3, ny))),
                                                    len(range(x, min(x + 4, nx))))) < 0.7
    occ[nz // 2, ny // 3, 5:nx - 5] = True  # a rod across the x tiles
    occ[1, 2:ny - 2, nx // 2] = True
    return occ


def _inits(occ: np.ndarray, dtype: str, seed: int):
    rng = np.random.default_rng(seed + 100)
    o = torch.from_numpy(occ)
    if dtype == "int32":
        flat = torch.arange(o.numel(), dtype=torch.int32).reshape(o.shape)
        return torch.where(o, (o.numel() - 1) - flat, tc.SENTINEL).to(torch.int32), o
    seed_m = occ & (rng.random(occ.shape) < 0.05)
    seed_m.reshape(-1)[np.flatnonzero(occ)[:1]] = True  # at least one seed
    return (o & torch.from_numpy(seed_m)).to(torch.uint8), o


def _oracle_tiles(init, occ, ball, n, tile):
    """Tiles computed per sweep by the schedule's rule, from the full
    sequence of plain sweeps: all in sweep 0; in sweep i the tiles within
    ceil(halo / extent) tiles of one whose voxels differ between outputs i - 1
    and i - 2; none after the first sweep that changed nothing."""
    _, halo = tap_set(ball)
    reach = [-(-halo // t) for t in tile]
    grid_t = [-(-s // t) for s, t in zip(init.shape, tile)]
    outs = [init.numpy()]
    counts = []
    changed_prev = None
    for i in range(n):
        if i == 0:
            active = np.ones(grid_t, bool)
        else:
            active = np.zeros(grid_t, bool)
            for tz, ty, tx in zip(*np.nonzero(changed_prev)):
                active[max(tz - reach[0], 0):tz + reach[0] + 1,
                       max(ty - reach[1], 0):ty + reach[1] + 1,
                       max(tx - reach[2], 0):tx + reach[2] + 1] = True
        counts.append(int(active.sum()))
        new, _ = tc.sweep_plain(torch.from_numpy(outs[-1]), occ, ball)
        outs.append(new.numpy())
        diff = outs[-1] != outs[-2]
        changed_prev = np.zeros(grid_t, bool)
        for tz, ty, tx in np.ndindex(*grid_t):
            changed_prev[tz, ty, tx] = diff[tz * tile[0]:(tz + 1) * tile[0],
                                            ty * tile[1]:(ty + 1) * tile[1],
                                            tx * tile[2]:(tx + 1) * tile[2]].any()
        if not diff.any():
            break
    return counts + [0] * (n - len(counts))


def _check_schedule(init, occ, ball, n, tile=(4, 8, 32)):
    g, flags, tiles = tc.sweeps_tiled_plain(init, occ, ball, n, tile=tile)
    for fix in (False, True):
        pg, pf = tc.sweeps_plain(init, occ, ball, n, until_fixpoint=fix)
        assert torch.equal(g, pg) and torch.equal(flags, pf)
    assert tiles.tolist() == _oracle_tiles(init, occ, ball, n, tile)
    return flags, tiles


@pytest.mark.parametrize("dtype,ball", [
    ("int32", 1.0), ("int32", 2.0), ("int32", 3.0), ("int32", SHELLS),
    ("uint8", 1.0), ("uint8", 2.0), ("uint8", 3.0), ("uint8", SHELLS),
])
def test_schedule_bit_equal_to_plain_sweeps(dtype, ball):
    occ = _scene(seed=7)
    init, o = _inits(occ, dtype, seed=7)
    flags, tiles = _check_schedule(init, o, ball, 8)
    n_tiles = 3 * 4 * 3
    assert int(tiles[0]) == n_tiles
    # the skipping is exercised: some later sweep computes fewer tiles
    assert any(0 < int(t) < n_tiles for t in tiles[1:]) or not bool(flags[1])


@pytest.mark.parametrize("dtype,ball", [("int32", 3.0), ("uint8", 2.5), ("int32", SHELLS)])
def test_schedule_tile_smaller_than_halo(dtype, ball):
    """Tiles of 2 x 2 x 4 under a halo of 2-3: the reach spans 1-2 tiles a
    side on every axis."""
    occ = _scene(seed=11, shape=(9, 13, 21))
    init, o = _inits(occ, dtype, seed=11)
    _, tiles = _check_schedule(init, o, ball, 6, tile=(2, 2, 4))
    assert 0 < int(tiles[1]) < int(tiles[0])


def test_schedule_fixpoint_at_sweep_zero():
    """Voxels 4 apart at r 3: sweep 0 changes nothing, so the schedule stops
    there and the grid is the initial one (held in the buffer sweep 1 would
    have written)."""
    occ = np.zeros(SHAPE, bool)
    occ[::4, ::4, ::4] = True
    for dtype in ("int32", "uint8"):
        init, o = _inits(occ, dtype, seed=3)
        for n in (1, 2, 5):
            g, flags, tiles = tc.sweeps_tiled_plain(init, o, 3.0, n)
            assert torch.equal(g, init) and not bool(flags.any())
            assert tiles.tolist() == [36] + [0] * (n - 1)
        _check_schedule(init, o, 3.0, 5)


def _tiled(init, occ, ball, n, until_fixpoint=False):
    g, flags, _ = tc.sweeps_tiled_plain(init, occ, ball, n, until_fixpoint)
    return g, flags


def test_schedule_corridor_hits_the_cap():
    """A serpentine corridor far longer than the cap's reach: the capped
    labels, ``converged`` False and the sweep count equal the plain sweeps'
    and JAX's while_loop."""
    occ = np.zeros(SHAPE, bool)
    occ[0, ::4, :] = True
    for y in range(0, SHAPE[1] - 4, 4):
        occ[0, y:y + 4, -1 if (y // 4) % 2 == 0 else 0] = True
    o = torch.from_numpy(occ)
    cap = 12
    kl, kconv, kn = tc.label_components(o, 1.5, cap, sweep_fn=_tiled)
    pl, pconv, pn = tc.label_components_plain(o, 1.5, cap)
    jl, jconv = jc.label_components(jnp.asarray(occ), 1.5, cap)
    assert torch.equal(kl, pl) and np.array_equal(kl.numpy(), np.asarray(jl))
    assert not bool(kconv) and not bool(jconv) and not bool(pconv)
    assert int(kn) == int(pn) == cap
    flat = torch.arange(o.numel(), dtype=torch.int32).reshape(o.shape)
    _, _, tiles = tc.sweeps_tiled_plain(torch.where(o, flat, tc.SENTINEL), o, 1.5, cap)
    assert int(tiles[-1]) < int(tiles[0])  # late sweeps touch only the fronts' tiles


@pytest.mark.parametrize("ball", [2.0, 3.0, "shells"])
def test_seeded_labels_through_the_schedule_match_jax(ball):
    occ = _scene(seed=5)
    rng = np.random.default_rng(5)
    seed = occ & (rng.random(SHAPE) < 0.05)
    radius, r2 = (3.0, SHELLS.r2) if ball == "shells" else (ball, None)
    tl, tr, tconv, tit = tc.label_components_seeded(
        torch.from_numpy(occ), torch.from_numpy(seed), radius, 8, traced_r2=r2, sweep_fn=_tiled)
    jl, jr, jconv, jit = jc.label_components_seeded(
        jnp.asarray(occ), jnp.asarray(seed), radius, 8,
        traced_r2=None if r2 is None else jnp.float32(r2))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert bool(tconv) == bool(jconv) and int(tit) == int(jit)


@pytest.mark.parametrize("max_iters", [2, 8])
def test_reach_through_the_schedule_matches_jax(max_iters):
    occ = _scene(seed=9)
    rng = np.random.default_rng(9)
    seed = occ & (rng.random(SHAPE) < 0.03)
    tr, tconv = tc.propagate_reach(torch.from_numpy(occ), torch.from_numpy(seed), 2.0,
                                   max_iters, sweep_fn=_tiled)
    jr, jconv = jc.propagate_reach(jnp.asarray(occ), jnp.asarray(seed), 2.0, max_iters)
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert bool(tconv) == bool(jconv)


def test_components_to_fixpoint_through_the_schedule_match_jax():
    occ = _scene(seed=13)
    o = torch.from_numpy(occ)
    kl, kconv, kn = tc.label_components(o, 2.0, 64, sweep_fn=_tiled)
    pl, pconv, pn = tc.label_components_plain(o, 2.0, 64)
    jl, jconv = jc.label_components(jnp.asarray(occ), 2.0, 64)
    assert np.array_equal(kl.numpy(), np.asarray(jl)) and torch.equal(kl, pl)
    assert bool(kconv) and bool(jconv) and int(kn) == int(pn) < 64
