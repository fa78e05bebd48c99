"""The persistent K2 launch's schedule, modelled on the CPU.

On the card every sweep of one ``ops/components.sweeps`` call runs in one
cooperative launch that recomputes, after sweep 0, only the tiles within
the ball's reach of a tile that changed in the sweep before, and stops at
the first sweep that changed nothing.  ``sweeps_tiled_plain`` is the plain
model of that schedule: here it is held bit-equal (grid and per-sweep
flags) to ``sweeps_plain``, its tiles computed per sweep to a count taken
independently from the full sequence of sweeps, and, through the label
functions, to the JAX package (labels, reach, ``converged``, ``iters``).
The grid-sharded step's launches of k sweeps on a halo-extended slab
(``sweeps_batch_plain`` with ``grow``: each sweep's exact rows shrink by
``grow`` at each end) are held to the same kind of oracle: the exact rows,
the flags of the interior rows and the tiles per sweep, whatever the
second buffer held.  Small seeded grids whose sizes are not multiples of
the tile.
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


def _held(occ, grid_t, tile) -> np.ndarray:
    """The tiles holding an occupied voxel."""
    o = np.asarray(occ)
    return np.array([[[o[tz * tile[0]:(tz + 1) * tile[0], ty * tile[1]:(ty + 1) * tile[1],
                         tx * tile[2]:(tx + 1) * tile[2]].any()
                       for tx in range(grid_t[2])] for ty in range(grid_t[1])]
                     for tz in range(grid_t[0])])


def _oracle_tiles(init, occ, ball, n, tile):
    """Tiles computed per sweep by the schedule's rule, from the full
    sequence of plain sweeps: of the tiles holding an occupied voxel, all in
    sweep 0; in sweep i those within ceil(halo / extent) tiles of one whose
    voxels differ between outputs i - 1 and i - 2; none after the first
    sweep that changed nothing."""
    _, halo = tap_set(ball)
    reach = [-(-halo // t) for t in tile]
    grid_t = [-(-s // t) for s, t in zip(init.shape, tile)]
    held = _held(occ, grid_t, tile)
    outs = [init.numpy()]
    counts = []
    changed_prev = None
    for i in range(n):
        if i == 0:
            active = held.copy()
        else:
            active = np.zeros(grid_t, bool)
            for tz, ty, tx in zip(*np.nonzero(changed_prev)):
                active[max(tz - reach[0], 0):tz + reach[0] + 1,
                       max(ty - reach[1], 0):ty + reach[1] + 1,
                       max(tx - reach[2], 0):tx + reach[2] + 1] = True
            active &= held
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


def _oracle_batch(init, occ, ball, n, grow, tile):
    """One launch of ``sweeps_batch_plain`` from the full sequence of plain
    sweeps over the whole slab (every tile computed): (the outputs 0 ..
    of that sequence, tiles per sweep).  Sweep s's tiles are those meeting
    its exact rows [(s + 1) grow, nz - (s + 1) grow): all of them at s = 0,
    later those within ceil(halo / extent) tiles of one whose voxels in
    sweep s - 1's exact rows differ between its input and output, of the
    tiles holding an occupied voxel; none after a sweep with no such tile."""
    _, halo = tap_set(ball)
    reach = [-(-halo // t) for t in tile]
    nz = init.shape[0]
    grid_t = [-(-s // t) for s, t in zip(init.shape, tile)]
    outs, counts, changed_prev = [init], [], None
    for s in range(n):
        lo, hi = (s + 1) * grow, nz - (s + 1) * grow
        meets = np.array([tz * tile[0] < hi and tz * tile[0] + tile[0] > lo
                          for tz in range(grid_t[0])])[:, None, None] & _held(occ, grid_t, tile)
        if s == 0:
            active = meets
            if not active.any():
                break
        else:
            active = np.zeros(grid_t, bool)
            for tz, ty, tx in zip(*np.nonzero(changed_prev)):
                active[max(tz - reach[0], 0):tz + reach[0] + 1,
                       max(ty - reach[1], 0):ty + reach[1] + 1,
                       max(tx - reach[2], 0):tx + reach[2] + 1] = True
            active &= meets
            if not active.any():
                break
        counts.append(int(active.sum()))
        outs.append(tc.sweep_plain(outs[-1], occ, ball)[0])
        diff = (outs[-1] != outs[-2]).numpy()
        diff[:lo] = diff[hi:] = False
        changed_prev = np.zeros(grid_t, bool)
        for tz, ty, tx in np.ndindex(*grid_t):
            changed_prev[tz, ty, tx] = diff[tz * tile[0]:(tz + 1) * tile[0],
                                            ty * tile[1]:(ty + 1) * tile[1],
                                            tx * tile[2]:(tx + 1) * tile[2]].any()
    return outs, counts + [0] * (n - len(counts))


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
    occ[10, 27, 68] = True  # a lone voxel in a corner tile: settled from sweep 0 on
    init, o = _inits(occ, dtype, seed=7)
    flags, tiles = _check_schedule(init, o, ball, 8)
    n_tiles = int(_held(occ, (3, 4, 3), (4, 8, 32)).sum())
    assert int(tiles[0]) == n_tiles < 3 * 4 * 3  # the empty tiles are never computed
    # the skipping is exercised: some later sweep computes fewer tiles
    assert any(0 < int(t) < n_tiles for t in tiles[1:]) or not bool(flags[1])


@pytest.mark.parametrize("dtype,ball", [("int32", 3.0), ("uint8", 2.5), ("int32", SHELLS)])
def test_schedule_tile_smaller_than_halo(dtype, ball):
    """Tiles of 2 x 2 x 4 under a halo of 2-3: the reach spans 1-2 tiles a
    side on every axis."""
    occ = _scene(seed=11, shape=(9, 13, 21))
    occ[8, 0, 20] = True  # a lone voxel in a corner tile: settled from sweep 0 on
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
    occ[10, 27, 68] = True  # a lone voxel far from the corridor: its tile settles
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


@pytest.mark.parametrize("dtype,ball,grow,n", [
    ("int32", 1.0, 1, 8), ("int32", 3.0, 3, 8), ("int32", 2.0, 3, 5), ("int32", SHELLS, 3, 4),
    ("uint8", 2.0, 2, 8), ("uint8", SHELLS, 3, 3),
])
def test_batch_schedule_matches_oracle(dtype, ball, grow, n):
    """A launch of k sweeps on a slab of 10 interior rows between halos of n
    x grow rows: the exact rows after each launch, the interior's per-sweep
    flags and the tiles per sweep equal the oracle's from unskipped sweeps,
    with the second buffer's occupied voxels poisoned two ways (the stale
    rows never reach a count; off the mask it holds the fill, the launch's
    contract); the flags and tiles land at the call's offset i0."""
    halo = n * grow
    occ = _scene(seed=17, shape=(10 + 2 * halo, 19, 40))
    init, o = _inits(occ, dtype, seed=17)
    outs, want = _oracle_batch(init, o, ball, n, grow, (4, 8, 32))
    rows = (halo, halo + 10)
    lo, hi = n * grow, init.shape[0] - n * grow
    want_flags = [int(bool((b[rows[0]:rows[1]] != a[rows[0]:rows[1]]).any()))
                  for a, b in zip(outs, outs[1:])]
    want_flags += [0] * (n - len(want_flags))
    got = []
    for poison in (0x00, 0xA5):
        bufs = (init.clone(), torch.full_like(init, tc.SENTINEL if dtype == "int32" else 0))
        bufs[1][o] = poison
        changed = torch.zeros(n + 2, dtype=torch.int32)
        tiles = torch.zeros(n + 2, dtype=torch.int32)
        tc.sweeps_batch_plain(*bufs, o, ball, changed, tiles, 2, n, grow, rows)
        assert tiles[2:].tolist() == want and changed[2:].tolist() == want_flags
        assert not bool(changed[:2].any()) and not bool(tiles[:2].any())
        assert torch.equal(bufs[n % 2][lo:hi], outs[-1][lo:hi])
        got.append(bufs[n % 2][lo:hi])
    assert torch.equal(got[0], got[1])
    # the tile rows of the stale rows only are skipped, and so are the empty tiles
    assert want[0] < int(_held(occ, [-(-init.shape[0] // 4), 3, 2], (4, 8, 32)).sum()) or grow < 4
    assert any(0 < t < want[0] for t in want[1:]) or want_flags[-1] == 0
