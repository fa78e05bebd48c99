"""Parity of the port's explore BFS (K7's plain version) and demotion
write-back (K8's plain version) with vofod_tpu.ops.explore.

The same numpy fields and queries go through both packages; every result is
an integer or a bool and is held bit-equal: connected, the reached voxels,
the submap corners, the demoted grid and the count of demotion writes.  One
stated difference: the port empties the reached set of an invalid query
(the JAX version may keep its centre voxel there, which no caller reads), so
reached is compared on valid queries and must be empty on invalid ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.ops.explore import apply_demotions as j_apply
from vofod_tpu.ops.explore import explore_to_ground as j_explore
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.explore import (
    apply_demotions,
    demote_floating_plain,
    explore_plain,
    explore_to_ground,
    unpack_rows,
)

FRONT, GROUND = -750.0, -300.0
AIR, UNK, GND = -1000.0, -740.0, -100.0


def _both(vals, qx, qy, qz, qvalid, bounds, S, max_iters=96):
    shape = vals.shape
    jg, tg = JGrid((0.0, 0.0, 0.0), shape, 0.5), GridSpec((0.0, 0.0, 0.0), shape, 0.5)
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    jc, jr, jco = j_explore(
        jg, jnp.asarray(vals), jnp.asarray(i32(qx)), jnp.asarray(i32(qy)),
        jnp.asarray(i32(qz)), jnp.asarray(qvalid), jnp.asarray(i32(bounds)),
        jnp.float32(FRONT), jnp.float32(GROUND), S, max_iters,
    )
    t = lambda a: torch.from_numpy(i32(a))  # noqa: E731
    tc, tr, tco = explore_to_ground(
        tg, torch.from_numpy(vals), t(qx), t(qy), t(qz), torch.from_numpy(np.asarray(qvalid)),
        t(bounds), FRONT, GROUND, S, max_iters,
    )
    return (np.array(jc), np.array(jr), np.array(jco)), (tc.numpy(), tr.numpy(), tco.numpy())


def _assert_same(j, t, qvalid):
    (jc, jr, jco), (tc, tr, tco) = j, t
    qvalid = np.asarray(qvalid)
    assert np.array_equal(tc, jc)
    assert np.array_equal(tco, jco)
    assert np.array_equal(tr[qvalid], jr[qvalid])
    assert not tr[~qvalid].any()


def _field(shape, seed, p=(0.55, 0.35, 0.10)):
    rng = np.random.default_rng(seed)
    return rng.choice([AIR, UNK, GND], p=list(p), size=shape).astype(np.float32)


@pytest.mark.parametrize("S,shape", [(16, (14, 15, 16)), (32, (20, 22, 24))])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_explore_random_fields(S, shape, seed):
    """Random air / unknown / ground fields; queries anywhere in the grid,
    some invalid; Manhattan bounds from 0 past the submap's cap."""
    vals = _field(shape, seed, p=(0.45, 0.47, 0.08))
    rng = np.random.default_rng(100 + seed)
    Q = 12
    qx, qy, qz = (rng.integers(0, n, Q) for n in shape[::-1])
    qvalid = rng.random(Q) < 0.75
    bounds = rng.integers(0, S, Q)
    j, t = _both(vals, qx, qy, qz, qvalid, bounds, S)
    _assert_same(j, t, qvalid)


def test_explore_shell_touch_and_grid_edges():
    """Unbroken unknown space reaches the shell; grid-edge starts are
    connected by definition; a lone unknown voxel in air floats."""
    vals = np.full((20, 20, 20), UNK, np.float32)
    vals[:, :, 14:] = AIR
    vals[10, 10, 15] = UNK  # lone voxel in cleared air
    qx, qy, qz = [10, 0, 19, 5, 15], [10, 4, 5, 0, 10], [10, 4, 5, 19, 10]
    qvalid = np.ones(5, bool)
    j, t = _both(vals, qx, qy, qz, qvalid, [6, 4, 4, 4, 8], 16)
    _assert_same(j, t, qvalid)
    assert t[0].tolist() == [True, True, True, True, False]


def _serpentine(shape, z, y0, x0, legs=4, leg=8):
    """Air with a one-voxel unknown corridor zig-zagging from (z, y0, x0)."""
    vals = np.full(shape, AIR, np.float32)
    for k in range(legs):
        xs = range(x0, x0 + leg) if k % 2 == 0 else range(x0 + leg - 1, x0 - 1, -1)
        for x in xs:
            vals[z, y0 + 2 * k, x] = UNK
        if k < legs - 1:
            vals[z, y0 + 2 * k + 1, xs[-1]] = UNK
    return vals


@pytest.mark.parametrize("max_iters", [3, 8])
def test_explore_serpentine_capped(max_iters):
    """A winding corridor longer than the sweep cap: the Jacobi BFS stops
    max_iters voxels along it, exactly as the JAX while_loop does."""
    vals = _serpentine((12, 24, 24), 6, 4, 4)
    qvalid = np.ones(1, bool)
    j, t = _both(vals, [4], [4], [6], qvalid, [30], 32, max_iters)
    _assert_same(j, t, qvalid)
    _, free = _both(vals, [4], [4], [6], qvalid, [30], 32, 96)
    assert t[1].sum() == max_iters + 1 < free[1].sum()
    assert not t[0][0]


def test_packed_rows_unpack_to_the_bool_form():
    vals = _field((14, 15, 16), 5, p=(0.3, 0.6, 0.1))
    vals[[3, 8, 2], [12, 8, 3], [3, 8, 12]] = UNK  # the query voxels
    g = GridSpec((0.0, 0.0, 0.0), vals.shape, 0.5)
    q = torch.tensor([3, 8, 12], dtype=torch.int32)
    args = (g, torch.from_numpy(vals), q, q.flip(0), q % 10, torch.ones(3, dtype=torch.bool),
            torch.tensor([7, 3, 12], dtype=torch.int32), FRONT, GROUND, 16)
    c, bits, co = explore_plain(*args)
    c2, reached, co2 = explore_to_ground(*args)
    assert bits.dtype == torch.int64 and bits.shape == (3, 16, 16)
    assert torch.equal(unpack_rows(bits, 16), reached)
    assert torch.equal(c, c2) and torch.equal(co, co2)
    # bit x of row (z, y) is voxel (z, y, x)
    z, y, x = torch.nonzero(reached[0])[0].tolist()
    assert (int(bits[0, z, y]) >> x) & 1


@pytest.mark.parametrize("seed", [0, 1])
def test_demotions_overlapping_patches(seed):
    """Floating queries whose patches overlap and cross the grid edge: the
    port's K8 plain version (demote decision + write-back) against the JAX
    classify's demote rule followed by vofod_tpu apply_demotions.  Queries
    2-5 sit in small unknown pockets carved into air, so they float."""
    shape, S, K = (16, 18, 20), 16, 4
    vals = _field(shape, 10 + seed, p=(0.45, 0.53, 0.02))
    rng = np.random.default_rng(20 + seed)
    Q = 10
    qx = np.clip(8 + rng.integers(-3, 4, Q), 0, 19)
    qx[:2] = [0, 19]  # patches past the grid edge
    qy, qz = np.clip(9 + rng.integers(-3, 4, Q), 0, 17), np.clip(8 + rng.integers(-3, 4, Q), 0, 15)
    for q in range(2, 6):
        vals[qz[q] - 1:qz[q] + 2, qy[q] - 1:qy[q] + 2, qx[q] - 1:qx[q] + 3] = AIR
    for q in range(2, 6):
        vals[qz[q], qy[q], qx[q]:qx[q] + 2] = UNK
    qvalid = np.ones(Q, bool)
    qvalid[-1] = False
    bounds = rng.integers(2, 8, Q)
    bounds[2:6] = 6
    j, t = _both(vals, qx, qy, qz, qvalid, bounds, S)
    _assert_same(j, t, qvalid)
    connected, reached, corners = j
    # connected queries share slot 0, the others spread over 1..K-1
    slot = np.where(connected, 0, 1 + np.arange(Q) % (K - 1))
    qslot = (slot[:, None] == np.arange(K)[None, :]) & qvalid[:, None]
    qgate = np.array([True, True, True, False])
    for overflow in (np.False_, np.True_):
        cc = np.any(qslot & connected[:, None], axis=0)
        floating = qgate & ~cc & ~overflow
        demote = qvalid & np.any(qslot & floating[None, :], axis=1)
        want = np.asarray(j_apply(jnp.asarray(vals), jnp.asarray(reached), jnp.asarray(corners),
                                  jnp.asarray(demote), jnp.float32(FRONT)))
        got, n, conn = demote_floating_plain(
            torch.from_numpy(vals), torch.from_numpy(_pack(reached)), torch.from_numpy(corners),
            torch.from_numpy(qslot), torch.from_numpy(connected), torch.from_numpy(qvalid),
            torch.from_numpy(qgate), torch.tensor(bool(overflow)), FRONT,
        )
        assert np.array_equal(got.numpy(), want)
        assert int(n) == _writes(reached, corners, demote, shape)
        assert np.array_equal(conn.numpy(), cc)
        got_bool = apply_demotions(torch.from_numpy(vals), torch.from_numpy(reached),
                                   torch.from_numpy(corners), torch.from_numpy(demote), FRONT)
        assert np.array_equal(got_bool.numpy(), want)
        if not overflow:
            assert (want != vals).sum() > 0, "no demotion exercised"
        else:
            assert np.array_equal(want, vals)


def _pack(reached):
    S = reached.shape[-1]
    return (reached.astype(np.int64) << np.arange(S, dtype=np.int64)).sum(-1)


def _writes(reached, corners, demote, shape):
    n = 0
    for q in np.nonzero(demote)[0]:
        for z, y, x in np.argwhere(reached[q]):
            g = corners[q] + (z, y, x)
            n += bool(np.all(g >= 0) and np.all(g < np.array(shape)))
    return n
