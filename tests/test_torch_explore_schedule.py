"""K7's and K8's schedules (csrc/explore.cu) on the CPU: their plain models
``ops.explore.explore_planes_plain`` and ``demote_rows_plain`` held
bit-equal to vofod_tpu's ``explore_to_ground`` and to JAX's demote decision
(vofod_tpu/pipeline/classify.py:188-194) followed by ``apply_demotions``.

K7's model runs the kernel's registers (warps of z planes, lane = y), the
edge-plane exchange between warps and the level loop with its cap and its
fixpoint exit; cases: random fields at S = 16, 31 and 32 with invalid
queries, the serpentine corridor at ``max_iters`` 1, 8 and 96, a shell
touch and grid-edge starts, submaps past the grid in y and z, and a shard's
z window against the dense grid.  K8's model runs the verdict's slot words
and the row-by-row stores with their count; cases: query overflow, an
ungated slot, every member connected, queries in no slot, overlapping
patches, K = 5, 32 and 40.  The port keeps an invalid query's reached set
empty (test_torch_explore.py)."""

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
    EXPLORE_PLANES, EXPLORE_WARPS, _pack_rows, demote_rows_plain, explore_planes_plain,
    unpack_rows)

FRONT, GROUND = -750.0, -300.0
AIR, UNK, GND = -1000.0, -740.0, -100.0
i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
Q_JAX = 12
# the grids: S = 16 on SHAPE16, S = 31 and 32 on SHAPE32
SHAPE16, SHAPE32 = (16, 18, 20), (20, 22, 24)


def _field(shape, seed, p=(0.45, 0.47, 0.08)):
    rng = np.random.default_rng(seed)
    return rng.choice([AIR, UNK, GND], p=list(p), size=shape).astype(np.float32)


def _model(vals, qx, qy, qz, qvalid, bounds, S, max_iters=96, z_window=None, grid_shape=None):
    g = GridSpec((0.0, 0.0, 0.0), grid_shape or vals.shape, 0.5)
    t = lambda a: torch.from_numpy(i32(a))  # noqa: E731
    return explore_planes_plain(g, torch.from_numpy(vals), t(qx), t(qy), t(qz),
                                torch.from_numpy(np.asarray(qvalid)), t(bounds), FRONT, GROUND,
                                S, max_iters, z_window)


def _jax(vals, qx, qy, qz, qvalid, bounds, S, max_iters=96):
    jc, jr, jco = j_explore(
        JGrid((0.0, 0.0, 0.0), vals.shape, 0.5), jnp.asarray(vals), jnp.asarray(i32(qx)),
        jnp.asarray(i32(qy)), jnp.asarray(i32(qz)), jnp.asarray(qvalid), jnp.asarray(i32(bounds)),
        jnp.float32(FRONT), jnp.float32(GROUND), S, max_iters)
    return np.array(jc), np.array(jr), np.array(jco)


def _check(vals, qx, qy, qz, qvalid, bounds, S, max_iters=96):
    """The model against JAX: connected, reached unpacked (valid queries;
    empty on invalid ones), corners; returns the model's outputs.  The
    queries are padded to Q_JAX with invalid ones (the JAX programs of a
    shape compile once)."""
    n = Q_JAX - len(qx)
    qx, qy, qz, bounds = (np.concatenate([i32(a), np.zeros(n, np.int32)])
                          for a in (qx, qy, qz, bounds))
    qvalid = np.concatenate([np.asarray(qvalid, bool), np.zeros(n, bool)])
    jc, jr, jco = _jax(vals, qx, qy, qz, qvalid, bounds, S, max_iters)
    c, bits, co, sweeps = _model(vals, qx, qy, qz, qvalid, bounds, S, max_iters)
    reached = unpack_rows(bits, S).numpy()
    assert np.array_equal(c.numpy(), jc)
    assert np.array_equal(co.numpy(), jco)
    assert np.array_equal(reached[qvalid], jr[qvalid])
    assert not reached[~qvalid].any()
    sweeps = sweeps.numpy()
    assert (sweeps[~qvalid] == 0).all() and (sweeps[qvalid] >= 1).all()
    assert (sweeps <= max_iters).all()
    return c.numpy(), reached, sweeps


def test_register_layout():
    """S <= 32 is 32 lanes by EXPLORE_WARPS x EXPLORE_PLANES planes."""
    assert EXPLORE_WARPS * EXPLORE_PLANES == 32


@pytest.mark.parametrize("S,shape", [(16, SHAPE16), (31, SHAPE32), (32, SHAPE32)])
@pytest.mark.parametrize("seed", [0, 1])
def test_k7_random_fields(S, shape, seed):
    """Random fields; queries anywhere (their submaps past the grid on
    every side), a quarter invalid; Manhattan bounds from 0 past the cap."""
    vals = _field(shape, seed)
    rng = np.random.default_rng(100 + seed)
    Q = Q_JAX
    qx, qy, qz = (rng.integers(0, n, Q) for n in shape[::-1])
    qvalid = rng.random(Q) < 0.75
    _check(vals, qx, qy, qz, qvalid, rng.integers(0, S, Q), S)


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


@pytest.mark.parametrize("max_iters", [1, 8, 96])
def test_k7_serpentine_cap(max_iters):
    """A corridor longer than the cap: the level loop stops after max_iters
    sweeps (one voxel each), as the JAX while_loop does; uncapped it runs to
    the fixpoint, one sweep past the corridor's end."""
    vals = _serpentine((12, 24, 24), 6, 4, 4)
    c, reached, sweeps = _check(vals, [4], [4], [6], [True], [30], 32, max_iters)
    corridor = int((vals == UNK).sum())
    if max_iters < corridor:
        assert sweeps[0] == max_iters and reached.sum() == max_iters + 1
    else:
        assert sweeps[0] == corridor and reached.sum() == corridor
    assert not c[0]


def test_k7_shell_touch_and_grid_edges():
    """Unbroken unknown space reaches the shell (across the warps' edge
    planes); grid-edge starts are connected by definition; a lone unknown
    voxel in air floats."""
    vals = np.full(SHAPE16, UNK, np.float32)
    vals[:, :, 14:] = AIR
    vals[10, 10, 15] = UNK
    c, _, _ = _check(vals, [10, 0, 19, 5, 15], [10, 4, 5, 0, 10], [10, 4, 5, 15, 10],
                     np.ones(5, bool), [6, 4, 4, 4, 8], 16)
    assert c[:5].tolist() == [True, True, True, True, False]


@pytest.mark.parametrize("S,shape", [(16, SHAPE16), (32, SHAPE32)])
def test_k7_submaps_past_the_grid(S, shape):
    """Queries near the grid's faces in y and z: their rows past the grid
    read as air, in a field of unknown with ground beyond the bound."""
    vals = _field(shape, 5, p=(0.1, 0.85, 0.05))
    nz, ny, nx = shape
    qx, qy, qz = [nx // 2] * 4, [1, ny - 2, 2, ny // 2], [1, nz - 2, nz // 2, nz - 1]
    _check(vals, qx, qy, qz, np.ones(4, bool), [S // 2, S // 2, 5, S], S)


@pytest.mark.parametrize("z0", [0, 16, 32])
def test_k7_z_window_matches_the_dense_grid(z0):
    """A shard's slab of rows [z0, z0 + 8) extended by the explore pad
    (rows [z0 - pad, z0 + 8 + pad) of the grid, -1e30 past the grid) gives
    the dense grid's results for the queries it owns."""
    S, shape, nzl = 16, (40, 18, 20), 8
    vals = _field(shape, 9 + z0)
    rng = np.random.default_rng(9 + z0)
    Q = 10
    qx, qy = rng.integers(0, shape[2], Q), rng.integers(0, shape[1], Q)
    qz = rng.integers(z0, z0 + nzl, Q)
    bounds = rng.integers(2, S, Q)
    qvalid = np.ones(Q, bool)
    dense = _model(vals, qx, qy, qz, qvalid, bounds, S)
    pad = S // 2
    lo, hi = max(z0 - pad, 0), min(z0 + nzl + pad, shape[0])
    slab = np.full((nzl + 2 * pad, *shape[1:]), -1e30, np.float32)
    slab[lo - (z0 - pad):hi - (z0 - pad)] = vals[lo:hi]
    win = _model(slab, qx, qy, qz, qvalid, bounds, S, z_window=(z0 - pad, shape[0]),
                 grid_shape=shape)
    for a, b in zip(win, dense):
        assert torch.equal(a, b)
    assert dense[3].max() > 1


# ---- K8 ------------------------------------------------------------------------------


def _k8_case(shape, S, K, Q, seed):
    """Floating and connected queries over a field, their patches
    overlapping and crossing the grid's faces; the JAX explore's outputs."""
    vals = _field(shape, 10 + seed, p=(0.45, 0.53, 0.02))
    rng = np.random.default_rng(20 + seed)
    qx = np.clip(shape[2] // 2 + rng.integers(-4, 5, Q), 0, shape[2] - 1)
    qx[:2] = [0, shape[2] - 1]
    qy = np.clip(shape[1] // 2 + rng.integers(-4, 5, Q), 0, shape[1] - 1)
    qz = np.clip(shape[0] // 2 + rng.integers(-4, 5, Q), 0, shape[0] - 1)
    for q in range(2, Q // 2):  # small unknown pockets in air: these float
        vals[qz[q] - 1:qz[q] + 2, qy[q] - 1:qy[q] + 2, max(qx[q] - 1, 0):qx[q] + 3] = AIR
        vals[qz[q], qy[q], qx[q]:qx[q] + 2] = UNK
    qvalid = np.ones(Q, bool)
    qvalid[-1] = False
    bounds = rng.integers(2, S // 2, Q)
    connected, reached, corners = _jax(vals, qx, qy, qz, qvalid, bounds, S)
    return vals, qvalid, connected, reached, corners


def _k8_check(vals, reached, corners, qslot, connected, qvalid, qgate, overflow):
    """The model against JAX's decision, apply_demotions and its
    cluster_connected; returns the count of demotion writes."""
    cc = np.any(qslot & connected[:, None], axis=0)
    floating = qgate & ~cc & ~overflow
    demote = qvalid & np.any(qslot & floating[None, :], axis=1)
    want = np.asarray(j_apply(jnp.asarray(vals), jnp.asarray(reached), jnp.asarray(corners),
                              jnp.asarray(demote), jnp.float32(FRONT)))
    got, n, conn = demote_rows_plain(
        torch.from_numpy(vals), _pack_rows(torch.from_numpy(reached)), torch.from_numpy(corners),
        torch.from_numpy(qslot), torch.from_numpy(connected), torch.from_numpy(qvalid),
        torch.from_numpy(qgate), torch.tensor(bool(overflow)), FRONT)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(conn.numpy(), cc)
    writes = 0
    for q in np.nonzero(demote)[0]:
        g = corners[q] + np.argwhere(reached[q])
        writes += int(np.all((g >= 0) & (g < np.array(vals.shape)), axis=1).sum())
    assert int(n) == writes and n.dtype == torch.int32
    return writes


@pytest.mark.parametrize("K", [5, 32, 40])
@pytest.mark.parametrize("overflow", [False, True])
def test_k8_slots(K, overflow):
    """Connected queries in slot 0, floating ones spread over the others
    (past 32: a second slot word), one slot ungated, some queries in no
    slot; under query overflow nothing demotes and cluster_connected is
    still written."""
    vals, qvalid, connected, reached, corners = _k8_case(SHAPE16, 16, K, Q_JAX, K)
    Q = len(qvalid)
    slot = np.where(connected, 0, 1 + (np.arange(Q) * 7) % (K - 1))
    qslot = (slot[:, None] == np.arange(K)[None, :]) & qvalid[:, None]
    qslot[3] = False  # a query in no slot
    qgate = np.ones(K, bool)
    qgate[slot[4]] = False  # an ungated slot
    n = _k8_check(vals, reached, corners, qslot, connected, qvalid, qgate, np.bool_(overflow))
    assert (n == 0) == overflow


def test_k8_every_member_connected():
    """A slot whose queries include one connected one never demotes, though
    its other members floated."""
    vals, qvalid, connected, reached, corners = _k8_case(SHAPE16, 16, 4, Q_JAX, 3)
    assert connected.any() and (~connected & qvalid).any()
    qslot = np.zeros((len(qvalid), 4), bool)
    qslot[qvalid, 1] = True  # every valid query in slot 1
    n = _k8_check(vals, reached, corners, qslot, connected, qvalid, np.ones(4, bool),
                  np.False_)
    assert n == 0


def test_k8_overlapping_patches_at_s32():
    """At the flagship submap: every unconnected query floats in its own
    slot, patches overlap, and the writes are counted once a query."""
    vals, qvalid, connected, reached, corners = _k8_case(SHAPE32, 32, 32, Q_JAX, 7)
    Q = len(qvalid)
    slot = np.where(connected, 0, 1 + np.arange(Q) % 31)
    qslot = (slot[:, None] == np.arange(32)[None, :]) & qvalid[:, None]
    n = _k8_check(vals, reached, corners, qslot, connected, qvalid, np.ones(32, bool), np.False_)
    assert n > 0
