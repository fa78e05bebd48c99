"""K11 parity: the plain versions of the two EMA passes against the JAX
package, bit for bit.

* The point EMA (``point_ema_plain``) against vofod_tpu/pipeline/
  background.py ``_finish`` and, through ``split_and_update``, against the
  whole JAX stage: the new grid, ``far`` and the occupied count.
* The demotion EMA (``demote_ema_plain``) against the JAX demotion of
  vofod_tpu/pipeline/sepclusters.py (the int8 ball max of the unsafe
  background, then ``w1 v + (1 - w1) score_ray``) and, through
  ``run_sepclusters``, against the whole JAX stage, with ``sure_sufficient``
  True and False and its_diff 1 and 2.

All float32 elementwise with the same rounding steps: bit-equal, with one
measured exception.  XLA's CPU ``exp2`` is not exact at the integer
arguments -13 ... -63 (relative error up to 2.0e-6), while PyTorch's (CPU
and CUDA) and the kernel's are: the point-EMA weight ``2^-count`` then
differs for counts >= 13, where it is below 2^-12.  Those voxels are held
within 1e-6 score units (|Δw| x 1000 <= 2.0e-6 x 2^-13 x 1000 < 5e-7), the
port's weight is checked to be exactly 2^-count, and every other voxel is
bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vofod_tpu.config import DynParams as JDyn, VoFODConfig as JConfig
from vofod_tpu.ops.morphology import ball_pool_max as j_ball_pool_max
from vofod_tpu.pipeline import background as jb
from vofod_tpu.pipeline.sepclusters import run_sepclusters as j_sep
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.pipeline.background import point_ema, point_ema_plain, split_and_update
from vofod_tpu_torch.pipeline.sepclusters import (
    demote_ema, demote_ema_plain, demote_weights, run_sepclusters)

SHAPE = (12, 16, 20)
# default scores, and scores that float32 does not represent exactly
SCORES = [dict(), dict(score_point=-0.7, score_unknown=-740.3, score_ray=-999.9)]
# point-EMA counts from here on take an inexact weight in XLA's CPU exp2
EXP2_EXACT_BELOW = 13


def _assert_point_grid(got, want, counts):
    exact = counts < EXP2_EXACT_BELOW
    assert np.array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got[~exact], want[~exact], rtol=0, atol=1e-6)


def _field(rng):
    u = rng.random(SHAPE)
    return np.where(u < 0.5, -900.0, np.where(u < 0.8, -200.0, -0.05)).astype(np.float32)


@pytest.mark.parametrize("scores", range(len(SCORES)))
@pytest.mark.parametrize("seed", [0, 1])
def test_point_ema_plain_against_jax_finish(scores, seed):
    rng = np.random.default_rng(200 + seed)
    vals = rng.uniform(-1000.0, 0.0, SHAPE).astype(np.float32)
    counts = np.where(rng.random(SHAPE) < 0.3, rng.integers(0, 90, SHAPE), 0).astype(np.int32)
    assert (counts > 63).any()
    close = rng.random(SHAPE) < 0.5
    occupied = counts > 0
    far = occupied & ~close
    jd, td = JDyn(**SCORES[scores]), DynParams(**SCORES[scores])
    z = jnp.zeros((), jnp.int32)
    want = jb._finish(JConfig(), jd.as_arrays(), jnp.asarray(vals), jnp.asarray(counts),
                      jnp.asarray(occupied), jnp.asarray(far), jnp.asarray(close),
                      jnp.zeros(SHAPE, jnp.int32), z, jnp.bool_(True), jnp.bool_(True), z)
    got, got_far, n_occ = point_ema_plain(
        torch.from_numpy(vals), torch.from_numpy(counts), torch.from_numpy(close),
        float(td.score_point), float(td.score_unknown))
    _assert_point_grid(got.numpy(), np.asarray(want.grid), counts)
    assert (occupied & (counts >= EXP2_EXACT_BELOW)).sum() > 50
    assert torch.equal(torch.exp2(-torch.arange(64, dtype=torch.float32)),
                       torch.tensor([2.0**-k for k in range(64)], dtype=torch.float32))
    assert np.array_equal(got_far.numpy(), far)
    assert n_occ.dtype == torch.int32 and int(n_occ) == int(occupied.sum())
    assert (got.numpy() != vals).sum() > 0
    # the dispatching entry point takes the plain version on the CPU
    same = point_ema(torch.from_numpy(vals), torch.from_numpy(counts),
                     torch.from_numpy(close), float(td.score_point), float(td.score_unknown))
    assert all(torch.equal(a, b) for a, b in zip(same, (got, got_far, n_occ)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_and_update_grid_bit_equal(seed):
    rng = np.random.default_rng(210 + seed)
    vals = np.full(SHAPE, -900.0, np.float32)  # air over a background floor
    vals[:3] = _field(rng)[:3]
    counts = np.where(rng.random(SHAPE) < 0.1, rng.integers(1, 80, SHAPE), 0).astype(np.int32)
    counts[5:] = 0
    for z, y, x in ((10, 2, 2), (10, 12, 15), (9, 8, 8)):  # floating returns: far
        counts[z, y, x] = rng.integers(1, 80)
    cfg_kw = dict(background_sufficient_points_ratio=0.0001)
    want = jb.split_and_update(JConfig(**cfg_kw), JDyn().as_arrays(), jnp.asarray(vals),
                               jnp.asarray(counts), jnp.bool_(False))
    got = split_and_update(VoFODConfig(**cfg_kw), DynParams(), torch.from_numpy(vals),
                           torch.from_numpy(counts), torch.tensor(False))
    _assert_point_grid(got.grid.numpy(), np.asarray(want.grid), counts)
    assert np.array_equal(got.far.numpy(), np.asarray(want.far))
    assert np.array_equal(got.close.numpy(), np.asarray(want.close))
    assert int(got.n_occupied) == int(np.asarray(want.occupied).sum())
    assert np.asarray(want.far).any() and np.asarray(want.close).any()


@pytest.mark.parametrize("scores", range(len(SCORES)))
@pytest.mark.parametrize("its_diff", [1, 2])
@pytest.mark.parametrize("sure", [True, False])
def test_demote_ema_plain_against_jax(scores, its_diff, sure):
    rng = np.random.default_rng(220 + its_diff + 2 * sure)
    vals = _field(rng)
    bg = vals > -300.0
    safe = rng.random(SHAPE) < 0.6
    radius = 1.6
    jd = JDyn(**SCORES[scores]).as_arrays()
    td = DynParams(**SCORES[scores])
    # the JAX demotion (vofod_tpu/pipeline/sepclusters.py:144-156)
    demote = j_ball_pool_max(jnp.asarray(bg & ~safe).astype(jnp.int8), radius, fill=0) > 0
    w1_j = jnp.clip(jnp.power(0.5, jnp.float32(its_diff)), 0.0, 1.0)
    g = jnp.asarray(vals)
    want = np.asarray(jnp.where(demote & jnp.bool_(sure), w1_j * g + (1.0 - w1_j) * jd.score_ray,
                                g))
    w1, c = demote_weights(its_diff, td.score_ray)
    got = demote_ema_plain(torch.from_numpy(vals), torch.from_numpy(bg),
                           torch.from_numpy(safe), torch.tensor(sure), radius, w1, c)
    assert np.array_equal(got.numpy(), want)
    assert ((got.numpy() != vals).sum() > 0) == sure
    same = demote_ema(torch.from_numpy(vals), torch.from_numpy(bg), torch.from_numpy(safe),
                      torch.tensor(sure), radius, w1, c)
    assert torch.equal(same, got)


@pytest.mark.parametrize("its_diff", [1, 2])
@pytest.mark.parametrize("sure_ground", [True, False])
def test_run_sepclusters_grid_bit_equal(its_diff, sure_ground):
    """The whole stage: with a sure ground slab (demotions happen) and with
    no sure voxel at all (``sure_sufficient`` False: nothing is demoted)."""
    rng = np.random.default_rng(230 + its_diff)
    # air with a ground slab and background specks floating above it
    vals = np.full(SHAPE, -900.0, np.float32)
    vals[:2] = 0.5 if sure_ground else -0.2
    vals[5:][rng.random((SHAPE[0] - 5,) + SHAPE[1:]) < 0.05] = -200.0
    prev_safe = rng.random(SHAPE) < 0.2
    jo = j_sep(JConfig(), JDyn().as_arrays(), jnp.asarray(vals), jnp.asarray(prev_safe),
               jnp.float32(its_diff), prev_sure=jnp.bool_(False))
    to = run_sepclusters(VoFODConfig(), DynParams(), torch.from_numpy(vals),
                         torch.from_numpy(prev_safe), float(its_diff),
                         prev_sure=torch.tensor(False))
    assert bool(to.sure_bg_sufficient) == bool(jo.sure_bg_sufficient) == sure_ground
    assert np.array_equal(to.safe.numpy(), np.asarray(jo.safe))
    assert np.array_equal(to.grid.numpy(), np.asarray(jo.grid))
    assert ((to.grid.numpy() != vals).sum() > 0) == sure_ground
