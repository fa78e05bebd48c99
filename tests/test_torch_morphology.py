"""K1 parity: the port's Euclidean-ball pools against vofod_tpu's.

The same seeded numpy grids go through ``vofod_tpu.ops.morphology`` (JAX on
the CPU) and ``vofod_tpu_torch.ops.morphology`` (its plain PyTorch version on
CPU tensors; the CUDA kernel is held to that plain version on the card by
chip_smoke.py).  Integer pools are exact, so the tolerance is zero: every
voxel, grid edges included, must be bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vofod_tpu.ops import morphology as jm
from vofod_tpu_torch.ops import morphology as tm

SHAPE = (9, 13, 17)  # odd, unequal sides: every edge and corner case


def _grid(dtype, seed, density=0.2):
    rng = np.random.default_rng(seed)
    if dtype == np.int8:
        return (rng.random(SHAPE) < density).astype(np.int8)
    vals = rng.integers(0, 5000, SHAPE).astype(np.int32)
    return np.where(rng.random(SHAPE) < density, vals, np.iinfo(np.int32).max).astype(np.int32)


@pytest.mark.parametrize("radius", [1.6, 2.0, 3.0])
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_ball_pool_min_max_bit_equal(radius, op, dtype):
    a = _grid(dtype, seed=int(radius * 10) + (dtype == np.int32))
    jf = jm.ball_pool_min if op == "min" else jm.ball_pool_max
    tf = tm.ball_pool_min if op == "min" else tm.ball_pool_max
    want = np.asarray(jf(jnp.asarray(a), radius))
    got = tf(torch.from_numpy(a), radius).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("radius", [1.6, 2.0, 3.0])
def test_ball_pool_max_fill0_bit_equal(radius):
    """The step's form: int8 mask, explicit fill 0 (bg_near, demotion ball)."""
    a = _grid(np.int8, seed=7)
    want = np.asarray(jm.ball_pool_max(jnp.asarray(a), radius, fill=0))
    got = tm.ball_pool_max(torch.from_numpy(a), radius, fill=0).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("radius", [1.6, 2.0, 3.0])
def test_ball_pool_sum_bit_equal(radius):
    a = _grid(np.int8, seed=11, density=0.5).astype(np.int32)
    want = np.asarray(jm.ball_pool_sum(jnp.asarray(a), radius))
    got = tm.ball_pool_sum(torch.from_numpy(a), radius).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("radius", [1.6, 2.0, 3.0])
def test_ball_taps_match_offsets(radius):
    """The CUDA kernels' tap list is the JAX ball, in the same order."""
    taps = tm.ball_taps(radius)
    assert [tuple(t) for t in taps.tolist()] == list(jm.ball_offsets(radius))
    assert int(np.abs(taps).max()) == int(np.floor(radius))
