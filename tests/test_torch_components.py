"""K2 parity: seeded label propagation and reachability against vofod_tpu.

``label_components_seeded`` (fixed 8 sweeps, reversed flat-id keys) and
``propagate_reach`` (JAX: while_loop to the fixpoint or the cap; port: a
fixed number of sweeps with a device change flag) get the same seeded numpy
masks.  Labels, reach, ``converged`` and ``iters`` are integers and bools:
bit-equal, including components too long to converge within the sweeps
(components.py:120-134), where an in-place or multi-sweep kernel would drift.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vofod_tpu.ops import components as jc
from vofod_tpu_torch.ops import components as tc

SHAPE = (10, 14, 40)


def _masks(kind, seed):
    rng = np.random.default_rng(seed)
    occ = rng.random(SHAPE) < 0.12
    if kind == "long_line":
        # a 40-voxel rod: at r=3 it needs ~13 sweeps, more than the 8 allowed
        occ[:] = False
        occ[5, 7, :] = True
        occ[2, 3, 4:9] = True
    elif kind == "slab":
        occ[0:2, :, :] = True  # a large ground-like component on the edge
    seed_m = occ & (rng.random(SHAPE) < 0.05)
    if kind == "long_line":
        seed_m[:] = False
        seed_m[5, 7, 39] = True
    return occ, seed_m


@pytest.mark.parametrize("kind", ["random", "long_line", "slab"])
@pytest.mark.parametrize("radius", [2.0, 3.0])
def test_label_components_seeded_bit_equal(kind, radius):
    occ, seed = _masks(kind, seed=int(radius))
    jl, jr, jconv, jit = jc.label_components_seeded(
        jnp.asarray(occ), jnp.asarray(seed), radius, 8
    )
    tl, tr, tconv, tit = tc.label_components_seeded(
        torch.from_numpy(occ), torch.from_numpy(seed), radius, 8
    )
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert bool(tconv) == bool(jconv)
    assert int(tit) == int(jit)
    if kind == "long_line":
        assert not bool(tconv) and int(tit) == 8  # the cap case is exercised


@pytest.mark.parametrize("kind", ["random", "long_line", "slab"])
@pytest.mark.parametrize("max_iters", [2, 8])
def test_propagate_reach_bit_equal(kind, max_iters):
    occ, seed = _masks(kind, seed=5)
    jr, jconv = jc.propagate_reach(jnp.asarray(occ), jnp.asarray(seed), 2.0, max_iters)
    tr, tconv = tc.propagate_reach(torch.from_numpy(occ), torch.from_numpy(seed), 2.0, max_iters)
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert bool(tconv) == bool(jconv)

