"""Parity of the port's ``masked_compact`` (prefix sum + searchsorted) with
vofod_tpu's (block totals + triangular MXU matmul): ids, valid and total are
integers and bools, bit-equal, including overflow past the capacity, an empty
mask and a full one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vofod_tpu.ops.compaction import masked_compact as j_compact
from vofod_tpu_torch.ops.compaction import masked_compact


def _mask(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(n, bool)
    if kind == "full":
        return np.ones(n, bool)
    density = {"sparse": 0.001, "dense": 0.3}[kind]
    return rng.random(n) < density


@pytest.mark.parametrize("kind", ["empty", "full", "sparse", "dense"])
@pytest.mark.parametrize("n,capacity", [(5000, 64), (2048, 2048), (300, 256), (40000, 4096)])
def test_masked_compact_bit_equal(kind, n, capacity):
    m = _mask(kind, n, seed=n + capacity)
    jids, jvalid, jtotal = j_compact(jnp.asarray(m), capacity)
    tids, tvalid, ttotal = masked_compact(torch.from_numpy(m), capacity)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert int(ttotal) == int(jtotal)
    assert tids.dtype == torch.int32


def test_masked_compact_grid_shape():
    """A 3-D grid compacts by flat id, as the classification uses it."""
    m = np.random.default_rng(0).random((6, 7, 9)) < 0.1
    jids, _, jtotal = j_compact(jnp.asarray(m), 32)
    tids, _, ttotal = masked_compact(torch.from_numpy(m), 32)
    assert np.array_equal(tids.numpy(), np.asarray(jids)) and int(ttotal) == int(jtotal)
