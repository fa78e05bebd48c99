"""Parity of the port's ``masked_compact`` (prefix sum + searchsorted) with
vofod_tpu's (block totals + triangular MXU matmul): ids, valid and total are
integers and bools, bit-equal, including overflow past the capacity, an empty
mask and a full one.  The query form ``masked_compact_isin`` is held to the
JAX classify's ``far & any(labels[..., None] == sel)`` followed by
``masked_compact``, with ``-2`` entries in ``sel`` matching nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vofod_tpu.ops.compaction import masked_compact as j_compact
from vofod_tpu_torch.ops.compaction import masked_compact, masked_compact_isin


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


@pytest.mark.parametrize("sel", [
    [3, -2, 7, -2],  # some labels, -2 padding
    [-2, -2, -2, -2],  # nothing gated: an empty selection
    list(range(0, 40, 2)),  # half the labels: overflows the small capacity
])
@pytest.mark.parametrize("shape,capacity", [((6, 7, 9), 16), ((12, 20, 33), 256)])
def test_masked_compact_isin_bit_equal(sel, shape, capacity):
    rng = np.random.default_rng(len(sel) + capacity)
    far = rng.random(shape) < 0.3
    labels = rng.integers(0, 40, shape).astype(np.int32)
    sel = np.asarray(sel, np.int32)
    qmask = jnp.asarray(far) & jnp.any(jnp.asarray(labels)[..., None] == jnp.asarray(sel), axis=-1)
    jids, jvalid, jtotal = j_compact(qmask, capacity)
    tids, tvalid, ttotal = masked_compact_isin(
        torch.from_numpy(far), torch.from_numpy(labels), torch.from_numpy(sel), capacity
    )
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert int(ttotal) == int(jtotal)
