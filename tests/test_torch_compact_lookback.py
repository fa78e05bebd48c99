"""K6's single-pass schedule (csrc/compact.cu) on the CPU: its plain model
``ops.compaction.masked_compact_lookback_plain`` held bit-equal to
vofod_tpu's ``masked_compact`` (ids, valid, total; the query form to JAX's
``far & any(labels[..., None] == sel)`` then ``masked_compact``).

The cases are where the schedule can go wrong: fewer elements than one
tile, an exact multiple of tiles, more tiles than run at once (the flagship
2,470,491 voxels), a mask starting at byte offsets 1-15 of its allocation
(the head and tail chunks read byte by byte), no set element, exactly
``capacity`` of them, more (tiles whose prefix passes the capacity write
nothing), a capacity above n, the query form with ``-2`` padding, and the
tiles stepping in ascending, reversed and random order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.ops.compaction import masked_compact as j_compact
from vofod_tpu_torch import kernels
from vofod_tpu_torch.ops.compaction import masked_compact_lookback_plain

TILE = kernels.COMPACT_TILE
N_SMALL = 31_680  # two tiles (one JAX compile for the cases of this size)


def _at_offset(values: np.ndarray, off: int) -> torch.Tensor:
    """``values`` as a bool view starting ``off`` bytes into a 64-byte
    aligned allocation."""
    base = torch.zeros(values.size + 64, dtype=torch.bool)
    start = (off - base.data_ptr()) % 64
    view = base[start:start + values.size]
    view.copy_(torch.from_numpy(values.reshape(-1)))
    assert view.data_ptr() % 16 == off % 16
    return view.reshape(values.shape)


def _tiles(n: int, off: int) -> int:
    return -(-(n + off) // TILE)


def _order(kind: str, n_tiles: int, seed: int):
    if kind == "ascending":
        return None
    if kind == "reversed":
        return list(range(n_tiles))[::-1]
    return np.random.default_rng(seed).permutation(n_tiles).tolist()


def _check(mask: np.ndarray, capacity: int, off: int, order: str, resident=None,
           seed: int = 0) -> int:
    view = _at_offset(mask, off)
    got = masked_compact_lookback_plain(
        view, capacity, order=_order(order, _tiles(mask.size, off), seed), resident=resident)
    jids, jvalid, jtotal = j_compact(jnp.asarray(mask), capacity)
    assert np.array_equal(got[0].numpy(), np.asarray(jids))
    assert np.array_equal(got[1].numpy(), np.asarray(jvalid))
    assert int(got[2]) == int(jtotal)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    return int(jtotal)


# (n, capacity, density, byte offset, order, resident tiles)
CASES = {
    "exact multiple of tiles, overflow": (3 * TILE, 4096, 0.3, 0, "reversed", None),
    "exact multiple, one resident": (3 * TILE, 4096, 0.01, 0, "random", 1),
    "flagship past resident": (2_470_491, 2048, 0.0005, 0, "random", 48),
    "flagship past resident, reversed": (2_470_491, 2048, 0.002, 5, "reversed", 40),
    "below one tile, cap > n": (500, 4096, 0.4, 3, "random", None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_lookback_schedule_matches_jax(name):
    n, cap, density, off, order, resident = CASES[name]
    mask = np.random.default_rng(n + cap).random(n) < density
    total = _check(mask, cap, off, order, resident, seed=n)
    if "overflow" in name or "reversed" in name:
        assert total > cap


@pytest.mark.parametrize("off", range(1, 16))
def test_lookback_byte_offsets(off):
    """A view starting at each byte offset: the head and tail chunks byte
    by byte, the rest as 16-byte loads; 2 tiles in random order."""
    n = N_SMALL
    mask = np.random.default_rng(off).random(n) < 0.01
    mask[:17] = True  # the head chunk, and the element after it
    mask[-17:] = True  # the tail chunk
    _check(mask, 256, off, "random", seed=off)


@pytest.mark.parametrize("kind", ["empty", "total = cap", "total > cap"])
def test_lookback_totals(kind):
    n, cap = N_SMALL, 256
    rng = np.random.default_rng(len(kind))
    mask = np.zeros(n, bool)
    if kind == "total = cap":
        mask[rng.choice(n, cap, replace=False)] = True
    elif kind == "total > cap":
        mask = rng.random(n) < 0.3
    total = _check(mask, cap, 9, "reversed", resident=2)
    assert total == {"empty": 0, "total = cap": cap}.get(kind, total)
    assert kind != "total > cap" or total > cap


@pytest.mark.parametrize("sel", [[3, -2, 7, -2], [-2, -2, -2, -2], list(range(0, 40, 2))])
def test_lookback_query_form(sel):
    """``far & isin(labels, sel)``, -2 matching nothing; 2 tiles."""
    shape, cap = (N_SMALL,), 256
    rng = np.random.default_rng(len(sel))
    far = rng.random(shape) < 0.3
    labels = rng.integers(0, 40, shape).astype(np.int32)
    sel = np.asarray(sel, np.int32)
    got = masked_compact_lookback_plain(
        _at_offset(far, 7), cap, torch.from_numpy(labels), torch.from_numpy(sel),
        order=_order("random", _tiles(far.size, 7), 1))
    qmask = jnp.asarray(far) & jnp.any(jnp.asarray(labels)[..., None] == jnp.asarray(sel),
                                       axis=-1)
    jids, jvalid, jtotal = j_compact(qmask, cap)
    assert np.array_equal(got[0].numpy(), np.asarray(jids))
    assert np.array_equal(got[1].numpy(), np.asarray(jvalid))
    assert int(got[2]) == int(jtotal)

