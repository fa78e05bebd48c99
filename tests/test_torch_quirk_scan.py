"""K13b's column-walk design, modelled on the CPU.

On the card K13b (the reference's VoxelGridCounted indexing quirk) runs as
four passes: the (y, x) columns' sums, their exclusive prefix in export
order by a single-pass scan, a walk up each column writing the rank table,
and a single-pass scan over the cells.  ``quirk_counts_columnwalk_plain``
is the plain model of those passes; here it is held bit-equal to the
port's plain version ``quirk_sure_counts_plain`` and to JAX's
``_quirk_sure_counts``, at leaf sizes 1-3, on grids whose height the leaf
does not divide and whose column count is odd, on a random field, on no
bg, all bg and a single bg voxel, with the kernel's tiles and with tiles
small enough that every scan spans many of them.  The one-shard chain of
the grid-sharded form (columns, ranks at rank 0 of 1, cell queries) is
held to the same counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.pipeline import sepclusters as js
from vofod_tpu_torch import kernels
from vofod_tpu_torch.pipeline import sepclusters as ts

# (7, 5, 9): no leaf of 2 or 3 divides the height; (6, 11, 13): every leaf
# does; both have an odd column count
SHAPES = ((7, 5, 9), (6, 11, 13))
CASES = ("random", "no bg", "all bg", "single bg")


def _fields(case: str, shape, seed: int = 5):
    rng = np.random.default_rng(seed)
    sure = rng.random(shape) < 0.5
    if case == "random":
        bg = rng.random(shape) < 0.4
    elif case == "no bg":
        bg = np.zeros(shape, bool)
    elif case == "all bg":
        bg = np.ones(shape, bool)
    else:  # a sure bg voxel inside the grid, away from the first column
        bg = np.zeros(shape, bool)
        z, y, x = (s // 2 for s in shape)
        bg[z, y, x] = sure[z, y, x] = True
    return bg, sure


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lsz", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_columnwalk_model_bit_equal(case, lsz, shape):
    bg, sure = _fields(case, shape)
    want = np.asarray(js._quirk_sure_counts(jnp.asarray(bg), jnp.asarray(sure), lsz))
    tb, tsure = torch.from_numpy(bg), torch.from_numpy(sure)
    plain = ts.quirk_sure_counts_plain(tb, tsure, lsz)
    np.testing.assert_array_equal(plain.numpy(), want)
    for tiles in ((kernels.QUIRK_COL_TILE, kernels.QUIRK_CELL_TILE), (4, 8), (1, 1)):
        got = ts.quirk_counts_columnwalk_plain(tb, tsure, lsz, *tiles)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"tiles {tiles}")
    if case == "single bg":
        assert int(plain.sum()) == 1
    if case == "no bg":
        assert not plain.any()


@pytest.mark.parametrize("lsz", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_one_shard_chain_equals_dense(case, lsz):
    shape = SHAPES[1]
    bg, sure = (torch.from_numpy(a) for a in _fields(case, shape, seed=9))
    blocks = ts.quirk_columns_plain(bg, sure)[None]
    u, below = ts.quirk_ranks_plain(bg, sure, blocks, 0, bg.numel())
    assert int(below) == 0
    got = ts.quirk_query_plain(bg, lsz, u, below)
    assert torch.equal(got, ts.quirk_sure_counts_plain(bg, sure, lsz))
