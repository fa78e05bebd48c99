"""K11's demotion EMA and K13c as their kernels run them, on the CPU.

On the card both are K1's streamed run-table pool (csrc/ball_pool.cuh)
with their own staging and store (csrc/ema.cu): K11 stages ``bg & ~safe``
while loading and applies ``w1 v + c`` where the int8 ball max is set;
K13c stages the extended-lattice centres of the unsure coarse cells and
applies ``w1^k v + (1 - w1^k) score`` for their ball sum k, writing
``safe`` beside the grid.  Their plain models (``demote_ema_runs_plain``,
``exact_demote_runs_plain``: ``ball_pool_runs_plain`` with the staging
rule and the epilogue, at the kernel's int8 tile and several z chunks)
are held here, on the same seeded numpy inputs:

* inside the port's sepclusters stage, in place of the kernel, bit-equal
  to vofod_tpu ``run_sepclusters`` / ``run_sepclusters_exact`` (grid,
  safe, sure flag): static 0.8 and 1.2 m, the traced shells of a 2.0 m
  bound at 1.9 m, a halo-7 ball, leaf sizes 1, 2 and 3 on a grid that is
  no multiple of them, no sure cluster and an empty background;
* bit-equal to today's plain versions (``demote_ema_plain``,
  ``exact_demote_ema_plain``), also on random masks and through a z
  window with z_off > 0 and zc_lo > 0 (a shard of 2), whose rows equal the
  dense model's.

At leaf sizes 2 and 3 the scene has unsure boundary cells whose centres
lie outside the fine grid: a staging that masks them by the fine grid is
checked to differ from JAX.  All outputs are integer masks or float32
arithmetic in the same order: the tolerance is zero.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.config import DynParams as JDyn, VoFODConfig as JConfig
from vofod_tpu.pipeline import sepclusters as js
from vofod_tpu_torch.config import DynParams, VoFODConfig
from vofod_tpu_torch.ops import morphology as tm
from vofod_tpu_torch.ops.components import label_census, label_components
from vofod_tpu_torch.pipeline import sepclusters as ts

SHAPE = (11, 19, 21)
SHAPE_LSZ = (11, 13, 19)  # odd, and 1 mod 3 in y and x: boundary centres fall outside
ZCHUNKS = [1, 4, 11]

# (config kw, dyn kw, scene) per stage case
STAGES = {
    "static 0.8 m": (dict(), dict(), "specks"),
    "static 1.2 m": (dict(sepclusters_max_bg_distance=1.2), dict(), "specks"),
    "shells, 2.0 m bound at 1.9 m": (
        dict(dynamic_radii=True, sepclusters_max_bg_distance_bound=2.0,
             ground_points_max_distance_bound=2.0), dict(sepclusters_max_bg_distance=1.9),
        "specks"),
    "halo 7 (3.995 m)": (dict(sepclusters_max_bg_distance=3.995), dict(), "specks"),
    "no sure cluster": (dict(), dict(), "unsure"),
    "empty background": (dict(), dict(), "air"),
}


def _scene(shape, kind, seed):
    """Air; with "specks" a sure slab in one corner and background specks
    in the far one, beyond the reach of every radius here (unsafe: demoted
    where a sure cluster exists), with "unsure" the specks alone (no seed:
    sure_sufficient False)."""
    rng = np.random.default_rng(seed)
    vals = np.full(shape, -900.0, np.float32)
    if kind == "air":
        return vals
    if kind == "specks":
        vals[:2, :6, :6] = 0.5
    far = vals[4:, 12:, 14:]
    far[rng.random(far.shape) < 0.1] = -200.0
    return vals


@functools.lru_cache(maxsize=None)
def _jax_stage(case):
    kw, dkw, kind = STAGES[case]
    vals = _scene(SHAPE, kind, 7)
    prev_safe = np.zeros(SHAPE, bool)  # a warm start inside the slab only
    prev_safe[:2, :6, :6] = np.random.default_rng(8).random((2, 6, 6)) < 0.5
    stage = functools.partial(js.run_sepclusters, JConfig(**kw))
    if kw.get("dynamic_radii"):  # its traced pools take ~20 s op by op, ~5 s jitted
        stage = jax.jit(stage)
    jo = stage(JDyn(**dkw).as_arrays(), jnp.asarray(vals), jnp.asarray(prev_safe),
               jnp.float32(2.0), prev_sure=jnp.bool_(False))
    return vals, prev_safe, (np.asarray(jo.grid), np.asarray(jo.safe),
                             bool(jo.sure_bg_sufficient))


@pytest.mark.parametrize("zchunk", ZCHUNKS)
@pytest.mark.parametrize("case", list(STAGES))
def test_demote_model_in_the_stage_bit_equal_to_jax(case, zchunk, monkeypatch):
    kw, dkw, kind = STAGES[case]
    vals, prev_safe, (j_grid, j_safe, j_sure) = _jax_stage(case)
    calls = []

    def model(v, b, s, sure, ball, w1, c):
        got = ts.demote_ema_runs_plain(v, b, s, sure, ball, w1, c, zchunk)
        assert torch.equal(got, ts.demote_ema_plain(v, b, s, sure, ball, w1, c))
        calls.append(tm.tap_set(ball)[1])
        return got

    monkeypatch.setattr(ts, "demote_ema", model)
    out = ts.run_sepclusters(VoFODConfig(**kw), DynParams(**dkw), torch.from_numpy(vals),
                             torch.from_numpy(prev_safe), 2.0, torch.tensor(False))
    assert len(calls) == 1
    np.testing.assert_array_equal(out.grid.numpy(), j_grid)
    np.testing.assert_array_equal(out.safe.numpy(), j_safe)
    assert bool(out.sure_bg_sufficient) == j_sure == (kind == "specks")
    assert (j_grid != vals).any() == (kind == "specks")  # demotions ran where they should
    if case.startswith("halo 7"):
        assert calls == [7]


BALLS = [pytest.param(1.6, id="r1.6"), pytest.param(2.4, id="r2.4"),
         pytest.param(tm.Shells(4.0, float(np.float32(3.8) * np.float32(3.8))),
                      id="shells-b4-1.9m"),
         pytest.param(7.99, id="r7.99-halo7")]


@pytest.mark.parametrize("zchunk", [2, 5])
@pytest.mark.parametrize("ball", BALLS)
def test_demote_model_random_masks(ball, zchunk):
    rng = np.random.default_rng(31)
    vals = torch.from_numpy(rng.uniform(-1000.0, 0.0, SHAPE).astype(np.float32))
    bg = torch.from_numpy(rng.random(SHAPE) < 0.05)
    safe = torch.from_numpy(rng.random(SHAPE) < 0.5)
    w1, c = ts.demote_weights(3.0, -999.9)
    for sure in (True, False):
        got = ts.demote_ema_runs_plain(vals, bg, safe, torch.tensor(sure), ball, w1, c, zchunk)
        want = ts.demote_ema_plain(vals, bg, safe, torch.tensor(sure), ball, w1, c)
        assert torch.equal(got, want)
        assert bool((got != vals).any()) == sure


# ---- K13c ----

# (max_bg_distance, counted-indexing quirk, scene)
EXACT = {
    "lsz 1 (0.8 m)": (0.8, True, "boundary"),
    "lsz 2 (1.2 m)": (1.2, False, "boundary"),
    "lsz 2 (1.2 m), quirk": (1.2, True, "boundary"),
    "lsz 3 (1.8 m)": (1.8, False, "boundary"),
    "lsz 2, no sure cluster": (1.2, False, "unsure"),
    "lsz 2, empty background": (1.2, False, "air"),
}


def _exact_scene(shape, kind, seed):
    """Air; a sure slab at the low corner (a sure cluster) unless "unsure",
    and unsure background voxels, some on the grid's last plane, row and
    column (cells whose centres lie outside at leaf sizes 2 and 3)."""
    vals = np.full(shape, -740.0, np.float32)
    if kind == "air":
        return vals
    nz, ny, nx = shape
    if kind != "unsure":
        vals[0:2, 1:6, 1:7] = 0.0
    for z, y, x in ((nz - 1, ny - 1, nx - 1), (nz - 2, ny - 1, 4), (5, ny - 1, nx - 1),
                    (nz - 1, 6, nx - 1), (7, 8, 10), (nz - 1, ny - 1, 12)):
        vals[z, y, x] = -200.0
    rng = np.random.default_rng(seed)
    vals[3:][rng.random((nz - 3,) + shape[1:]) < 0.01] = -200.0
    return vals


def _exact_cfg(max_bg, quirk):
    kw = dict(sepclusters_exact_census=True, sepclusters_max_bg_distance=max_bg,
              compat_counted_indexing=quirk)
    return JConfig(**kw), VoFODConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_exact(case):
    max_bg, quirk, kind = EXACT[case]
    vals = _exact_scene(SHAPE_LSZ, kind, 9)
    jo = js.run_sepclusters_exact(_exact_cfg(max_bg, quirk)[0], JDyn().as_arrays(),
                                  jnp.asarray(vals), jnp.zeros(SHAPE_LSZ, bool),
                                  jnp.float32(2.0), prev_sure=jnp.bool_(False))
    return vals, (np.asarray(jo.grid), np.asarray(jo.safe), bool(jo.sure_bg_sufficient))


def _fine_masked(stage, shape, z_off=0):
    """A staging that masks the centres by the fine grid (wrong at lsz >= 2)."""
    nz, ny, nx = shape

    def masked(zi, rows, cols):
        out = stage(zi, rows, cols)
        if not 0 <= zi < nz:
            return torch.zeros_like(out)
        keep = ((rows >= 0) & (rows < ny))[:, None] & ((cols >= 0) & (cols < nx))[None, :]
        return torch.where(keep, out, torch.zeros_like(out))

    return masked


@pytest.mark.parametrize("zchunk", ZCHUNKS)
@pytest.mark.parametrize("case", list(EXACT))
def test_exact_model_in_the_stage_bit_equal_to_jax(case, zchunk, monkeypatch):
    max_bg, quirk, kind = EXACT[case]
    vals, (j_grid, j_safe, j_sure) = _jax_exact(case)
    args = []

    def model(*a):
        got = ts.exact_demote_runs_plain(*a, zchunk)
        want = ts.exact_demote_ema_plain(*a)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        args.append(a)
        return got

    monkeypatch.setattr(ts, "exact_demote_ema", model)
    out = ts.run_sepclusters_exact(_exact_cfg(max_bg, quirk)[1], DynParams(),
                                   torch.from_numpy(vals), 2.0, torch.tensor(False))
    assert len(args) == 1
    np.testing.assert_array_equal(out.grid.numpy(), j_grid)
    np.testing.assert_array_equal(out.safe.numpy(), j_safe)
    assert bool(out.sure_bg_sufficient) == j_sure == (kind == "boundary")
    assert (j_grid != vals).any() == (kind == "boundary")
    lsz = args[0][5]
    assert lsz == max(math.ceil(max_bg / 0.5) - 1, 1)
    if kind == "boundary" and lsz > 1 and zchunk == ZCHUNKS[0]:
        # the scene's boundary centres matter: masked by the fine grid, the
        # demotion differs from JAX's
        v, occ_c, census, _, _, _, radius, min_sure, w1, score, _, _ = args[0]
        stage = ts.centre_stage(occ_c, census, lsz, min_sure, *occ_c.shape)
        k = tm.ball_pool_runs_plain(torch.empty_like(v, dtype=torch.int8), tm.run_table(radius),
                                    "sum", 0, (16, 128), zchunk, _fine_masked(stage, v.shape))
        w1k = torch.pow(w1, k.to(torch.float32))
        assert not np.array_equal((w1k * v + (1.0 - w1k) * score).numpy(), j_grid)


def _coarse_inputs(vals, max_bg):
    """The K13c inputs of the port's exact stage (quirk off) on ``vals``."""
    dyn = DynParams()
    radius = max_bg / 0.5
    mv = math.ceil(radius)
    lsz = max(mv - 1, 1)
    bg, sure = vals > dyn.thr_new_obstacles, vals > dyn.thr_sure_obstacles
    occ_c = ts.pool_sum_coarse(bg.to(torch.int32), lsz) > 0
    sure_c = ts.pool_sum_coarse((bg & sure).to(torch.int32), lsz)
    labels, _, _ = label_components(occ_c, mv / lsz, 128)
    min_sure = float(np.float32(dyn.sepclusters_min_sure_points))
    census, flags = label_census(labels, sure_c, occ_c, occ_c.numel(), min_sure)
    return radius, lsz, occ_c, census, flags, min_sure


@pytest.mark.parametrize("zchunk", [1, 3])
@pytest.mark.parametrize("max_bg", [0.8, 1.2, 1.8])
def test_exact_model_window_rows(max_bg, zchunk):
    """Shard 1 of 2 (rows 6-11 of 12): its slab and the coarse rows of its
    halo window, z_off and zc_lo > 0, against the dense model's rows and the
    windowed plain version."""
    shape = (12,) + SHAPE_LSZ[1:]
    vals = torch.from_numpy(_exact_scene(shape, "boundary", 10))
    radius, lsz, occ_c, census, flags, min_sure = _coarse_inputs(vals, max_bg)
    prev = torch.tensor(False)
    consts = (min_sure, ts.demote_weights(2.0, -1000.0)[0], -1000.0, -300.0)
    dense = ts.exact_demote_runs_plain(vals, occ_c, census, flags, prev, lsz, radius, *consts,
                                       None, zchunk)
    assert bool(dense[2]) and (dense[0] != vals).any()
    z_off, hc = 6, -(-int(math.floor(radius)) // lsz)
    zc_lo = z_off // lsz - hc
    held = slice(zc_lo, min(occ_c.shape[0], -(-shape[0] // lsz) + hc))
    assert z_off > 0 and zc_lo > 0
    window = (z_off, zc_lo, occ_c.shape[0])
    args = (vals[z_off:].contiguous(), occ_c[held].contiguous(), census[held].contiguous(),
            flags, prev, lsz, radius, *consts, window)
    got = ts.exact_demote_runs_plain(*args, zchunk)
    want = ts.exact_demote_ema_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(got[0], dense[0][z_off:]) and torch.equal(got[1], dense[1][z_off:])
    assert (got[0] != vals[z_off:]).any()


@pytest.mark.parametrize("zchunk", [1, 3, 11])
def test_empty_tiles_skip_their_pool(zchunk):
    """A tile and chunk whose staged values are all 0 pools nothing (the
    max's identity, -128, where the pool gives 0): K11's epilogue reads
    both as "not set", so its grid is the same, and tiles that stage a set
    value pool as before."""
    unsafe = torch.zeros(SHAPE, dtype=torch.int8)  # set voxels in one corner: tiles empty
    unsafe[7:, :8][torch.from_numpy(np.random.default_rng(3).random((4, 8, 21)) < 0.1)] = 1
    table, tile = tm.run_table(1.6), (16, 128)
    pooled = tm.ball_pool_runs_plain(unsafe, table, "max", 0, tile, zchunk)
    skipped = tm.ball_pool_runs_plain(unsafe, table, "max", 0, tile, zchunk, skip_empty=True)
    empty = skipped == -128
    assert empty.any() and (~empty).any()
    assert torch.equal(pooled[empty], torch.zeros_like(pooled[empty]))
    assert torch.equal(pooled[~empty], skipped[~empty])
    assert torch.equal(pooled > 0, skipped > 0)
