"""K13 and the exact-mode uses of K1 and K2: the plain versions of the
port's reference-exact sepclusters against vofod_tpu on the same inputs.

Every output here is integer, boolean, or float32 arithmetic that both
packages perform step for step in the same order, so every comparison is
bit-equal (measured: bit-equal):

* ``hascloseto_pool_any`` (the compat box as a K1 tap set) at r = 3.0
  (integer: the +3 axis extremes are missing) and r = 1.6;
* ``label_components`` run to convergence (K2 with gated launches): labels
  and ``converged``, in a converged case, in one that hits the cap and in
  one whose first sweep is already the fixpoint, and the sweep count the
  JAX while_loop runs;
* ``label_census`` (K13a) against ``DenseOps.label_census`` at leaf size 1
  and 2;
* ``_quirk_sure_counts`` (K13b) at leaf size 1, 2 and 3;
* ``run_sepclusters_exact`` (K13 as a whole with K13c's w1^k demotion): leaf
  size 1 (max_bg_distance 0.8 m at 0.5 m, the flagship) and 2 (1.2 m), the
  counted-indexing quirk on and off, the previous sure flag True and False,
  and an empty background — grid, safe, sure_bg_sufficient and converged.

Against the verbatim NumPy oracle ``tests/oracles.py sepclusters_exact_np``
(float64 EMA, one demotion per (cell, offset) pair) the grid agrees within
rtol 1e-5, atol 1e-4, the bound tests/test_sepclusters_exact.py holds the
JAX function to (measured max |Δ| below 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import sepclusters_exact_np
from vofod_tpu.config import Box as JBox, DynParams as JDyn, SensorConfig as JSensor
from vofod_tpu.config import VoFODConfig as JConfig
from vofod_tpu.ops.components import label_components as j_label_components
from vofod_tpu.ops.morphology import ball_pool_min, hascloseto_pool_any as j_hascloseto
from vofod_tpu.parallel.gridops import DENSE
from vofod_tpu.pipeline import sepclusters as js
from vofod_tpu_torch.config import Box, DynParams, SensorConfig, VoFODConfig
from vofod_tpu_torch.ops.components import label_census, label_components
from vofod_tpu_torch.ops.morphology import hascloseto_pool_any, hascloseto_taps
from vofod_tpu_torch.pipeline import sepclusters as ts

SHAPE = (9, 14, 17)


def _configs(**kw):
    j = JConfig(sensor=JSensor(vertical_rays=8, horizontal_rays=16),
                oparea=JBox((0, 0, 4), (12.0, 12.0, 12.0)), **kw)
    t = VoFODConfig(sensor=SensorConfig(vertical_rays=8, horizontal_rays=16),
                    oparea=Box((0, 0, 4), (12.0, 12.0, 12.0)), **kw)
    return j, t


def _scene(shape, seed, n_noise=80):
    """A sure slab (an anchor cluster), a sparse unsure clump and noise of
    bg / sure / air values."""
    rng = np.random.default_rng(seed)
    vals = np.full(shape, -740.0, np.float32)
    vals[1:3, 2:7, 2:8] = 0.0
    vals[4:6, 8:12, 9:15] = -200.0
    flat = vals.reshape(-1)
    idx = rng.integers(0, flat.size, size=n_noise)
    flat[idx] = rng.choice([-200.0, -50.0, 0.5, -900.0], size=n_noise).astype(np.float32)
    vals[0, 0, 0] = np.inf  # an apriori voxel
    return vals


@pytest.mark.parametrize("radius", [3.0, 1.6])
def test_hascloseto_bit_equal(radius):
    rng = np.random.default_rng(int(radius * 10))
    mask = rng.random(SHAPE) < 0.02
    want = np.asarray(j_hascloseto(jnp.asarray(mask), radius))
    got = hascloseto_pool_any(torch.from_numpy(mask), radius)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    taps = hascloseto_taps(radius)
    if radius == 3.0:  # the exclusive upper bound: (3,0,0), (0,3,0), (0,0,3) missing
        assert taps.min() == -3 and taps.max() == 2 and len(taps) == 120


def _serpentine(shape):
    """One voxel-wide corridor winding across the z = 0 plane: labels creep
    along it ~2 voxels per sweep at radius 2, so a small cap binds."""
    occ = np.zeros(shape, bool)
    _, ny, nx = shape
    for y in range(0, ny, 4):
        occ[0, y, :] = True
        if y + 4 < ny:
            end = nx - 1 if (y // 4) % 2 == 0 else 0
            occ[0, y:y + 4, end] = True
    return occ


@pytest.mark.parametrize("case", ["converged", "capped", "isolated"])
def test_label_components_bit_equal(case):
    rng = np.random.default_rng(3)
    if case == "converged":
        occ, radius, cap = rng.random(SHAPE) < 0.2, 2.0, 128
    elif case == "capped":
        occ, radius, cap = _serpentine(SHAPE), 2.0, 6
    else:  # voxels 3 apart: sweep 0 is already the fixpoint (an even cap)
        occ, radius, cap = np.zeros(SHAPE, bool), 2.0, 128
        occ[::3, ::3, ::3] = True
    jl, jc = j_label_components(jnp.asarray(occ), radius, cap)
    tl, tc, sweeps = label_components(torch.from_numpy(occ), radius, cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert bool(tc) == bool(jc) == (case != "capped")
    # the while_loop's sweep count (its body, eagerly): one past the last
    # sweep that changed something, or the cap
    flat = jnp.arange(occ.size, dtype=jnp.int32).reshape(occ.shape)
    lab, n = jnp.where(occ, flat, 2**31 - 1), 0
    while n < cap:
        new = jnp.where(occ, jnp.minimum(lab, ball_pool_min(lab, radius)), 2**31 - 1)
        n += 1
        if bool(jnp.all(new == lab)):
            break
        lab = new
    assert int(sweeps) == n
    assert (int(sweeps) < cap) == (case != "capped")
    if case == "isolated":
        assert n == 1


@pytest.mark.parametrize("lsz", [1, 2])
def test_label_census_bit_equal(lsz):
    rng = np.random.default_rng(4 + lsz)
    cshape = tuple(-(-n // lsz) for n in SHAPE)
    occ = rng.random(cshape) < 0.3
    sure_c = rng.integers(0, 5, cshape).astype(np.int32)
    labels, _ = j_label_components(jnp.asarray(occ), 3.0 / lsz, 128)
    ncv = occ.size
    want = np.asarray(jnp.where(jnp.asarray(occ), DENSE.label_census(
        labels, jnp.where(jnp.asarray(occ), jnp.asarray(sure_c), 0), ncv), 0))
    min_sure = 6.0
    got, flags = label_census(torch.from_numpy(np.array(labels)), torch.from_numpy(sure_c),
                              torch.from_numpy(occ), ncv, min_sure)
    np.testing.assert_array_equal(got.numpy(), want)
    assert flags.tolist() == [bool(occ.any()), bool((occ & (want >= min_sure)).any())]


@pytest.mark.parametrize("lsz", [1, 2, 3])
def test_quirk_sure_counts_bit_equal(lsz):
    vals = _scene(SHAPE, 10 + lsz)
    bg, sure = vals > -300.0, vals > -0.1
    want = np.asarray(js._quirk_sure_counts(jnp.asarray(bg), jnp.asarray(sure), lsz))
    got = ts.quirk_sure_counts(torch.from_numpy(bg), torch.from_numpy(sure), lsz)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    spec = np.asarray(js._pool_sum_coarse(jnp.asarray(bg & sure).astype(jnp.int32), lsz))
    assert want.sum() == spec.sum() and (want != spec).any()  # a real permutation


@pytest.mark.parametrize("max_bg,quirk,prev_sure", [  # leaf size 1 and 2 at 0.5 m
    (0.8, False, False), (0.8, True, True), (1.2, False, True), (1.2, True, False)])
def test_run_sepclusters_exact_bit_equal(max_bg, quirk, prev_sure):
    jcfg, tcfg = _configs(sepclusters_max_bg_distance=max_bg, compat_counted_indexing=quirk)
    shape = tcfg.grid_shape
    vals = _scene(shape, 20)
    its = 2.0
    jd = JDyn()
    jout = js.run_sepclusters_exact(jcfg, jd.as_arrays(), jnp.asarray(vals),
                                    jnp.zeros(shape, bool), jnp.float32(its),
                                    prev_sure=jnp.bool_(prev_sure))
    tout = ts.run_sepclusters_exact(tcfg, DynParams(), torch.from_numpy(vals), its,
                                    torch.tensor(prev_sure))
    np.testing.assert_array_equal(tout.grid.numpy(), np.asarray(jout.grid))
    np.testing.assert_array_equal(tout.safe.numpy(), np.asarray(jout.safe))
    assert bool(tout.sure_bg_sufficient) == bool(jout.sure_bg_sufficient)
    assert bool(tout.converged) == bool(jout.converged)
    assert bool(tout.sure_bg_sufficient)  # the slab is a sure cluster: demotions ran
    assert (tout.grid.numpy() != vals).any()
    want, want_suff = sepclusters_exact_np(
        vals, thr_new=jd.thr_new_obstacles, thr_sure=jd.thr_sure_obstacles,
        min_sure_points=jd.sepclusters_min_sure_points,
        max_dist_idx=max_bg / tcfg.voxel_size, score_ray=jd.score_ray, its_diff=its,
        quirk_indexing=quirk)
    assert bool(tout.sure_bg_sufficient) == want_suff
    np.testing.assert_allclose(tout.grid.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("prev_sure", [False, True])
def test_run_sepclusters_exact_empty_background(prev_sure):
    """No background voxel: the reference returns before touching the sure
    flag (ref :1155-1159), so the previous value is kept, nothing demotes."""
    jcfg, tcfg = _configs(compat_counted_indexing=True)
    vals = np.full(tcfg.grid_shape, -740.0, np.float32)
    jout = js.run_sepclusters_exact(jcfg, JDyn().as_arrays(), jnp.asarray(vals),
                                    jnp.zeros(vals.shape, bool), jnp.float32(1.0),
                                    prev_sure=jnp.bool_(prev_sure))
    tout = ts.run_sepclusters_exact(tcfg, DynParams(), torch.from_numpy(vals), 1.0,
                                    torch.tensor(prev_sure))
    assert bool(tout.sure_bg_sufficient) == bool(jout.sure_bg_sufficient) == prev_sure
    np.testing.assert_array_equal(tout.grid.numpy(), vals)
    assert not tout.safe.any() and bool(tout.converged)
