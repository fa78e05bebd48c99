"""The warp-combined DDA walk's schedule (K12, K15b-6c), modelled on the CPU.

On the card a warp's 32 rays step together; at each step the lanes whose
chord lies in an owned voxel group by that voxel, each group's chords are
summed in float64 to its lowest lane by pointer-jumping shuffles, and that
lane issues one float64 atomicAdd.  ``dda_warp_groups_plain`` is the plain
model of that schedule and ``raycast_dda_warp_plain`` adds its groups in a
shuffled order (the atomics land in any order) and rounds once.  Held here:

* within one float32 ulp of the float64 sum of the ungrouped emissions,
  rounded once (float64 partial sums are exact to ~1e-11 in any order);
* within K12_RAYLEN_RTOL = 5e-4 (chip_smoke.py) of ``raycast_dda_plain``
  and of JAX's ``raycast_dda``, the sequential float32 sums, whose own
  rounding is the difference; the same nonzero voxels;
* the slab form's rows bit-equal to the dense form's (the same groups, in
  the same order, over the owned rows), the slab's rays walked by
  K15b-6c's two rules: a ray whose z rows miss the slab is not walked,
  and a ray stops once its rows have passed the slab's;
* one add per (step, warp, voxel) group, far fewer than emissions where the
  rays leave one sensor as a beam row;
* the rays K15b-6c drops before walking (their z rows miss the slab) have
  no chord in it, rays ending on the slab's boundary planes included, and
  a walk by both rules emits the dense walk's emissions in the slab's rows
  and fewer outside them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.geometry import GridSpec as JGrid
from vofod_tpu.ops import raycast as jr
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops import raycast as tr

SHAPE, VS, ORIGIN = (12, 30, 40), 0.5, (-10.0, -7.5, -1.0)
MAX_LEN = 8.0
K12_RAYLEN_RTOL = 5e-4
GRID = GridSpec(ORIGIN, SHAPE, VS)
CASES = ("sensor", "sensor_ragged", "random", "axis")


def _rays(case: str, seed: int = 0):
    """(starts, dirs, lengths, valid): ``sensor`` rays leave points within
    3 cm of one sensor as beam rows of azimuth neighbours (a warp shares its
    first voxels for metres); ``sensor_ragged`` the same with 500 rays (a
    partial last warp) and random lengths; ``random`` and ``axis`` as
    tests/test_torch_exact_raycast.py, every warp diverging at once."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(ORIGIN) + 0.3, np.array(ORIGIN) + np.array(SHAPE[::-1]) * VS - 0.3
    R = 500 if case == "sensor_ragged" else 512
    if case.startswith("sensor"):
        rows, cols = 2, -(-R // 2)
        az = np.tile(np.linspace(0.0, 2.0 * np.pi, cols, endpoint=False), rows)[:R]
        el = np.repeat(np.linspace(-0.4, 0.4, rows), cols)[:R]
        dirs = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], 1)
        starts = np.array([0.1, 0.2, 1.6]) + rng.uniform(-0.03, 0.03, (R, 3))
        lengths = (rng.uniform(0.5, MAX_LEN, R) if case == "sensor_ragged"
                   else np.full(R, MAX_LEN - 0.5))
    else:
        starts = rng.uniform(lo, hi, (R, 3))
        dirs = rng.standard_normal((R, 3))
        lengths = rng.uniform(0.2, MAX_LEN, R)
        if case == "axis":
            dirs = np.repeat(np.concatenate([np.eye(3), -np.eye(3)]), R // 6 + 1, axis=0)[:R]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    valid = rng.random(R) < 0.9
    return tuple(torch.from_numpy(a) for a in (starts.astype(np.float32),
                                               dirs.astype(np.float32),
                                               lengths.astype(np.float32), valid))


def _f64_sum(rays, slab=None):
    fid, w = tr.dda_emissions_plain(GRID, *rays, MAX_LEN)
    e = torch.zeros(GRID.n_voxels, dtype=torch.float64).index_add_(0, fid, w.double())
    e = e.reshape(SHAPE)
    return e if slab is None else e[slab[0]:slab[0] + slab[1]]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("order_seed", [0, 1])
def test_within_one_ulp_of_the_float64_sum(case, order_seed):
    rays = _rays(case)
    got = tr.raycast_dda_warp_plain(GRID, *rays, MAX_LEN,
                                    order=torch.Generator().manual_seed(order_seed))
    want = _f64_sum(rays).float()
    ulp = torch.nextafter(want, torch.full_like(want, float("inf"))) - want
    assert torch.equal(got > 0, want > 0)
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("case", CASES)
def test_within_rtol_of_the_plain_version_and_jax(case):
    rays = _rays(case)
    got = tr.raycast_dda_warp_plain(GRID, *rays, MAX_LEN, order=torch.Generator().manual_seed(7))
    plain = tr.raycast_dda_plain(GRID, *rays, MAX_LEN)
    jax_ = torch.from_numpy(np.array(jr.raycast_dda(
        JGrid(ORIGIN, SHAPE, VS), *(jnp.asarray(t.numpy()) for t in rays), MAX_LEN)))
    for ref in (plain, jax_):
        nz = ref > 0
        assert torch.equal(got > 0, nz) and int(nz.sum()) > 100
        rel = ((got[nz].double() - ref[nz].double()).abs() / ref[nz].double()).max()
        assert float(rel) <= K12_RAYLEN_RTOL


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("slab", [(0, 4), (4, 4), (8, 4), (3, 5)])
def test_slab_rows_bit_equal_to_the_dense_form(case, slab):
    rays = _rays(case)
    dense = tr.raycast_dda_warp_plain(GRID, *rays, MAX_LEN)
    got = tr.raycast_dda_warp_plain(GRID, *rays, MAX_LEN, slab=slab)
    assert tuple(got.shape) == (slab[1], *SHAPE[1:])
    assert torch.equal(got, dense[slab[0]:slab[0] + slab[1]])
    want = _f64_sum(rays, slab).float()
    ulp = torch.nextafter(want, torch.full_like(want, float("inf"))) - want
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("case", CASES)
def test_one_add_per_group(case):
    """One add per (step, warp, voxel): the groups' sums add up to the
    emissions', and no two groups share a (step, warp, voxel)."""
    rays = _rays(case)
    fid, w, idx = tr.dda_emissions_plain(GRID, *rays, MAX_LEN, with_index=True)
    R = rays[0].shape[0]
    lf, sums = tr.dda_warp_groups_plain(GRID, *rays, MAX_LEN)
    keys = torch.stack([idx // R, (idx % R) // 32, fid], 1)
    assert len(lf) == len(torch.unique(keys, dim=0)) <= len(fid)
    assert abs(float(sums.sum()) - float(w.double().sum())) <= 1e-9 * float(w.double().sum())
    if case.startswith("sensor"):  # a warp's rays share their voxels for metres
        assert len(lf) * 3 < len(fid)


def _slab_rays(case: str, slab):
    """``_rays(case)``, or for ``boundary`` the sensor rays turned to end on
    the planes z0 and z0 + rows, or just short of or past them."""
    rays = _rays("sensor" if case == "boundary" else case)
    if case != "boundary":
        return rays
    starts, dirs, lengths, valid = rays
    zb = ORIGIN[2] + VS * torch.tensor([slab[0], slab[0] + slab[1]], dtype=torch.float32)
    target = zb[torch.arange(len(dirs)) % 2] + torch.tensor([0.0, -1e-4, 1e-4, -0.3])[
        torch.arange(len(dirs)) % 4]
    dz = torch.where(dirs[:, 2].abs() > 0.05, dirs[:, 2], 0.05)
    dirs = torch.cat([dirs[:, :2], dz[:, None]], 1)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    lengths = ((target - starts[:, 2]) / dirs[:, 2]).clamp(0.0, MAX_LEN)
    return starts, dirs, lengths, valid


@pytest.mark.parametrize("case", CASES + ("boundary",))
@pytest.mark.parametrize("slab", [(0, 4), (4, 4), (8, 4), (3, 5)])
def test_slab_skip_drops_no_chord(case, slab):
    rays = _slab_rays(case, slab)
    skip = tr.dda_slab_skips_plain(GRID, rays[0], rays[1], rays[2], slab)
    fid, w, idx = tr.dda_emissions_plain(GRID, *rays, MAX_LEN, with_index=True)
    z = fid // (SHAPE[1] * SHAPE[2])
    in_slab = (z >= slab[0]) & (z < slab[0] + slab[1])
    assert not bool((skip[idx % rays[0].shape[0]] & in_slab).any())
    if case in ("random", "axis"):
        assert int(skip.sum()) > 0


@pytest.mark.parametrize("case", CASES + ("boundary",))
@pytest.mark.parametrize("slab", [(0, 4), (4, 4), (8, 4), (3, 5)])
def test_slab_walk_keeps_the_slabs_emissions(case, slab):
    """A walk by K15b-6c's skip and stop rules emits, in the slab's rows,
    the dense walk's emissions (ids, chords and stream positions), and
    fewer emissions in all: the rules cut walking, not the slab's sums."""
    rays = _slab_rays(case, slab)
    z_of = lambda fid: fid // (SHAPE[1] * SHAPE[2])  # noqa: E731
    dense = tr.dda_emissions_plain(GRID, *rays, MAX_LEN, with_index=True)
    cut = tr.dda_emissions_plain(GRID, *rays, MAX_LEN, with_index=True, slab=slab)
    mine = [(z_of(e[0]) >= slab[0]) & (z_of(e[0]) < slab[0] + slab[1]) for e in (dense, cut)]
    assert int(mine[0].sum()) > 0
    for a, b in zip(dense, cut):
        assert torch.equal(a[mine[0]], b[mine[1]])
    if case != "boundary":  # (those rays end on the slab's planes: nothing to cut)
        assert len(cut[0]) < len(dense[0])
