"""K15b-7a's cut and K15b-7c's stores in K15b-7b's walk, on the CPU.

The sequential explore over z shards (parallel/gridops.py
``ZShardOps.explore_sequential``) cuts each shard's band and ground words of
the queries' submaps (K15b-7a), psums the stack, walks it (K15b-7b) and
writes the failed queries' demotions into each shard's slab (K15b-7c).  On
the card the cut runs a block a (slot, chunk of z planes), and the walk's
launch stores the demotions itself as each query fails.  Held here:

* the cut's schedule block by block (``ops/explore.explore_cut_blocks_plain``:
  the planes each block loads, the ranges it zeroes, the rows each warp
  takes) bit-equal to ``explore_cut_plain`` at S 16, 32 and 40, under the
  kernel's schedule, one block a slot at 16 warps and 3 planes on 2 warps,
  on boxes that straddle a seam, miss the slab, run past the grid's x, y
  and z edges, and invalid slots, at ``z_lo`` 0 and of a middle shard; the
  psum of the shards' cuts is the whole grid's;
* the fused launch's plain model (``explore_seq_fused_plain``: the walk,
  then plain stores of thr_frontiers on the slab's window) against the CPU
  path (``explore_sequential_stack_plain``, then ``demote_direct_plain``)
  at 2, 3 and 4 shards, slab and count, on failed floods that cross seams;
  the counts' sum is the dense ``explore_sequential_plain``'s, and a shard
  with no reached voxel counts 0;
* the shards' fused slabs against the JAX package's sequential explore
  (tests/test_torch_seq_speculate.py's ``lax.scan`` walk), and
  ``ZShardOps.explore_sequential`` against the dense plain K7s.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_seq_speculate import (AIR, CASES, GND, ORIGIN, SHAPE, THR_F, THR_G, UNK,
                                            VOXEL, _jax_walk)
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu_torch import kernels
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.explore import (cut_block_planes, demote_direct_plain,
                                         explore_cut_blocks_plain, explore_cut_plain,
                                         explore_seq_fused_plain, explore_sequential_plain,
                                         explore_sequential_stack_plain, unpack_rows)
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.gridops import ZShardOps

# ---- K15b-7a: the cut ---------------------------------------------------------------

CUT_SHAPE = (21, 18, 19)  # three slabs of 7 planes; odd widths
SLAB = 7


def _cut_case(S: int, seed: int = 5):
    """A field of air / band / ground (50 / 40 / 10 %) with 2 % NaN, and
    24 query slots: 12 random voxels (two of them invalid slots), boxes on
    the seams (z 7 and 14), one whose S = 16 box misses the first slab (z
    20), and the grid's corners and edges in x, y and z."""
    rng = np.random.default_rng(seed + S)
    nz, ny, nx = CUT_SHAPE
    u = rng.random(CUT_SHAPE)
    vals = np.where(u < 0.5, AIR, np.where(u < 0.9, UNK, GND)).astype(np.float32)
    vals[rng.random(CUT_SHAPE) < 0.02] = np.nan
    special = [(7, 9, 9), (14, 4, 12), (20, 9, 9), (0, 0, 0), (nz - 1, ny - 1, nx - 1),
               (3, 0, nx - 1), (10, ny - 1, 0), (13, 9, 0), (6, 0, 9), (SLAB - 1, 5, 5),
               (2 * SLAB, ny - 2, 1), (1, 1, nx - 2)]
    pts = [tuple(int(rng.integers(0, d)) for d in CUT_SHAPE) for _ in range(12)] + special
    qz, qy, qx = (torch.tensor([p[k] for p in pts], dtype=torch.int32) for k in range(3))
    qvalid = torch.tensor([i not in (4, 9) for i in range(len(pts))])
    return torch.from_numpy(vals), qx, qy, qz, qvalid


SCHEDULES = {"kernel's": (None, None), "one block a slot": ("S", 16), "3 planes, 2 warps": (3, 2)}


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("z_lo", [0, SLAB])
@pytest.mark.parametrize("S", [16, 32, 40])
def test_cut_blocks_equal_plain(S, z_lo, sched):
    """The cut's blocks, zero ranges and warps' rows (each word written
    once, or the model raises) give explore_cut_plain's stack."""
    vals, qx, qy, qz, qvalid = _cut_case(S)
    slab = vals[z_lo:z_lo + SLAB].contiguous()
    planes, warps = SCHEDULES[sched]
    got = explore_cut_blocks_plain(slab, qx, qy, qz, qvalid, THR_F, THR_G, S, z_lo,
                                   S if planes == "S" else planes, warps)
    want = explore_cut_plain(slab, qx, qy, qz, qvalid, THR_F, THR_G, S, z_lo)
    assert got.dtype == want.dtype == kernels.stack_words(S)
    assert torch.equal(got, want)
    assert bool((want[~qvalid] == 0).all()) and bool((want[qvalid] != 0).any())


@pytest.mark.parametrize("S", [16, 32, 40])
def test_cut_psum_is_whole_grid(S):
    """Each submap row has one owner: the sum of the three slabs' cuts is the
    cut of the whole grid (the psum of the stack)."""
    vals, qx, qy, qz, qvalid = _cut_case(S)
    parts = [explore_cut_blocks_plain(vals[z:z + SLAB].contiguous(), qx, qy, qz, qvalid, THR_F,
                                      THR_G, S, z).to(torch.int64)
             for z in range(0, CUT_SHAPE[0], SLAB)]
    whole = explore_cut_plain(vals, qx, qy, qz, qvalid, THR_F, THR_G, S)
    assert torch.equal(sum(parts).to(whole.dtype), whole)


@pytest.mark.parametrize("name", ["CUT_PLANES", "CUT_WARPS", "CUT_ROWS"])
def test_cut_constants_mirror_the_kernel(name):
    """The plain model's schedule is the kernel's: kernels.py's constant
    equals csrc/explore.cu's."""
    src = (Path(kernels.__file__).parent / "csrc" / "explore.cu").read_text()
    found = re.findall(rf"^constexpr int {name} = (\d+);", src, flags=re.M)
    assert found == [str(getattr(kernels, name))]


def test_cut_block_planes():
    """A block loads exactly its planes inside the slab: the chunks' load
    ranges tile the slab's planes of the box, a box that misses the slab and
    an invalid slot load nothing, and a box straddling the seam loads only
    its own side."""
    for S, planes in ((16, 4), (32, 4), (32, 32), (40, 3), (15, 7)):
        for z0 in range(-S - 2, 25):
            for z_lo, nz in ((0, 7), (7, 7), (14, 7)):
                loads, zeroed = set(), set()
                for c in range(-(-S // planes)):
                    p0, p1, za, zb = cut_block_planes(S, planes, c, z0, z_lo, nz, True)
                    assert p0 <= za <= zb <= p1
                    loads |= set(range(za, zb))
                    zeroed |= set(range(p0, za)) | set(range(zb, p1))
                    none = cut_block_planes(S, planes, c, z0, z_lo, nz, False)
                    assert none[2] == none[3] == p1
                want = {z for z in range(S) if z_lo <= z0 + z < z_lo + nz}
                assert loads == want and zeroed == set(range(S)) - want
    # the fixture's cases: the z 20 box misses slab 0, the z 7 box straddles
    vals, qx, qy, qz, qvalid = _cut_case(16)
    stack = explore_cut_plain(vals[:SLAB].contiguous(), qx, qy, qz, qvalid, THR_F, THR_G, 16, 0)
    seam, far = 12, 14  # the first and third of the special slots
    assert int(qz[seam]) == 7 and int(qz[far]) == 20
    assert bool(qvalid[far]) and bool((stack[far] == 0).all())
    # its box's planes 1-7 are slab 0's rows 0-6; plane 0 lies below the grid
    assert bool((stack[seam][:, 1:8] != 0).any())
    assert bool((stack[seam][:, :1] == 0).all()) and bool((stack[seam][:, 8:] == 0).all())


# ---- K15b-7b's walk with K15b-7c's stores ------------------------------------------

N_Z = SHAPE[0]


def _slabs(n: int) -> list[tuple[int, int]]:
    """n slabs of the grid's z rows as [z_lo, z_hi): equal ones where n
    divides the rows, else the last one shorter (20 = 7 + 7 + 6)."""
    step = -(-N_Z // n)
    return [(z, min(z + step, N_Z)) for z in range(0, N_Z, step)]


_MADE = {}


def _case(name):
    if name not in _MADE:
        vals, t, S, mi, ov = CASES[name]()
        q = tuple(torch.from_numpy(np.asarray(t[k])) for k in (
            "qx", "qy", "qz", "qvalid", "qlabels", "qids", "qslot", "mm")) + (torch.tensor(ov),)
        _MADE[name] = (torch.from_numpy(vals), q, S, mi)
    return _MADE[name]


FUSED_CASES = ["random S16", "random S40", "chain", "max_iters 8"]


@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("name", FUSED_CASES)
def test_fused_walk_equals_walk_then_stores(name, n_shards):
    """Each shard's slab and count from the fused model equal the walk,
    then demote_direct_plain on its window; the counts sum to the dense
    K7s's, the slabs make its grid, and a shard with no reached voxel in
    its rows counts 0."""
    vals, q, S, mi = _case(name)
    grid = GridSpec(ORIGIN, SHAPE, VOXEL)
    stack = explore_cut_plain(vals, *q[:4], THR_F, THR_G, S)
    walk = explore_sequential_stack_plain(grid, stack, *q, mi)
    dg, _, dn = explore_sequential_plain(grid, vals.clone(), *q, THR_F, THR_G, S, mi)
    conn, reached, corners, demoted = walk
    bits = unpack_rows(reached.to(torch.int64) & ((1 << S) - 1), S) & demoted[:, None, None, None]
    gz = corners[:, 0].long()[:, None] + torch.arange(S)  # [Q, S] each box plane's grid z
    slabs, total, empty = [], 0, 0
    for z_lo, z_hi in _slabs(n_shards):
        slab = vals[z_lo:z_hi].contiguous()
        got = explore_seq_fused_plain(grid, stack, slab, z_lo, *q, THR_F, mi)
        want_slab, want_n = demote_direct_plain(slab, reached, corners, demoted, THR_F,
                                                (z_lo, N_Z))
        assert torch.equal(got[0], want_slab) and torch.equal(got[5], want_n)
        for a, b in zip(got[1:5], walk):
            assert torch.equal(a, b)
        assert torch.equal(slab, vals[z_lo:z_hi])  # the model returns a new slab
        mine = ((gz >= z_lo) & (gz < z_hi))[:, :, None] & bits.any(-1)
        if not bool(mine.any()):
            assert int(got[5]) == 0
            empty += 1
        slabs.append(got[0])
        total += int(got[5])
    assert total == int(dn) and torch.equal(torch.cat(slabs), dg)
    if name == "chain" and n_shards == 4:  # the pocket (z 9-11) crosses the seam at 10
        assert empty == 2 and int(demoted.sum()) == 7 and total == 27


def test_fused_floods_cross_seams():
    """The cases' failed floods do cross the seams the fused test cuts at."""
    for name in FUSED_CASES:
        vals, q, S, mi = _case(name)
        grid = GridSpec(ORIGIN, SHAPE, VOXEL)
        stack = explore_cut_plain(vals, *q[:4], THR_F, THR_G, S)
        _, reached, corners, demoted = explore_sequential_stack_plain(grid, stack, *q, mi)
        z = []
        for k in torch.nonzero(demoted)[:, 0].tolist():
            zz = torch.nonzero(unpack_rows(reached[k].to(torch.int64) & ((1 << S) - 1), S))[:, 0]
            z.append((int(corners[k, 0]) + zz).unique())
        seams = {lo for n in (2, 3, 4) for lo, _ in _slabs(n)[1:]}
        assert any(bool(((zz < s).any() & (zz >= s).any())) for zz in z for s in seams), name


@pytest.mark.parametrize("name", ["random S32", "chain", "disjoint"])
def test_fused_slabs_against_jax(name):
    """Three shards' fused slabs make the grid the JAX package's sequential
    explore leaves, and their counts its demoted voxels."""
    vals, q, S, mi = _case(name)
    grid = GridSpec(ORIGIN, SHAPE, VOXEL)
    stack = explore_cut_plain(vals, *q[:4], THR_F, THR_G, S)
    outs = [explore_seq_fused_plain(grid, stack, vals[a:b].contiguous(), a, *q, THR_F, mi)
            for a, b in _slabs(3)]
    jv, jc, _, jd = _jax_walk(SHAPE, S, mi, q[0].shape[0], q[6].shape[1])(
        *(x.numpy() for x in (vals,) + q))
    got = torch.cat([o[0] for o in outs]).numpy()
    assert np.array_equal(got, np.asarray(jv))
    assert np.array_equal(outs[0][1].numpy(), np.asarray(jc))
    assert np.array_equal(outs[0][4].numpy(), np.asarray(jd))
    assert sum(int(o[5]) for o in outs) == int((got != vals.numpy()).sum()) > 0


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("name", ["random S16", "chain"])
def test_zshard_sequential_equals_dense(name, n_shards):
    """ZShardOps.explore_sequential on the CPU (the cut, its psum, the walk,
    then demote_direct_plain) is the dense plain K7s: grid, cluster_connected
    and count on every shard."""
    vals, q, S, mi = _case(name)
    assert mi == 96  # the grid path's max_iters
    grid = GridSpec(ORIGIN, SHAPE, VOXEL)
    comm = LocalComm(n_shards, ["cpu"], timeout=120.0)
    ops = ZShardOps(comm, n_shards)
    nzl = N_Z // n_shards
    outs = comm.run(lambda r: ops.explore_sequential(
        grid, vals[r * nzl:(r + 1) * nzl].clone(), *q, THR_F, THR_G, S))
    dg, dc, dn = explore_sequential_plain(grid, vals.clone(), *q, THR_F, THR_G, S)
    assert torch.equal(torch.cat([o[0] for o in outs]), dg)
    for _, c, n in outs:
        assert torch.equal(c, dc) and torch.equal(n, dn)
