"""K15b-1 as the H100 kernel runs it, and the sharded K2 sweeps that fill
their halo rows in place, on the CPU.

* The plain model of the kernel's segment table
  (vofod_tpu_torch/parallel/gridops.py ``halo_segments``, run byte range by
  byte range and tile by tile by ``halo_exchange_segments_plain``) against
  ``halo_exchange_plain`` and the rows cut from the whole grid, on the
  blocks ``ZShardOps.halo_recv`` receives at 4 CPU shards: r = 0, 1, 3 (one
  hop), 16 (four hops of a 5-row slab, the last past every shard) and 23
  (five hops), f32 / int32 / uint8 / bool, slab addresses at every
  alignment the kernel takes, planes of one tile and of several.
* ``halo_fill_plain_`` (the in-place form) against ``halo_exchange_plain``,
  its interior untouched, and ``ZShardOps.halo_fill_`` through the
  collective.
* ``ZShardOps.sweeps``, one schedule on both devices (two halo'd buffers,
  the source's halo rows filled in place, the gated launch skipped after a
  sweep that changed nothing), at 2 and 4 shards against the dense
  ``ops/components.sweeps``: labels or reach, per-sweep flags and the sweep
  count, fixed-count and gated, a fixpoint after 2 of 5 and of 6 sweeps
  (skipped sweeps leave either buffer as the result), a halo of more hops
  than the slab's rows, traced shells, and one exchange of the slab a call.
* The sharded labels against JAX's sharded ``label_components`` at 8 shards
  (the fixtures of tests/test_torch_gridops.py).

Everything is integer or selection arithmetic: bit-equal throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_gridops import _jax_sharded, mesh  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.parallel.gridops import ZShardOps as JZShardOps
from vofod_tpu_torch.ops import components as tc
from vofod_tpu_torch.ops.morphology import Shells
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.gridops import (
    HALO_TILE_BYTES, ZShardOps, halo_exchange_plain, halo_exchange_segments_plain,
    halo_fill_plain_, halo_segments)

N_HALO, NZL = 4, 5  # 4 shards of 5 rows: r = 16 takes 4 hops, the 4th past every shard
HALO_R = (0, 1, 3, 16, 23)
PLANES = ((5, 7), (33, 70))  # rows of 35 elements; rows of 2,310 (9,240 f32 bytes: 2 tiles)
DTYPES = {"f32": (torch.float32, -1e30), "int32": (torch.int32, tc.SENTINEL),
          "uint8": (torch.uint8, 0), "bool": (torch.bool, False)}


def _grid(dtype: torch.dtype, plane, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    shape = (N_HALO * NZL,) + plane
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    if dtype == torch.float32:
        return torch.from_numpy(rng.uniform(-5.0, 5.0, shape).astype(np.float32))
    hi = 250 if dtype == torch.uint8 else 10**6
    return torch.from_numpy(rng.integers(1, hi, shape)).to(dtype)


def _global_ext(g: torch.Tensor, rank: int, r: int, fill) -> torch.Tensor:
    """The definition of the exchange: the grid's rows [z0 - r, z0 + nzl + r),
    ``fill`` past its edges."""
    pad = torch.full((r,) + tuple(g.shape[1:]), fill, dtype=g.dtype)
    return torch.cat([pad, g, pad])[rank * NZL:rank * NZL + NZL + 2 * r]


def _received(comm, g: torch.Tensor, r: int):
    """Every shard's slab and the blocks K15b-1 gets: (slab, lo, hi, takes)."""
    ops = ZShardOps(comm)
    slabs = [g[i * NZL:(i + 1) * NZL].contiguous() for i in range(N_HALO)]
    return [(slabs[i],) + got for i, got in
            enumerate(comm.run(lambda rank: ops.halo_recv(slabs[rank], r)))]


def _poisoned(shape, dtype, byte: int) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype)
    t.view(torch.uint8).fill_(byte)
    return t


@pytest.fixture(scope="module")
def comm4():
    return LocalComm(N_HALO, ["cpu"], timeout=60.0)


@pytest.mark.parametrize("r", HALO_R)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_segment_model_matches_plain_exchange(comm4, dtype, r):
    """The segment table tiles the extended slab exactly (segments in order,
    head + 16 x chunks + tail = bytes, edges under 16 bytes, enough tiles
    for the chunks), and running it byte range by byte range, tile by tile,
    gives halo_exchange_plain's slab, bit for bit, over two poisons (a byte
    left unwritten would show in one), at every slab address the kernel
    takes."""
    dt, fill = DTYPES[dtype]
    elem = torch.empty((), dtype=dt).element_size()
    for plane in PLANES:
        g = _grid(dt, plane, seed=r)
        row = int(np.prod(plane)) * elem
        for rank, (slab, lo, hi, takes) in enumerate(_received(comm4, g, r)):
            want = halo_exchange_plain(slab, lo, hi, takes, fill)
            assert torch.equal(want, _global_ext(g, rank, r, fill))
            for addr in range(0, 16, elem) if elem == 4 else (0, 1, 7, 15):
                segs = halo_segments(NZL, r, takes, row, addr)
                assert [s["off"] for s in segs] == list(np.cumsum(
                    [0] + [s["bytes"] for s in segs[:-1]]))
                assert sum(s["bytes"] for s in segs) == want.numel() * elem
                for s in segs:
                    assert s["head"] + 16 * s["chunks"] + s["tail"] == s["bytes"]
                    assert s["head"] < 16 and s["tail"] < 16 or s["chunks"] == 0
                    assert (s["tiles"] - 1) * HALO_TILE_BYTES < max(16 * s["chunks"], 1)
                    assert 16 * s["chunks"] <= s["tiles"] * HALO_TILE_BYTES
                for byte in (0x00, 0xA5):
                    got = halo_exchange_segments_plain(
                        _poisoned(want.shape, dt, byte), slab, lo, hi, takes, fill, addr)
                    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), (
                        f"rank {rank} plane {plane} addr {addr} poison {byte}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_inplace_fill_matches_plain_exchange(comm4, dtype):
    """halo_fill_plain_ and the model's in-place form (no interior segment)
    write the 2r halo rows of a halo'd buffer as halo_exchange_plain places
    them and leave its interior as it was; ZShardOps.halo_fill_ through the
    collective gives ZShardOps.halo_exchange of the interior."""
    dt, fill = DTYPES[dtype]
    ops = ZShardOps(comm4)
    for r in (1, 3, 16, 23):
        g = _grid(dt, PLANES[0], seed=100 + r)
        for rank, (slab, lo, hi, takes) in enumerate(_received(comm4, g, r)):
            want = halo_exchange_plain(slab, lo, hi, takes, fill)
            for byte in (0x00, 0xA5):
                buf = _poisoned(want.shape, dt, byte)
                buf[r:r + NZL] = slab
                interior = buf[r:r + NZL].clone()
                assert halo_fill_plain_(buf, r, lo, hi, takes, fill) is buf
                assert torch.equal(buf.view(torch.uint8), want.view(torch.uint8))
                assert torch.equal(buf[r:r + NZL], interior)
                model = _poisoned(want.shape, dt, byte)
                model[r:r + NZL] = slab
                halo_exchange_segments_plain(model, None, lo, hi, takes, fill, 4)
                assert torch.equal(model.view(torch.uint8), want.view(torch.uint8))
        slabs = [g[i * NZL:(i + 1) * NZL].contiguous() for i in range(N_HALO)]

        def shard(rank, r=r, slabs=slabs):
            buf = torch.zeros((NZL + 2 * r,) + PLANES[0], dtype=dt)
            buf[r:r + NZL] = slabs[rank]
            return ops.halo_fill_(buf, r, fill), ops.halo_exchange(slabs[rank], r, fill)

        for rank, (filled, ext) in enumerate(comm4.run(shard)):
            assert torch.equal(filled, ext) and torch.equal(ext, _global_ext(g, rank, r, fill))


# ---- the sharded sweeps: one schedule on both devices -------------------------------


def _pairs(shape, seed: int) -> np.ndarray:
    """Isolated pairs of face-adjacent voxels: along z on rows (z0, z0 + 1)
    for odd z0, so across every edge of slabs of even height, and along x
    on row 0.  At radius 1 the labels settle in the first sweep, so the
    second changes nothing and every later gated sweep is skipped."""
    rng = np.random.default_rng(seed)
    occ = np.zeros(shape, bool)
    nz, ny, nx = shape
    for z0 in range(1, nz - 1, 2):
        for y in range((z0 // 2) % 3, ny, 3):  # next to no voxel of rows z0 - 1, z0 + 2
            x = int(rng.integers(0, nx))
            occ[z0, y, x] = occ[z0 + 1, y, x] = True
    for y in range(1, ny, 3):
        x = int(rng.integers(0, nx - 1))
        occ[0, y, x] = occ[0, y, x + 1] = True
    return occ


# (case, shape, ball, sweeps, dtype): random blobs to their fixpoint inside
# the cap; the pairs' fixpoint after 2 of 5 and of 6 sweeps (either buffer
# ends as the result); radius 3 over 2-row slabs (a halo of 2 hops at 4
# shards); traced shells; the uint8 reach sweeps
SWEEP_CASES = {
    "random": ((8, 9, 10), 2.0, 12, "int32"),
    "fixpoint_2_of_5": ((8, 9, 10), 1.0, 5, "int32"),
    "fixpoint_2_of_6": ((8, 9, 10), 1.0, 6, "int32"),
    "multihop": ((8, 7, 8), 3.0, 10, "int32"),
    "shells": ((8, 9, 10), Shells(3.0, 5.0), 10, "int32"),
    "reach": ((8, 9, 10), 2.0, 6, "uint8"),
}


def _sweep_inputs(case: str):
    shape, ball, n, dtype = SWEEP_CASES[case]
    rng = np.random.default_rng(len(case))
    occ = _pairs(shape, 3) if case.startswith("fixpoint") else rng.random(shape) < 0.25
    o = torch.from_numpy(occ)
    if dtype == "int32":
        flat = torch.arange(o.numel(), dtype=torch.int32).reshape(shape)
        init = torch.where(o, (o.numel() - 1) - flat, tc.SENTINEL).to(torch.int32)
    else:
        init = (o & torch.from_numpy(rng.random(shape) < 0.1)).to(torch.uint8)
    return init, o, ball, n


@pytest.mark.parametrize("gated", [False, True], ids=["fixed", "gated"])
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_unified_sweeps_match_dense(case, n_shards, gated):
    """Labels (reach), per-sweep flags and the sweep count of the sharded
    schedule equal the dense sweeps'; gated, the sweeps after the fixpoint
    are skipped and the result is still the fixpoint."""
    init, occ, ball, n = _sweep_inputs(case)
    comm = LocalComm(n_shards, ["cpu"], timeout=60.0)
    ops = ZShardOps(comm)
    nzl = init.shape[0] // n_shards
    cut = lambda t, rank: t[rank * nzl:(rank + 1) * nzl].contiguous()  # noqa: E731
    out = comm.run(lambda rank: ops.sweeps(cut(init, rank), cut(occ, rank), ball, n, gated))
    want, wflags = tc.sweeps(init, occ, ball, n, gated)
    assert torch.equal(torch.cat([s for s, _ in out]), want)
    for _, flags in out:
        assert torch.equal(flags, wflags)
    if case.startswith("fixpoint"):
        assert wflags.tolist() == [True] + [False] * (n - 1)
    elif case != "reach":
        assert bool(wflags[0]) and not bool(wflags[-1])  # the fixpoint comes inside the cap
    if gated and init.dtype == torch.int32 and not isinstance(ball, Shells):
        got = comm.run(lambda rank: ops.label_components(cut(occ, rank), ball, n))
        lab, conv, n_run = tc.label_components(occ, ball, n)
        assert torch.equal(torch.cat([g[0] for g in got]), lab)
        for _, c, k in got:
            assert bool(c) == bool(conv) and int(k) == int(n_run)


def test_sweeps_exchange_the_slab_once_and_fill_halos_in_place(monkeypatch):
    """One full exchange a sweeps() call (the occupancy's) and one in-place
    halo fill a sweep, also for the gated sweeps skipped after the fixpoint:
    the interior is never copied or cloned per sweep."""
    init, occ, ball, n = _sweep_inputs("fixpoint_2_of_6")
    comm = LocalComm(2, ["cpu"], timeout=60.0)
    ops = ZShardOps(comm)
    calls = {"halo_exchange": 0, "halo_fill_": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(ZShardOps, name), **kw):
            calls[_name] += 1
            return _fn(ops, *a, **kw)
        monkeypatch.setattr(ops, name, counted)
    nzl = init.shape[0] // 2
    out = comm.run(lambda rank: ops.sweeps(init[rank * nzl:(rank + 1) * nzl].contiguous(),
                                           occ[rank * nzl:(rank + 1) * nzl], ball, n, True))
    assert calls == {"halo_exchange": 2, "halo_fill_": 2 * n}
    assert torch.equal(torch.cat([s for s, _ in out]), tc.sweeps(init, occ, ball, n, True)[0])


def test_plain_sweep_leaf_skips_like_the_gated_launch():
    """propagate_sweep_plain leaves dst and the flag untouched when the
    previous flag is 0, and otherwise writes one sweep and ORs the flag of
    the given rows."""
    init, occ, ball, _ = _sweep_inputs("random")
    dst = torch.full_like(init, 7)
    changed = torch.zeros((), dtype=torch.int32)
    tc.propagate_sweep_plain(init, dst, occ, ball, changed, torch.tensor(0, dtype=torch.int32))
    assert bool((dst == 7).all()) and int(changed) == 0
    tc.propagate_sweep_plain(init, dst, occ, ball, changed, torch.tensor(1, dtype=torch.int32),
                             (2, 6))
    new, ch = tc.sweep_plain(init, occ, ball, (2, 6))
    assert torch.equal(dst, new) and int(changed) == int(ch) == 1


@pytest.fixture(scope="module")
def jax_pair_labels(mesh):  # noqa: F811
    """JAX's sharded label_components of a pairs scene and a random one at 8
    shards of 2 rows (radius 3: a halo of 2 hops), one program."""
    scenes = (_pairs((16, 9, 10), 5), np.random.default_rng(6).random((16, 9, 10)) < 0.25)
    jops = JZShardOps("grid", 8)
    spec = jax.sharding.PartitionSpec("grid", None, None)
    res = _jax_sharded(mesh, lambda a, b: (*jops.label_components(a, 1.0, 6),
                                           *jops.label_components(b, 3.0, 24)),
                       *[jnp.asarray(s) for s in scenes],
                       out=(spec, jax.sharding.PartitionSpec(), spec,
                            jax.sharding.PartitionSpec()))
    return scenes, [np.asarray(a) for a in res]


def test_sharded_labels_match_jax(jax_pair_labels):
    """The unified schedule's labels and ``converged`` at 8 CPU shards equal
    JAX's sharded while_loop's: a fixpoint after 2 of 6 sweeps at radius 1,
    and a multi-hop halo at radius 3."""
    (pairs, rand), (jl1, jc1, jl2, jc2) = jax_pair_labels
    comm = LocalComm(8, ["cpu"], timeout=60.0)
    ops = ZShardOps(comm)
    for occ, radius, n, jl, jc in ((pairs, 1.0, 6, jl1, jc1), (rand, 3.0, 24, jl2, jc2)):
        slabs = [torch.from_numpy(occ[2 * i:2 * i + 2].copy()) for i in range(8)]
        out = comm.run(lambda rank: ops.label_components(slabs[rank], radius, n))
        np.testing.assert_array_equal(torch.cat([o[0] for o in out]).numpy(), jl)
        assert all(bool(c) == bool(jc) for _, c, _ in out)
