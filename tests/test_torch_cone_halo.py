"""The grid-sharded cone sweeps of k planes a launch (K15b-3's x/y cones and
K15b-4b's transposed z cones) on the CPU, through their plain models.

A launch sweeps k planes over the shard's rows extended by k rows below and
2k above (the A pass reads rows a - 1 .. a + 2, so a slab edge that is not
the grid's loses one exact row a plane below and two above), clipped at the
grid's edges (K15b-4b's at the window's true y extent wy); between launches
the carry's halo rows are refilled from the neighbours' own rows
(ops/raycast.py ``cone_halo_plan``, ``_refill_halo``).  Held here, on
seeded numpy opacity at 2, 3 and 4 shards of 5, 4 and 3 rows with k = 1,
2, 3 and every plane, the sensor inside the window so that seeded and swept
planes mix:

* both sweeps bit-equal to ``cone_sweep_plain``'s cones (the dense K4 plain
  version), which covers a halo of two hops (2k > a shard's rows), a halo
  clipped at a global edge and, for the z cones, wy = 7 that no shard
  count divides (the last shard owns fewer rows).  7 planes keep JAX's
  scans (unrolled 8 planes) quick to compile;
* within 2^-6 of JAX's ``_sweep_cones_lat_sharded`` and
  ``_sweep_cones_z_transposed`` under ``shard_map`` on the CPU mesh: JAX
  rounds to bf16 after every add and multiply where the port rounds each
  4-tap sum once (T in [0, 1]; measured max |d| 2^-6 = 4 x 2^-8 at 3 shards,
  3 and 2 x 2^-8 at 2 and 4, on 4-8 % of the voxels);
* NaN written into every halo row of the carry after each launch: the
  refill overwrites every one (T stays bit-equal), and with the refill
  skipped the NaN reaches the shard's own rows;
* each shard that owns rows launches ceil(planes / k) times, and the
  collective copies are (launches - 1) x the halo's source shards;
* K15b-1's asymmetric in-place fill (k rows below, 2k above) as the
  kernel's byte-range model writes it, against ``halo_fill_plain_``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests.torch_threads import one_torch_thread  # noqa: F401
from vofod_tpu.ops import raycast as jr
from vofod_tpu.parallel.grid_step import make_grid_mesh
from vofod_tpu_torch.ops import raycast as rc
from vofod_tpu_torch.parallel.comm import LocalComm
from vofod_tpu_torch.parallel.gridops import halo_exchange_segments_plain, halo_fill_plain_

SHARDS = {2: 5, 3: 4, 4: 3}  # shards: rows a shard
NY, NX = 7, 6  # no shard count divides wy = 7; x and y cones of different lengths
KS = (1, 2, 3, 1000)  # 1000: every plane in one launch
JAX_TOL = 2.0**-6
SPEC = P("grid", None, None)
PLAIN = {name: getattr(rc, name) for name in ("cone_lat_batch_plain", "cone_zt_batch_plain")}


def _case(n: int):
    nzl = SHARDS[n]
    nz = n * nzl
    rng = np.random.default_rng(40 + n)
    op = rng.random((nz, NY, NX)) < 0.12
    # the sensor inside the window, between voxel centres on every axis
    rel_z = np.arange(nz, dtype=np.float32) + 0.5 - np.float32(0.43 * nz)
    rel_y = np.arange(NY, dtype=np.float32) + 0.5 - np.float32(5.3)
    rel_x = np.arange(NX, dtype=np.float32) + 0.5 - np.float32(3.6)
    return op, rel_x, rel_y, rel_z


def _pad_tail(a, axis_i, n):
    if a.shape[axis_i] >= n:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis_i] = (0, n - a.shape[axis_i])
    return jnp.pad(a, widths)


def _extend_rel(rel, n):
    k = n - rel.shape[0]
    if k <= 0:
        return rel
    return jnp.concatenate([rel, rel[-1] + jnp.arange(1, k + 1, dtype=rel.dtype)])


def _jax_cones(n: int, op, rel_x, rel_y, rel_z) -> np.ndarray:
    """JAX's x/y cones (``_sweep_cones_lat_sharded``, laid out as its
    ``_sweep_frame_zsharded`` lays them out) and transposed z cones over n
    shards in one shard_map program: T [6, nz, ny, nx] in grid order."""
    rx, ry, rzg = jnp.asarray(rel_x), jnp.asarray(rel_y), jnp.asarray(rel_z)

    def fn(o, rz):
        rz = rz[:, 0]
        nzl, ny, nx = o.shape
        pb = max(nx, ny)
        op_x, op_y = jnp.moveaxis(o, 2, 0), jnp.moveaxis(o, 1, 0)
        planes = jnp.stack([_pad_tail(_pad_tail(p, 2, pb), 0, pb)
                            for p in (op_x, op_x[::-1], op_y, op_y[::-1])], axis=1)
        rs = jnp.stack([_extend_rel(r, pb) for r in (rx, -rx[::-1], ry, -ry[::-1])], axis=1)
        ra = jnp.broadcast_to(rz[None], (4, nzl))
        rb = jnp.stack([_extend_rel(r, pb) for r in (ry, ry, rx, rx)])
        t = jr._sweep_cones_lat_sharded(planes, rs, ra, rb, "grid", n)
        tz = jr._sweep_cones_z_transposed(o, rzg, ry, rx, "grid", n)
        return jnp.stack([jnp.moveaxis(t[:nx, 0, :, :ny], 0, 2),
                          jnp.moveaxis(t[:nx, 1, :, :ny][::-1], 0, 2),
                          jnp.moveaxis(t[:ny, 2, :, :nx], 0, 1),
                          jnp.moveaxis(t[:ny, 3, :, :nx][::-1], 0, 1),
                          tz[:, 0], tz[::-1, 1]])

    return np.asarray(jax.jit(shard_map(
        fn, mesh=make_grid_mesh(n), in_specs=(SPEC, P("grid", None)),
        out_specs=P(None, "grid", None, None), check_vma=False))(
            jnp.asarray(op.astype(np.float32)), rzg[:, None]))


@pytest.fixture(scope="module")
def cases():
    """Per shard count: the inputs, the dense plain T and JAX's T (the
    three JAX programs compiled side by side: compiling is most of the
    module's time)."""
    inputs = {n: _case(n) for n in SHARDS}
    with ThreadPoolExecutor(len(SHARDS)) as pool:
        jax_t = dict(zip(inputs, pool.map(lambda n: _jax_cones(n, *inputs[n]), inputs)))
    out = {}
    for n, (op, rel_x, rel_y, rel_z) in inputs.items():
        t = [torch.from_numpy(a) for a in (rel_x, rel_y, rel_z)]
        dense = rc.cone_sweep_plain(torch.from_numpy(op), *t)
        out[n] = (torch.from_numpy(op.astype(np.uint8)), *t, dense, jax_t[n])
    return out


def _sweep(n, window, rel_x, rel_y, rel_z, k, monkeypatch, wrap=None):
    """Both sharded sweeps at k planes a launch over n CPU shards: (T6 in
    grid order, the launches of each shard, the collective copies by kind)."""
    monkeypatch.setattr(rc, "CONE_BATCH", k)
    comm = LocalComm(n, ["cpu"], timeout=60.0)
    nz, wy, wx = window.shape
    nzl = nz // n
    launches = {}
    for name, real in PLAIN.items():

        def counted(*a, real=real, name=name):
            launches.setdefault((name, comm.rank), 0)
            launches[(name, comm.rank)] += 1
            real(*a)
            if wrap is not None:
                wrap(*a)

        monkeypatch.setattr(rc, name, counted)

    def shard(rank):
        T6 = torch.full((6, nzl, wy, wx), float("nan"))
        rc.cone_sweep_lat_sharded(window, rel_x, rel_y, rel_z, T6[:4], comm)
        rc.cone_sweep_z_transposed(window, rel_x, rel_y, rel_z, T6[4:], comm)
        return T6

    comm.reset_copies()
    T6 = torch.cat(comm.run(shard), dim=1)
    return T6, launches, dict(comm.copies_by)


def _sources(n: int, rows: int, extent: int, k: int, i: int) -> int:
    """The shards the halo of shard i's slab comes from, counted from the
    halo's rows: k below and 2k above its own rows, within [0, extent)."""
    a, b = min(i * rows, extent), min((i + 1) * rows, extent)
    if a >= b:
        return 0
    halo = list(range(max(0, a - k), a)) + list(range(b, min(extent, b + 2 * k)))
    return len({z // rows for z in halo})


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", sorted(SHARDS))
def test_sharded_cones_match_dense_and_jax(cases, n, k, monkeypatch):
    window, rel_x, rel_y, rel_z, dense, want = cases[n]
    T6, launches, copies = _sweep(n, window, rel_x, rel_y, rel_z, k, monkeypatch)
    assert torch.equal(T6, dense)
    assert np.abs(T6.numpy() - want).max() <= JAX_TOL
    nz, wy, wx = window.shape
    nzl, nyl = nz // n, -(-wy // n)
    lat_planes, zt_planes = max(wx, wy), nz
    for rank in range(n):
        assert launches[("cone_lat_batch_plain", rank)] == -(-lat_planes // min(k, lat_planes))
        owns = rank * nyl < wy
        assert launches.get(("cone_zt_batch_plain", rank), 0) == (
            -(-zt_planes // min(k, zt_planes)) if owns else 0)
    lat_fills = -(-lat_planes // min(k, lat_planes)) - 1
    zt_fills = -(-zt_planes // min(k, zt_planes)) - 1
    want_copies = (lat_fills * sum(_sources(n, nzl, nz, min(k, lat_planes), i) for i in range(n))
                   + zt_fills * sum(_sources(n, nyl, wy, min(k, zt_planes), i) for i in range(n)))
    assert copies.get("ppermute", 0) == want_copies
    assert copies["all_to_all"] == n * (n - 1)  # the z cones' T back to z rows


def test_jax_difference_is_bf16_rounding(cases):
    """The port against JAX: some voxels differ (the rounding points
    differ), by no more than 2^-6."""
    d = max(float(np.abs(c[4].numpy() - c[5]).max()) for c in cases.values())
    assert 0 < d <= JAX_TOL  # measured 4 x 2^-8


@pytest.mark.parametrize("n", sorted(SHARDS))
def test_stale_halo_rows_never_reach_own_rows(cases, n, monkeypatch):
    """NaN in every halo row of the carry after each launch (k = 2: two
    hops above where 2k exceeds a shard's rows): the refill overwrites every
    one, so T is still the dense T; with the refill skipped the NaN reaches
    the shards' own rows."""
    window, rel_x, rel_y, rel_z, dense, _ = cases[n]

    def poison(opaque, rx, ry, rz, carry, T, slab, rows, p0, m):
        if carry is not None:
            carry[:rows[0] - slab[0]] = float("nan")
            carry[rows[1] - slab[0]:] = float("nan")

    T6, _, _ = _sweep(n, window, rel_x, rel_y, rel_z, 2, monkeypatch, wrap=poison)
    assert torch.equal(T6, dense)
    monkeypatch.setattr(rc, "_refill_halo", lambda carry, plan, comm: None)
    T6, _, _ = _sweep(n, window, rel_x, rel_y, rel_z, 2, monkeypatch, wrap=poison)
    assert torch.isnan(T6[:4]).any() and torch.isnan(T6[4:]).any()


def test_halo_plan_clips_at_the_edges():
    """The plan's rows at 3 shards of 4 rows: the bottom shard takes no row
    below, the top none above, a halo of 2k = 6 rows takes two hops (4 + 2),
    and an extent of 10 rows (the last shard owning 2) clips the upper
    halo there; a shard past the extent owns nothing."""
    own, lo, hi = rc.cone_halo_plan(3, 4, 12, 3)
    assert own == [(0, 4), (4, 8), (8, 12)]
    assert lo == [[], [3], [3]] and hi == [[4, 2], [4], []]
    own, lo, hi = rc.cone_halo_plan(4, 3, 10, 2)
    assert own == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert lo == [[], [2], [2], [2]] and hi == [[3, 1], [3, 1], [1], []]
    own, lo, hi = rc.cone_halo_plan(4, 3, 8, 2)
    assert own[3] == (8, 8) and lo[3] == [] and hi[3] == [] and hi[2] == []


@pytest.mark.parametrize("addr", [0, 2, 6])
def test_asymmetric_inplace_fill_byte_model(addr):
    """K15b-1's in-place fill of a carry slab with k = 3 rows below (one hop)
    and 2k = 6 above (hops of 4 and 2 rows), bf16 rows moved as bytes: the
    kernel's byte-range model writes what halo_fill_plain_ writes and
    leaves the own rows as they were."""
    rng = np.random.default_rng(addr)
    plane = (2, 13)
    lo_t, hi_t = [3], [4, 2]
    own = torch.from_numpy(rng.random((4,) + plane).astype(np.float32)).to(torch.bfloat16)
    lo = [torch.from_numpy(rng.random((t,) + plane).astype(np.float32)).to(torch.bfloat16)
          for t in lo_t]
    hi = [torch.from_numpy(rng.random((t,) + plane).astype(np.float32)).to(torch.bfloat16)
          for t in hi_t]
    want = torch.cat([lo[0], own, hi[0], hi[1]]).view(torch.uint8)
    for fn in (lambda e, b_lo, b_hi: halo_fill_plain_(e, 3, b_lo, b_hi, lo_t, 0, hi_takes=hi_t),
               lambda e, b_lo, b_hi: halo_exchange_segments_plain(e, None, b_lo, b_hi, lo_t, 0,
                                                                  addr, hi_takes=hi_t)):
        ext = torch.full((13,) + plane, float("nan"), dtype=torch.bfloat16)
        ext[3:7] = own
        fn(ext.view(torch.uint8), [b.view(torch.uint8) for b in lo],
           [b.view(torch.uint8) for b in hi])
        assert torch.equal(ext.view(torch.uint8), want)
