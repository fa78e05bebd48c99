"""Dense-grid operation seam: one step, two grid layouts.

PyTorch counterpart of vofod_tpu/parallel/gridops.py.  Every stage of the
step (pipeline/frontend.py, background.py, classify.py, detect.py,
sepclusters.py, step.py) touches the dense (nz, ny, nx) grid through the
small set of primitives below, so the same stage code runs in two layouts:

* :class:`DenseOps` (``DENSE``): the grid lives on one device and every
  primitive is the port's existing op, called exactly as before the seam
  (the dense step's launches and results do not change).

* :class:`ZShardOps`: the grid is sharded along z over the shards of a
  parallel/comm.LocalComm (or a ProcessComm, one shard a process) and each
  method runs inside the comm's ``run`` on the shard's local (nz/n, ny,
  nx) slab.  Stencils read slabs extended by a halo of the neighbours' rows
  (K15b-1), the explore's demotions fold back
  onto their owners (K15b-2), compactions merge per-shard lists (z is the
  leading axis, so shard-major concatenation keeps ids ascending), lookups
  and sums reduce over the shards, and the sweep raycast runs lateral-
  sharded with pipelined or transposed z cones (ops/raycast.py
  raycast_update_zsharded).  The reference-exact modes run sharded too:
  the coarse components sweep halo'd slabs to the global fixpoint, the
  census scatters into the global label space around a psum (K15b-6a), and
  the exact DDA walks every ray on every shard, keeping the slab's chords
  (K15b-6c); the counted-indexing quirk (K15b-6b) and the exact demotion
  (K13c on halo'd coarse arrays) are in pipeline/sepclusters.py.  The
  traced-radius pools and sweeps of ``cfg.dynamic_radii`` exchange a halo
  of the static bound and run K14's tap set on the extended slab (the
  exchange pattern does not move with the radius), and the sequential
  explore runs on a replicated stack of its queries' submap bits
  (K15b-7a/b/c, :meth:`ZShardOps.explore_sequential`).

Point-space arrays and compacted lists are replicated.  Every output equals
the dense one bit for bit: each element gets the same operands in the same
order (tests/test_torch_gridops.py, tests/test_torch_grid_step.py).
"""

from __future__ import annotations

import math

import torch

from vofod_tpu_torch import kernels
from vofod_tpu_torch.geometry import GridSpec
from vofod_tpu_torch.ops.compaction import masked_compact, masked_compact_isin
from vofod_tpu_torch.ops.components import (
    SENTINEL, census_read_plain, census_scatter_plain, label_census, label_components,
    label_components_seeded, propagate_reach, sweeps_batch_plain)
from vofod_tpu_torch.ops.explore import (
    demote_floating, explore, explore_cut, explore_sequential_, explore_sequential_stack)
from vofod_tpu_torch.ops.morphology import (
    INT_FILL, Shells, ball_pool, ball_pool_max, ball_pool_max_traced, ball_pool_sum,
    ball_pool_sum_traced, shell_pool, tap_set)
from vofod_tpu_torch.ops.raycast import (
    ray_ema_grid_, raycast_dda, raycast_dda_slab, raycast_update_, raycast_update_zsharded)

Tensor = torch.Tensor

ZCONE_MODES = ("pipelined", "transpose")
# K2's sweeps a launch on the grid-sharded step (:func:`sharded_sweeps`):
# one halo exchange and one collective of the flags serve this many sweeps.
# On the exact census's 128 sweeps 8 costs the least device time, 16 costs
# 15 % more for a third less host time, which the grid paths are bound by
# (PERF.md section 6); the step's 8-sweep calls run one launch either way.
SWEEP_BATCH = 16


class DenseOps:
    """Single-device primitives (the default provider)."""

    is_sharded = False

    def slab(self, nz: int):
        """(first row, rows) of this device's z slab; None: the whole grid."""
        return None

    # ---- reductions --------------------------------------------------------------
    def gsum(self, x: Tensor) -> Tensor:
        return x.sum()

    def psum(self, x: Tensor) -> Tensor:
        """Sum of per-slab partial results: the one slab's."""
        return x

    def gany(self, x: Tensor) -> Tensor:
        return torch.any(x)

    # ---- stencils ----------------------------------------------------------------
    def stencil(self, fn, arrays, fills, halo: int):
        """``fn(*arrays)`` of a stencil reaching ``halo`` rows in z."""
        return fn(*arrays)

    def halo_window(self, arrays, fills, halo: int, nz: int):
        """(arrays, window) for a kernel reading rows up to ``halo`` beyond
        the slab: here the grids themselves and no window."""
        return list(arrays), None

    # ``traced_r2``: the runtime squared radius of cfg.dynamic_radii (K14's
    # shells), ``radius`` then the static bound
    def pool_max(self, a: Tensor, radius: float, fill=None, traced_r2=None) -> Tensor:
        if traced_r2 is not None:
            return ball_pool_max_traced(a, traced_r2, radius, fill=fill)
        return ball_pool_max(a, radius, fill=fill)

    def pool_sum(self, a: Tensor, radius: float, traced_r2=None) -> Tensor:
        if traced_r2 is not None:
            return ball_pool_sum_traced(a, traced_r2, radius)
        return ball_pool_sum(a, radius)

    def label_seeded(self, occupied, seed, radius: float, max_iters: int, traced_r2=None):
        return label_components_seeded(occupied, seed, radius, max_iters, traced_r2=traced_r2)

    def propagate_reach(self, occupied, seed, radius: float, max_iters: int, traced_r2=None):
        return propagate_reach(occupied, seed, radius, max_iters, traced_r2=traced_r2)

    def label_components(self, occupied, radius: float, max_iters: int):
        return label_components(occupied, radius, max_iters)

    def label_census(self, labels, vals, occ, ncv: int, min_sure: float):
        """K13a: (cell census, flags); one call, two launches."""
        return label_census(labels, vals, occ, ncv, min_sure)

    # ---- histogram scatter -------------------------------------------------------
    def scatter_add(self, grid: GridSpec, fid: Tensor, w: Tensor) -> Tensor:
        """int32 grid of w added at the flat ids (w 0 where invalid)."""
        out = torch.zeros(grid.n_voxels, dtype=torch.int32, device=fid.device)
        out.index_add_(0, fid.long(), w)
        return out.reshape(grid.shape)

    # ---- compaction / list bridge ------------------------------------------------
    def compact(self, mask: Tensor, capacity: int):
        return masked_compact(mask, capacity)

    def compact_isin(self, far: Tensor, labels: Tensor, sel: Tensor, capacity: int):
        return masked_compact_isin(far, labels, sel, capacity)

    def lookup(self, dense: Tensor, fids: Tensor) -> Tensor:
        return dense.reshape(-1)[fids.long()]

    # ---- submap ops --------------------------------------------------------------
    def explore(self, grid, vals, qx, qy, qz, qvalid, m_q, thr_frontiers, thr_ground,
                submap: int):
        return explore(grid, vals, qx, qy, qz, qvalid, m_q, thr_frontiers, thr_ground, submap)

    def demote(self, vals, reached, corners, qslot, connected, qvalid, qgate, query_overflow,
               thr_frontiers):
        """K8: (grid, n_writes int32, cluster_connected bool [K])."""
        return demote_floating(vals, reached, corners, qslot, connected, qvalid, qgate,
                               query_overflow, thr_frontiers)

    def explore_sequential(self, grid, vals, qx, qy, qz, qvalid, qlabels, qids, qslot, m_q,
                           query_overflow, thr_frontiers, thr_ground, submap: int):
        """K7s: (grid, cluster_connected bool [K], n_writes int32); on the
        card in place on ``vals``."""
        return explore_sequential_(grid, vals, qx, qy, qz, qvalid, qlabels, qids, qslot, m_q,
                                   query_overflow, thr_frontiers, thr_ground, submap)

    # ---- raycast -----------------------------------------------------------------
    def raycast_update_(self, grid, vals, had_point, opaque, origin_world, rot_s2w, ema, **kw):
        return raycast_update_(grid, vals, had_point, opaque, origin_world, rot_s2w, ema, **kw)

    def raycast_dda_update_(self, grid, vals, had_point, starts, dirs, lengths, valid,
                            max_length: float, ema):
        """The exact raycast: K12's walk, then its ray EMA in place on
        ``vals``."""
        raylen = raycast_dda(grid, starts, dirs, lengths, valid, max_length)
        return ray_ema_grid_(vals, had_point, raylen, ema)


DENSE = DenseOps()


def halo_exchange_plain(g: Tensor, lo: list, hi: list, takes: list[int], fill) -> Tensor:
    """Plain version of K15b-1 (kernels.halo_exchange's arguments): the
    hops' blocks around the slab, nearest hop innermost, ``fill`` blocks
    where no shard lies that far."""

    def part(b, take):
        if b is not None:
            return b
        return torch.full((take,) + tuple(g.shape[1:]), fill, dtype=g.dtype, device=g.device)

    lo_parts = [part(b, t) for b, t in zip(lo, takes)]
    hi_parts = [part(b, t) for b, t in zip(hi, takes)]
    return torch.cat(lo_parts[::-1] + [g] + hi_parts)


def halo_fill_plain_(ext: Tensor, r: int, lo: list, hi: list, takes: list[int],
                     fill, hi_takes: list[int] | None = None) -> Tensor:
    """Plain version of K15b-1's in-place form (kernels.halo_fill_'s
    arguments): the halo rows of ``ext`` [r + nzl + r_hi, ...] (r_hi =
    sum(hi_takes), default ``takes``) written as :func:`halo_exchange_plain`
    places them, the interior untouched."""
    hi_takes = takes if hi_takes is None else hi_takes
    nzl = ext.shape[0] - r - sum(hi_takes)
    below = 0
    for b, take in zip(lo, takes):
        ext[r - below - take:r - below] = fill if b is None else b
        below += take
    below = r + nzl
    for b, take in zip(hi, hi_takes):
        ext[below:below + take] = fill if b is None else b
        below += take
    return ext


HALO_TILE_BYTES = 8192  # csrc/halo.cu TILE_CHUNKS x 16: the bytes of one thread block


def halo_segments(nzl: int, r: int, takes: list[int], row_bytes: int, addr: int = 0,
                  interior: bool = True, hi_takes: list[int] | None = None) -> list[dict]:
    """Plain model of K15b-1's segment table (csrc/halo.cu
    ``vofod_halo_exchange``): the extended slab's contiguous byte ranges in
    order, the low hops' blocks farthest first, the interior (unless
    ``interior`` is False: the in-place form), the high hops' blocks.  Each
    has its byte offset ``off`` in the slab, ``bytes``, its ``source``
    (("lo", h), ("slab", 0) or ("hi", h)) and how the kernel splits it when
    the slab starts at address ``addr``: ``head`` bytes before its first
    whole 16-byte chunk, ``chunks``, ``tail`` bytes after them (chunk_span)
    and ``tiles``, the thread blocks of HALO_TILE_BYTES of chunks (at least
    one, which also writes the head and tail).  ``hi_takes`` (default
    ``takes``): the high side's rows a hop; a hop of 0 rows has no
    segment."""
    hi_takes = takes if hi_takes is None else hi_takes
    below = [sum(takes[:h]) for h in range(len(takes))]
    above = [sum(hi_takes[:h]) for h in range(len(hi_takes))]
    rows = [(r - below[h] - takes[h], takes[h], ("lo", h)) for h in reversed(range(len(takes)))
            if takes[h]]
    if interior:
        rows.append((r, nzl, ("slab", 0)))
    rows += [(r + nzl + above[h], hi_takes[h], ("hi", h)) for h in range(len(hi_takes))
             if hi_takes[h]]
    segs = []
    for row0, n, source in rows:
        off, size = row0 * row_bytes, n * row_bytes
        d0, d1 = addr + off, addr + off + size
        v0, v1 = -(-d0 // 16) * 16, d1 // 16 * 16
        if v0 > v1:  # no whole chunk: every byte is head
            v0 = v1 = d1
        chunks = (v1 - v0) // 16
        segs.append(dict(off=off, bytes=size, source=source, head=v0 - d0, chunks=chunks,
                         tail=d1 - v1, tiles=max(1, -(-chunks * 16 // HALO_TILE_BYTES))))
    return segs


def halo_exchange_segments_plain(ext: Tensor, g: Tensor | None, lo: list, hi: list,
                                 takes: list[int], fill, addr: int = 0,
                                 hi_takes: list[int] | None = None) -> Tensor:
    """K15b-1 as its kernel runs it, on any device: ``ext`` [r + nzl + r_hi, ...]
    written byte range by byte range from :func:`halo_segments` (``g`` None:
    the in-place form), tile by tile, each segment's first tile also writing
    its head and tail bytes, a fill byte at address a being byte a % 4 of
    the fill's element pattern.  ``addr``: the slab's address the split
    assumes (a multiple of the element size, as the kernel requires);
    ``hi_takes`` as :func:`halo_segments`."""
    elem = ext.element_size()
    if addr % elem:
        raise ValueError(f"a slab of {elem}-byte elements cannot start at address {addr}")
    hi_takes = takes if hi_takes is None else hi_takes
    r = sum(takes)
    nzl = ext.shape[0] - r - sum(hi_takes)
    row_bytes = ext[0].numel() * elem
    out = ext.view(torch.uint8).reshape(-1)
    pattern = torch.tensor([fill], dtype=ext.dtype).view(torch.uint8).repeat(4 // elem)
    srcs = {("slab", 0): g, **{("lo", h): b for h, b in enumerate(lo)},
            **{("hi", h): b for h, b in enumerate(hi)}}

    def put(seg, a: int, b: int) -> None:  # bytes [a, b) of the segment
        d = seg["off"]
        src = srcs[seg["source"]]
        if src is not None:
            out[d + a:d + b] = src.reshape(-1).view(torch.uint8)[a:b]
        else:
            phase = torch.arange(addr + d + a, addr + d + b) % 4
            out[d + a:d + b] = pattern[phase].to(out.device)

    for seg in halo_segments(nzl, r, takes, row_bytes, addr, interior=g is not None,
                             hi_takes=hi_takes):
        head, body = seg["head"], 16 * seg["chunks"]
        tile_chunks = HALO_TILE_BYTES // 16
        for t in range(seg["tiles"]):
            if t == 0:
                put(seg, 0, head)
                put(seg, head + body, seg["bytes"])
            c0, c1 = t * tile_chunks, min((t + 1) * tile_chunks, seg["chunks"])
            if c1 > c0:
                put(seg, head + 16 * c0, head + 16 * c1)
    return ext


def halo_fold_min_plain(ext: Tensor, r: int, from_next: list, from_prev: list,
                        takes: list[int]) -> Tensor:
    """Plain version of K15b-2 (kernels.halo_fold_min's arguments)."""
    nzl = ext.shape[0] - 2 * r
    out = ext[r:r + nzl].clone()
    for fn, fp, take in zip(from_next, from_prev, takes):
        if fn is not None:
            out[nzl - take:] = torch.minimum(out[nzl - take:], fn)
        if fp is not None:
            out[:take] = torch.minimum(out[:take], fp)
    return out


def _on_card(t: Tensor, what: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


def batch_on_card(src, dst, occ, ball, taps, reach, scratch, launch, i0, n, grow, rows, gate,
                  share) -> None:
    """A launch of :func:`sharded_sweeps`: K2's batched kernel."""
    kernels.propagate_batch(src, dst, occ, taps, reach, scratch, launch, i0, n, grow, rows,
                            gate, share)


def batch_plain(src, dst, occ, ball, taps, reach, scratch, launch, i0, n, grow, rows, gate,
                share) -> None:
    """A launch of :func:`sharded_sweeps`: its plain model, on either device."""
    sweeps_batch_plain(src, dst, occ.view(torch.bool), ball, scratch[0], scratch[1], i0, n,
                       grow, rows, gate)


def sharded_sweeps(ops, init: Tensor, occ: Tensor, ball, n: int, until_fixpoint: bool,
                   leaf) -> tuple[Tensor, Tensor, Tensor]:
    """ops/components.sweeps on a shard's slab (inside ``ops.comm.run``), k =
    min(:data:`SWEEP_BATCH`, n) sweeps a launch: two buffers of the slab
    extended by H = k g rows (g: the halo of the ball, of the static bound
    for traced shells) take turns; each launch fills the halo rows of its
    source in place from the neighbours' (K15b-1's in-place form, multi-hop
    where H exceeds the slab; ``fill`` past the global edges, where the
    occupancy reads 0, so those rows stay at the fill) and runs its k
    sweeps, the last launch the rest.  ``init`` holds the fill off the mask
    (ops/components.sweeps).  After sweep j of a launch the rows
    within j g of the extended slab's ends are stale and the interior stays
    exact (csrc/propagate.cu); the flags count the interior rows only.
    With ``until_fixpoint`` each launch's flags take their max over the
    shards in one collective, whose last entry gates the next launch (a
    launch after a fixpoint does nothing); otherwise the flags are OR-ed
    over the shards at the end.  ``leaf``: :func:`batch_on_card` (the
    kernel) or :func:`batch_plain` (its plain model).
    Returns (slab, bool [n] global per-sweep flags, int32 [n] tiles
    computed per sweep on this shard)."""
    taps, reach = tap_set(ball)
    grow = int(math.floor(ball.bound)) if isinstance(ball, Shells) else reach
    k = min(SWEEP_BATCH, n)
    halo = k * grow
    nzl = init.shape[0]
    rows = (halo, halo + nzl)
    fill = SENTINEL if init.dtype == torch.int32 else 0
    occ_ext = ops.halo_exchange(occ.contiguous().view(torch.uint8), halo, 0)
    shape = (nzl + 2 * halo,) + tuple(init.shape[1:])
    bufs = kernels.sweep_buffers(init, halo)
    n_launches = -(-n // k)
    scratch = kernels.sweeps_scratch(shape, n, n_launches, init.device)
    # the shards that share this card's residency: those this process drives
    # on it (other processes' contexts are time-sliced, never co-resident)
    share = sum(ops.comm.devices[r] == ops.comm.device for r in ops.comm.shards)
    flags, gate, cur = [], None, 0
    for b in range(n_launches):
        i0 = b * k
        m = min(k, n - i0)
        src = bufs[cur]
        ops.halo_fill_(src, halo, fill)
        leaf(src, bufs[1 - cur], occ_ext, ball, taps, reach, scratch, b, i0, m, grow, rows, gate,
             share)
        # the interior's result: the buffer the last sweep wrote (after an
        # early stop or a gated launch both buffers' interiors hold it)
        cur = (cur + m) % 2
        if until_fixpoint:  # the 0 / 1 flags' max over the shards: their OR, in int32
            got = ops.comm.pmax(scratch[0][i0:i0 + m])
            flags.append(got)
            gate = got[-1]
    changed, tiles = scratch[0], scratch[1]
    flags = torch.cat(flags) != 0 if until_fixpoint else ops.comm.any(changed != 0)
    return bufs[cur][halo:halo + nzl], flags, tiles


class ZShardOps:
    """Z-sharded primitives over the ``n`` shards of ``comm`` (a
    parallel/comm.LocalComm, or a ProcessComm: one shard a process); every
    method runs inside ``comm.run`` with the
    dense grid arguments being the calling shard's (nz/n, ny, nx) slab.

    zcone_mode: "pipelined" (the z cones run sweep-sharded, n rounds), the
      JAX default, or "transpose" (the window made y-sharded by an
      all_to_all, both z cones swept over all planes, K15b-4b).
    """

    is_sharded = True

    def __init__(self, comm, n: int | None = None, zcone_mode: str = "pipelined"):
        if zcone_mode not in ZCONE_MODES:
            raise ValueError(f"unknown zcone_mode {zcone_mode!r}, expected one of {ZCONE_MODES}")
        if n is not None and n != comm.n:
            raise ValueError(f"ZShardOps n={n} differs from the comm's {comm.n} shards")
        self.comm = comm
        self.n = comm.n
        self.zcone_mode = zcone_mode

    def slab(self, nz: int) -> tuple[int, int]:
        nzl = nz // self.n
        return self.comm.rank * nzl, nzl

    # ---- K15b-1 / K15b-2 ------------------------------------------------------------
    def halo_recv(self, g: Tensor, r: int):
        """The collective of :meth:`halo_exchange`: (lo, hi, takes), the
        blocks received for each hop (None past the global edges), nearest
        hop first.  All hops' rows move in one collective."""
        nzl, n = g.shape[0], self.n
        items, hops, takes = [], [], []
        need = r
        while need > 0:
            h = len(takes) + 1
            take = min(nzl, need)
            need -= take
            takes.append(take)
            if h >= n:  # no shard that far away: the global-edge fill
                hops.append(None)
                continue
            hops.append(len(items))
            items.append((g[nzl - take:], [(i, i + h) for i in range(n - h)]))  # my low side
            items.append((g[:take], [(i, i - h) for i in range(h, n)]))  # my high side
        got = self.comm.ppermutes(items) if items else []
        lo = [None if j is None else got[j] for j in hops]
        hi = [None if j is None else got[j + 1] for j in hops]
        return lo, hi, takes

    def halo_exchange(self, g: Tensor, r: int, fill) -> Tensor:
        """The local slab extended by r rows of the neighbours' content on
        each side (``fill`` past the global edges); multi-hop when r exceeds
        the slab height.  K15b-1 assembles it."""
        if g.dtype not in kernels.HALO_DTYPES:
            raise ValueError(f"halo exchange of a {g.dtype} slab: K15b-1 takes "
                             f"{sorted(map(str, kernels.HALO_DTYPES))}")
        if r <= 0:
            return g
        lo, hi, takes = self.halo_recv(g, r)
        g = g.contiguous()
        if _on_card(g, "halo exchange"):
            return kernels.halo_exchange(g, lo, hi, takes, fill)
        return halo_exchange_plain(g, lo, hi, takes, fill)

    def halo_fill_(self, ext: Tensor, r: int, fill) -> Tensor:
        """In place: the 2r halo rows of ``ext`` [nzl + 2r, ...] from the
        neighbours' edge rows of its interior (``fill`` past the global
        edges), so that ``ext`` is :meth:`halo_exchange` of its interior
        (K15b-1's in-place form); the interior is not copied.  Returns
        ``ext``."""
        if ext.dtype not in kernels.HALO_DTYPES:
            raise ValueError(f"halo fill of a {ext.dtype} slab: K15b-1 takes "
                             f"{sorted(map(str, kernels.HALO_DTYPES))}")
        if r <= 0:
            return ext
        lo, hi, takes = self.halo_recv(ext[r:ext.shape[0] - r], r)
        if _on_card(ext, "halo fill"):
            kernels.halo_fill_(ext, r, lo, hi, takes, fill)
        else:
            halo_fill_plain_(ext, r, lo, hi, takes, fill)
        return ext

    def fold_recv(self, ext: Tensor, r: int):
        """The collective of :meth:`halo_fold_min`: (from_next, from_prev,
        takes), the halo blocks each neighbour sends back, per hop."""
        nzl, n = ext.shape[0] - 2 * r, self.n
        items, takes = [], []
        need, off = r, 0  # off: rows consumed from the inner edge of each halo
        while need > 0:
            h = len(takes) + 1
            take = min(nzl, need)
            need -= take
            if h >= n:
                break
            # my low halo's hop-h block is shard (i - h)'s last rows, my high
            # halo's is shard (i + h)'s first rows: back to their owners
            items.append((ext[r - off - take:r - off], [(i, i - h) for i in range(h, n)]))
            items.append((ext[r + nzl + off:r + nzl + off + take],
                          [(i, i + h) for i in range(n - h)]))
            takes.append(take)
            off += take
        got = self.comm.ppermutes(items) if items else []
        return got[0::2], got[1::2], takes

    def halo_fold_min(self, ext: Tensor, r: int) -> Tensor:
        """Inverse of :meth:`halo_exchange` for min-combining writes: the
        halo rows go back to their owners, which min them into their slab
        (K15b-2); returns the local slab."""
        if r <= 0:
            return ext
        from_next, from_prev, takes = self.fold_recv(ext, r)
        ext = ext.contiguous()
        if _on_card(ext, "halo fold"):
            return kernels.halo_fold_min(ext, r, from_next, from_prev, takes)
        return halo_fold_min_plain(ext, r, from_next, from_prev, takes)

    # ---- reductions -----------------------------------------------------------------
    def gsum(self, x: Tensor) -> Tensor:
        return self.comm.psum(x.sum())

    def psum(self, x: Tensor) -> Tensor:
        return self.comm.psum(x)

    def gany(self, x: Tensor) -> Tensor:
        return self.comm.any(torch.any(x))

    # ---- stencils ---------------------------------------------------------------------
    def stencil(self, fn, arrays, fills, halo: int):
        """``fn`` on the arrays' slabs extended by ``halo`` rows, cropped back
        to the slab: each interior voxel reads what it reads on the dense
        grid."""
        nzl = arrays[0].shape[0]
        out = fn(*[self.halo_exchange(a, halo, f) for a, f in zip(arrays, fills)])
        return out[halo:halo + nzl] if halo else out

    def halo_window(self, arrays, fills, halo: int, nz: int):
        """The arrays' slabs extended by ``halo`` rows and the kernel window
        (nz, first global row held, own rows [z0, z0 + nzl)) of K10."""
        z0, nzl = self.slab(nz)
        exts = [self.halo_exchange(a, halo, f) for a, f in zip(arrays, fills)]
        return exts, (nz, z0 - halo, z0, z0 + nzl)

    def _pool(self, a: Tensor, radius: float, op: str, fill, traced_r2) -> Tensor:
        """K1 (K14 with ``traced_r2``) on the slab extended by floor(radius)
        rows: with a traced radius that is the static bound, so the exchange
        does not move with the radius (vofod_tpu ``ZShardOps._pool``)."""
        if traced_r2 is None:
            fn = lambda e: ball_pool(e, radius, op, fill)  # noqa: E731
        else:
            fn = lambda e: shell_pool(e, traced_r2, radius, op, fill)  # noqa: E731
        return self.stencil(fn, (a,), (fill,), int(math.floor(radius)))

    def pool_max(self, a: Tensor, radius: float, fill=None, traced_r2=None) -> Tensor:
        fill = INT_FILL["max"][a.dtype] if fill is None else fill
        return self._pool(a, radius, "max", fill, traced_r2)

    def pool_sum(self, a: Tensor, radius: float, traced_r2=None) -> Tensor:
        return self._pool(a, radius, "sum", 0, traced_r2)

    def sweeps(self, init: Tensor, occ: Tensor, ball, n: int,
               until_fixpoint: bool = False) -> tuple[Tensor, Tensor]:
        """ops/components.sweeps on the slab: :func:`sharded_sweeps` with
        K2's batched launch on the card, its plain model on the CPU.
        Returns (slab, bool [n] global per-sweep flags)."""
        leaf = batch_on_card if _on_card(init, "sharded sweeps") else batch_plain
        slab, flags, _ = sharded_sweeps(self, init, occ, ball, n, until_fixpoint, leaf)
        return slab, flags

    def label_seeded(self, occupied, seed, radius: float, max_iters: int, traced_r2=None):
        """ops/components.label_components_seeded with global flat ids."""
        nz = occupied.shape[0] * self.n
        return label_components_seeded(occupied, seed, radius, max_iters, traced_r2=traced_r2,
                                       sweep_fn=self.sweeps, z0=self.slab(nz)[0], nz=nz)

    def propagate_reach(self, occupied, seed, radius: float, max_iters: int, traced_r2=None):
        return propagate_reach(occupied, seed, radius, max_iters, traced_r2=traced_r2,
                               sweep_fn=self.sweeps)

    def label_components(self, occupied, radius: float, max_iters: int):
        """ops/components.label_components with global flat ids, swept to
        the global fixpoint: each gated K2 launch reads the previous
        launch's last flag OR-ed over the shards, so the labels,
        ``converged`` and the sweep count are the dense step's."""
        return label_components(occupied, radius, max_iters, sweep_fn=self.sweeps,
                                z0=self.slab(occupied.shape[0] * self.n)[0])

    def label_census(self, labels, vals, occ, ncv: int, min_sure: float):
        """K13a across the shards (vofod_tpu ``ZShardOps.label_census``):
        the slab's cells scattered into the global label space (K15b-6a),
        the int32 census psum'd, then read back for the slab's cells with
        the two flags (K15b-6a), each OR-ed over the shards."""
        labels, vals, occ = labels.contiguous(), vals.contiguous(), occ.contiguous()
        if _on_card(labels, "label census"):
            census = self.comm.psum(kernels.census_scatter(labels, vals, occ, ncv))
            out, flags = kernels.census_read(labels, occ, census, min_sure)
        else:
            census = self.comm.psum(census_scatter_plain(labels, vals, occ, ncv))
            out, flags = census_read_plain(labels, occ, census, min_sure)
        return out, self.comm.any(flags)

    # ---- histogram scatter ----------------------------------------------------------
    def scatter_add(self, grid: GridSpec, fid: Tensor, w: Tensor) -> Tensor:
        """The slab's part of DenseOps.scatter_add: only the owned ids add."""
        z0, nzl = self.slab(grid.nz)
        nvl = nzl * grid.ny * grid.nx
        lf = fid.long() - z0 * grid.ny * grid.nx
        own = (lf >= 0) & (lf < nvl)
        out = torch.zeros(nvl, dtype=torch.int32, device=fid.device)
        out.index_add_(0, lf.clamp(0, nvl - 1), torch.where(own, w, 0))
        return out.reshape(nzl, grid.ny, grid.nx)

    # ---- compaction / list bridge ---------------------------------------------------
    def _merge(self, ids_l: Tensor, valid_l: Tensor, tot_l: Tensor, mask: Tensor,
               capacity: int):
        """Per-shard compact (K6) + ordered merge: shard-major concatenation
        of ascending per-shard lists is globally ascending, and each shard's
        part of any global prefix is a prefix of its own list, so K6 on the
        gathered valid flags picks the dense result."""
        nynx = mask.shape[1] * mask.shape[2]
        z0, _ = self.slab(mask.shape[0] * self.n)
        gids = torch.where(valid_l, ids_l + z0 * nynx, 0)
        all_ids = self.comm.all_gather(gids).reshape(-1)
        all_valid = self.comm.all_gather(valid_l).reshape(-1)
        sel, svalid, _ = masked_compact(all_valid, capacity)
        ids = torch.where(svalid, all_ids[sel.long()], 0).to(torch.int32)
        total = self.comm.psum(tot_l)
        valid = torch.arange(capacity, dtype=torch.int32, device=mask.device) < total
        return ids, valid, total

    def compact(self, mask: Tensor, capacity: int):
        return self._merge(*masked_compact(mask, capacity), mask, capacity)

    def compact_isin(self, far: Tensor, labels: Tensor, sel: Tensor, capacity: int):
        """K6's label-predicate form on the slab (its fused lookup reads the
        slab's own labels), then the merge."""
        return self._merge(*masked_compact_isin(far, labels, sel, capacity), far, capacity)

    def lookup(self, dense: Tensor, fids: Tensor) -> Tensor:
        """dense.flat[fids] of the global ids: the owner's value, summed over
        the shards (zeros elsewhere)."""
        nzl = dense.shape[0]
        nynx = dense.shape[1] * dense.shape[2]
        nvl = nzl * nynx
        lf = fids.long() - self.slab(nzl * self.n)[0] * nynx
        own = (lf >= 0) & (lf < nvl)
        vals = dense.reshape(-1)[lf.clamp(0, nvl - 1)]
        return self.comm.psum(torch.where(own, vals, torch.zeros((), dtype=dense.dtype,
                                                                 device=dense.device)))

    # ---- submap ops -----------------------------------------------------------------
    def explore(self, grid, vals, qx, qy, qz, qvalid, m_q, thr_frontiers, thr_ground,
                submap: int):
        """K7 on the slab extended by the explore pad, for the queries the
        shard owns; ``connected`` OR-ed over the shards.  ``reached`` stays
        shard-local: only the owner's rows are set, and only the owner
        demotes (:meth:`demote`)."""
        pad = submap // 2
        z0, nzl = self.slab(grid.nz)
        ext = self.halo_exchange(vals, pad, -1e30)
        own = (qz >= z0) & (qz < z0 + nzl)
        conn, reached, corners = explore(grid, ext, qx, qy, qz, qvalid & own, m_q,
                                         thr_frontiers, thr_ground, submap,
                                         z_window=(z0 - pad, grid.nz))
        return self.comm.any(conn), reached, corners

    def demote(self, vals, reached, corners, qslot, connected, qvalid, qgate, query_overflow,
               thr_frontiers):
        """K8 by each query's owner on its halo-extended slab, folded back
        onto the neighbours with K15b-2 (min is idempotent, so the fold is
        exact); the write count summed over the shards.  ``connected`` is
        OR-ed over the shards already, so every shard's cluster_connected
        is the same."""
        pad = reached.shape[1] // 2
        nzl = vals.shape[0]
        z0, _ = self.slab(nzl * self.n)
        qz = corners[:, 0] + pad
        own = (qz >= z0) & (qz < z0 + nzl)
        ext = self.halo_exchange(vals, pad, 0.0)
        ext, n_writes, cluster_connected = demote_floating(
            ext, reached, corners, qslot, connected, qvalid & own, qgate, query_overflow,
            thr_frontiers, z_window=(z0 - pad, nzl * self.n))
        return self.halo_fold_min(ext, pad), self.comm.psum(n_writes), cluster_connected

    def explore_sequential(self, grid, vals, qx, qy, qz, qvalid, qlabels, qids, qslot, m_q,
                           query_overflow, thr_frontiers, thr_ground, submap: int):
        """K7s over the shards, with no collective per query: the sequential
        walk reads and writes only its queries' S^3 submaps, and its BFS only
        two bits a voxel (unknown band, ground).  Each shard cuts those bits
        of the rows it owns (K15b-7a), one psum replicates the stack (each
        row has one owner, the others send 0), every shard walks the queries
        on it (K15b-7b, replicated as K9 is), and each writes the failed
        queries' demotions into its own rows (K15b-7c, on the bare slab; on
        the card stored by K15b-7b's walk as each query fails, in the same
        launch); the write counts are psum'd.  Returns (slab,
        cluster_connected bool [K], n_writes int32), the dense K7s's."""
        z0, _ = self.slab(grid.nz)
        vals = vals.contiguous()
        stack = self.comm.psum(explore_cut(vals, qx, qy, qz, qvalid, thr_frontiers, thr_ground,
                                           submap, z0))
        vals, conn, _, _, _, n_writes = explore_sequential_stack(
            grid, stack, vals, z0, qx, qy, qz, qvalid, qlabels, qids, qslot, m_q, query_overflow,
            thr_frontiers)
        return vals, conn, self.comm.psum(n_writes)

    # ---- raycast --------------------------------------------------------------------
    def raycast_update_(self, grid, vals, had_point, opaque, origin_world, rot_s2w, ema, **kw):
        return raycast_update_zsharded(grid, vals, had_point, opaque, origin_world, rot_s2w,
                                       ema, comm=self.comm, zcone_mode=self.zcone_mode, **kw)

    def raycast_dda_update_(self, grid, vals, had_point, starts, dirs, lengths, valid,
                            max_length: float, ema):
        """The exact raycast on the slab (vofod_tpu ``ZShardOps.raycast_dda``):
        every ray walked, the slab's chords kept (K15b-6c), then K12's ray
        EMA with the old rule's max over the shards."""
        raylen = raycast_dda_slab(grid, starts, dirs, lengths, valid, max_length,
                                  self.slab(grid.nz))
        return ray_ema_grid_(vals, had_point, raylen, ema, gmax=self.comm.pmax)
