"""Dense-grid operation seam: one step, two grid layouts.

PyTorch counterpart of vofod_tpu/parallel/gridops.py.  Every stage of the
step (pipeline/frontend.py, background.py, classify.py, detect.py,
sepclusters.py, step.py) touches the dense (nz, ny, nx) grid through the
small set of primitives below, so the same stage code runs in two layouts:

* :class:`DenseOps` (``DENSE``): the grid lives on one device and every
  primitive is the port's existing op, called exactly as before the seam
  (the dense step's launches and results do not change).

* :class:`ZShardOps`: the grid is sharded along z over the shards of a
  parallel/comm.LocalComm and each method runs inside ``LocalComm.run`` on
  the shard's local (nz/n, ny, nx) slab.  Stencils read slabs extended by a
  halo of the neighbours' rows (K15b-1), the explore's demotions fold back
  onto their owners (K15b-2), compactions merge per-shard lists (z is the
  leading axis, so shard-major concatenation keeps ids ascending), lookups
  and sums reduce over the shards, and the sweep raycast runs lateral-
  sharded with pipelined z cones (ops/raycast.py raycast_update_zsharded).

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
    SENTINEL, label_components_seeded, propagate_reach, sweep_plain)
from vofod_tpu_torch.ops.explore import demote_floating, explore
from vofod_tpu_torch.ops.morphology import INT_FILL, ball_pool, ball_pool_max, ball_pool_sum, tap_set
from vofod_tpu_torch.ops.raycast import raycast_update_, raycast_update_zsharded

Tensor = torch.Tensor

ZCONE_MODES = ("pipelined", "transpose")


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

    def pool_max(self, a: Tensor, radius: float, fill=None) -> Tensor:
        return ball_pool_max(a, radius, fill=fill)

    def pool_sum(self, a: Tensor, radius: float) -> Tensor:
        return ball_pool_sum(a, radius)

    def label_seeded(self, occupied, seed, radius: float, max_iters: int):
        return label_components_seeded(occupied, seed, radius, max_iters)

    def propagate_reach(self, occupied, seed, radius: float, max_iters: int):
        return propagate_reach(occupied, seed, radius, max_iters)

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
        return demote_floating(vals, reached, corners, qslot, connected, qvalid, qgate,
                               query_overflow, thr_frontiers)

    # ---- raycast -----------------------------------------------------------------
    def raycast_update_(self, grid, vals, had_point, opaque, origin_world, rot_s2w, ema, **kw):
        return raycast_update_(grid, vals, had_point, opaque, origin_world, rot_s2w, ema, **kw)


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


class ZShardOps:
    """Z-sharded primitives over the ``n`` shards of ``comm`` (a
    parallel/comm.LocalComm); every method runs inside ``comm.run`` with the
    dense grid arguments being the calling shard's (nz/n, ny, nx) slab.

    zcone_mode: "pipelined" (the z cones run sweep-sharded, n rounds), the
      JAX default.  "transpose" (the all_to_all form) has no port yet
      (ROADMAP queue 1) and raises.
    """

    is_sharded = True

    def __init__(self, comm, n: int | None = None, zcone_mode: str = "pipelined"):
        if zcone_mode not in ZCONE_MODES:
            raise ValueError(f"unknown zcone_mode {zcone_mode!r}, expected one of {ZCONE_MODES}")
        if zcone_mode == "transpose":
            raise NotImplementedError(
                "zcone_mode='transpose' (the all_to_all z cones, K15b-4b) is not ported yet: "
                "ROADMAP queue 1, K15b rest")
        if n is not None and n != comm.n:
            raise ValueError(f"ZShardOps n={n} differs from the comm's {comm.n} shards")
        self.comm = comm
        self.n = comm.n
        self.zcone_mode = zcone_mode

    def slab(self, nz: int) -> tuple[int, int]:
        nzl = nz // self.n
        return self.comm.rank * nzl, nzl

    @staticmethod
    def check_step(cfg, raycast_mode: str, frontend_mode: str) -> None:
        """Refuse the step modes with no sharded form yet (their stages
        would run the dense form on a slab): make_step_fn calls this for a
        sharded ``ops``."""
        refused = [
            (frontend_mode != "raw", f"frontend_mode={frontend_mode!r}"),
            (raycast_mode == "exact", "raycast_mode='exact'"),
            (cfg.sepclusters_exact_census, "sepclusters_exact_census"),
            (cfg.compat_hascloseto_bounds, "compat_hascloseto_bounds"),
            (cfg.dynamic_radii, "dynamic_radii"),
            (cfg.sequential_explore, "sequential_explore"),
        ]
        for on, what in refused:
            if on:
                raise NotImplementedError(
                    f"the grid-sharded step: {what} is not sharded yet (ROADMAP queue 1, "
                    "K15b rest)")

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

    def pool_max(self, a: Tensor, radius: float, fill=None) -> Tensor:
        fill = INT_FILL["max"][a.dtype] if fill is None else fill
        return self.stencil(lambda e: ball_pool(e, radius, "max", fill), (a,), (fill,),
                            int(math.floor(radius)))

    def pool_sum(self, a: Tensor, radius: float) -> Tensor:
        return self.stencil(lambda e: ball_pool(e, radius, "sum", 0), (a,), (0,),
                            int(math.floor(radius)))

    def sweeps(self, init: Tensor, occ: Tensor, ball, n: int,
               until_fixpoint: bool = False) -> tuple[Tensor, Tensor]:
        """ops/components.sweeps on the slab: each sweep exchanges a halo of
        the keys and runs K2 on the extended slab with its change flag over
        the interior rows only (a flag over the halo rows would count changes
        the dense sweep never sees); the flags are OR-ed over the shards.
        ``until_fixpoint`` gates each launch on the previous sweep's global
        flag.  Returns (slab, bool [n] global per-sweep flags)."""
        taps, halo = tap_set(ball)
        nzl = init.shape[0]
        rows = (halo, halo + nzl)
        fill = SENTINEL if init.dtype == torch.int32 else 0
        cur = init.contiguous()
        if _on_card(init, "sharded sweeps"):
            occ_ext = self.halo_exchange(occ.contiguous().view(torch.uint8), halo, 0)
            changed = torch.zeros(n, dtype=torch.int32, device=init.device)
            flags, prev = [], None
            for i in range(n):
                ext = self.halo_exchange(cur, halo, fill)
                # gated: a skipped launch must leave the fixpoint in place
                dst = ext.clone() if until_fixpoint else torch.empty_like(ext)
                kernels.propagate_sweep(ext, dst, occ_ext, taps, halo, changed[i], prev, rows)
                if until_fixpoint:
                    flags.append(self.comm.any(changed[i] != 0))
                    prev = flags[-1].to(torch.int32)
                cur = dst[halo:halo + nzl]
            return cur, torch.stack(flags) if until_fixpoint else self.comm.any(changed != 0)
        occ_ext = self.halo_exchange(occ, halo, False)
        flags = []
        for _ in range(n):
            if until_fixpoint and flags and not bool(flags[-1]):
                flags.append(flags[-1])
                continue
            new, ch = sweep_plain(self.halo_exchange(cur, halo, fill), occ_ext, ball, rows)
            cur = new[halo:halo + nzl]
            flags.append(self.comm.any(ch) if until_fixpoint else ch)
        flags = torch.stack(flags)
        return cur, flags if until_fixpoint else self.comm.any(flags)

    def label_seeded(self, occupied, seed, radius: float, max_iters: int):
        """ops/components.label_components_seeded with global flat ids."""
        nz = occupied.shape[0] * self.n
        return label_components_seeded(occupied, seed, radius, max_iters, sweep_fn=self.sweeps,
                                       z0=self.slab(nz)[0], nz=nz)

    def propagate_reach(self, occupied, seed, radius: float, max_iters: int):
        return propagate_reach(occupied, seed, radius, max_iters, sweep_fn=self.sweeps)

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
        exact); the write count summed over the shards."""
        pad = reached.shape[1] // 2
        nzl = vals.shape[0]
        z0, _ = self.slab(nzl * self.n)
        qz = corners[:, 0] + pad
        own = (qz >= z0) & (qz < z0 + nzl)
        ext = self.halo_exchange(vals, pad, 0.0)
        ext, n_writes = demote_floating(ext, reached, corners, qslot, connected, qvalid & own,
                                        qgate, query_overflow, thr_frontiers,
                                        z_window=(z0 - pad, nzl * self.n))
        return self.halo_fold_min(ext, pad), self.comm.psum(n_writes)

    # ---- raycast --------------------------------------------------------------------
    def raycast_update_(self, grid, vals, had_point, opaque, origin_world, rot_s2w, ema, **kw):
        return raycast_update_zsharded(grid, vals, had_point, opaque, origin_world, rot_s2w,
                                       ema, comm=self.comm, **kw)
