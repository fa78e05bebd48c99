"""Bounded flood-fill to ground (K7), the demotion write-back (K8) and the
sequential explore with live demotion (K7s).

PyTorch counterpart of vofod_tpu/ops/explore.py (ref src/voxel_map.cpp
:402-488, call site vofod_nodelet.cpp:1692-1718): per query an SxSxS submap
around the query voxel, then a masked 6-neighbour BFS through the unknown
band (frontiers < v <= ground) inside the query's Manhattan ball.  For CUDA
tensors both steps are hand-written kernels (csrc/explore.cu: one block per
query, masks bit-packed in shared memory); CPU tensors take the plain
versions here.

The reached set travels between the two as packed rows: int64 [Q, S, S]
with bit x of row (z, y) set when voxel (z, y, x) of the query's submap was
explored (S <= 62).  :func:`explore_to_ground` and :func:`apply_demotions`
keep the JAX package's bool [Q, S, S, S] form for the tests.  One deliberate
difference: the reached set of an invalid query is empty here, where the
JAX version may hold its centre voxel; no caller reads it (an invalid query
never demotes).

On the grid-sharded step the grid is a shard's slab extended by the
explore pad: ``z_window = (z_lo, nz_g)`` says it holds the global rows
[z_lo, z_lo + rows) of an nz_g-row grid (the JAX ``z_halo`` / ``z_off``);
the queries and corners stay in global coordinates.

The plain BFS runs a FIXED ``max_iters`` sweeps over the packed rows: the
dilation is monotone, so sweeps past the fixpoint change nothing and the
result equals the JAX while_loop's, with no host sync.

K7s (:func:`explore_sequential_`, ``cfg.sequential_explore``) is the
reference's order: one query at a time, each reading the grid as the
earlier failed queries left it (vofod_tpu/pipeline/classify.py:211-267).
On the card it is one launch of csrc/explore.cu; its plain version is a
host loop over K7's and K8's plain versions, for the tests and the card's
comparison only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vofod_tpu_torch import kernels
from vofod_tpu_torch.geometry import GridSpec

Tensor = torch.Tensor


def _pack_rows(m: Tensor) -> Tensor:
    """bool [..., S] -> int64 [...] with bit x = m[..., x]."""
    S = m.shape[-1]
    w = torch.ones(S, dtype=torch.int64, device=m.device) << torch.arange(
        S, dtype=torch.int64, device=m.device
    )
    return (m.to(torch.int64) * w).sum(-1)


def unpack_rows(b: Tensor, S: int) -> Tensor:
    """int64 [...] packed rows -> bool [..., S]."""
    sh = torch.arange(S, dtype=torch.int64, device=b.device)
    return ((b[..., None] >> sh) & 1).to(torch.bool)


def _dil6_bits(m: Tensor, full: int) -> Tensor:
    """6-neighbour dilation of bit-packed [Q, S(z), S(y)] rows (x in bits)."""
    p = F.pad(m, (1, 1, 1, 1))
    S = m.shape[1]
    return (
        m
        | ((m << 1) & full) | (m >> 1)
        | p[:, 2:, 1:-1] | p[:, :S, 1:-1]
        | p[:, 1:-1, 2:] | p[:, 1:-1, :S]
    )


def _dil6(m: Tensor) -> Tensor:
    """6-neighbour dilation of bool [Q, S, S, S] (= morphology.dilate6)."""
    p = F.pad(m, (1, 1, 1, 1, 1, 1))
    S = m.shape[1]
    return (
        m
        | p[:, 2:, 1:-1, 1:-1] | p[:, :S, 1:-1, 1:-1]
        | p[:, 1:-1, 2:, 1:-1] | p[:, 1:-1, :S, 1:-1]
        | p[:, 1:-1, 1:-1, 2:] | p[:, 1:-1, 1:-1, :S]
    )


def explore_plain(
    grid: GridSpec,
    vmap_grid: Tensor,
    qx: Tensor,
    qy: Tensor,
    qz: Tensor,
    qvalid: Tensor,
    max_manhattan: Tensor,
    thr_frontiers: float,
    thr_ground: float,
    submap: int,
    max_iters: int = 96,
    z_window: tuple[int, int] | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of K7: (connected bool [Q], reached int64 [Q, S, S]
    packed rows, corners int32 [Q, 3] (z, y, x) submap corner in grid
    coords)."""
    S = submap
    if S > 62:
        raise ValueError("explore submap side must be <= 62 (int64 rows)")
    half = S // 2
    dev = vmap_grid.device
    z_lo = 0 if z_window is None else z_window[0]
    padded = F.pad(vmap_grid, (half,) * 6, value=-1e30)  # outside: certain air
    bound = torch.clamp(max_manhattan, max=half - 1)

    # gather the Q submaps: padded[q + a] for a in [0, S) per axis (a query
    # outside a shard's window gathers clamped rows: it is invalid there)
    r = torch.arange(S, dtype=torch.int64, device=dev)
    zi = (qz.long()[:, None] - z_lo + r).clamp(0, padded.shape[0] - 1)[:, :, None, None]
    yi = (qy.long()[:, None] + r)[:, None, :, None]
    xi = (qx.long()[:, None] + r)[:, None, None, :]
    vals = padded[zi, yi, xi]  # [Q, S, S, S]

    rel = torch.abs(torch.arange(S, dtype=torch.int32, device=dev) - half)
    manh = rel[:, None, None] + rel[None, :, None] + rel[None, None, :]  # [S,S,S]

    unknown = (vals > thr_frontiers) & (vals <= thr_ground)
    ground = vals > thr_ground
    ball = manh[None] <= bound[:, None, None, None]
    expandable = unknown & ball

    full = (1 << S) - 1
    exp_bits = _pack_rows(expandable)  # [Q, S, S]
    # start: the centre voxel (built from comparisons: no host-to-device copy)
    is_mid = torch.arange(S, device=dev) == half
    cen = is_mid[:, None, None] & is_mid[None, :, None] & is_mid[None, None, :]
    bits = exp_bits & _pack_rows(cen)
    for _ in range(max_iters):
        bits = bits | (exp_bits & _dil6_bits(bits, full))
    bits = torch.where(qvalid[:, None, None], bits, 0)
    reached = unpack_rows(bits, S)

    closure = cen | (_dil6(reached) & ball)
    hit_ground = torch.any((closure & ground).reshape(len(qx), -1), dim=1)
    shell = manh[None] == (bound - 1)[:, None, None, None]
    hit_shell = torch.any((reached & shell).reshape(len(qx), -1), dim=1)
    # grid-edge starts are "connected" by definition (ref voxel_map.cpp:410-414)
    at_edge = (
        (qx <= 0) | (qy <= 0) | (qz <= 0)
        | (qx >= grid.nx - 1) | (qy >= grid.ny - 1) | (qz >= grid.nz - 1)
    )
    connected = (hit_ground | hit_shell | at_edge) & qvalid
    corners = torch.stack([qz - half, qy - half, qx - half], dim=-1).to(torch.int32)
    return connected, bits, corners


def explore(grid: GridSpec, vmap_grid: Tensor, qx: Tensor, qy: Tensor, qz: Tensor,
            qvalid: Tensor, max_manhattan: Tensor, thr_frontiers: float,
            thr_ground: float, submap: int, max_iters: int = 96,
            z_window: tuple[int, int] | None = None):
    """K7 (packed reached rows); see :func:`explore_plain`."""
    if vmap_grid.is_cuda:
        return kernels.explore(vmap_grid, qx, qy, qz, qvalid, max_manhattan,
                               thr_frontiers, thr_ground, submap, max_iters, z_window)
    if vmap_grid.device.type != "cpu":
        raise ValueError(f"explore: unsupported device {vmap_grid.device}")
    return explore_plain(grid, vmap_grid, qx, qy, qz, qvalid, max_manhattan,
                         thr_frontiers, thr_ground, submap, max_iters, z_window)


def explore_to_ground(grid: GridSpec, vmap_grid: Tensor, qx: Tensor, qy: Tensor,
                      qz: Tensor, qvalid: Tensor, max_manhattan: Tensor,
                      thr_frontiers: float, thr_ground: float, submap: int,
                      max_iters: int = 96) -> tuple[Tensor, Tensor, Tensor]:
    """The JAX-shaped form: (connected bool [Q], reached bool [Q, S, S, S]
    — explored unknown-band voxels, corners int32 [Q, 3])."""
    connected, bits, corners = explore(grid, vmap_grid, qx, qy, qz, qvalid, max_manhattan,
                                       thr_frontiers, thr_ground, submap, max_iters)
    return connected, unpack_rows(bits, submap), corners


def _demotion_writes(vmap_grid: Tensor, reached: Tensor, corners: Tensor,
                     demote: Tensor, thr_frontiers: float,
                     z_window: tuple[int, int] | None = None) -> tuple[Tensor, Tensor]:
    """(new grid, int32 count of demotion writes) — every reached voxel of a
    demoting query inside the grid ends at min(value, thr) whatever the order
    (explore.py:178-182 of the JAX package), so all Q patches go through one
    masked scatter; with no demoting query it is a no-op."""
    Q, S = reached.shape[0], reached.shape[1]
    nz, ny, nx = vmap_grid.shape
    z_lo, nz_g = (0, nz) if z_window is None else z_window
    dev = vmap_grid.device
    r = torch.arange(S, dtype=torch.int64, device=dev)
    zg = corners[:, 0].long()[:, None] + r
    z = zg - z_lo
    y = corners[:, 1].long()[:, None] + r
    x = corners[:, 2].long()[:, None] + r
    inz = (zg >= 0) & (zg < nz_g) & (z >= 0) & (z < nz)
    iny, inx = (y >= 0) & (y < ny), (x >= 0) & (x < nx)
    fid = (z[:, :, None, None] * ny + y[:, None, :, None]) * nx + x[:, None, None, :]
    inside = inz[:, :, None, None] & iny[:, None, :, None] & inx[:, None, None, :]
    hit = reached & demote[:, None, None, None] & inside
    nv = nz * ny * nx
    hit = hit.reshape(-1)
    fid = torch.where(hit, fid.reshape(-1), nv)  # nv: discarded slot
    # a plain (non-accumulating) scatter: every index but the discarded slot
    # receives True only, so duplicates agree and the result is exact
    cover = torch.zeros(nv + 1, dtype=torch.bool, device=dev)
    cover.index_put_((fid,), hit)
    cover = cover[:nv].reshape(vmap_grid.shape)
    new = torch.where(cover, torch.clamp(vmap_grid, max=thr_frontiers), vmap_grid)
    return new, hit.sum().to(torch.int32)


def apply_demotions(
    vmap_grid: Tensor,
    reached: Tensor,
    corners: Tensor,
    demote: Tensor,
    thr_frontiers: float,
) -> Tensor:
    """Write explored-unknown voxels of failed searches back to the frontiers
    score (ref vofod_nodelet.cpp:1709-1716); ``reached`` bool [Q, S, S, S]."""
    return _demotion_writes(vmap_grid, reached, corners, demote, thr_frontiers)[0]


def demote_floating_plain(vmap_grid: Tensor, reached_bits: Tensor, corners: Tensor,
                          qslot: Tensor, connected: Tensor, qvalid: Tensor, qgate: Tensor,
                          query_overflow: Tensor, thr_frontiers: float,
                          z_window: tuple[int, int] | None = None) -> tuple[Tensor, Tensor]:
    """Plain version of K8: the demote decision of vofod_tpu/pipeline/
    classify.py:188-194 — a valid query demotes when a slot it belongs to
    passed the explore gate (``qgate``), none of that slot's queries
    connected, and the queries did not overflow — then the write-back.
    Returns (new grid, int32 count of demotion writes)."""
    cluster_connected = torch.any(qslot & connected[:, None], dim=0)  # [K]
    floating = qgate & ~cluster_connected & ~query_overflow
    demote = qvalid & torch.any(qslot & floating[None, :], dim=1)
    reached = unpack_rows(reached_bits, reached_bits.shape[-1])
    return _demotion_writes(vmap_grid, reached, corners, demote, thr_frontiers, z_window)


def demote_floating(vmap_grid: Tensor, reached_bits: Tensor, corners: Tensor,
                    qslot: Tensor, connected: Tensor, qvalid: Tensor, qgate: Tensor,
                    query_overflow: Tensor, thr_frontiers: float,
                    z_window: tuple[int, int] | None = None) -> tuple[Tensor, Tensor]:
    """K8.  On a CUDA tensor the kernel updates ``vmap_grid`` IN PLACE and
    returns it; the plain version returns a new tensor.  Callers use the
    returned grid and must not read ``vmap_grid`` afterwards."""
    if vmap_grid.is_cuda:
        n = kernels.demote_(vmap_grid, reached_bits, corners, qslot, connected, qvalid,
                            qgate, query_overflow, thr_frontiers, z_window)
        return vmap_grid, n
    if vmap_grid.device.type != "cpu":
        raise ValueError(f"demote: unsupported device {vmap_grid.device}")
    return demote_floating_plain(vmap_grid, reached_bits, corners, qslot, connected, qvalid,
                                 qgate, query_overflow, thr_frontiers, z_window)


def explore_sequential_plain(grid: GridSpec, vmap_grid: Tensor, qx: Tensor, qy: Tensor,
                             qz: Tensor, qvalid: Tensor, qlabels: Tensor, qids: Tensor,
                             qslot: Tensor, max_manhattan: Tensor, query_overflow: Tensor,
                             thr_frontiers: float, thr_ground: float, submap: int,
                             max_iters: int = 96) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of K7s: (new grid, cluster_connected bool [K], int32
    count of demotion writes).  The queries run in ``jnp.lexsort((qids,
    qlabels))`` order; one is skipped when it is invalid, its slot already
    connected, or the queries overflowed (the lax.scan of vofod_tpu/pipeline/
    classify.py:222-267); a query that fails demotes its reached voxels at
    once (min(v, thr_frontiers)).  A host loop that reads the query table
    back: it never runs on the card's main path."""
    K = qslot.shape[1]
    dev = vmap_grid.device
    conn = torch.zeros(K, dtype=torch.bool, device=dev)
    n_writes = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    if bool(query_overflow):
        return vmap_grid, conn, n_writes
    labels, ids, valid = qlabels.tolist(), qids.tolist(), qvalid.tolist()
    for q in sorted(range(len(labels)), key=lambda i: (labels[i], ids[i], i)):
        if not valid[q] or bool(torch.any(qslot[q] & conn)):
            continue
        s = slice(q, q + 1)
        connected, bits, corners = explore_plain(
            grid, vmap_grid, qx[s], qy[s], qz[s], one, max_manhattan[s], thr_frontiers,
            thr_ground, submap, max_iters)
        if bool(connected[0]):
            conn = conn | qslot[q]
        else:
            vmap_grid, n = _demotion_writes(vmap_grid, unpack_rows(bits, submap), corners, one,
                                            thr_frontiers)
            n_writes = n_writes + n
    return vmap_grid, conn, n_writes


def explore_sequential_(grid: GridSpec, vmap_grid: Tensor, qx: Tensor, qy: Tensor, qz: Tensor,
                        qvalid: Tensor, qlabels: Tensor, qids: Tensor, qslot: Tensor,
                        max_manhattan: Tensor, query_overflow: Tensor, thr_frontiers: float,
                        thr_ground: float, submap: int,
                        max_iters: int = 96) -> tuple[Tensor, Tensor, Tensor]:
    """K7s: (grid, cluster_connected bool [K], n_writes int32).  On a CUDA
    tensor the kernel updates ``vmap_grid`` IN PLACE and returns it; the
    plain version returns a new tensor.  Callers use the returned grid."""
    if vmap_grid.is_cuda:
        conn, n = kernels.explore_sequential_(
            vmap_grid, qx, qy, qz, qvalid, qlabels, qids, qslot, max_manhattan, query_overflow,
            thr_frontiers, thr_ground, submap, max_iters)
        return vmap_grid, conn, n
    if vmap_grid.device.type != "cpu":
        raise ValueError(f"explore_sequential: unsupported device {vmap_grid.device}")
    return explore_sequential_plain(grid, vmap_grid, qx, qy, qz, qvalid, qlabels, qids, qslot,
                                    max_manhattan, query_overflow, thr_frontiers, thr_ground,
                                    submap, max_iters)
