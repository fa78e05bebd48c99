"""Bounded flood-fill to ground (K7), the demotion write-back (K8) and the
sequential explore with live demotion (K7s).

PyTorch counterpart of vofod_tpu/ops/explore.py (ref src/voxel_map.cpp
:402-488, call site vofod_nodelet.cpp:1692-1718): per query an SxSxS submap
around the query voxel, then a masked 6-neighbour BFS through the unknown
band (frontiers < v <= ground) inside the query's Manhattan ball.  For CUDA
tensors both steps are hand-written kernels (csrc/explore.cu: one block per
query; K7's masks bit-packed in registers for S <= 32, in shared memory
past it); CPU tensors take the plain versions here.  The kernels' schedules
have plain models here too, held to the JAX package by the CPU tests:
:func:`explore_planes_plain` (K7's warps of z planes, lane = y, its level
loop; it also returns each query's sweep count) and
:func:`demote_rows_plain` (K8's verdict words and row stores).  K8 returns
``cluster_connected`` beside the grid and its count, and on the card its
count is the int32 K7 zeroed after its corners (``kernels.demote_count``).

The reached set travels between the two as packed rows: int64 [Q, S, S]
with bit x of row (z, y) set when voxel (z, y, x) of the query's submap was
explored (S <= 64).  :func:`explore_to_ground` and :func:`apply_demotions`
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

K15b-7a/b/c are K7s on the grid-sharded step (parallel/gridops.py
``ZShardOps.explore_sequential``): the walk's BFS reads two bits a voxel
(unknown band, ground) of its queries' submaps only, so each shard cuts
those bits of its own rows (:func:`explore_cut`, a [Q, 2, S, S] stack of
packed rows; its launch's schedule block by block:
:func:`explore_cut_blocks_plain`), a psum replicates the stack, every shard
walks the queries on it (:func:`explore_sequential_stack`, a failed query's
reached voxels leaving the later queries' band), and each shard writes the
failed queries' demotions into its own rows (K15b-7c).  On the card the
walk's launch stores them as each query fails (:func:`explore_seq_fused_plain`
models it); on the CPU :func:`demote_direct_plain` writes them after the
walk.

On the card K7s and K15b-7b are one launch each that speculates, then
commits: every valid query is flooded at once on the grid before the walk,
and one block's walk floods again only the queries whose speculative flood
meets an earlier failed query's.  :func:`explore_sequential_spec_plain` is
that schedule's plain model, held by the tests to both plain versions and
to the JAX package.
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


def _full(S: int) -> int:
    """The int64 value of a row's S low bits (all 64: -1)."""
    return -1 if S == 64 else (1 << S) - 1


def _shr(m: Tensor, k: int) -> Tensor:
    """Rows shifted right by k >= 0 bits as unsigned words (torch's int64
    shift carries bit 63 down)."""
    return (m >> k) & _full(64 - k) if k else m


def _dil6_bits(m: Tensor, full: int) -> Tensor:
    """6-neighbour dilation of bit-packed [Q, S(z), S(y)] rows (x in bits)."""
    p = F.pad(m, (1, 1, 1, 1))
    S = m.shape[1]
    return (
        m
        | ((m << 1) & full) | _shr(m, 1)
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


def _manhattan(S: int, dev) -> Tensor:
    """int32 [S, S, S]: each submap voxel's Manhattan distance to the centre."""
    rel = torch.abs(torch.arange(S, dtype=torch.int32, device=dev) - S // 2)
    return rel[:, None, None] + rel[None, :, None] + rel[None, None, :]


def _bfs_plain(unknown: Tensor, ground: Tensor, bound: Tensor, max_iters: int,
               until_fixpoint: bool = False) -> tuple[Tensor, Tensor]:
    """K7's BFS on bool [Q, S, S, S] unknown-band and ground masks with
    Manhattan bounds ``bound`` int32 [Q]: (reached packed int64 [Q, S, S],
    hit bool [Q] — the flood's closure touched ground or the reached set the
    shell at bound - 1).  ``until_fixpoint``: stop at the first sweep that
    changes nothing (a host read per sweep; the same result)."""
    Q, S = unknown.shape[0], unknown.shape[1]
    dev = unknown.device
    half = S // 2
    manh = _manhattan(S, dev)
    ball = manh[None] <= bound[:, None, None, None]
    full = _full(S)
    exp_bits = _pack_rows(unknown & ball)  # [Q, S, S]
    # start: the centre voxel (built from comparisons: no host-to-device copy)
    is_mid = torch.arange(S, device=dev) == half
    cen = is_mid[:, None, None] & is_mid[None, :, None] & is_mid[None, None, :]
    bits = exp_bits & _pack_rows(cen)
    for _ in range(max_iters):
        new = bits | (exp_bits & _dil6_bits(bits, full))
        if until_fixpoint and torch.equal(new, bits):
            break
        bits = new
    reached = unpack_rows(bits, S)
    closure = cen | (_dil6(reached) & ball)
    hit_ground = torch.any((closure & ground).reshape(Q, -1), dim=1)
    shell = manh[None] == (bound - 1)[:, None, None, None]
    hit_shell = torch.any((reached & shell).reshape(Q, -1), dim=1)
    return bits, hit_ground | hit_shell


# K7's schedule for S <= 32 (csrc/explore.cu explore_planes_kernel, its
# constexprs EXPLORE_WARPS and EXPLORE_PLANES): each of the block's warps
# owns PLANES consecutive z planes of the submap, lane y holding the word of
# row (z, y) of each in a register
EXPLORE_WARPS = 8
EXPLORE_PLANES = 32 // EXPLORE_WARPS


def _lanes(rows: Tensor) -> Tensor:
    """[Q, S(z), S(y)] words -> the kernel's registers [Q, WARPS, PLANES, 32
    lanes] (lane = y; 0 past S in z and y)."""
    Q, S = rows.shape[0], rows.shape[1]
    out = rows.new_zeros((Q, 32, 32))
    out[:, :S, :S] = rows
    return out.reshape(Q, EXPLORE_WARPS, EXPLORE_PLANES, 32)


def _edge_planes(cur: Tensor) -> tuple[Tensor, Tensor]:
    """(below, above) [Q, WARPS, 32]: the planes next to each warp's first
    and last, read from the other warps' edge planes in shared memory (0
    past the submap)."""
    first, last = cur[:, :, 0], cur[:, :, -1]
    return F.pad(last[:, :-1], (0, 0, 1, 0)), F.pad(first[:, 1:], (0, 0, 0, 1))


def _lane_dil6(cur: Tensor, full: int) -> Tensor:
    """6-neighbour dilation of the registers: x by shifts, y from lanes y -/+
    1 (``__shfl_up_sync`` / ``__shfl_down_sync``, masked at lanes 0 and 31),
    z from the warp's own neighbouring planes or, at its edge planes, from
    :func:`_edge_planes`."""
    below, above = _edge_planes(cur)
    zm = torch.cat([below[:, :, None], cur[:, :, :-1]], dim=2)
    zp = torch.cat([cur[:, :, 1:], above[:, :, None]], dim=2)
    ym, yp = F.pad(cur[..., :-1], (1, 0)), F.pad(cur[..., 1:], (0, 1))
    return cur | ((cur << 1) & full) | (cur >> 1) | zm | zp | ym | yp


def _ring_bits(dzy: Tensor, s: Tensor, half: int, shell: bool) -> Tensor:
    """Each lane's row bits at Manhattan distance <= s (``ball_bits``) or ==
    s (``shell_bits``) from the centre; ``dzy`` the row's |dz| + |dy|."""
    rem = s - dzy
    r = rem.clamp(min=0)
    one = torch.ones_like(r)
    bits = ((one << (half - r)) | (one << (half + r)) if shell
            else ((one << (2 * r + 1)) - 1) << (half - r))
    return torch.where(rem >= 0, bits, 0)


def explore_planes_plain(grid: GridSpec, vmap_grid: Tensor, qx: Tensor, qy: Tensor, qz: Tensor,
                         qvalid: Tensor, max_manhattan: Tensor, thr_frontiers: float,
                         thr_ground: float, submap: int, max_iters: int = 96,
                         z_window: tuple[int, int] | None = None):
    """K7's schedule for S <= 32, step by step: (connected bool [Q], reached
    int64 [Q, S, S], corners int32 [Q, 3], sweeps int32 [Q] — the Jacobi
    sweeps each query's block ran, 0 for an invalid query).

    The load: lane x of a warp reads voxel x of each of its rows, and two
    ballots give the row's band and ground words, which lane y keeps.  A
    level: every warp puts its first and last planes into shared memory,
    one barrier ORs the blocks' "changed" flags (the block leaves at the
    first level that saw no change, or after ``max_iters`` sweeps), then
    each lane computes its planes' next words from registers, shuffles and
    the neighbouring warps' edge planes (parity-buffered, so one barrier a
    level).  The closure, ground and shell tests run on the fixpoint's
    registers."""
    S = submap
    if not 2 <= S <= 32:
        raise ValueError(f"K7's register schedule takes S in [2, 32], got {S}")
    half, dev = S // 2, vmap_grid.device
    z_lo = 0 if z_window is None else z_window[0]
    vals = _submaps(vmap_grid, qx, qy, qz, S, z_lo)
    gz = qz.long()[:, None] - half - z_lo + torch.arange(S, device=dev)
    inz = ((gz >= 0) & (gz < vmap_grid.shape[0]))[:, :, None, None]
    vals = torch.where(inz, vals, -1e30)  # rows past the buffer: certain air
    band = _pack_rows((vals > thr_frontiers) & (vals <= thr_ground))
    ground = _pack_rows(vals > thr_ground)
    hit, reached, sweeps = _planes_flood(band, ground, max_manhattan, qvalid, max_iters)
    connected = (hit | _at_grid_edge(grid, qx, qy, qz)) & qvalid
    corners = torch.stack([qz - half, qy - half, qx - half], dim=-1).to(torch.int32)
    return connected, reached, corners, sweeps


def _planes_flood(band: Tensor, ground: Tensor, max_manhattan: Tensor, qvalid: Tensor,
                  max_iters: int) -> tuple[Tensor, Tensor, Tensor]:
    """K7's flood on the block's registers (csrc/explore.cu planes_flood),
    from the [Q, S, S] band and ground words of each query's submap: (hit
    bool [Q] — the closure touched ground or the reached set the shell at
    bound - 1 —, reached int64 [Q, S, S] (0 for an invalid query), sweeps
    int32 [Q]).  Only the ``qvalid`` queries flood."""
    Q, S = band.shape[0], band.shape[-1]
    half, dev = S // 2, band.device
    band, ground = _lanes(band), _lanes(ground)
    lane = torch.arange(32, device=dev)
    z = lane.reshape(EXPLORE_WARPS, EXPLORE_PLANES)  # the plane of (warp, j)
    dzy = ((z - half).abs()[:, :, None] + (lane - half).abs()[None, None, :])[None]
    bound = torch.clamp(max_manhattan, max=half - 1).long()[:, None, None, None]
    ball = _ring_bits(dzy, bound, half, shell=False)
    centre = torch.where((z == half)[:, :, None] & (lane == half)[None, None, :], 1 << half, 0)
    expandable = band & ball
    cur = expandable & centre
    full = (1 << S) - 1

    sweeps = torch.zeros(Q, dtype=torch.int32, device=dev)
    running = qvalid.clone()  # an invalid query's block stores empty rows and leaves
    for _ in range(max_iters):
        if not bool(running.any()):
            break
        new = cur | (expandable & _lane_dil6(cur, full))
        changed = (new != cur).any(dim=(1, 2, 3))
        cur = torch.where(running[:, None, None, None], new, cur)
        sweeps += running.to(torch.int32)
        running = running & changed
    clo = (_lane_dil6(cur, full) & ball) | centre
    shell = _ring_bits(dzy, bound - 1, half, shell=True)
    hit = ((clo & ground) != 0).any(dim=(1, 2, 3)) | ((cur & shell) != 0).any(dim=(1, 2, 3))
    reached = torch.where(qvalid[:, None, None], cur.reshape(Q, 32, 32)[:, :S, :S], 0)
    return hit, reached, sweeps


def _at_grid_edge(grid: GridSpec, qx: Tensor, qy: Tensor, qz: Tensor) -> Tensor:
    """Grid-edge starts are "connected" by definition (ref voxel_map.cpp
    :410-414)."""
    return ((qx <= 0) | (qy <= 0) | (qz <= 0)
            | (qx >= grid.nx - 1) | (qy >= grid.ny - 1) | (qz >= grid.nz - 1))


def _submaps(vmap_grid: Tensor, qx: Tensor, qy: Tensor, qz: Tensor, S: int, z_lo: int,
             fill: float = -1e30) -> Tensor:
    """The Q submaps [Q, S, S, S] at the corners (q - S // 2) of a grid
    holding the z rows [z_lo, z_lo + rows): ``fill`` past x and y; a row past
    z gathers a clamped row (the callers mask it)."""
    half = S // 2
    padded = F.pad(vmap_grid, (half,) * 4, value=fill)  # y and x only
    r = torch.arange(S, dtype=torch.int64, device=vmap_grid.device)
    zi = (qz.long()[:, None] - half - z_lo + r).clamp(0, vmap_grid.shape[0] - 1)
    yi = (qy.long()[:, None] + r)[:, None, :, None]
    xi = (qx.long()[:, None] + r)[:, None, None, :]
    return padded[zi[:, :, None, None], yi, xi]


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
    if S > 64:
        raise ValueError("explore submap side must be <= 64 (int64 rows)")
    half = S // 2
    z_lo = 0 if z_window is None else z_window[0]
    vals = _submaps(vmap_grid, qx, qy, qz, S, z_lo)  # [Q, S, S, S]
    # rows past the grid read as certain air
    gz = qz.long()[:, None] - half - z_lo + torch.arange(S, device=vmap_grid.device)
    inz = ((gz >= 0) & (gz < vmap_grid.shape[0]))[:, :, None, None]
    vals = torch.where(inz, vals, -1e30)
    unknown = (vals > thr_frontiers) & (vals <= thr_ground) & qvalid[:, None, None, None]
    bound = torch.clamp(max_manhattan, max=half - 1)
    bits, hit = _bfs_plain(unknown, vals > thr_ground, bound, max_iters)
    connected = (hit | _at_grid_edge(grid, qx, qy, qz)) & qvalid
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
                          z_window: tuple[int, int] | None = None
                          ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version of K8: the demote decision of vofod_tpu/pipeline/
    classify.py:188-194 — a valid query demotes when a slot it belongs to
    passed the explore gate (``qgate``), none of that slot's queries
    connected, and the queries did not overflow — then the write-back.
    Returns (new grid, int32 count of demotion writes, cluster_connected
    bool [K] — the slots with a connected query)."""
    cluster_connected = torch.any(qslot & connected[:, None], dim=0)  # [K]
    floating = qgate & ~cluster_connected & ~query_overflow
    demote = qvalid & torch.any(qslot & floating[None, :], dim=1)
    reached = unpack_rows(reached_bits, reached_bits.shape[-1])
    new, n = _demotion_writes(vmap_grid, reached, corners, demote, thr_frontiers, z_window)
    return new, n, cluster_connected


def demote_rows_plain(vmap_grid: Tensor, reached_bits: Tensor, corners: Tensor, qslot: Tensor,
                      connected: Tensor, qvalid: Tensor, qgate: Tensor, query_overflow: Tensor,
                      thr_frontiers: float, z_window: tuple[int, int] | None = None
                      ) -> tuple[Tensor, Tensor, Tensor]:
    """K8's schedule, step by step: (new grid, int32 count, cluster_connected
    bool [K]), :func:`demote_floating_plain`'s.

    The verdict: thread p of a block reads ``connected[p]`` and, when set,
    packs query p's slots into ceil(K / 32) words; each warp ORs its 32
    queries' words (``__reduce_or_sync``) and the warps OR theirs into
    shared memory; a valid query under no overflow demotes when one of its
    gated slots has no bit there.  The stores: each warp takes 32 rows at a
    time; a row whose word is 0, or that lies outside the buffer and the
    grid in z or y, is skipped; a non-empty one stores min(v, thr) at its
    set bits inside the grid in x (lane = x, NaN kept) and counts them
    (``__popc``)."""
    Q, S = reached_bits.shape[0], reached_bits.shape[1]
    K = qslot.shape[1]
    nz, ny, nx = vmap_grid.shape
    z_lo, nz_g = (0, nz) if z_window is None else z_window
    dev = vmap_grid.device
    kw = -(-K // 32)
    # the verdict: the warps' OR of their queries' slot words, then the block's
    words = _pack_rows(F.pad(qslot & connected[:, None], (0, 32 * kw - K)).reshape(Q, kw, 32))
    lanes = F.pad(words, (0, 0, 0, -Q % 32)).reshape(-1, 32, kw)
    bits = unpack_rows(lanes, 32).any(dim=1).any(dim=0)  # [kw, 32]: the block's words
    cluster_connected = bits.reshape(-1)[:K]
    floating = qgate & ~cluster_connected
    demote = qvalid & ~query_overflow & torch.any(qslot & floating[None, :], dim=1)
    # the stores: a row r = z * S + y of query q, its word inside the grid
    r = torch.arange(S * S, device=dev)
    gz = corners[:, 0].long()[:, None] + r // S
    gy = corners[:, 1].long()[:, None] + r % S
    lz = gz - z_lo
    row_in = (gz >= 0) & (gz < nz_g) & (lz >= 0) & (lz < nz) & (gy >= 0) & (gy < ny)
    x0 = corners[:, 2].long()
    xlo, xhi = (-x0).clamp(min=0), (nx - x0).clamp(max=S)
    width = (xhi - xlo).clamp(min=0)
    low = torch.where(width >= 64, -1, (1 << width.clamp(max=63)) - 1)
    xmask = torch.where(xhi > xlo, low << xlo, 0)
    w = torch.where(row_in & demote[:, None], reached_bits.reshape(Q, -1) & xmask[:, None], 0)
    hit = unpack_rows(w, S)  # [Q, S * S, S]: lane x of each non-empty row
    count = hit.sum().to(torch.int32)
    x = x0[:, None, None] + torch.arange(S, device=dev)
    fid = (lz.clamp(0, nz - 1)[:, :, None] * ny + gy.clamp(0, ny - 1)[:, :, None]) * nx + x
    ids = fid[hit]
    flat = vmap_grid.reshape(-1).clone()
    v = flat[ids]
    flat[ids] = torch.where(v > thr_frontiers, thr_frontiers, v)  # NaN kept
    return flat.reshape(vmap_grid.shape), count, cluster_connected


def demote_floating(vmap_grid: Tensor, reached_bits: Tensor, corners: Tensor,
                    qslot: Tensor, connected: Tensor, qvalid: Tensor, qgate: Tensor,
                    query_overflow: Tensor, thr_frontiers: float,
                    z_window: tuple[int, int] | None = None) -> tuple[Tensor, Tensor, Tensor]:
    """K8: (grid, n_writes int32, cluster_connected bool [K]).  On a CUDA
    tensor the kernel updates ``vmap_grid`` IN PLACE and returns it, and its
    count is the one beside K7's ``corners`` (``kernels.demote_count``); the
    plain version returns a new tensor.  Callers use the returned grid and
    must not read ``vmap_grid`` afterwards."""
    if vmap_grid.is_cuda:
        n, cluster_connected = kernels.demote_(vmap_grid, reached_bits, corners, qslot,
                                               connected, qvalid, qgate, query_overflow,
                                               thr_frontiers, z_window)
        return vmap_grid, n, cluster_connected
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


# ---- the sequential explore over z shards (K15b-7) ---------------------------------


def _words_i64(w: Tensor) -> Tensor:
    """Packed rows as non-negative int64 (the 32-bit words zero-extended)."""
    return w.to(torch.int64) & 0xFFFFFFFF if w.dtype == torch.int32 else w


def explore_cut_plain(vmap_grid: Tensor, qx: Tensor, qy: Tensor, qz: Tensor, qvalid: Tensor,
                      thr_frontiers: float, thr_ground: float, submap: int,
                      z_lo: int = 0) -> Tensor:
    """Plain version of K15b-7a, the cut: the [Q, 2, S, S] packed rows
    (``kernels.stack_words``: 32-bit for S <= 32) of every valid query's
    submap — the unknown band (thr_frontiers < v <= thr_ground), then
    ground (v > thr_ground) — for the submap rows inside ``vmap_grid``,
    which holds the z rows [z_lo, z_lo + rows) of the grid; every other row
    is 0, as are the voxels past the grid in x and y (air)."""
    S = submap
    dev = vmap_grid.device
    vals = _submaps(vmap_grid, qx, qy, qz, S, z_lo)
    gz = qz.long()[:, None] - S // 2 - z_lo + torch.arange(S, device=dev)
    own = ((gz >= 0) & (gz < vmap_grid.shape[0]))[:, :, None, None] & qvalid[:, None, None, None]
    band = own & (vals > thr_frontiers) & (vals <= thr_ground)
    ground = own & (vals > thr_ground)
    return torch.stack([_pack_rows(band), _pack_rows(ground)], dim=1).to(kernels.stack_words(S))


def explore_cut(vmap_grid: Tensor, qx: Tensor, qy: Tensor, qz: Tensor, qvalid: Tensor,
                thr_frontiers: float, thr_ground: float, submap: int, z_lo: int = 0) -> Tensor:
    """K15b-7a; see :func:`explore_cut_plain`."""
    if vmap_grid.is_cuda:
        return kernels.explore_cut(vmap_grid, qx, qy, qz, qvalid, thr_frontiers, thr_ground,
                                   submap, z_lo)
    if vmap_grid.device.type != "cpu":
        raise ValueError(f"explore cut: unsupported device {vmap_grid.device}")
    return explore_cut_plain(vmap_grid, qx, qy, qz, qvalid, thr_frontiers, thr_ground, submap,
                             z_lo)


def cut_block_planes(S: int, planes: int, chunk: int, z0: int, z_lo: int, nz: int,
                     valid: bool) -> tuple[int, int, int, int]:
    """K15b-7a's block for one chunk of a slot (csrc/explore.cu
    explore_cut_kernel): (p0, p1, za, zb) — its submap planes [p0, p1), and
    [za, zb) the ones it loads, those in the slab's rows [z_lo, z_lo + nz)
    of a submap whose corner is at z0 (none for an invalid slot: za = zb =
    p1).  It zeroes its other planes' words."""
    p0 = chunk * planes
    p1 = min(S, p0 + planes)
    za, zb = max(p0, z_lo - z0), min(p1, z_lo + nz - z0)
    if not valid or za >= zb:
        za = zb = p1
    return p0, p1, za, zb


def explore_cut_blocks_plain(vmap_grid: Tensor, qx: Tensor, qy: Tensor, qz: Tensor,
                             qvalid: Tensor, thr_frontiers: float, thr_ground: float,
                             submap: int, z_lo: int = 0, planes: int | None = None,
                             warps: int | None = None) -> Tensor:
    """The schedule of K15b-7a's launch, block by block (``planes`` z planes
    of a slot a block, ``warps`` warps; default the kernel's
    ``kernels.CUT_PLANES`` / ``CUT_WARPS``): each block zeroes the words of
    its planes outside the slab (:func:`cut_block_planes`) and writes the
    band and ground words of its slab rows, warp w taking rows i0 .. i0 +
    CUT_ROWS - 1 for i0 = (w + k * warps) * CUT_ROWS.  Raises unless every
    word of the stack is written exactly once.  The tests hold it to
    :func:`explore_cut_plain`."""
    S = submap
    planes = min(S, kernels.CUT_PLANES if planes is None else planes)
    warps = kernels.CUT_WARPS if warps is None else warps
    R, Q, half = kernels.CUT_ROWS, qx.shape[0], S // 2
    nz, dev = vmap_grid.shape[0], vmap_grid.device
    padded = F.pad(vmap_grid, (S,) * 4, value=-1e30)  # past the grid in x and y: air
    out = torch.zeros((Q, 2, S * S), dtype=torch.int64, device=dev)
    writes = torch.zeros((Q, 2, S * S), dtype=torch.int32, device=dev)
    for q in range(Q):
        z0, y0, x0 = (int(c) - half for c in (qz[q], qy[q], qx[q]))
        for chunk in range(-(-S // planes)):
            p0, p1, za, zb = cut_block_planes(S, planes, chunk, z0, z_lo, nz, bool(qvalid[q]))
            for lo, hi in ((p0, za), (zb, p1)):  # the zero stores (out holds 0)
                writes[q, :, lo * S:hi * S] += 1
            n = (zb - za) * S
            if n == 0:
                continue
            i = torch.cat([torch.arange(i0, min(i0 + R, n), device=dev) for w in range(warps)
                           for i0 in range(w * R, n, warps * R)])
            lz, gy = z0 + za + i // S - z_lo, y0 + i % S
            v = padded[lz[:, None], (gy + S)[:, None],
                       x0 + S + torch.arange(S, device=dev)[None, :]]
            rows = za * S + i
            out[q, 0, rows] = _pack_rows((v > thr_frontiers) & (v <= thr_ground))
            out[q, 1, rows] = _pack_rows(v > thr_ground)
            writes[q, :, rows] += 1
    if not bool((writes == 1).all()):
        raise AssertionError("K15b-7a's blocks do not write every word of the stack once")
    return out.reshape(Q, 2, S, S).to(kernels.stack_words(S))


def explore_sequential_stack_plain(grid: GridSpec, stack: Tensor, qx: Tensor, qy: Tensor,
                                   qz: Tensor, qvalid: Tensor, qlabels: Tensor, qids: Tensor,
                                   qslot: Tensor, max_manhattan: Tensor, query_overflow: Tensor,
                                   max_iters: int = 96):
    """Plain version of K15b-7b, the walk: K7s on the cut's stack ([Q, 2, S,
    S] words of the whole grid) in place of the grid.  Returns
    (cluster_connected bool [K], reached [Q, S, S] words of the failed
    queries — 0 elsewhere, corners int32 [Q, 3], demoted bool [Q] — the
    failed queries).  The order, the skips and the grid-edge rule are
    :func:`explore_sequential_plain`'s; a query's unknown band loses the
    voxels every earlier failed query reached (they were demoted to
    thr_frontiers, which is neither band nor ground), kept here on a mask
    of the grid.  A host loop: never on the card's main path."""
    Q, S = stack.shape[0], stack.shape[-1]
    K = qslot.shape[1]
    half = S // 2
    dev = stack.device
    conn = torch.zeros(K, dtype=torch.bool, device=dev)
    reached = torch.zeros((Q, S, S), dtype=stack.dtype, device=dev)
    demoted = torch.zeros(Q, dtype=torch.bool, device=dev)
    corners = torch.stack([qz - half, qy - half, qx - half], dim=-1).to(torch.int32)
    if bool(query_overflow):
        return conn, reached, corners, demoted
    # the voxels demoted so far, on the grid padded by S (any box fits)
    gone = torch.zeros((grid.nz + 2 * S, grid.ny + 2 * S, grid.nx + 2 * S), dtype=torch.bool,
                       device=dev)
    edge = _at_grid_edge(grid, qx, qy, qz).tolist()
    bound = torch.clamp(max_manhattan, max=half - 1)
    labels, ids, valid = qlabels.tolist(), qids.tolist(), qvalid.tolist()
    for q in sorted(range(Q), key=lambda i: (labels[i], ids[i], i)):
        if not valid[q] or bool(torch.any(qslot[q] & conn)):
            continue
        if edge[q]:
            conn = conn | qslot[q]
            continue
        z0, y0, x0 = (int(c) + S for c in corners[q])
        box = (slice(z0, z0 + S), slice(y0, y0 + S), slice(x0, x0 + S))
        band = unpack_rows(_words_i64(stack[q, 0]), S) & ~gone[box]
        ground = unpack_rows(_words_i64(stack[q, 1]), S)
        bits, hit = _bfs_plain(band[None], ground[None], bound[q:q + 1], max_iters,
                               until_fixpoint=True)
        if bool(hit[0]):
            conn = conn | qslot[q]
        else:
            reached[q] = bits[0].to(stack.dtype)
            demoted[q] = True
            gone[box] |= unpack_rows(bits[0], S)
    return conn, reached, corners, demoted


def _shifted_rows(w: Tensor, d: tuple[int, int, int]) -> Tensor:
    """The [S, S] rows ``w`` of a failed query's box seen from a box at d =
    (dz, dy, dx) = that box's corner - its corner (|d| < S): row (z, y) is
    w's row (z + dz, y + dy) shifted right by dx (left by -dx), 0 where that
    row lies outside ``w`` — K15b-7b's word shifts."""
    S = w.shape[-1]
    dz, dy, dx = d
    out = torch.zeros_like(w)
    z0, z1, y0, y1 = max(0, -dz), min(S, S - dz), max(0, -dy), min(S, S - dy)
    src = w[z0 + dz:z1 + dz, y0 + dy:y1 + dy]
    out[z0:z1, y0:y1] = _shr(src, dx) if dx >= 0 else (src << -dx) & _full(S)
    return out


def explore_sequential_spec_plain(grid: GridSpec, words: Tensor, qx: Tensor, qy: Tensor,
                                  qz: Tensor, qvalid: Tensor, qlabels: Tensor, qids: Tensor,
                                  qslot: Tensor, max_manhattan: Tensor, query_overflow: Tensor,
                                  max_iters: int = 96):
    """The schedule of K7s's and K15b-7b's launch (csrc/explore.cu
    explore_spec_kernel), step by step, on the [Q, 2, S, S] band and ground
    words of each query's submap (:func:`explore_cut_plain` of the whole
    grid: what K7s's blocks load, K15b-7b's stack).  Returns
    (cluster_connected bool [K], reached [Q, S, S] words of the failed
    queries — 0 elsewhere, corners int32 [Q, 3], demoted bool [Q], redo —
    the floods the walk ran again): :func:`explore_sequential_stack_plain`'s
    outputs, and K7s's grid and count are :func:`demote_direct_plain` of
    them.  A test instrument, not the CPU path.

    1. Every valid query that does not start at the grid's edge is flooded
       on the grid before the walk (K7's register flood for S <= 32, the
       packed-row BFS past it), all at once.
    2. The walk takes the valid queries in (label, id, index) order and skips
       one whose cluster connected; a grid-edge start connects.
    3. Any other query's speculative rows are tested against the rows of
       every earlier failed query whose box overlaps its own (K15b-7b's word
       shifts, :func:`_shifted_rows`).
    4. With no voxel in common the speculative verdict and rows stand;
       otherwise the query is flooded again on its band minus those rows."""
    Q, S = words.shape[0], words.shape[-1]
    K = qslot.shape[1]
    half, dev = S // 2, words.device
    conn = torch.zeros(K, dtype=torch.bool, device=dev)
    reached = torch.zeros((Q, S, S), dtype=words.dtype, device=dev)
    demoted = torch.zeros(Q, dtype=torch.bool, device=dev)
    corners = torch.stack([qz - half, qy - half, qx - half], dim=-1).to(torch.int32)
    if bool(query_overflow):
        return conn, reached, corners, demoted, 0
    band, ground = _words_i64(words[:, 0]), _words_i64(words[:, 1])
    edge = _at_grid_edge(grid, qx, qy, qz)

    def flood(b: Tensor, g: Tensor, mm: Tensor, live: Tensor) -> tuple[Tensor, Tensor]:
        if S <= 32:
            hit, rows, _ = _planes_flood(b, g, mm, live, max_iters)
            return hit, rows
        bound = torch.clamp(mm, max=half - 1)
        rows, hit = _bfs_plain(unpack_rows(b, S) & live[:, None, None, None],
                               unpack_rows(g, S), bound, max_iters)
        return hit, rows

    spec_hit, spec_rows = flood(band, ground, max_manhattan, qvalid & ~edge)
    labels, ids, valid = qlabels.tolist(), qids.tolist(), qvalid.tolist()
    box = corners.tolist()
    failed, redo = [], 0
    for q in sorted(range(Q), key=lambda i: (labels[i], ids[i], i)):
        if not valid[q] or bool(torch.any(qslot[q] & conn)):
            continue
        if bool(edge[q]):
            conn = conn | qslot[q]
            continue
        clear = torch.zeros((S, S), dtype=torch.int64, device=dev)
        for f in failed:
            d = tuple(a - b for a, b in zip(box[q], box[f]))
            if max(abs(v) for v in d) < S:
                clear |= _shifted_rows(_words_i64(reached[f]), d)
        rows, hit = spec_rows[q], bool(spec_hit[q])
        if bool(torch.any(rows & clear)):
            redo += 1
            h, r = flood((band[q] & ~clear)[None], ground[q:q + 1], max_manhattan[q:q + 1],
                         torch.ones(1, dtype=torch.bool, device=dev))
            rows, hit = r[0], bool(h[0])
        if hit:
            conn = conn | qslot[q]
        else:
            reached[q] = rows.to(words.dtype)
            demoted[q] = True
            failed.append(q)
    return conn, reached, corners, demoted, redo


def demote_direct_plain(vmap_grid: Tensor, reached: Tensor, corners: Tensor, demoted: Tensor,
                        thr_frontiers: float,
                        z_window: tuple[int, int] | None = None) -> tuple[Tensor, Tensor]:
    """Plain version of K15b-7c, the write-back: min(v, thr_frontiers) at
    the reached voxels ([Q, S, S] words) of the ``demoted`` queries inside
    ``vmap_grid`` (the z rows [z_lo, z_lo + rows) of an nz_g-row grid, as
    K8's ``z_window``).  Returns (new grid, int32 count of the writes)."""
    bits = unpack_rows(_words_i64(reached), reached.shape[-1])
    return _demotion_writes(vmap_grid, bits, corners, demoted, thr_frontiers, z_window)


def slab_stores_plain(slab: Tensor, z_lo: int, reached: Tensor, corners: Tensor,
                      demoted: Tensor, thr_frontiers: float) -> tuple[Tensor, Tensor]:
    """K15b-7c as K15b-7b's walking block does it (csrc/explore.cu
    ``store_demotions`` on the slab's window): each failed query stores
    thr_frontiers, with no read, at its reached voxels ([Q, S, S] words)
    that lie in ``slab`` (the grid's z rows [z_lo, z_lo + rows)) and inside
    the grid in x and y, one store and count each.  Returns (new slab,
    int32 count of the stores).  It equals :func:`demote_direct_plain`'s
    min(v, thr) only because every reached voxel was in the band (v > thr)
    and no two failed floods share one: the tests hold it there."""
    out = slab.clone()
    S = reached.shape[-1]
    nzw, ny, nx = slab.shape
    n = 0
    for q in torch.nonzero(demoted)[:, 0].tolist():
        z, y, x = torch.nonzero(unpack_rows(_words_i64(reached[q]), S)).unbind(1)
        z0, y0, x0 = (int(c) for c in corners[q])
        lz, gy, gx = z + z0 - z_lo, y + y0, x + x0
        keep = (lz >= 0) & (lz < nzw) & (gy >= 0) & (gy < ny) & (gx >= 0) & (gx < nx)
        out[lz[keep], gy[keep], gx[keep]] = thr_frontiers
        n += int(keep.sum())
    return out, torch.tensor(n, dtype=torch.int32, device=slab.device)


def explore_seq_fused_plain(grid: GridSpec, stack: Tensor, slab: Tensor, z_lo: int, qx: Tensor,
                            qy: Tensor, qz: Tensor, qvalid: Tensor, qlabels: Tensor,
                            qids: Tensor, qslot: Tensor, max_manhattan: Tensor,
                            query_overflow: Tensor, thr_frontiers: float, max_iters: int = 96):
    """The plain model of K15b-7b's launch with K15b-7c's stores: the
    schedule's walk (:func:`explore_sequential_spec_plain`), then the
    walking block's stores into ``slab`` (:func:`slab_stores_plain`).
    Returns :func:`explore_sequential_stack`'s
    (slab, cluster_connected, reached, corners, demoted, n_writes).  A test
    instrument, not the CPU path."""
    conn, reached, corners, demoted, _ = explore_sequential_spec_plain(
        grid, stack, qx, qy, qz, qvalid, qlabels, qids, qslot, max_manhattan, query_overflow,
        max_iters)
    slab, n = slab_stores_plain(slab, z_lo, reached, corners, demoted, thr_frontiers)
    return slab, conn, reached, corners, demoted, n


def explore_sequential_stack(grid: GridSpec, stack: Tensor, slab: Tensor, z_lo: int,
                             qx: Tensor, qy: Tensor, qz: Tensor, qvalid: Tensor,
                             qlabels: Tensor, qids: Tensor, qslot: Tensor, max_manhattan: Tensor,
                             query_overflow: Tensor, thr_frontiers: float, max_iters: int = 96):
    """K15b-7b and K15b-7c: the walk on the stack, and the failed queries'
    demotions in ``slab`` (the grid's z rows [z_lo, z_lo + rows)).  Returns
    (slab, cluster_connected bool [K], reached [Q, S, S] words, corners
    int32 [Q, 3], demoted bool [Q], n_writes int32: the slab's writes).  On
    a CUDA tensor one launch, whose walk stores as each query fails, updates
    ``slab`` IN PLACE and returns it; on the CPU
    :func:`explore_sequential_stack_plain`, then :func:`demote_direct_plain`
    into a new tensor."""
    q = (qx, qy, qz, qvalid, qlabels, qids, qslot, max_manhattan, query_overflow)
    if stack.is_cuda:
        conn, reached, corners, demoted, n = kernels.explore_seq_stack(
            stack, grid.shape, *q, max_iters, slab, z_lo, thr_frontiers)
        return slab, conn, reached, corners, demoted, n
    if stack.device.type != "cpu":
        raise ValueError(f"explore walk: unsupported device {stack.device}")
    conn, reached, corners, demoted = explore_sequential_stack_plain(grid, stack, *q, max_iters)
    slab, n = demote_direct_plain(slab, reached, corners, demoted, thr_frontiers,
                                  (z_lo, grid.nz))
    return slab, conn, reached, corners, demoted, n
