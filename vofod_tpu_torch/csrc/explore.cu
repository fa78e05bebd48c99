// K7 — the bounded flood-fill to ground (explore BFS), K8 — the demotion
// write-back of failed searches, and K7s — the sequential explore with live
// demotion.
//
// K7 replaces vofod_tpu/ops/explore.py `explore_to_ground`: per query an
// S x S x S submap around the query voxel, a 6-neighbour BFS through the
// unknown band (frontiers < v <= ground) inside the query's Manhattan ball,
// at most 96 sweeps under a while_loop, then ground / shell / grid-edge
// contact.  K8 replaces `apply_demotions` together with the demote decision
// of vofod_tpu/pipeline/classify.py:188-194: the explored unknown voxels of
// a query whose cluster floats are written down to the frontiers score.
//
// Bound on the H100: latency.  The work is tiny (a few valid queries of
// 256 x 32^3 voxels; the flagship grid, 9.9 MB, sits in L2), so a query's
// time is its chain of dependent steps.  K7 at S <= 32
// (explore_planes_kernel) is one block of 8 warps a query:
//  - the load keeps many rows in flight: a warp owns 4 z planes and starts
//    16 rows' loads (128 coalesced bytes each) before their ballots, so a
//    warp waits 8 L2 round trips for its 128 rows, not 128 (4-byte cp.async
//    copies into shared memory measured slower; a TMA box cannot take it: a
//    tensor map's strides must be multiples of 16 bytes, the flagship row is
//    241 x 4 = 964); a voxel outside the grid, or outside the buffer's z
//    rows [z_lo, z_lo + nz) on the grid-sharded step, reads as certain air;
//  - the masks live in registers, bit-packed: lane y holds the 32-bit word
//    of row (z, y) of each of its warp's planes (expandable = unknown &
//    ball, ground, reached); the Manhattan ball and shell of a row are bit
//    ranges computed from the row's offset, never stored;
//  - the sweeps are Jacobi, like the JAX while_loop: a level builds every
//    next word from the current ones, y neighbours by two shuffles, z
//    neighbours from the lane's own registers or, at a warp's edge planes,
//    from the neighbouring warps' edge planes in shared memory (two parity
//    buffers: one __syncthreads_or a level, which also ends the loop at the
//    fixpoint or after max_iters sweeps; an in-place update would advance
//    more than one voxel per sweep and differ whenever max_iters binds);
//  - an invalid query's block writes empty outputs and returns; block 0
//    zeroes the int32 K8 adds its writes to (it lies after the corners in
//    their allocation: no fill launch).
// 32 < S <= 62 keeps the block BFS of 64-bit rows in shared memory
// (explore_kernel on bfs_block / bfs_sweeps; bfs_sweeps is the S > 32 flood
// of K7s and K15b-7b too).  Reached leaves the
// kernel as packed int64 rows [Q, S, S] (bit x of row (z, y)).
//
// K8 runs one block per query.  The verdict is one parallel pass: the
// block's threads OR the slots of the connected queries into words of 32
// slots (block 0 writes them out as cluster_connected), and the query
// demotes when it is valid, the queries did not overflow, and one of its
// gated slots has no connected query.  The stores are a warp a row (lane =
// x, 4 rows in flight, empty rows skipped together): min(v, thr) at every
// reached voxel inside the grid.  Every reached voxel was in the unknown
// band (v > thr) of the grid the BFS read, so all writers of a voxel store
// the same value: plain stores, no atomics on the grid.  It updates the
// grid in place and counts its writes in the int32 K7 zeroed.
//
// K7s replaces the lax.scan of vofod_tpu/pipeline/classify.py:222-267
// (cfg.sequential_explore, the reference's own order, vofod_nodelet.cpp
// :1692-1718): the queries run one at a time in ascending (component label,
// flat id) order, a query whose cluster already connected is skipped, and a
// failed query demotes its reached voxels before the next one reads the
// grid.  K15b-7b is the same walk on the grid-sharded step's replicated
// stack of band and ground words.  Both are ONE launch of
// explore_spec_kernel, which speculates, then commits:
//  - most of the walk does not depend on its order.  A failed query
//    demotes only voxels it reached, all in the unknown band, to
//    thr_frontiers (neither band nor ground).  When query j's flood R on the
//    grid before the walk (Jacobi, at most max_iters sweeps: the ball of
//    that radius in the band graph) meets no voxel an earlier failed query
//    reached, j reaches the same R with the same verdict on the grid the
//    walk left: every voxel of R keeps a shortest path inside R, removing
//    voxels outside R only lengthens other paths, and ground is untouched;
//  - so each valid query's block floods it on the grid before the walk, all
//    in parallel, on K7's registers (S <= 32, planes_flood) or on rows in
//    shared memory (S > 32, bfs_sweeps), and writes its reached rows, its
//    verdict and its rank among the valid queries (K7s also its band and
//    ground words, so that a redone flood reloads no grid) to scratch,
//    fences, and takes a ticket;
//  - the block that draws the last ticket walks the valid queries in rank
//    order: a query whose cluster connected is skipped, a grid-edge start
//    connects, and any other has its speculative rows tested against the
//    rows of the earlier failed queries whose boxes overlap its own (one L2
//    round trip).  Only where they meet is the query flooded again, on its
//    band words minus those rows.  One barrier a walked query publishes the
//    connected slots and the failed list;
//  - the failed floods are disjoint sets of band voxels (each one floods
//    the band minus the earlier ones), and the walk reads band words, never
//    the grid, so the walking block stores thr_frontiers, which is min(v,
//    thr_frontiers) there, at a failed query's voxels from the registers
//    that hold its flood as it fails (plain stores), and writes the count
//    at the end: K7s into the live grid, K15b-7b into the shard's slab (its
//    z rows of the grid; the stack was cut from the slabs before the launch
//    and nothing writes them in between, so a reached voxel still holds its
//    band value).  That store is K15b-7c, the grid-sharded step's demotion
//    write-back: it has no launch of its own.
// Scratch, rows and the live grid are written in this launch, so every read
// of them goes through L2 (__ldcg), never the read-only cache.  The ticket
// is an int32 per (device, stream) that the last block sets back to 0: no
// memset, and no co-residency (Q may pass the resident blocks).  Bound:
// latency, the floods in parallel, then the walk's chain of round trips.
#include "common.cuh"

namespace {

constexpr int EXPLORE_T = 256;

template <typename W>
__device__ __forceinline__ W low_bits(int n) {  // n in [0, 8 * sizeof(W)]
  return n <= 0 ? W(0) : (W(~W(0)) >> (8 * (int)sizeof(W) - n));
}

// Bits of row (z, y) whose Manhattan distance to the centre is <= b.
template <typename W>
__device__ __forceinline__ W ball_bits(int dzy, int b, int half) {
  const int rem = b - dzy;
  if (rem < 0) return W(0);
  return low_bits<W>(2 * rem + 1) << (half - rem);
}

// Bits of row (z, y) whose Manhattan distance is exactly s.
template <typename W>
__device__ __forceinline__ W shell_bits(int dzy, int s, int half) {
  const int rem = s - dzy;
  if (rem < 0) return W(0);
  return (W(1) << (half - rem)) | (W(1) << (half + rem));
}

// 6-neighbour dilation of row r of the packed mask m (rows r = z * S + y).
template <typename W>
__device__ __forceinline__ W dil6_row(const W* m, int r, int z, int y, int S, W full) {
  const W c = m[r];
  W d = c | ((c << 1) & full) | (c >> 1);
  if (z > 0) d |= m[r - S];
  if (z < S - 1) d |= m[r + S];
  if (y > 0) d |= m[r - 1];
  if (y < S - 1) d |= m[r + 1];
  return d;
}

// A grid read: through the read-only cache when no thread of the launch
// writes the grid (K7), through L2 when the launch writes it (K7s).
template <bool kLive>
__device__ __forceinline__ float grid_at(const float* grid, size_t i) {
  return kLive ? __ldcg(grid + i) : __ldg(grid + i);
}

// The band and ground bits of one submap row by one warp, 32 x-lanes per
// chunk: row (gz, gy) of a grid of (nz, ny, nx) rows whose x runs from x0;
// a row or voxel outside the grid is certain air (no bit).  The same words
// on every lane.
template <typename W, bool kLive>
__device__ __forceinline__ void submap_row_bits(const float* grid, int nz, int ny, int nx,
                                                int gz, int gy, int x0, int S, float thr_f,
                                                float thr_g, W& unk, W& gnd) {
  const int lane = threadIdx.x & 31;
  const bool row_in = gz >= 0 && gz < nz && gy >= 0 && gy < ny;
  unk = 0;
  gnd = 0;
  for (int xc = 0; xc < S; xc += 32) {
    const int x = xc + lane, gx = x0 + x;
    float v = -1e30f;  // outside the grid: certain air
    if (x < S && row_in && gx >= 0 && gx < nx)
      v = grid_at<kLive>(grid, ((size_t)gz * ny + gy) * nx + gx);
    const unsigned bu = __ballot_sync(0xffffffffu, x < S && v > thr_f && v <= thr_g);
    const unsigned bg = __ballot_sync(0xffffffffu, x < S && v > thr_g);
    unk |= W(bu) << xc;
    gnd |= W(bg) << xc;
  }
}

// The BFS proper, by the whole block, on the packed rows a caller filled
// (expandable = unknown & ball, ground, cur = the expandable centre bit)
// and synced: Jacobi sweeps, then whether the flood's closure touched
// ground or the reached set the shell at bound - 1 (the same on every
// thread).  The reached rows are left in `cur`.  Ends on a barrier, so the
// caller may read every row of `cur`.
template <typename W>
__device__ bool bfs_sweeps(int bound, int S, int max_iters, const W* expandable, const W* ground,
                           W*& cur, W*& nxt) {
  const int half = S / 2, rows = S * S;
  const W full = low_bits<W>(S);
  // Jacobi sweeps: nxt = cur | (expandable & dil6(cur)) until no change
  int it = 0;
  bool changed = true;
  while (changed && it < max_iters) {
    int ch = 0;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int z = r / S, y = r - (r / S) * S;
      const W c = cur[r];
      const W nw = c | (expandable[r] & dil6_row<W>(cur, r, z, y, S, full));
      nxt[r] = nw;
      ch |= nw != c;
    }
    changed = __syncthreads_or(ch) != 0;
    W* t = cur;
    cur = nxt;
    nxt = t;
    ++it;
  }

  // closure = centre | (dil6(reached) & ball); shell at manh == bound - 1
  int hit = 0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int z = r / S, y = r - (r / S) * S;
    const int dzy = abs(z - half) + abs(y - half);
    W clo = dil6_row<W>(cur, r, z, y, S, full) & ball_bits<W>(dzy, bound, half);
    if (z == half && y == half) clo |= W(1) << half;
    hit |= (clo & ground[r]) != 0;
    hit |= (cur[r] & shell_bits<W>(dzy, bound - 1, half)) != 0;
  }
  return __syncthreads_or(hit) != 0;
}

// One query's BFS by the whole block, submap corner (x0, y0, z0).  `grid`
// holds the z rows [z_lo, z_lo + nz) (the whole grid, or a shard's slab
// extended by the explore pad); rows outside it read as air.  Returns
// bfs_sweeps' verdict; the reached rows are left in `cur`.
template <typename W>
__device__ bool bfs_block(const float* grid, int nz, int ny, int nx, int z_lo, int x0, int y0,
                          int z0, int bound, float thr_f, float thr_g, int S, int max_iters,
                          W* expandable, W* ground, W*& cur, W*& nxt) {
  const int half = S / 2, rows = S * S;
  // submap -> packed rows: one warp per row
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const int z = r / S, y = r - (r / S) * S;
    W unk, gnd;
    submap_row_bits<W, false>(grid, nz, ny, nx, z0 + z - z_lo, y0 + y, x0, S, thr_f, thr_g,
                               unk, gnd);
    if ((threadIdx.x & 31) == 0) {
      const int dzy = abs(z - half) + abs(y - half);
      const W e = unk & ball_bits<W>(dzy, bound, half);
      expandable[r] = e;
      ground[r] = gnd;
      cur[r] = (z == half && y == half) ? (e & (W(1) << half)) : W(0);
    }
  }
  __syncthreads();
  return bfs_sweeps<W>(bound, S, max_iters, expandable, ground, cur, nxt);
}

__device__ __forceinline__ bool at_grid_edge(int gx, int gy, int gz, int nz, int ny, int nx) {
  return gx <= 0 || gy <= 0 || gz <= 0 || gx >= nx - 1 || gy >= ny - 1 || gz >= nz - 1;
}

// An invalid query's block: empty rows, not connected.
__device__ __forceinline__ void explore_skip(unsigned long long* rout, int rows,
                                             uint8_t* connected, int q) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) rout[r] = 0ull;
  if (threadIdx.x == 0) connected[q] = 0;
}

// The submap corner of query q, stored as corners[q] = (z0, y0, x0); block 0
// also zeroes K8's write count, which K8 adds to after this launch.
__device__ __forceinline__ void explore_head(int q, int x0, int y0, int z0, int32_t* corners,
                                             int32_t* n_writes) {
  if (threadIdx.x == 0) {
    corners[3 * q + 0] = z0;
    corners[3 * q + 1] = y0;
    corners[3 * q + 2] = x0;
    if (q == 0) n_writes[0] = 0;
  }
}

// 6-neighbour dilation of one lane's row word c of plane j: x by shifts, y
// from the lanes y - 1 and y + 1 (0 past lanes 0 and 31), z from the planes
// zm and zp.  Every lane of the warp calls it (the shuffles).
__device__ __forceinline__ uint32_t lane_dil6(uint32_t c, uint32_t zm, uint32_t zp, int lane,
                                              uint32_t full) {
  uint32_t ym = __shfl_up_sync(0xffffffffu, c, 1);
  uint32_t yp = __shfl_down_sync(0xffffffffu, c, 1);
  if (lane == 0) ym = 0;
  if (lane == 31) yp = 0;
  return c | ((c << 1) & full) | (c >> 1) | zm | zp | ym | yp;
}

// K7 for S <= 32, one block a query: EXPLORE_WARPS warps, warp w owning the
// EXPLORE_PLANES z planes [w * PLANES, (w + 1) * PLANES) of the submap, lane
// y holding the 32-bit word of row (z, y) of each plane in registers
// (expandable, ground, reached: 3 x PLANES words a lane).
//  - The load: a warp reads its rows with lane = x (128 coalesced bytes a
//    row), LOAD_ROWS rows in flight before their ballots, and lane y keeps
//    row y's band and ground words.
//  - A level (one Jacobi sweep): each warp puts its first and last planes
//    into shared memory (two parity buffers), one __syncthreads_or ORs the
//    lanes' "changed" of the last sweep and publishes the edge planes, and
//    each lane computes its planes' next words from its registers, two
//    shuffles a plane and the neighbouring warps' edge planes.  The block
//    leaves at the first level whose barrier saw no change, or after
//    max_iters sweeps: exactly the JAX while_loop's Jacobi sweeps.
//  - The closure, ground and shell tests run on the fixpoint's registers;
//    lanes y store the reached rows of a plane coalesced (S x 8 bytes).
// The flood (planes_flood) is K7s's and K15b-7b's too, on the rows of the
// grid (planes_load_grid) or of packed words (planes_load_words).
constexpr int EXPLORE_WARPS = 8;
constexpr int EXPLORE_PLANES = 32 / EXPLORE_WARPS;
constexpr int LOAD_ROWS = 16;

using PlaneWords = uint32_t[EXPLORE_PLANES];
using EdgePlanes = uint32_t[2][EXPLORE_WARPS][2][32];  // parity, warp, (first, last), lane

// The band and ground words of the lane's rows (zw + j, lane) of the submap
// at corner (x0, y0, z0), read from `grid` (the z rows [z_lo, z_lo + nz) of
// the grid; a voxel outside them or the grid is certain air).
template <bool kLive>
__device__ __forceinline__ void planes_load_grid(const float* grid, int nz, int ny, int nx,
                                                 int z_lo, int x0, int y0, int z0, int S,
                                                 float thr_f, float thr_g, PlaneWords& band,
                                                 PlaneWords& gnd) {
  const int lane = threadIdx.x & 31, zw = (threadIdx.x >> 5) * EXPLORE_PLANES;
  const int gx = x0 + lane;
  const bool x_in = lane < S && gx >= 0 && gx < nx;
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j) {
    band[j] = 0;
    gnd[j] = 0;
    const int lz = z0 + zw + j - z_lo;  // the row's plane in the buffer
    if (zw + j >= S) continue;          // warp-uniform
    const bool z_in = lz >= 0 && lz < nz;
    for (int yc = 0; yc < S; yc += LOAD_ROWS) {
      float v[LOAD_ROWS];
#pragma unroll
      for (int b = 0; b < LOAD_ROWS; ++b) {
        const int gy = y0 + yc + b;
        v[b] = -1e30f;  // outside the grid or the buffer: certain air
        if (x_in && z_in && yc + b < S && gy >= 0 && gy < ny)
          v[b] = grid_at<kLive>(grid, ((size_t)lz * ny + gy) * nx + gx);
      }
#pragma unroll
      for (int b = 0; b < LOAD_ROWS; ++b) {
        const uint32_t bu = __ballot_sync(0xffffffffu, v[b] > thr_f && v[b] <= thr_g);
        const uint32_t bg = __ballot_sync(0xffffffffu, v[b] > thr_g);
        if (lane == yc + b) {
          band[j] = bu;
          gnd[j] = bg;
        }
      }
    }
  }
}

// The lane's rows of packed [S, S] words written in this launch or before
// (through L2), one load a lane-plane; 0 past S.
__device__ __forceinline__ void planes_load_words(const uint32_t* rows, int S, PlaneWords& w) {
  const int lane = threadIdx.x & 31, zw = (threadIdx.x >> 5) * EXPLORE_PLANES;
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j)
    w[j] = zw + j < S && lane < S ? __ldcg(rows + (zw + j) * S + lane) : 0u;
}

__device__ __forceinline__ void planes_store_words(uint32_t* rows, int S, const PlaneWords& w) {
  const int lane = threadIdx.x & 31, zw = (threadIdx.x >> 5) * EXPLORE_PLANES;
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j)
    if (zw + j < S && lane < S) rows[(zw + j) * S + lane] = w[j];
}

// The flood by the whole block on its registers: band and ground words in,
// the reached words out in `cur`; returns whether the flood's closure
// touched ground or the reached set the shell at bound - 1 (the same on
// every thread).  Ends on a barrier, after its last read of `edge`.
__device__ __forceinline__ bool planes_flood(const PlaneWords& band, const PlaneWords& gnd,
                                             PlaneWords& cur, int bound, int S, int max_iters,
                                             EdgePlanes& edge) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = S / 2, zw = warp * EXPLORE_PLANES;  // this warp's first plane
  const int dy = abs(lane - half);
  uint32_t expd[EXPLORE_PLANES];
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j) {
    const int z = zw + j;
    expd[j] = band[j] & ball_bits<uint32_t>(abs(z - half) + dy, bound, half);
    cur[j] = (z == half && lane == half) ? (expd[j] & (1u << half)) : 0u;
  }

  const uint32_t full = low_bits<uint32_t>(S);
  int it = 0, par = 0;
  bool changed = true;
  for (;;) {
    edge[par][warp][0][lane] = cur[0];
    edge[par][warp][1][lane] = cur[EXPLORE_PLANES - 1];
    if (!__syncthreads_or(changed) || it == max_iters) break;
    const uint32_t below = warp > 0 ? edge[par][warp - 1][1][lane] : 0u;
    const uint32_t above = warp < EXPLORE_WARPS - 1 ? edge[par][warp + 1][0][lane] : 0u;
    uint32_t nw[EXPLORE_PLANES];
    changed = false;
#pragma unroll
    for (int j = 0; j < EXPLORE_PLANES; ++j) {
      const uint32_t zm = j > 0 ? cur[j - 1] : below;
      const uint32_t zp = j < EXPLORE_PLANES - 1 ? cur[j + 1] : above;
      nw[j] = cur[j] | (expd[j] & lane_dil6(cur[j], zm, zp, lane, full));
      changed |= nw[j] != cur[j];
    }
#pragma unroll
    for (int j = 0; j < EXPLORE_PLANES; ++j) cur[j] = nw[j];
    ++it;
    par ^= 1;
  }

  // closure = centre | (dil6(reached) & ball); shell at manh == bound - 1.
  // The barrier that ended the loop published the fixpoint's edge planes.
  const uint32_t below = warp > 0 ? edge[par][warp - 1][1][lane] : 0u;
  const uint32_t above = warp < EXPLORE_WARPS - 1 ? edge[par][warp + 1][0][lane] : 0u;
  int hit = 0;
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j) {
    const int z = zw + j, dzy = abs(z - half) + dy;
    const uint32_t zm = j > 0 ? cur[j - 1] : below;
    const uint32_t zp = j < EXPLORE_PLANES - 1 ? cur[j + 1] : above;
    uint32_t clo = lane_dil6(cur[j], zm, zp, lane, full) & ball_bits<uint32_t>(dzy, bound, half);
    if (z == half && lane == half) clo |= 1u << half;
    hit |= (clo & gnd[j]) != 0u;
    hit |= (cur[j] & shell_bits<uint32_t>(dzy, bound - 1, half)) != 0u;
  }
  return __syncthreads_or(hit) != 0;
}

__global__ void __launch_bounds__(EXPLORE_WARPS * 32) explore_planes_kernel(
    const float* __restrict__ grid, int nz, int ny, int nx, int z_lo, int nz_g,
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const uint8_t* __restrict__ qvalid,
    const int32_t* __restrict__ max_manhattan, float thr_f, float thr_g, int S,
    int max_iters, uint8_t* __restrict__ connected,
    unsigned long long* __restrict__ reached_out, int32_t* __restrict__ corners,
    int32_t* __restrict__ n_writes) {
  __shared__ EdgePlanes edge;
  const int q = blockIdx.x, lane = threadIdx.x & 31;
  const int half = S / 2, rows = S * S;
  const int x0 = qx[q] - half, y0 = qy[q] - half, z0 = qz[q] - half;
  unsigned long long* rout = reached_out + (size_t)q * rows;
  explore_head(q, x0, y0, z0, corners, n_writes);
  if (qvalid[q] == 0) {  // the JAX tier ladder's saving, with no host sync
    explore_skip(rout, rows, connected, q);
    return;
  }
  PlaneWords band, gnd, cur;
  planes_load_grid<false>(grid, nz, ny, nx, z_lo, x0, y0, z0, S, thr_f, thr_g, band, gnd);
  const bool h = planes_flood(band, gnd, cur, min(max_manhattan[q], half - 1), S, max_iters,
                              edge);
  const int zw = (threadIdx.x >> 5) * EXPLORE_PLANES;
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j)
    if (zw + j < S && lane < S) rout[(zw + j) * S + lane] = (unsigned long long)cur[j];
  if (threadIdx.x == 0)
    connected[q] = (h || at_grid_edge(x0 + half, y0 + half, z0 + half, nz_g, ny, nx)) ? 1 : 0;
}

// K7 for 32 < S <= 62 (64-bit rows): one block a query runs bfs_block, the
// Jacobi sweeps over packed rows in shared memory.
__global__ void __launch_bounds__(EXPLORE_T) explore_kernel(
    const float* __restrict__ grid, int nz, int ny, int nx, int z_lo, int nz_g,
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const uint8_t* __restrict__ qvalid,
    const int32_t* __restrict__ max_manhattan, float thr_f, float thr_g, int S,
    int max_iters, uint8_t* __restrict__ connected,
    unsigned long long* __restrict__ reached_out, int32_t* __restrict__ corners,
    int32_t* __restrict__ n_writes) {
  using W = unsigned long long;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = blockIdx.x;
  const int half = S / 2, rows = S * S;
  const int x0 = qx[q] - half, y0 = qy[q] - half, z0 = qz[q] - half;
  unsigned long long* rout = reached_out + (size_t)q * rows;
  explore_head(q, x0, y0, z0, corners, n_writes);
  if (qvalid[q] == 0) {
    explore_skip(rout, rows, connected, q);
    return;
  }
  W* expandable = reinterpret_cast<W*>(smem_raw);
  W* ground = expandable + rows;
  W* cur = ground + rows;
  W* nxt = cur + rows;
  const int bound = min(max_manhattan[q], half - 1);
  const bool hit = bfs_block<W>(grid, nz, ny, nx, z_lo, x0, y0, z0, bound, thr_f, thr_g, S,
                                max_iters, expandable, ground, cur, nxt);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) rout[r] = cur[r];
  if (threadIdx.x == 0)
    connected[q] = (hit || at_grid_edge(x0 + half, y0 + half, z0 + half, nz_g, ny, nx)) ? 1 : 0;
}

// One atomic per warp on a device write counter.
__device__ __forceinline__ void add_count(int count, int* n_writes) {
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  if ((threadIdx.x & 31) == 0 && count != 0) atomicAdd(n_writes, count);
}

// K8, one block a query (DEMOTE_T threads):
//  - the verdict in one parallel pass: the block's threads take one query
//    each and, when it connected, OR its slots into ceil(K / 32) words
//    (__reduce_or_sync in the warp, an atomicOr in shared memory); block 0
//    writes those bits as cluster_connected.  The query demotes when it is
//    valid, the queries did not overflow, and one of its gated slots has no
//    connected query.  A block whose query has no gated slot (or is invalid,
//    or overflowed) leaves before the pass, but block 0.
//  - the stores a warp a row: each warp takes 32 rows (lane i loads row i's
//    word), skips the empty ones together, and runs DEMOTE_ROWS non-empty
//    rows at a time with lane = x: one coalesced read of each row's span,
//    min(v, thr) stored where the row's bit is set (NaN kept), the count
//    from __popc of the row's bits inside the grid.
constexpr int DEMOTE_T = 256;
constexpr int DEMOTE_ROWS = 4;

__global__ void __launch_bounds__(DEMOTE_T) demote_kernel(
    float* __restrict__ grid, int nz, int ny, int nx, int z_lo, int nz_g,
    const unsigned long long* __restrict__ reached, const int32_t* __restrict__ corners,
    int S, const uint8_t* __restrict__ qslot, const uint8_t* __restrict__ connected,
    const uint8_t* __restrict__ qvalid, const uint8_t* __restrict__ qgate,
    const uint8_t* __restrict__ query_overflow, int Q, int K, float thr,
    int* __restrict__ n_writes, uint8_t* __restrict__ cluster_connected) {
  extern __shared__ uint32_t slot_conn[];  // ceil(K / 32) words: slot k has a connected query
  const int q = blockIdx.x, lane = threadIdx.x & 31;
  const int KW = (K + 31) / 32;
  for (int j = threadIdx.x; j < KW; j += blockDim.x) slot_conn[j] = 0u;
  const bool live = qvalid[q] != 0 && query_overflow[0] == 0;
  int gated = 0;
  for (int k = threadIdx.x; k < K && live; k += blockDim.x)
    gated |= qslot[(size_t)q * K + k] != 0 && qgate[k] != 0;
  if (!__syncthreads_or(gated) && q != 0) return;

  for (int p0 = 0; p0 < Q; p0 += blockDim.x) {  // warp-uniform trip count
    const int p = p0 + threadIdx.x;
    const bool conn = p < Q && connected[p] != 0;
    for (int j = 0; j < KW; ++j) {
      uint32_t bits = 0u;
      if (conn) {
        const uint8_t* row = qslot + (size_t)p * K + 32 * j;
        const int n = min(32, K - 32 * j);
#pragma unroll 8
        for (int b = 0; b < n; ++b) bits |= (uint32_t)(row[b] != 0) << b;
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (lane == 0 && bits != 0u) atomicOr(slot_conn + j, bits);
    }
  }
  __syncthreads();
  if (q == 0)
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      cluster_connected[k] = (slot_conn[k >> 5] >> (k & 31)) & 1u;
  int floats = 0;
  for (int k = threadIdx.x; k < K && live; k += blockDim.x)
    floats |= qslot[(size_t)q * K + k] != 0 && qgate[k] != 0 &&
              ((slot_conn[k >> 5] >> (k & 31)) & 1u) == 0u;
  if (!__syncthreads_or(floats)) return;  // the verdict

  const unsigned long long* rq = reached + (size_t)q * S * S;
  const int z0 = corners[3 * q], y0 = corners[3 * q + 1], x0 = corners[3 * q + 2];
  // the row's bits inside the grid in x
  const int xlo = max(0, -x0), xhi = min(S, nx - x0);
  const unsigned long long xmask =
      xhi <= xlo ? 0ull : ((xhi - xlo >= 64 ? ~0ull : ((1ull << (xhi - xlo)) - 1ull)) << xlo);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5, rows = S * S;
  int count = 0;
  for (int r0 = warp * 32; r0 < rows; r0 += nwarps * 32) {
    // lane i: row r0 + i, its word and its offset in the buffer
    const int r = r0 + lane;
    unsigned long long w = r < rows ? rq[r] & xmask : 0ull;
    const int gz = z0 + r / S, gy = y0 + r % S, lz = gz - z_lo;
    if (gz < 0 || gz >= nz_g || lz < 0 || lz >= nz || gy < 0 || gy >= ny) w = 0ull;
    const long long off = ((long long)lz * ny + gy) * nx + x0;
    count += __popcll(w);
    unsigned todo = __ballot_sync(0xffffffffu, w != 0ull);
    while (todo != 0u) {  // DEMOTE_ROWS non-empty rows in flight
      unsigned long long wb[DEMOTE_ROWS];
      long long ob[DEMOTE_ROWS];
#pragma unroll
      for (int b = 0; b < DEMOTE_ROWS; ++b) {
        const int i = todo != 0u ? __ffs(todo) - 1 : 0;
        wb[b] = __shfl_sync(0xffffffffu, w, i);
        ob[b] = __shfl_sync(0xffffffffu, off, i);
        if (todo == 0u) wb[b] = 0ull;
        todo &= todo - 1u;
      }
      for (int xc = 0; xc < S; xc += 32) {
        float v[DEMOTE_ROWS];
#pragma unroll
        for (int b = 0; b < DEMOTE_ROWS; ++b)
          v[b] = (wb[b] >> (xc + lane)) & 1ull ? grid[ob[b] + xc + lane] : 0.0f;
#pragma unroll
        for (int b = 0; b < DEMOTE_ROWS; ++b)
          if (((wb[b] >> (xc + lane)) & 1ull) && v[b] > thr) grid[ob[b] + xc + lane] = thr;
      }
    }
  }
  add_count(count, n_writes);
}

// ---- K7s and K15b-7b: speculate, then commit --------------------------------
// A valid query's record, by rank: (gx, gy, gz, meta), meta = the slot q
// (bits 0-11), the speculative verdict (bit 12), a grid-edge start (bit 13)
// and bound + 1 (bits 16-23; a negative bound acts as -1: no ball, no
// shell).
__device__ __forceinline__ int rec_q(const int4& r) { return r.w & 0xfff; }
__device__ __forceinline__ bool rec_hit(const int4& r) { return (r.w >> 12) & 1; }
__device__ __forceinline__ bool rec_edge(const int4& r) { return (r.w >> 13) & 1; }
__device__ __forceinline__ int rec_bound(const int4& r) { return ((r.w >> 16) & 0xff) - 1; }

// The demotion of one reached row w (bit x: grid x0 + x) of a failed query:
// thr_f at its voxels inside the grid.  They were in the band (v > thr_f)
// when the launch began and no two failed floods share one, so min(v,
// thr_f) is thr_f: stored without a read.  Returns the stores.
__device__ __forceinline__ int store_row(float* row, unsigned long long w, int x0, int nx,
                                         float thr_f) {
  int count = 0;
  while (w != 0ull) {
    const int x = x0 + __ffsll((long long)w) - 1;
    w &= w - 1;
    if (x < 0 || x >= nx) continue;
    row[x] = thr_f;
    ++count;
  }
  return count;
}

// A query's rows on the S <= 32 route: K7's registers (lane y of warp w
// holds rows (w * PLANES + j, y)); `clear` gathers the rows of the earlier
// failed floods that fall in the query's box.
struct PlanesBody {
  using W = uint32_t;
  static __host__ __device__ size_t smem(int) { return 0; }
  PlaneWords band, gnd, cur, clear;
  EdgePlanes& edge;
  int S, max_iters;

  __device__ PlanesBody(unsigned char*, int S_, int max_iters_, EdgePlanes& e)
      : edge(e), S(S_), max_iters(max_iters_) {}
  // K7s: the band and ground words from the live grid, also kept in `words`
  // ([2, S, S]) for a redone flood
  __device__ void load_grid(const float* grid, int nz, int ny, int nx, int x0, int y0, int z0,
                            float thr_f, float thr_g, W* words) {
    planes_load_grid<true>(grid, nz, ny, nx, 0, x0, y0, z0, S, thr_f, thr_g, band, gnd);
    planes_store_words(words, S, band);
    planes_store_words(words + S * S, S, gnd);
  }
  __device__ void load_words(const W* words) {
    planes_load_words(words, S, band);
    planes_load_words(words + S * S, S, gnd);
  }
  __device__ bool flood(int bound) {
    return planes_flood(band, gnd, cur, bound, S, max_iters, edge);
  }
  __device__ void load_rows(const W* rows) { planes_load_words(rows, S, cur); }
  __device__ void store_rows(W* rows) const { planes_store_words(rows, S, cur); }
  // `clear` = the rows of the earlier failed queries (ranks sfail[0, nf))
  // whose boxes overlap this query's (record `rec`): a failed query's box
  // lies at d = (dz, dy, dx) = this corner - its corner, so its row (z + dz,
  // y + dy), shifted by dx, meets this query's row (z, y).  CLEAR_BATCH
  // failed floods' rows are loaded at once, then OR-ed: one round trip for
  // up to CLEAR_BATCH of them, not one each.
  static constexpr int CLEAR_BATCH = 8;
  __device__ void clear_failed(const W* frows, const int4* srec, const int* sfail, int nf,
                               const int4& rec) {
    const int lane = threadIdx.x & 31, zw = (threadIdx.x >> 5) * EXPLORE_PLANES;
#pragma unroll
    for (int j = 0; j < EXPLORE_PLANES; ++j) clear[j] = 0u;
    for (int f0 = 0; f0 < nf; f0 += CLEAR_BATCH) {
      W w[CLEAR_BATCH][EXPLORE_PLANES];
      int dx[CLEAR_BATCH];
#pragma unroll
      for (int b = 0; b < CLEAR_BATCH; ++b) {
        const int4 rf = f0 + b < nf ? srec[sfail[f0 + b]] : rec;
        const int dz = rec.z - rf.z, dy = rec.y - rf.y, iy = lane + dy;
        dx[b] = rec.x - rf.x;
        const bool live = f0 + b < nf && abs(dz) < S && abs(dy) < S && abs(dx[b]) < S &&
                          lane < S && iy >= 0 && iy < S;
        if (!live) dx[b] = 0;
        const W* rows = frows + (size_t)rec_q(rf) * S * S;
#pragma unroll
        for (int j = 0; j < EXPLORE_PLANES; ++j) {
          const int iz = zw + j + dz;
          w[b][j] = live && zw + j < S && iz >= 0 && iz < S ? __ldcg(rows + iz * S + iy) : 0u;
        }
      }
#pragma unroll
      for (int b = 0; b < CLEAR_BATCH; ++b)
#pragma unroll
        for (int j = 0; j < EXPLORE_PLANES; ++j)
          clear[j] |= dx[b] >= 0 ? W(w[b][j] >> dx[b]) : W(w[b][j] << -dx[b]);
    }
  }
  __device__ bool overlaps() const {
    W m = 0;
#pragma unroll
    for (int j = 0; j < EXPLORE_PLANES; ++j) m |= cur[j] & clear[j];
    return m != 0;
  }
  // thr_f at the reached voxels (box corner (x0, y0, z0)) of the failed
  // query the registers hold that lie in `grid`, the z rows [z_lo, z_lo +
  // nzw) of the grid; returns this thread's count
  __device__ int store_demotions(float* grid, int z_lo, int nzw, int ny, int nx, int x0, int y0,
                                 int z0, float thr_f) const {
    const int lane = threadIdx.x & 31, zw = (threadIdx.x >> 5) * EXPLORE_PLANES;
    const int gy = y0 + lane;
    int count = 0;
    if (lane >= S || gy < 0 || gy >= ny) return 0;
#pragma unroll
    for (int j = 0; j < EXPLORE_PLANES; ++j) {
      const int lz = z0 + zw + j - z_lo;
      if (zw + j >= S || lz < 0 || lz >= nzw) continue;
      count += store_row(grid + ((size_t)lz * ny + gy) * nx, cur[j], x0, nx, thr_f);
    }
    return count;
  }
  __device__ void apply_clear() {
#pragma unroll
    for (int j = 0; j < EXPLORE_PLANES; ++j) band[j] &= ~clear[j];
  }
};

// The S > 32 route: 64-bit rows in shared memory (band, ground and the two
// Jacobi buffers; bfs_sweeps), thread t owning rows t + k * EXPLORE_T.
constexpr int SMEM_ROWS = (62 * 62 + EXPLORE_T - 1) / EXPLORE_T;

struct SmemBody {
  using W = unsigned long long;
  static __host__ __device__ size_t smem(int S) { return 4 * (size_t)S * S * sizeof(W); }
  W *band, *ground, *cur, *nxt;
  W clear[SMEM_ROWS];
  int S, max_iters;

  __device__ SmemBody(unsigned char* raw, int S_, int max_iters_, EdgePlanes&)
      : S(S_), max_iters(max_iters_) {
    band = reinterpret_cast<W*>(raw);
    ground = band + S * S;
    cur = ground + S * S;
    nxt = cur + S * S;
  }
  __device__ void load_grid(const float* grid, int nz, int ny, int nx, int x0, int y0, int z0,
                            float thr_f, float thr_g, W* words) {
    const int rows = S * S, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    for (int r = warp; r < rows; r += nwarps) {  // one warp a row
      W unk, gnd;
      submap_row_bits<W, true>(grid, nz, ny, nx, z0 + r / S, y0 + r % S, x0, S, thr_f, thr_g,
                               unk, gnd);
      if ((threadIdx.x & 31) == 0) {
        band[r] = words[r] = unk;
        ground[r] = words[rows + r] = gnd;
      }
    }
  }
  __device__ void load_words(const W* words) {
    const int rows = S * S;
#pragma unroll
    for (int k = 0; k < SMEM_ROWS; ++k) {
      const int r = threadIdx.x + k * EXPLORE_T;
      if (r < rows) {
        band[r] = __ldcg(words + r);
        ground[r] = __ldcg(words + rows + r);
      }
    }
  }
  __device__ bool flood(int bound) {
    const int half = S / 2, rows = S * S;
    __syncthreads();  // the rows other threads loaded
    for (int r = threadIdx.x; r < rows; r += EXPLORE_T) {
      const int z = r / S, y = r - z * S;
      const W e = band[r] & ball_bits<W>(abs(z - half) + abs(y - half), bound, half);
      band[r] = e;
      cur[r] = (z == half && y == half) ? (e & (W(1) << half)) : W(0);
    }
    __syncthreads();
    return bfs_sweeps<W>(bound, S, max_iters, band, ground, cur, nxt);
  }
  __device__ void load_rows(const W* rows) {
#pragma unroll
    for (int k = 0; k < SMEM_ROWS; ++k) {
      const int r = threadIdx.x + k * EXPLORE_T;
      if (r < S * S) cur[r] = __ldcg(rows + r);
    }
  }
  __device__ void store_rows(W* rows) const {
#pragma unroll
    for (int k = 0; k < SMEM_ROWS; ++k) {
      const int r = threadIdx.x + k * EXPLORE_T;
      if (r < S * S) rows[r] = cur[r];
    }
  }
  // PlanesBody::clear_failed's contract, one failed flood at a time
  __device__ void clear_failed(const W* frows, const int4* srec, const int* sfail, int nf,
                               const int4& rec) {
#pragma unroll
    for (int k = 0; k < SMEM_ROWS; ++k) clear[k] = 0;
    for (int f = 0; f < nf; ++f) {
      const int4 rf = srec[sfail[f]];
      const int dz = rec.z - rf.z, dy = rec.y - rf.y, dx = rec.x - rf.x;
      if (abs(dz) >= S || abs(dy) >= S || abs(dx) >= S) continue;  // boxes apart
      const W* rows = frows + (size_t)rec_q(rf) * S * S;
#pragma unroll
      for (int k = 0; k < SMEM_ROWS; ++k) {
        const int r = threadIdx.x + k * EXPLORE_T;
        const int iz = r / S + dz, iy = r % S + dy;
        if (r >= S * S || iz < 0 || iz >= S || iy < 0 || iy >= S) continue;
        const W w = __ldcg(rows + iz * S + iy);
        clear[k] |= dx >= 0 ? W(w >> dx) : W(w << -dx);
      }
    }
  }
  __device__ bool overlaps() const {
    W m = 0;
#pragma unroll
    for (int k = 0; k < SMEM_ROWS; ++k) {
      const int r = threadIdx.x + k * EXPLORE_T;
      if (r < S * S) m |= cur[r] & clear[k];
    }
    return m != 0;
  }
  __device__ int store_demotions(float* grid, int z_lo, int nzw, int ny, int nx, int x0, int y0,
                                 int z0, float thr_f) const {
    int count = 0;
#pragma unroll
    for (int k = 0; k < SMEM_ROWS; ++k) {
      const int r = threadIdx.x + k * EXPLORE_T;
      const int lz = z0 + r / S - z_lo, gy = y0 + r % S;
      if (r >= S * S || lz < 0 || lz >= nzw || gy < 0 || gy >= ny) continue;
      count += store_row(grid + ((size_t)lz * ny + gy) * nx, cur[r], x0, nx, thr_f);
    }
    return count;
  }
  __device__ void apply_clear() {
#pragma unroll
    for (int k = 0; k < SMEM_ROWS; ++k) {
      const int r = threadIdx.x + k * EXPLORE_T;
      if (r < S * S) band[r] &= ~clear[k];
    }
  }
};

// K7s (kDense: the live grid, demoted by the walk as queries fail; `words` the
// scratch of band and ground words its blocks write) and K15b-7b (the
// replicated stack as `words`; outputs reached, corners, demoted), one
// block a query slot, on a grid of (nz, ny, nx) rows.  `grid` holds its z
// rows [z_lo, z_lo + nzw), where the walk stores the demotions and counts
// them in n_writes (K7s: the whole grid; K15b-7b: the shard's slab).
// `spec` [Q, S, S]: the speculative reached rows; `frows`: where the failed
// queries' rows are read back (K7s: `spec`, a redone flood writing over its
// query's; K15b-7b: `reached`).
template <class Body, bool kDense>
__global__ void __launch_bounds__(EXPLORE_T) explore_spec_kernel(
    float* grid, int z_lo, int nzw, int nz, int ny, int nx, const int32_t* __restrict__ qx,
    const int32_t* __restrict__ qy, const int32_t* __restrict__ qz,
    const uint8_t* __restrict__ qvalid, const int32_t* __restrict__ qlabels,
    const int32_t* __restrict__ qids, const uint8_t* __restrict__ qslot,
    const int32_t* __restrict__ max_manhattan, const uint8_t* __restrict__ query_overflow,
    float thr_f, float thr_g, int Q, int K, int S, int max_iters, typename Body::W* words,
    typename Body::W* spec, int4* recs, uint32_t* slotw, typename Body::W* frows,
    uint8_t* __restrict__ cluster_connected, int32_t* __restrict__ n_writes,
    int32_t* __restrict__ corners, uint8_t* __restrict__ demoted, int* ticket, int* stats) {
  using W = typename Body::W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePlanes edge;
  __shared__ int last, total;
  const int q = blockIdx.x, half = S / 2, rows = S * S, KW = (K + 31) / 32;
  const bool overflow = query_overflow[0] != 0;  // every query is skipped
  Body body(smem_raw, S, max_iters, edge);

  // ---- the speculative flood of slot q on the grid before the walk
  const int gx = qx[q], gy = qy[q], gz = qz[q];
  if (!kDense) {  // K15b-7b's outputs: the walk writes the failed queries'
    if (threadIdx.x == 0) {
      corners[3 * q + 0] = gz - half;
      corners[3 * q + 1] = gy - half;
      corners[3 * q + 2] = gx - half;
      demoted[q] = 0;
    }
    for (int r = threadIdx.x; r < rows; r += EXPLORE_T) frows[(size_t)q * rows + r] = W(0);
  }
  if (qvalid[q] != 0 && !overflow) {  // block-uniform
    // its rank among the valid queries, jnp.lexsort((qids, qlabels)) order
    const int lq = qlabels[q], dq = qids[q];
    int rank = 0;
    for (int j0 = 0; j0 < Q; j0 += EXPLORE_T) {
      const int j = j0 + threadIdx.x;
      int before = 0;
      if (j < Q && qvalid[j] != 0) {
        const int lj = qlabels[j], dj = qids[j];
        before = lj < lq || (lj == lq && (dj < dq || (dj == dq && j < q)));
      }
      rank += __syncthreads_count(before);
    }
    const bool at_edge = at_grid_edge(gx, gy, gz, nz, ny, nx);
    const int bound = max(min(max_manhattan[q], half - 1), -1);
    bool hit = false;
    if (!at_edge) {  // an edge start connects by definition: no flood
      if (kDense)
        body.load_grid(grid, nz, ny, nx, gx - half, gy - half, gz - half, thr_f, thr_g,
                       words + (size_t)q * 2 * rows);
      else
        body.load_words(words + (size_t)q * 2 * rows);
      hit = body.flood(bound);
      body.store_rows(spec + (size_t)q * rows);
    }
    for (int w = threadIdx.x; w < KW; w += EXPLORE_T) {  // its slots as words of 32
      const uint8_t* row = qslot + (size_t)q * K + 32 * w;
      const int n = min(32, K - 32 * w);
      uint32_t bits = 0u;
      for (int b = 0; b < n; ++b) bits |= (uint32_t)(row[b] != 0) << b;
      slotw[(size_t)rank * KW + w] = bits;
    }
    if (threadIdx.x == 0)
      recs[rank] = make_int4(gx, gy, gz, q | (int)hit << 12 | (int)at_edge << 13 |
                                             (bound + 1) << 16);
  }

  // ---- the handoff: the block that takes the last ticket walks
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) {
    *ticket = 0;  // for the next launch on this stream
    total = 0;
  }

  // ---- the walk, over the valid queries in rank order
  int4* srec = reinterpret_cast<int4*>(smem_raw + (Body::smem(S) + 15) / 16 * 16);
  uint32_t* sslot = reinterpret_cast<uint32_t*>(srec + Q);  // [rank][KW]
  uint32_t* sconn = sslot + (size_t)Q * KW;                  // the connected slots
  int* sfail = reinterpret_cast<int*>(sconn + KW);           // the failed queries' ranks
  int nv = 0;
  for (int j0 = 0; j0 < Q && !overflow; j0 += EXPLORE_T)
    nv += __syncthreads_count(j0 + (int)threadIdx.x < Q && qvalid[j0 + threadIdx.x] != 0);
  for (int t = threadIdx.x; t < nv; t += EXPLORE_T) srec[t] = __ldcg(recs + t);
  for (int i = threadIdx.x; i < nv * KW; i += EXPLORE_T) sslot[i] = __ldcg(slotw + i);
  for (int w = threadIdx.x; w < KW; w += EXPLORE_T) sconn[w] = 0u;
  __syncthreads();

  int nf = 0, nredo = 0, nwalk = 0;  // the same on every thread
  int count = 0;                     // this thread's demotion stores
  for (int t = 0; t < nv; ++t) {
    const int4 rec = srec[t];
    const uint32_t* ks = sslot + (size_t)t * KW;
    bool already = false;
    for (int w = 0; w < KW; ++w) already |= (ks[w] & sconn[w]) != 0u;
    if (already) continue;  // its cluster connected before
    const int q_t = rec_q(rec);
    const bool at_edge = rec_edge(rec);
    if (!at_edge) {
      // its speculative rows against the earlier failed floods' rows, its
      // band and ground words with them (a redone flood's input): the
      // loads in flight together
      body.load_rows(spec + (size_t)q_t * rows);
      body.load_words(words + (size_t)q_t * 2 * rows);
      body.clear_failed(frows, srec, sfail, nf, rec);
    }
    // (also the barrier between the skip test's reads of sconn and its update)
    const bool redo = __syncthreads_or(!at_edge && body.overlaps()) != 0;
    bool conn = at_edge || rec_hit(rec);
    nwalk += at_edge ? 0 : 1;
    if (redo) {  // flood again on the band the earlier failed queries left
      ++nredo;
      body.apply_clear();
      conn = body.flood(rec_bound(rec));
    }
    if (conn) {
      for (int w = threadIdx.x; w < KW; w += EXPLORE_T) sconn[w] |= ks[w];
    } else {
      if (!kDense || redo) body.store_rows(frows + (size_t)q_t * rows);
      // the walk reads band words, never the grid: store now
      count += body.store_demotions(grid, z_lo, nzw, ny, nx, rec.x - half, rec.y - half,
                                    rec.z - half, thr_f);
      if (threadIdx.x == 0) {
        sfail[nf] = t;
        if (!kDense) demoted[q_t] = 1;
      }
      ++nf;
    }
    __syncthreads();  // the next query reads sconn, sfail and these rows
  }

  for (int k = threadIdx.x; k < K; k += EXPLORE_T)
    cluster_connected[k] = (sconn[k >> 5] >> (k & 31)) & 1u;
  add_count(count, &total);
  __syncthreads();
  if (threadIdx.x == 0) {
    n_writes[0] = total;
    stats[0] = nredo;  // floods redone
    stats[1] = nwalk;  // speculative rows tested
    stats[2] = nf;     // failed queries
    stats[3] = nv;     // valid queries walked (0 under query overflow)
  }
}

// ---- K15b-7a: the cut -----------------------------------------------------
// The band and ground words [2, S, S] of each query slot's submap rows that
// lie in the shard's slab (rows [z_lo, z_lo + nz) of the grid); every other
// row, the voxels past the grid in x and y, and every row of an invalid
// slot are 0.  Each row has one owner, so a psum of the shards' stacks is
// the whole grid's.  Bound: latency (the flagship's 9 valid slots read
// ~1.1 MB from L2; the launch writes a 2 MB stack).  A block of CUT_WARPS
// warps takes CUT_PLANES z planes of one slot (gridDim.y blocks a slot):
//  - from the slot's corner, before any load, it works out which of its
//    planes lie in the slab, [za, zb) (none for an invalid slot), and zeroes
//    the rows of its other planes with 16-byte stores (a slot's [2, S, S]
//    words are contiguous: two ranges a side of the slab, band and ground);
//  - the slab rows go a warp CUT_ROWS consecutive rows at a time: lane x
//    issues the loads of all of them through the read-only cache (the
//    launch writes no grid) before the ballots of any, so a warp waits one
//    L2 round trip for CUT_ROWS rows, not CUT_ROWS round trips; lane b then
//    stores row b's band word and lane CUT_ROWS + b its ground word.
// A block whose planes miss the slab leaves after its zero stores.  4
// planes on 4 warps took the least device time of the schedules measured
// on the grid-sequential step's calls, one block a slot among them
// (`chip_ab.py --seq-variants`); `kernels.CUT_PLANES` / `CUT_WARPS` mirror
// the two for the plain model.
constexpr int CUT_ROWS = 16;
constexpr int CUT_PLANES = 4;
constexpr int CUT_WARPS = 4;

// Words [0, n) of p to 0 by the whole block: 16-byte stores from the first
// 16-byte boundary, a scalar head and tail.
template <typename W>
__device__ __forceinline__ void zero_words(W* p, int n) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(p) & 15u);
  const int head = min(n, ((16 - mis) & 15) / (int)sizeof(W));
  const int nvec = max(n - head, 0) * (int)sizeof(W) / 16;
  const int tail = head + nvec * 16 / (int)sizeof(W);
  for (int i = threadIdx.x; i < head; i += blockDim.x) p[i] = W(0);
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) v[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tail + threadIdx.x; i < n; i += blockDim.x) p[i] = W(0);
}

template <typename W>
__global__ void __launch_bounds__(CUT_WARPS * 32) explore_cut_kernel(
    const float* __restrict__ grid, int nz, int ny, int nx, int z_lo,
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const uint8_t* __restrict__ qvalid, float thr_f,
    float thr_g, int S, W* __restrict__ stack) {
  const int q = blockIdx.x, half = S / 2, rows = S * S;
  const int p0 = blockIdx.y * CUT_PLANES, p1 = min(S, p0 + CUT_PLANES);
  W* band = stack + (size_t)q * 2 * rows;
  W* gnd = band + rows;
  const int z0 = qz[q] - half;
  int za = max(p0, z_lo - z0), zb = min(p1, z_lo + nz - z0);  // the planes in the slab
  if (qvalid[q] == 0 || za >= zb) za = zb = p1;
  zero_words(band + p0 * S, (za - p0) * S);
  zero_words(gnd + p0 * S, (za - p0) * S);
  zero_words(band + zb * S, (p1 - zb) * S);
  zero_words(gnd + zb * S, (p1 - zb) * S);
  const int n = (zb - za) * S;  // the slab rows, rows za * S + i of the slot
  if (n == 0) return;
  const int x0 = qx[q] - half, y0 = qy[q] - half;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* plane = grid + (size_t)(z0 + za - z_lo) * ny * nx;  // plane za in the slab
  for (int i0 = warp * CUT_ROWS; i0 < n; i0 += CUT_WARPS * CUT_ROWS) {
    W mine = 0;  // lane b: row i0 + b's band word; lane CUT_ROWS + b: its ground word
    for (int xc = 0; xc < S; xc += 32) {
      const int gx = x0 + xc + lane;
      const bool x_in = xc + lane < S && gx >= 0 && gx < nx;
      float v[CUT_ROWS];
#pragma unroll
      for (int b = 0; b < CUT_ROWS; ++b) {
        const int i = i0 + b, dz = i / S, gy = y0 + i - dz * S;
        v[b] = -1e30f;  // past the grid: certain air
        if (x_in && i < n && gy >= 0 && gy < ny)
          v[b] = __ldg(plane + ((size_t)dz * ny + gy) * nx + gx);
      }
#pragma unroll
      for (int b = 0; b < CUT_ROWS; ++b) {
        const uint32_t bu = __ballot_sync(0xffffffffu, v[b] > thr_f && v[b] <= thr_g);
        const uint32_t bg = __ballot_sync(0xffffffffu, v[b] > thr_g);
        if (lane == b) mine |= W(bu) << xc;
        if (lane == CUT_ROWS + b) mine |= W(bg) << xc;
      }
    }
    const int i = i0 + (lane & (CUT_ROWS - 1));
    if (i < n) (lane < CUT_ROWS ? band : gnd)[za * S + i] = mine;
  }
}

template <typename Kern>
int allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

int launch_explore(const void* grid, int nz, int ny, int nx, int z_lo, int nz_g, const void* qx,
                   const void* qy, const void* qz, const void* qvalid, const void* mm, float thr_f,
                   float thr_g, int Q, int S, int max_iters, void* connected, void* reached,
                   void* corners, void* n_writes, cudaStream_t s) {
  const float* g = static_cast<const float*>(grid);
  const int32_t *x = static_cast<const int32_t*>(qx), *y = static_cast<const int32_t*>(qy),
                *z = static_cast<const int32_t*>(qz), *m = static_cast<const int32_t*>(mm);
  const uint8_t* v = static_cast<const uint8_t*>(qvalid);
  uint8_t* c = static_cast<uint8_t*>(connected);
  unsigned long long* r = static_cast<unsigned long long*>(reached);
  int32_t *co = static_cast<int32_t*>(corners), *n = static_cast<int32_t*>(n_writes);
  if (S <= 32) {
    explore_planes_kernel<<<Q, EXPLORE_WARPS * 32, 0, s>>>(g, nz, ny, nx, z_lo, nz_g, x, y, z, v,
                                                            m, thr_f, thr_g, S, max_iters, c, r,
                                                            co, n);
    return (int)cudaGetLastError();
  }
  const size_t smem = 4 * (size_t)S * S * sizeof(unsigned long long);
  const int e = allow_smem(explore_kernel, smem);
  if (e != 0) return e;
  explore_kernel<<<Q, EXPLORE_T, smem, s>>>(g, nz, ny, nx, z_lo, nz_g, x, y, z, v, m, thr_f,
                                            thr_g, S, max_iters, c, r, co, n);
  return (int)cudaGetLastError();
}

// One launch's scratch for K7s / K15b-7b, in 16-byte aligned pieces: the
// walk's counts (4 int32), the records by rank (Q int4), the slot words by
// rank (Q x ceil(K / 32)), the speculative rows [Q, S, S] and, for K7s, the
// band and ground words [Q, 2, S, S].  Words are 32-bit for S <= 32.
struct SeqScratch {
  int* stats;
  int4* recs;
  uint32_t* slotw;
  void* spec;
  void* words;
  size_t bytes;
};

SeqScratch seq_scratch(void* base, int Q, int K, int S, bool dense) {
  const size_t word = S <= 32 ? 4 : 8, rows = (size_t)S * S;
  auto up = [](size_t n) { return (n + 15) / 16 * 16; };
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  SeqScratch sc;
  size_t off = 0;
  sc.stats = reinterpret_cast<int*>(b + off);
  off += 16;
  sc.recs = reinterpret_cast<int4*>(b + off);
  off += up(16 * (size_t)Q);
  sc.slotw = reinterpret_cast<uint32_t*>(b + off);
  off += up(4 * (size_t)Q * ((K + 31) / 32));
  sc.spec = reinterpret_cast<void*>(b + off);
  off += up(word * Q * rows);
  sc.words = dense ? reinterpret_cast<void*>(b + off) : nullptr;
  off += dense ? up(2 * word * Q * rows) : 0;
  sc.bytes = off;
  return sc;
}

// The spec kernel's launch: Q blocks of EXPLORE_T threads, the body's rows
// and the walk's records, slot words, connected slots and failed list in
// dynamic shared memory.  `grid` holds the z rows [z_lo, z_lo + nzw) of the
// (nz, ny, nx) grid the walk stores its demotions into; `stats`: where the
// walk writes its counts (null: the scratch's).
template <class Body, bool kDense>
int launch_spec(float* grid, int z_lo, int nzw, const void* stack, int nz, int ny, int nx,
                const void* qx, const void* qy, const void* qz, const void* qvalid,
                const void* qlabels, const void* qids, const void* qslot, const void* mm,
                const void* query_overflow, float thr_f, float thr_g, int Q, int K, int S,
                int max_iters, void* scratch, void* cluster_connected, void* n_writes,
                void* reached, void* corners, void* demoted, void* ticket, void* stats,
                cudaStream_t s) {
  using W = typename Body::W;
  const SeqScratch sc = seq_scratch(scratch, Q, K, S, kDense);
  const size_t KW = (K + 31) / 32;
  const size_t smem = (Body::smem(S) + 15) / 16 * 16 + (size_t)Q * (16 + 4 * KW + 4) + 4 * KW;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int e = allow_smem(explore_spec_kernel<Body, kDense>, smem);
  if (e != 0) return e;
  W* spec = static_cast<W*>(sc.spec);
  W* words = kDense ? static_cast<W*>(sc.words) : static_cast<W*>(const_cast<void*>(stack));
  explore_spec_kernel<Body, kDense><<<Q, EXPLORE_T, smem, s>>>(
      grid, z_lo, nzw, nz, ny, nx, static_cast<const int32_t*>(qx),
      static_cast<const int32_t*>(qy), static_cast<const int32_t*>(qz),
      static_cast<const uint8_t*>(qvalid), static_cast<const int32_t*>(qlabels),
      static_cast<const int32_t*>(qids), static_cast<const uint8_t*>(qslot),
      static_cast<const int32_t*>(mm), static_cast<const uint8_t*>(query_overflow), thr_f, thr_g,
      Q, K, S, max_iters, words, spec, sc.recs, sc.slotw,
      kDense ? spec : static_cast<W*>(reached), static_cast<uint8_t*>(cluster_connected),
      static_cast<int32_t*>(n_writes), static_cast<int32_t*>(corners),
      static_cast<uint8_t*>(demoted), static_cast<int*>(ticket),
      stats != nullptr ? static_cast<int*>(stats) : sc.stats);
  return (int)cudaGetLastError();
}

}  // namespace

// grid: device float32 [nz, ny, nx] holding the z rows [z_lo, z_lo + nz) of
// a grid of nz_g rows (z_lo = 0 and nz_g = nz but on the grid-sharded
// step); qx/qy/qz/max_manhattan: int32 [Q] in global grid coordinates;
// qvalid: bool [Q].  Outputs: connected bool [Q], reached int64 [Q, S, S]
// (bit x of row (z, y)), corners int32 [Q, 3] (z, y, x), and n_writes, the
// int32 K8 adds its stores to, zeroed.  2 <= S <= 62.
VOFOD_API int vofod_explore(const void* grid, int nz, int ny, int nx, int z_lo, int nz_g,
                            const void* qx, const void* qy, const void* qz, const void* qvalid,
                            const void* max_manhattan, float thr_f, float thr_g, int Q, int S,
                            int max_iters, void* connected, void* reached, void* corners,
                            void* n_writes, void* stream) {
  if (Q <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  return launch_explore(grid, nz, ny, nx, z_lo, nz_g, qx, qy, qz, qvalid, max_manhattan, thr_f,
                        thr_g, Q, S, max_iters, connected, reached, corners, n_writes,
                        static_cast<cudaStream_t>(stream));
}

// In place: grid[v] = min(grid[v], thr) at the reached voxels of every
// demoting query.  grid: the z rows [z_lo, z_lo + nz) of a grid of nz_g
// rows, as vofod_explore's; writes land only inside both.  qslot: bool
// [Q, K]; connected/qvalid: bool [Q]; qgate: bool [K]; query_overflow: bool
// scalar; n_writes: the int32 the kernel adds its stores to (vofod_explore's,
// zeroed by its launch).  Output: cluster_connected bool [K], whether a
// slot has a connected query (written under query overflow too).
VOFOD_API int vofod_demote(void* grid, int nz, int ny, int nx, int z_lo, int nz_g,
                           const void* reached,
                           const void* corners, int S, const void* qslot, const void* connected,
                           const void* qvalid, const void* qgate, const void* query_overflow,
                           int Q, int K, float thr, void* n_writes, void* cluster_connected,
                           void* stream) {
  if (Q <= 0 || K <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(K + 31) / 32 * sizeof(uint32_t);
  const int e = allow_smem(demote_kernel, smem);
  if (e != 0) return e;
  demote_kernel<<<Q, DEMOTE_T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(grid), nz, ny, nx, z_lo, nz_g,
      static_cast<const unsigned long long*>(reached),
      static_cast<const int32_t*>(corners), S, static_cast<const uint8_t*>(qslot),
      static_cast<const uint8_t*>(connected), static_cast<const uint8_t*>(qvalid),
      static_cast<const uint8_t*>(qgate), static_cast<const uint8_t*>(query_overflow), Q, K,
      thr, static_cast<int*>(n_writes), static_cast<uint8_t*>(cluster_connected));
  return (int)cudaGetLastError();
}

// The scratch bytes one K7s (dense != 0) or K15b-7b launch takes.
VOFOD_API int vofod_explore_seq_scratch(int Q, int K, int S, int dense, long long* bytes) {
  if (Q <= 0 || Q > 4096 || K <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  bytes[0] = (long long)seq_scratch(nullptr, Q, K, S, dense != 0).bytes;
  return 0;
}

// K7s, in place on grid: the sequential explore of the Q queries in (label,
// id) order with live demotion.  qx/qy/qz/qlabels/qids/max_manhattan: int32
// [Q]; qvalid: bool [Q]; qslot: bool [Q, K]; query_overflow: bool scalar.
// Outputs: cluster_connected bool [K], n_writes int32 scalar (written, not
// added to).  scratch: vofod_explore_seq_scratch's bytes (16-byte
// aligned); ticket: an int32 that is 0 and that no launch on another
// stream uses (left 0); stats: null or int32 [4], the walk's counts (floods
// redone, speculative rows tested, failed queries, valid queries walked).
// 1 <= Q <= 4096, 2 <= S <= 62.
VOFOD_API int vofod_explore_sequential(void* grid, int nz, int ny, int nx, const void* qx,
                                       const void* qy, const void* qz, const void* qvalid,
                                       const void* qlabels, const void* qids, const void* qslot,
                                       const void* max_manhattan, const void* query_overflow,
                                       float thr_f, float thr_g, int Q, int K, int S,
                                       int max_iters, void* cluster_connected, void* n_writes,
                                       void* scratch, void* ticket, void* stats, void* stream) {
  if (Q <= 0 || Q > 4096 || K <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(grid);
  if (S <= 32)
    return launch_spec<PlanesBody, true>(g, 0, nz, nullptr, nz, ny, nx, qx, qy, qz, qvalid,
                                         qlabels, qids, qslot, max_manhattan, query_overflow,
                                         thr_f, thr_g, Q, K, S, max_iters, scratch,
                                         cluster_connected, n_writes, nullptr, nullptr, nullptr,
                                         ticket, stats, s);
  return launch_spec<SmemBody, true>(g, 0, nz, nullptr, nz, ny, nx, qx, qy, qz, qvalid, qlabels,
                                     qids, qslot, max_manhattan, query_overflow, thr_f, thr_g, Q,
                                     K, S, max_iters, scratch, cluster_connected, n_writes,
                                     nullptr, nullptr, nullptr, ticket, stats, s);
}

// K15b-7a: the cut of a shard's slab.  grid: device float32 [nz, ny, nx],
// the rows [z_lo, z_lo + nz) of the grid; qx/qy/qz: int32 [Q] global;
// qvalid: bool [Q].  Output: stack [Q, 2, S, S] (band rows, then ground
// rows), uint32 words for S <= 32, else uint64.  2 <= S <= 62, 1 <= Q <=
// 65535.
VOFOD_API int vofod_explore_cut(const void* grid, int nz, int ny, int nx, int z_lo,
                                const void* qx, const void* qy, const void* qz,
                                const void* qvalid, float thr_f, float thr_g, int Q, int S,
                                void* stack, void* stream) {
  if (Q <= 0 || Q > 65535 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  const int32_t *x = static_cast<const int32_t*>(qx), *y = static_cast<const int32_t*>(qy),
                *z = static_cast<const int32_t*>(qz);
  const uint8_t* v = static_cast<const uint8_t*>(qvalid);
  const dim3 blocks(Q, (S + CUT_PLANES - 1) / CUT_PLANES);
  if (S <= 32)
    explore_cut_kernel<uint32_t><<<blocks, CUT_WARPS * 32, 0, s>>>(
        g, nz, ny, nx, z_lo, x, y, z, v, thr_f, thr_g, S, static_cast<uint32_t*>(stack));
  else
    explore_cut_kernel<unsigned long long><<<blocks, CUT_WARPS * 32, 0, s>>>(
        g, nz, ny, nx, z_lo, x, y, z, v, thr_f, thr_g, S,
        static_cast<unsigned long long*>(stack));
  return (int)cudaGetLastError();
}

// K15b-7b and K15b-7c: the walk on the replicated stack (vofod_explore_cut's
// words) of a grid of (nz, ny, nx) rows, and the demotions in place on
// `slab`, device float32 [slab_nz, ny, nx], the z rows [z_lo, z_lo +
// slab_nz) of that grid: thr_f at each failed query's reached voxels there,
// stored by the walk as the query fails.  The query table, scratch, ticket
// and stats as vofod_explore_sequential's.  Outputs: cluster_connected bool
// [K], n_writes int32 scalar (the slab's stores; written, not added to),
// reached [Q, S, S] words (the failed queries' floods, 0 elsewhere),
// corners int32 [Q, 3] (z, y, x), demoted bool [Q] (the failed queries).
// 1 <= Q <= 4096, 2 <= S <= 62, 0 <= z_lo, z_lo + slab_nz <= nz.
VOFOD_API int vofod_explore_seq_stack(const void* stack, int nz, int ny, int nx, void* slab,
                                      int z_lo, int slab_nz, const void* qx, const void* qy,
                                      const void* qz, const void* qvalid, const void* qlabels,
                                      const void* qids, const void* qslot,
                                      const void* max_manhattan, const void* query_overflow,
                                      float thr_f, int Q, int K, int S, int max_iters,
                                      void* cluster_connected, void* n_writes, void* reached,
                                      void* corners, void* demoted, void* scratch, void* ticket,
                                      void* stats, void* stream) {
  if (Q <= 0 || Q > 4096 || K <= 0 || S < 2 || S > 62 || z_lo < 0 || slab_nz < 1 ||
      z_lo + slab_nz > nz)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(slab);
  if (S <= 32)
    return launch_spec<PlanesBody, false>(g, z_lo, slab_nz, stack, nz, ny, nx, qx, qy, qz,
                                          qvalid, qlabels, qids, qslot, max_manhattan,
                                          query_overflow, thr_f, 0.0f, Q, K, S, max_iters,
                                          scratch, cluster_connected, n_writes, reached, corners,
                                          demoted, ticket, stats, s);
  return launch_spec<SmemBody, false>(g, z_lo, slab_nz, stack, nz, ny, nx, qx, qy, qz, qvalid,
                                      qlabels, qids, qslot, max_manhattan, query_overflow, thr_f,
                                      0.0f, Q, K, S, max_iters, scratch, cluster_connected,
                                      n_writes, reached, corners, demoted, ticket, stats, s);
}
