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
// (explore_kernel on bfs_block / bfs_sweeps, K7s's too).  Reached leaves the
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
// grid.  That chain is sequential by definition, so it is ONE block of 1024
// threads walking the Q queries in one launch (no host sync, no launch per
// query): the order is a Q x Q rank in the block, the connected clusters a
// flag per slot in shared memory, each query runs bfs_block on the
// CURRENT grid and, when it fails, writes min(v, thr) at its reached voxels
// before a __syncthreads().  The grid is read and written in the same
// launch, so it is no `const __restrict__` pointer and every read goes
// through L2 (__ldcg), never the read-only cache, which is not coherent with
// the kernel's own stores.  Bound: latency again — valid queries x sweeps
// on one SM.
#include "common.cuh"

namespace {

constexpr int EXPLORE_T = 256;
constexpr int SEQ_T = 1024;

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
template <typename W, bool kLive>
__device__ bool bfs_block(const float* grid, int nz, int ny, int nx, int z_lo, int x0, int y0,
                          int z0, int bound, float thr_f, float thr_g, int S, int max_iters,
                          W* expandable, W* ground, W*& cur, W*& nxt) {
  const int half = S / 2, rows = S * S;
  // submap -> packed rows: one warp per row
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const int z = r / S, y = r - (r / S) * S;
    W unk, gnd;
    submap_row_bits<W, kLive>(grid, nz, ny, nx, z0 + z - z_lo, y0 + y, x0, S, thr_f, thr_g,
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
constexpr int EXPLORE_WARPS = 8;
constexpr int EXPLORE_PLANES = 32 / EXPLORE_WARPS;
constexpr int LOAD_ROWS = 16;

__global__ void __launch_bounds__(EXPLORE_WARPS * 32) explore_planes_kernel(
    const float* __restrict__ grid, int nz, int ny, int nx, int z_lo, int nz_g,
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const uint8_t* __restrict__ qvalid,
    const int32_t* __restrict__ max_manhattan, float thr_f, float thr_g, int S,
    int max_iters, uint8_t* __restrict__ connected,
    unsigned long long* __restrict__ reached_out, int32_t* __restrict__ corners,
    int32_t* __restrict__ n_writes) {
  __shared__ uint32_t edge[2][EXPLORE_WARPS][2][32];  // parity, warp, (first, last), lane
  const int q = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = S / 2, rows = S * S;
  const int x0 = qx[q] - half, y0 = qy[q] - half, z0 = qz[q] - half;
  unsigned long long* rout = reached_out + (size_t)q * rows;
  explore_head(q, x0, y0, z0, corners, n_writes);
  if (qvalid[q] == 0) {  // the JAX tier ladder's saving, with no host sync
    explore_skip(rout, rows, connected, q);
    return;
  }
  const int bound = min(max_manhattan[q], half - 1);
  const int zw = warp * EXPLORE_PLANES;  // this warp's first plane

  // the load: band and ground words of rows (zw + j, lane)
  uint32_t expd[EXPLORE_PLANES], gnd[EXPLORE_PLANES], cur[EXPLORE_PLANES];
  const int gx = x0 + lane;
  const bool x_in = lane < S && gx >= 0 && gx < nx;
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j) {
    expd[j] = 0;
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
          v[b] = __ldg(grid + ((size_t)lz * ny + gy) * nx + gx);
      }
#pragma unroll
      for (int b = 0; b < LOAD_ROWS; ++b) {
        const uint32_t bu = __ballot_sync(0xffffffffu, v[b] > thr_f && v[b] <= thr_g);
        const uint32_t bg = __ballot_sync(0xffffffffu, v[b] > thr_g);
        if (lane == yc + b) {
          expd[j] = bu;
          gnd[j] = bg;
        }
      }
    }
  }
  // the submap is loaded
  const int dy = abs(lane - half);
#pragma unroll
  for (int j = 0; j < EXPLORE_PLANES; ++j) {
    const int z = zw + j;
    expd[j] &= ball_bits<uint32_t>(abs(z - half) + dy, bound, half);
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
  const bool h = __syncthreads_or(hit) != 0;
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
  const bool hit = bfs_block<W, false>(grid, nz, ny, nx, z_lo, x0, y0, z0, bound, thr_f, thr_g,
                                       S, max_iters, expandable, ground, cur, nxt);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) rout[r] = cur[r];
  if (threadIdx.x == 0)
    connected[q] = (hit || at_grid_edge(x0 + half, y0 + half, z0 + half, nz_g, ny, nx)) ? 1 : 0;
}

// The stores of one query's demotion, by the whole block: min(v, thr) at
// the reached voxels (rows `rq`, submap corner (z0, y0, x0)) inside
// both the buffer (rows [z_lo, z_lo + nz)) and the grid (nz_g rows).  Every
// reached voxel was in the unknown band (v > thr) of the grid the BFS
// read, so all writers of a voxel store the same value: plain stores, no
// atomics on the grid.  Returns this thread's count of the stores.
template <typename W>
__device__ int store_min_rows(float* grid, int nz, int ny, int nx, int z_lo, int nz_g,
                              const W* rq, int z0, int y0, int x0, int S, float thr) {
  int count = 0;
  for (int r = threadIdx.x; r < S * S; r += blockDim.x) {
    unsigned long long w = (unsigned long long)rq[r];
    if (w == 0ull) continue;
    const int gz = z0 + r / S, gy = y0 + r % S, lz = gz - z_lo;
    if (gz < 0 || gz >= nz_g || lz < 0 || lz >= nz || gy < 0 || gy >= ny) continue;
    float* row = grid + ((size_t)lz * ny + gy) * nx;
    while (w != 0ull) {
      const int x = __ffsll((long long)w) - 1;
      w &= w - 1;
      const int gx = x0 + x;
      if (gx < 0 || gx >= nx) continue;
      if (row[gx] > thr) row[gx] = thr;  // min(v, thr), NaN kept as in torch.clamp
      ++count;
    }
  }
  return count;
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

// The (label, id, index) rank of every query, jnp.lexsort((qids, qlabels))
// (a stable sort): order[j] is the j-th query.  No barrier.
__device__ void rank_queries(const int32_t* __restrict__ qlabels,
                             const int32_t* __restrict__ qids, int Q, int* order) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    const int li = qlabels[i], di = qids[i];
    int rank = 0;
    for (int j = 0; j < Q; ++j) {
      const int lj = qlabels[j], dj = qids[j];
      rank += lj < li || (lj == li && (dj < di || (dj == di && j < i)));
    }
    order[rank] = i;
  }
}

template <typename W>
__global__ void __launch_bounds__(SEQ_T) explore_seq_kernel(
    float* grid, int nz, int ny, int nx,
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const uint8_t* __restrict__ qvalid,
    const int32_t* __restrict__ qlabels, const int32_t* __restrict__ qids,
    const uint8_t* __restrict__ qslot, const int32_t* __restrict__ max_manhattan,
    const uint8_t* __restrict__ query_overflow, float thr_f, float thr_g, int Q, int K, int S,
    int max_iters, uint8_t* __restrict__ cluster_connected, int32_t* __restrict__ n_writes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int total;
  const int half = S / 2, rows = S * S;
  W* expandable = reinterpret_cast<W*>(smem_raw);
  W* ground = expandable + rows;
  W* buf_a = ground + rows;
  W* buf_b = buf_a + rows;
  int* order = reinterpret_cast<int*>(buf_b + rows);  // order[j]: the j-th query
  uint8_t* conn = reinterpret_cast<uint8_t*>(order + Q);  // slot k has connected

  rank_queries(qlabels, qids, Q, order);
  for (int k = threadIdx.x; k < K; k += blockDim.x) conn[k] = 0;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();

  int count = 0;
  // under query overflow every query is skipped (the cluster verdicts are
  // conservative then); the launch still happens, so the host never reads it
  for (int j = 0; j < Q && query_overflow[0] == 0; ++j) {
    const int q = order[j];
    if (qvalid[q] == 0) continue;
    const uint8_t* slots = qslot + (size_t)q * K;
    int already = 0;
    for (int k = threadIdx.x; k < K; k += blockDim.x) already |= slots[k] != 0 && conn[k] != 0;
    if (__syncthreads_or(already)) continue;  // its cluster connected before
    const int gx = qx[q], gy = qy[q], gz = qz[q];
    // grid-edge starts connect by definition; their BFS could not change that
    bool connected = at_grid_edge(gx, gy, gz, nz, ny, nx);
    if (!connected) {
      W* cur = buf_a;
      W* nxt = buf_b;
      const int bound = min(max_manhattan[q], half - 1);
      const int x0 = gx - half, y0 = gy - half, z0 = gz - half;
      connected = bfs_block<W, true>(grid, nz, ny, nx, 0, x0, y0, z0, bound, thr_f, thr_g, S,
                                     max_iters, expandable, ground, cur, nxt);
      if (!connected) {
        // live demotion: min(v, thr) at the reached voxels inside the grid
        count += store_min_rows(grid, nz, ny, nx, 0, nz, cur, z0, y0, x0, S, thr_f);
        __syncthreads();  // the next query's submap reads these stores
      }
    }
    if (connected) {
      for (int k = threadIdx.x; k < K; k += blockDim.x)
        if (slots[k] != 0) conn[k] = 1;
      __syncthreads();
    }
  }

  for (int k = threadIdx.x; k < K; k += blockDim.x) cluster_connected[k] = conn[k];
  add_count(count, &total);
  __syncthreads();
  if (threadIdx.x == 0) n_writes[0] = total;
}

// K15b-7a, the cut: one block per query packs the band and ground bits of
// the submap rows that lie in this shard's slab (rows [z_lo, z_lo + nz) of
// the grid), one warp per row as bfs_block; every other row, and every row
// of an invalid query, is 0.  Each row has one owner, so a psum of the
// shards' stacks is the whole grid's.
template <typename W>
__global__ void __launch_bounds__(EXPLORE_T) explore_cut_kernel(
    const float* __restrict__ grid, int nz, int ny, int nx, int z_lo,
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const uint8_t* __restrict__ qvalid, float thr_f,
    float thr_g, int S, W* __restrict__ stack) {
  const int q = blockIdx.x;
  const int half = S / 2, rows = S * S;
  W* band = stack + (size_t)q * 2 * rows;
  W* gnd = band + rows;
  const bool valid = qvalid[q] != 0;
  const int x0 = qx[q] - half, y0 = qy[q] - half, z0 = qz[q] - half;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const int z = r / S, y = r - (r / S) * S;
    W unk = 0, g = 0;
    if (valid)
      submap_row_bits<W, false>(grid, nz, ny, nx, z0 + z - z_lo, y0 + y, x0, S, thr_f, thr_g,
                                unk, g);
    if ((threadIdx.x & 31) == 0) {
      band[r] = unk;
      gnd[r] = g;
    }
  }
}

// K15b-7b, the walk: K7s on the replicated stack.  The order, the skips,
// the grid-edge rule (global dims) and the BFS are explore_seq_kernel's;
// instead of reading a grid the earlier failed queries demoted, a query
// takes its stack rows and clears from its band every voxel an earlier
// failed query reached (a demoted voxel holds thr_f: neither band nor
// ground).  Query i's box is offset by d = corner_j - corner_i from query
// j's, so j's row (z, y) meets i's row (z + dz, y + dy) with x shifted by
// dx.  The failed queries' rows are written to `reached` and read back
// from it (through L2: written in this launch) for the later queries;
// every other query's rows are 0.
template <typename W>
__global__ void __launch_bounds__(SEQ_T) explore_stack_kernel(
    const W* __restrict__ stack, int nz, int ny, int nx,
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const uint8_t* __restrict__ qvalid,
    const int32_t* __restrict__ qlabels, const int32_t* __restrict__ qids,
    const uint8_t* __restrict__ qslot, const int32_t* __restrict__ max_manhattan,
    const uint8_t* __restrict__ query_overflow, int Q, int K, int S, int max_iters,
    uint8_t* __restrict__ cluster_connected, W* reached, int32_t* __restrict__ corners,
    uint8_t* __restrict__ demoted) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int half = S / 2, rows = S * S;
  W* expandable = reinterpret_cast<W*>(smem_raw);
  W* ground = expandable + rows;
  W* buf_a = ground + rows;
  W* buf_b = buf_a + rows;
  int* order = reinterpret_cast<int*>(buf_b + rows);
  int* failed = order + Q;  // the failed queries so far, in order
  uint8_t* conn = reinterpret_cast<uint8_t*>(failed + Q);

  rank_queries(qlabels, qids, Q, order);
  for (int k = threadIdx.x; k < K; k += blockDim.x) conn[k] = 0;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    corners[3 * q + 0] = qz[q] - half;
    corners[3 * q + 1] = qy[q] - half;
    corners[3 * q + 2] = qx[q] - half;
  }
  __syncthreads();

  const bool overflow = query_overflow[0] != 0;
  int nf = 0;  // the same on every thread
  for (int j = 0; j < Q; ++j) {
    const int q = order[j];
    const uint8_t* slots = qslot + (size_t)q * K;
    // under query overflow every query is skipped, as in K7s
    bool skip = overflow || qvalid[q] == 0;
    if (!skip) {
      int already = 0;
      for (int k = threadIdx.x; k < K; k += blockDim.x) already |= slots[k] != 0 && conn[k] != 0;
      skip = __syncthreads_or(already) != 0;  // its cluster connected before
    }
    W* cur = buf_a;
    W* nxt = buf_b;
    bool fails = false;
    if (!skip) {
      const int gx = qx[q], gy = qy[q], gz = qz[q];
      bool connected = at_grid_edge(gx, gy, gz, nz, ny, nx);
      if (!connected) {
        const int bound = min(max_manhattan[q], half - 1);
        const W* band = stack + (size_t)q * 2 * rows;
        for (int r = threadIdx.x; r < rows; r += blockDim.x) {
          const int z = r / S, y = r - (r / S) * S;
          W clear = 0;
          for (int f = 0; f < nf; ++f) {
            const int i = failed[f];
            const int dz = gz - qz[i], dy = gy - qy[i], dx = gx - qx[i];
            const int iz = z + dz, iy = y + dy;
            if (dx <= -S || dx >= S || iz < 0 || iz >= S || iy < 0 || iy >= S) continue;
            const W w = __ldcg(reached + ((size_t)i * S + iz) * S + iy);
            clear |= dx >= 0 ? W(w >> dx) : W(w << -dx);
          }
          const int dzy = abs(z - half) + abs(y - half);
          const W e = band[r] & ~clear & ball_bits<W>(dzy, bound, half);
          expandable[r] = e;
          ground[r] = band[rows + r];
          cur[r] = (z == half && y == half) ? (e & (W(1) << half)) : W(0);
        }
        __syncthreads();
        connected = bfs_sweeps<W>(bound, S, max_iters, expandable, ground, cur, nxt);
      }
      fails = !connected;
      if (connected)
        for (int k = threadIdx.x; k < K; k += blockDim.x)
          if (slots[k] != 0) conn[k] = 1;
    }
    // the query's reached rows: a failed query's flood, else 0
    W* rq = reached + (size_t)q * rows;
    for (int r = threadIdx.x; r < rows; r += blockDim.x) rq[r] = fails ? cur[r] : W(0);
    if (threadIdx.x == 0) {
      demoted[q] = fails ? 1 : 0;
      if (fails) failed[nf] = q;
    }
    nf += fails ? 1 : 0;
    __syncthreads();  // the next query reads these rows, the list and the flags
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) cluster_connected[k] = conn[k];
}

// K15b-7c, the write-back: min(v, thr) at the reached voxels of every
// demoted query inside the shard's slab (the z window of K8), one block per
// query; the stores and the count are K8's.
template <typename W>
__global__ void __launch_bounds__(DEMOTE_T) demote_direct_kernel(
    float* __restrict__ grid, int nz, int ny, int nx, int z_lo, int nz_g,
    const W* __restrict__ reached, const int32_t* __restrict__ corners,
    const uint8_t* __restrict__ demoted, int S, float thr, int* __restrict__ n_writes) {
  const int q = blockIdx.x;
  if (demoted[q] == 0) return;
  add_count(store_min_rows(grid, nz, ny, nx, z_lo, nz_g, reached + (size_t)q * S * S,
                           corners[3 * q], corners[3 * q + 1], corners[3 * q + 2], S, thr),
            n_writes);
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

template <typename W>
int launch_explore_seq(void* grid, int nz, int ny, int nx, const void* qx, const void* qy,
                       const void* qz, const void* qvalid, const void* qlabels,
                       const void* qids, const void* qslot, const void* mm,
                       const void* query_overflow, float thr_f, float thr_g, int Q, int K,
                       int S, int max_iters, void* cluster_connected, void* n_writes,
                       cudaStream_t s) {
  const size_t smem = 4 * (size_t)S * S * sizeof(W) + (size_t)Q * sizeof(int) + (size_t)K;
  const int e = allow_smem(explore_seq_kernel<W>, smem);
  if (e != 0) return e;
  explore_seq_kernel<W><<<1, SEQ_T, smem, s>>>(
      static_cast<float*>(grid), nz, ny, nx, static_cast<const int32_t*>(qx),
      static_cast<const int32_t*>(qy), static_cast<const int32_t*>(qz),
      static_cast<const uint8_t*>(qvalid), static_cast<const int32_t*>(qlabels),
      static_cast<const int32_t*>(qids), static_cast<const uint8_t*>(qslot),
      static_cast<const int32_t*>(mm), static_cast<const uint8_t*>(query_overflow), thr_f,
      thr_g, Q, K, S, max_iters, static_cast<uint8_t*>(cluster_connected),
      static_cast<int32_t*>(n_writes));
  return (int)cudaGetLastError();
}

template <typename W>
int launch_explore_stack(const void* stack, int nz, int ny, int nx, const void* qx,
                         const void* qy, const void* qz, const void* qvalid, const void* qlabels,
                         const void* qids, const void* qslot, const void* mm,
                         const void* query_overflow, int Q, int K, int S, int max_iters,
                         void* cluster_connected, void* reached, void* corners, void* demoted,
                         cudaStream_t s) {
  const size_t smem = 4 * (size_t)S * S * sizeof(W) + 2 * (size_t)Q * sizeof(int) + (size_t)K;
  const int e = allow_smem(explore_stack_kernel<W>, smem);
  if (e != 0) return e;
  explore_stack_kernel<W><<<1, SEQ_T, smem, s>>>(
      static_cast<const W*>(stack), nz, ny, nx, static_cast<const int32_t*>(qx),
      static_cast<const int32_t*>(qy), static_cast<const int32_t*>(qz),
      static_cast<const uint8_t*>(qvalid), static_cast<const int32_t*>(qlabels),
      static_cast<const int32_t*>(qids), static_cast<const uint8_t*>(qslot),
      static_cast<const int32_t*>(mm), static_cast<const uint8_t*>(query_overflow), Q, K, S,
      max_iters, static_cast<uint8_t*>(cluster_connected), static_cast<W*>(reached),
      static_cast<int32_t*>(corners), static_cast<uint8_t*>(demoted));
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

// K7s, in place on grid: the sequential explore of the Q queries in (label,
// id) order with live demotion.  qx/qy/qz/qlabels/qids/max_manhattan: int32
// [Q]; qvalid: bool [Q]; qslot: bool [Q, K]; query_overflow: bool scalar.
// Outputs: cluster_connected bool [K], n_writes int32 scalar (written, not
// added to).  1 <= Q <= 4096, 2 <= S <= 62.
VOFOD_API int vofod_explore_sequential(void* grid, int nz, int ny, int nx, const void* qx,
                                       const void* qy, const void* qz, const void* qvalid,
                                       const void* qlabels, const void* qids, const void* qslot,
                                       const void* max_manhattan, const void* query_overflow,
                                       float thr_f, float thr_g, int Q, int K, int S,
                                       int max_iters, void* cluster_connected, void* n_writes,
                                       void* stream) {
  if (Q <= 0 || Q > 4096 || K <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 32)
    return launch_explore_seq<uint32_t>(grid, nz, ny, nx, qx, qy, qz, qvalid, qlabels, qids,
                                        qslot, max_manhattan, query_overflow, thr_f, thr_g, Q,
                                        K, S, max_iters, cluster_connected, n_writes, s);
  return launch_explore_seq<unsigned long long>(grid, nz, ny, nx, qx, qy, qz, qvalid, qlabels,
                                                qids, qslot, max_manhattan, query_overflow,
                                                thr_f, thr_g, Q, K, S, max_iters,
                                                cluster_connected, n_writes, s);
}

// K15b-7a: the cut of a shard's slab.  grid: device float32 [nz, ny, nx],
// the rows [z_lo, z_lo + nz) of the grid; qx/qy/qz: int32 [Q] global;
// qvalid: bool [Q].  Output: stack [Q, 2, S, S] (band rows, then ground
// rows), uint32 words for S <= 32, else uint64.  2 <= S <= 62.
VOFOD_API int vofod_explore_cut(const void* grid, int nz, int ny, int nx, int z_lo,
                                const void* qx, const void* qy, const void* qz,
                                const void* qvalid, float thr_f, float thr_g, int Q, int S,
                                void* stack, void* stream) {
  if (Q <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  const int32_t *x = static_cast<const int32_t*>(qx), *y = static_cast<const int32_t*>(qy),
                *z = static_cast<const int32_t*>(qz);
  const uint8_t* v = static_cast<const uint8_t*>(qvalid);
  if (S <= 32)
    explore_cut_kernel<uint32_t><<<Q, EXPLORE_T, 0, s>>>(g, nz, ny, nx, z_lo, x, y, z, v, thr_f,
                                                         thr_g, S,
                                                         static_cast<uint32_t*>(stack));
  else
    explore_cut_kernel<unsigned long long><<<Q, EXPLORE_T, 0, s>>>(
        g, nz, ny, nx, z_lo, x, y, z, v, thr_f, thr_g, S,
        static_cast<unsigned long long*>(stack));
  return (int)cudaGetLastError();
}

// K15b-7b: the walk on the replicated stack (vofod_explore_cut's words)
// of a grid of (nz, ny, nx) rows.  The query table as
// vofod_explore_sequential's.  Outputs: cluster_connected bool [K],
// reached [Q, S, S] words (the failed queries' floods, 0 elsewhere),
// corners int32 [Q, 3] (z, y, x), demoted bool [Q] (the failed queries).
// 1 <= Q <= 4096, 2 <= S <= 62.
VOFOD_API int vofod_explore_seq_stack(const void* stack, int nz, int ny, int nx, const void* qx,
                                      const void* qy, const void* qz, const void* qvalid,
                                      const void* qlabels, const void* qids, const void* qslot,
                                      const void* max_manhattan, const void* query_overflow,
                                      int Q, int K, int S, int max_iters,
                                      void* cluster_connected, void* reached, void* corners,
                                      void* demoted, void* stream) {
  if (Q <= 0 || Q > 4096 || K <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 32)
    return launch_explore_stack<uint32_t>(stack, nz, ny, nx, qx, qy, qz, qvalid, qlabels, qids,
                                          qslot, max_manhattan, query_overflow, Q, K, S,
                                          max_iters, cluster_connected, reached, corners,
                                          demoted, s);
  return launch_explore_stack<unsigned long long>(stack, nz, ny, nx, qx, qy, qz, qvalid, qlabels,
                                                  qids, qslot, max_manhattan, query_overflow, Q,
                                                  K, S, max_iters, cluster_connected, reached,
                                                  corners, demoted, s);
}

// K15b-7c, in place on a shard's slab: min(v, thr) at the reached voxels
// (vofod_explore_seq_stack's words) of the demoted queries.  grid: the z
// rows [z_lo, z_lo + nz) of a grid of nz_g rows; n_writes: int32 scalar the
// kernel adds its stores to (zeroed by the caller).
VOFOD_API int vofod_demote_direct(void* grid, int nz, int ny, int nx, int z_lo, int nz_g,
                                  const void* reached, const void* corners, const void* demoted,
                                  int Q, int S, float thr, void* n_writes, void* stream) {
  if (Q <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(grid);
  const int32_t* c = static_cast<const int32_t*>(corners);
  const uint8_t* d = static_cast<const uint8_t*>(demoted);
  int* n = static_cast<int*>(n_writes);
  if (S <= 32)
    demote_direct_kernel<uint32_t><<<Q, DEMOTE_T, 0, s>>>(
        g, nz, ny, nx, z_lo, nz_g, static_cast<const uint32_t*>(reached), c, d, S, thr, n);
  else
    demote_direct_kernel<unsigned long long><<<Q, DEMOTE_T, 0, s>>>(
        g, nz, ny, nx, z_lo, nz_g, static_cast<const unsigned long long*>(reached), c, d, S,
        thr, n);
  return (int)cudaGetLastError();
}
