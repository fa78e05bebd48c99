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
// Bound on the H100: latency.  The work is tiny (256 queries x 32^3 voxels,
// 32 MB of grid reads at most) but the BFS is a chain of up to 96
// dependent sweeps; as plain PyTorch every sweep was ~12 launches over
// [Q, S, S] words.  Here one block runs one query's whole BFS in shared
// memory (bfs_block):
//  - the submap is read straight from the grid, one warp per x-row (a
//    coalesced 128-byte row at S = 32); a voxel outside the grid reads
//    -1e30, certain air, so the whole-grid pad of the JAX version is gone;
//  - expandable (unknown & ball), ground and reached live bit-packed, one
//    word per (z, y) row (32-bit words for S <= 32: 4 KB a mask; 64-bit for
//    S <= 62); the Manhattan ball and shell of a row are bit ranges
//    computed from the row's offset, never stored;
//  - the sweeps are Jacobi, like the JAX while_loop: two reached buffers,
//    and __syncthreads_or on "changed" ends the loop at the fixpoint or
//    after max_iters.  An in-place update would advance more than one voxel
//    per sweep and differ whenever max_iters binds;
//  - an invalid query's block writes empty outputs and returns.
// Reached leaves the kernel as packed int64 rows [Q, S, S] (bit x of row
// (z, y)), 2 MB at the flagship shape instead of an 8.4 MB bool tensor.
//
// K8 runs one block per query.  The block decides on its own whether its
// query demotes (valid, and some slot it belongs to passed the explore gate
// with no connected member under no query overflow), then stores
// min(v, thr) at every reached voxel inside the grid.  Every reached voxel
// was in the unknown band (v > thr) of the grid the BFS read, so all
// writers of a voxel store the same value: plain stores, no atomics on the
// grid.  It updates the grid in place and counts its writes in one device
// int32.
//
// K7s replaces the lax.scan of vofod_tpu/pipeline/classify.py:222-267
// (cfg.sequential_explore, the reference's own order, vofod_nodelet.cpp
// :1692-1718): the queries run one at a time in ascending (component label,
// flat id) order, a query whose cluster already connected is skipped, and a
// failed query demotes its reached voxels before the next one reads the
// grid.  That chain is sequential by definition, so it is ONE block of 1024
// threads walking the Q queries in one launch (no host sync, no launch per
// query): the order is a Q x Q rank in the block, the connected clusters a
// flag per slot in shared memory, each query runs K7's bfs_block on the
// CURRENT grid and, when it fails, writes min(v, thr) at its reached voxels
// before a __syncthreads().  The grid is read and written in the same
// launch, so it is no `const __restrict__` pointer and every read goes
// through L2 (__ldcg), never the read-only cache, which is not coherent with
// the kernel's own stores.  Bound: latency again — valid queries x sweeps
// on one SM.
#include "common.cuh"

namespace {

constexpr int EXPLORE_T = 256;
constexpr int DEMOTE_T = 256;
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

// One query's BFS by the whole block, submap corner (x0, y0, z0).  `grid`
// holds the z rows [z_lo, z_lo + nz) (the whole grid, or a shard's slab
// extended by the explore pad); rows outside it read as air.  Returns
// (the same on every thread) whether the flood's closure touched ground or
// the reached set the shell at bound - 1; the reached rows are left in
// `cur`.  Ends on a barrier, so the caller may read every row of `cur`.
template <typename W, bool kLive>
__device__ bool bfs_block(const float* grid, int nz, int ny, int nx, int z_lo, int x0, int y0,
                          int z0, int bound, float thr_f, float thr_g, int S, int max_iters,
                          W* expandable, W* ground, W*& cur, W*& nxt) {
  const int half = S / 2, rows = S * S;
  const W full = low_bits<W>(S);

  // submap -> packed rows: one warp per row, 32 x-lanes per chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const int z = r / S, y = r - (r / S) * S;
    const int gz = z0 + z - z_lo, gy = y0 + y;  // gz: the buffer's row
    const bool row_in = gz >= 0 && gz < nz && gy >= 0 && gy < ny;
    W unk = 0, gnd = 0;
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
    if (lane == 0) {
      const int dzy = abs(z - half) + abs(y - half);
      const W e = unk & ball_bits<W>(dzy, bound, half);
      expandable[r] = e;
      ground[r] = gnd;
      cur[r] = (z == half && y == half) ? (e & (W(1) << half)) : W(0);
    }
  }
  __syncthreads();

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

__device__ __forceinline__ bool at_grid_edge(int gx, int gy, int gz, int nz, int ny, int nx) {
  return gx <= 0 || gy <= 0 || gz <= 0 || gx >= nx - 1 || gy >= ny - 1 || gz >= nz - 1;
}

template <typename W>
__global__ void __launch_bounds__(EXPLORE_T) explore_kernel(
    const float* __restrict__ grid, int nz, int ny, int nx, int z_lo, int nz_g,
    const int32_t* __restrict__ qx, const int32_t* __restrict__ qy,
    const int32_t* __restrict__ qz, const uint8_t* __restrict__ qvalid,
    const int32_t* __restrict__ max_manhattan, float thr_f, float thr_g, int S,
    int max_iters, uint8_t* __restrict__ connected,
    unsigned long long* __restrict__ reached_out, int32_t* __restrict__ corners) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = blockIdx.x;
  const int half = S / 2, rows = S * S;
  const int x0 = qx[q] - half, y0 = qy[q] - half, z0 = qz[q] - half;
  unsigned long long* rout = reached_out + (size_t)q * rows;
  if (threadIdx.x == 0) {
    corners[3 * q + 0] = z0;
    corners[3 * q + 1] = y0;
    corners[3 * q + 2] = x0;
  }
  if (qvalid[q] == 0) {  // the JAX tier ladder's saving, with no host sync
    for (int r = threadIdx.x; r < rows; r += blockDim.x) rout[r] = 0ull;
    if (threadIdx.x == 0) connected[q] = 0;
    return;
  }
  W* expandable = reinterpret_cast<W*>(smem_raw);
  W* ground = expandable + rows;
  W* cur = ground + rows;
  W* nxt = cur + rows;
  const int bound = min(max_manhattan[q], half - 1);
  const bool hit = bfs_block<W, false>(grid, nz, ny, nx, z_lo, x0, y0, z0, bound, thr_f, thr_g,
                                       S, max_iters, expandable, ground, cur, nxt);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) rout[r] = (unsigned long long)cur[r];
  if (threadIdx.x == 0)
    connected[q] = (hit || at_grid_edge(x0 + half, y0 + half, z0 + half, nz_g, ny, nx)) ? 1 : 0;
}

__global__ void __launch_bounds__(DEMOTE_T) demote_kernel(
    float* __restrict__ grid, int nz, int ny, int nx, int z_lo, int nz_g,
    const unsigned long long* __restrict__ reached, const int32_t* __restrict__ corners,
    int S, const uint8_t* __restrict__ qslot, const uint8_t* __restrict__ connected,
    const uint8_t* __restrict__ qvalid, const uint8_t* __restrict__ qgate,
    const uint8_t* __restrict__ query_overflow, int Q, int K, float thr,
    int* __restrict__ n_writes) {
  const int q = blockIdx.x;
  if (qvalid[q] == 0 || query_overflow[0] != 0) return;
  // demote = some slot of q passed the gate and none of its members connected
  int floats = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (qslot[(size_t)q * K + k] == 0 || qgate[k] == 0) continue;
    bool any_conn = false;
    for (int p = 0; p < Q && !any_conn; ++p)
      any_conn = qslot[(size_t)p * K + k] != 0 && connected[p] != 0;
    floats |= !any_conn;
  }
  if (!__syncthreads_or(floats)) return;

  const int rows = S * S;
  const int z0 = corners[3 * q + 0], y0 = corners[3 * q + 1], x0 = corners[3 * q + 2];
  const unsigned long long* rq = reached + (size_t)q * rows;
  int count = 0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    unsigned long long w = rq[r];
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
  // one atomic per warp on the write counter
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  if ((threadIdx.x & 31) == 0 && count != 0) atomicAdd(n_writes, count);
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

  // rank by (label, id, index): jnp.lexsort((qids, qlabels)), a stable sort
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    const int li = qlabels[i], di = qids[i];
    int rank = 0;
    for (int j = 0; j < Q; ++j) {
      const int lj = qlabels[j], dj = qids[j];
      rank += lj < li || (lj == li && (dj < di || (dj == di && j < i)));
    }
    order[rank] = i;
  }
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
        for (int r = threadIdx.x; r < rows; r += blockDim.x) {
          W w = cur[r];
          const int gzr = z0 + r / S, gyr = y0 + r % S;
          if (w == W(0) || gzr < 0 || gzr >= nz || gyr < 0 || gyr >= ny) continue;
          float* row = grid + ((size_t)gzr * ny + gyr) * nx;
          while (w != W(0)) {
            const int x = __ffsll((long long)w) - 1;
            w &= w - 1;
            const int gxr = x0 + x;
            if (gxr < 0 || gxr >= nx) continue;
            if (row[gxr] > thr_f) row[gxr] = thr_f;  // min(v, thr), NaN kept
            ++count;
          }
        }
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
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  if ((threadIdx.x & 31) == 0 && count != 0) atomicAdd(&total, count);
  __syncthreads();
  if (threadIdx.x == 0) n_writes[0] = total;
}

template <typename Kern>
int allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename W>
int launch_explore(const void* grid, int nz, int ny, int nx, int z_lo, int nz_g, const void* qx,
                   const void* qy, const void* qz, const void* qvalid, const void* mm, float thr_f,
                   float thr_g, int Q, int S, int max_iters, void* connected, void* reached,
                   void* corners, cudaStream_t s) {
  const size_t smem = 4 * (size_t)S * S * sizeof(W);
  const int e = allow_smem(explore_kernel<W>, smem);
  if (e != 0) return e;
  explore_kernel<W><<<Q, EXPLORE_T, smem, s>>>(
      static_cast<const float*>(grid), nz, ny, nx, z_lo, nz_g, static_cast<const int32_t*>(qx),
      static_cast<const int32_t*>(qy), static_cast<const int32_t*>(qz),
      static_cast<const uint8_t*>(qvalid), static_cast<const int32_t*>(mm), thr_f, thr_g, S,
      max_iters, static_cast<uint8_t*>(connected),
      static_cast<unsigned long long*>(reached), static_cast<int32_t*>(corners));
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

}  // namespace

// grid: device float32 [nz, ny, nx] holding the z rows [z_lo, z_lo + nz) of
// a grid of nz_g rows (z_lo = 0 and nz_g = nz but on the grid-sharded
// step); qx/qy/qz/max_manhattan: int32 [Q] in global grid coordinates;
// qvalid: bool [Q].  Outputs: connected bool [Q], reached int64 [Q, S, S]
// (bit x of row (z, y)), corners int32 [Q, 3] (z, y, x).  2 <= S <= 62.
VOFOD_API int vofod_explore(const void* grid, int nz, int ny, int nx, int z_lo, int nz_g,
                            const void* qx, const void* qy, const void* qz, const void* qvalid,
                            const void* max_manhattan, float thr_f, float thr_g, int Q, int S,
                            int max_iters, void* connected, void* reached, void* corners,
                            void* stream) {
  if (Q <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 32)
    return launch_explore<uint32_t>(grid, nz, ny, nx, z_lo, nz_g, qx, qy, qz, qvalid,
                                    max_manhattan,
                                    thr_f, thr_g, Q, S, max_iters, connected, reached,
                                    corners, s);
  return launch_explore<unsigned long long>(grid, nz, ny, nx, z_lo, nz_g, qx, qy, qz, qvalid,
                                            max_manhattan, thr_f, thr_g, Q, S, max_iters,
                                            connected, reached, corners, s);
}

// In place: grid[v] = min(grid[v], thr) at the reached voxels of every
// demoting query.  grid: the z rows [z_lo, z_lo + nz) of a grid of nz_g
// rows, as vofod_explore's; writes land only inside both.  qslot: bool
// [Q, K]; connected/qvalid: bool [Q]; qgate: bool [K]; query_overflow: bool
// scalar; n_writes: int32 scalar the kernel adds its stores to (zeroed by
// the caller).
VOFOD_API int vofod_demote(void* grid, int nz, int ny, int nx, int z_lo, int nz_g,
                           const void* reached,
                           const void* corners, int S, const void* qslot, const void* connected,
                           const void* qvalid, const void* qgate, const void* query_overflow,
                           int Q, int K, float thr, void* n_writes, void* stream) {
  if (Q <= 0 || K <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  demote_kernel<<<Q, DEMOTE_T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(grid), nz, ny, nx, z_lo, nz_g,
      static_cast<const unsigned long long*>(reached),
      static_cast<const int32_t*>(corners), S, static_cast<const uint8_t*>(qslot),
      static_cast<const uint8_t*>(connected), static_cast<const uint8_t*>(qvalid),
      static_cast<const uint8_t*>(qgate), static_cast<const uint8_t*>(query_overflow), Q, K,
      thr, static_cast<int*>(n_writes));
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
