// K7 — the bounded flood-fill to ground (explore BFS), and K8 — the
// demotion write-back of failed searches.
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
// memory:
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
#include "common.cuh"

namespace {

constexpr int EXPLORE_T = 256;
constexpr int DEMOTE_T = 256;

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

template <typename W>
__global__ void __launch_bounds__(EXPLORE_T) explore_kernel(
    const float* __restrict__ grid, int nz, int ny, int nx,
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
  const W full = low_bits<W>(S);

  // submap -> packed rows: one warp per row, 32 x-lanes per chunk
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const int z = r / S, y = r - (r / S) * S;
    const int gz = z0 + z, gy = y0 + y;
    const bool row_in = gz >= 0 && gz < nz && gy >= 0 && gy < ny;
    W unk = 0, gnd = 0;
    for (int xc = 0; xc < S; xc += 32) {
      const int x = xc + lane, gx = x0 + x;
      float v = -1e30f;  // outside the grid: certain air
      if (x < S && row_in && gx >= 0 && gx < nx) v = grid[((size_t)gz * ny + gy) * nx + gx];
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
    const W c = cur[r];
    W clo = dil6_row<W>(cur, r, z, y, S, full) & ball_bits<W>(dzy, bound, half);
    if (z == half && y == half) clo |= W(1) << half;
    hit |= (clo & ground[r]) != 0;
    hit |= (c & shell_bits<W>(dzy, bound - 1, half)) != 0;
    rout[r] = (unsigned long long)c;
  }
  hit = __syncthreads_or(hit);
  if (threadIdx.x == 0) {
    const int gx = x0 + half, gy = y0 + half, gz = z0 + half;
    const bool at_edge = gx <= 0 || gy <= 0 || gz <= 0 || gx >= nx - 1 ||
                         gy >= ny - 1 || gz >= nz - 1;
    connected[q] = (hit || at_edge) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(DEMOTE_T) demote_kernel(
    float* __restrict__ grid, int nz, int ny, int nx,
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
    const int gz = z0 + r / S, gy = y0 + r % S;
    if (gz < 0 || gz >= nz || gy < 0 || gy >= ny) continue;
    float* row = grid + ((size_t)gz * ny + gy) * nx;
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
int launch_explore(const void* grid, int nz, int ny, int nx, const void* qx, const void* qy,
                   const void* qz, const void* qvalid, const void* mm, float thr_f,
                   float thr_g, int Q, int S, int max_iters, void* connected, void* reached,
                   void* corners, cudaStream_t s) {
  const size_t smem = 4 * (size_t)S * S * sizeof(W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        explore_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  explore_kernel<W><<<Q, EXPLORE_T, smem, s>>>(
      static_cast<const float*>(grid), nz, ny, nx, static_cast<const int32_t*>(qx),
      static_cast<const int32_t*>(qy), static_cast<const int32_t*>(qz),
      static_cast<const uint8_t*>(qvalid), static_cast<const int32_t*>(mm), thr_f, thr_g, S,
      max_iters, static_cast<uint8_t*>(connected),
      static_cast<unsigned long long*>(reached), static_cast<int32_t*>(corners));
  return (int)cudaGetLastError();
}

}  // namespace

// grid: device float32 [nz, ny, nx]; qx/qy/qz/max_manhattan: int32 [Q];
// qvalid: bool [Q].  Outputs: connected bool [Q], reached int64 [Q, S, S]
// (bit x of row (z, y)), corners int32 [Q, 3] (z, y, x).  2 <= S <= 62.
VOFOD_API int vofod_explore(const void* grid, int nz, int ny, int nx, const void* qx,
                            const void* qy, const void* qz, const void* qvalid,
                            const void* max_manhattan, float thr_f, float thr_g, int Q, int S,
                            int max_iters, void* connected, void* reached, void* corners,
                            void* stream) {
  if (Q <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 32)
    return launch_explore<uint32_t>(grid, nz, ny, nx, qx, qy, qz, qvalid, max_manhattan,
                                    thr_f, thr_g, Q, S, max_iters, connected, reached,
                                    corners, s);
  return launch_explore<unsigned long long>(grid, nz, ny, nx, qx, qy, qz, qvalid,
                                            max_manhattan, thr_f, thr_g, Q, S, max_iters,
                                            connected, reached, corners, s);
}

// In place: grid[v] = min(grid[v], thr) at the reached voxels of every
// demoting query.  qslot: bool [Q, K]; connected/qvalid: bool [Q]; qgate:
// bool [K]; query_overflow: bool scalar; n_writes: int32 scalar the kernel
// adds its stores to (zeroed by the caller).
VOFOD_API int vofod_demote(void* grid, int nz, int ny, int nx, const void* reached,
                           const void* corners, int S, const void* qslot, const void* connected,
                           const void* qvalid, const void* qgate, const void* query_overflow,
                           int Q, int K, float thr, void* n_writes, void* stream) {
  if (Q <= 0 || K <= 0 || S < 2 || S > 62) return (int)cudaErrorInvalidValue;
  demote_kernel<<<Q, DEMOTE_T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(grid), nz, ny, nx, static_cast<const unsigned long long*>(reached),
      static_cast<const int32_t*>(corners), S, static_cast<const uint8_t*>(qslot),
      static_cast<const uint8_t*>(connected), static_cast<const uint8_t*>(qvalid),
      static_cast<const uint8_t*>(qgate), static_cast<const uint8_t*>(query_overflow), Q, K,
      thr, static_cast<int*>(n_writes));
  return (int)cudaGetLastError();
}
