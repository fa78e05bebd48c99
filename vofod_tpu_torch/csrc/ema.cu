// K11 — the two full-grid EMA passes of the step.
//
// Replaces vofod_tpu/pipeline/background.py `_finish` (the point EMA,
// ref updateVoxel :789-795) and the demotion EMA of
// vofod_tpu/pipeline/sepclusters.py:144-156 (ref :1219-1244).
//
// Bound on the H100: memory.  Each is one pass over the 2.47 M-voxel grid
// where the plain PyTorch form runs a chain of full-grid elementwise
// launches with a temporary each.
//
// * Point EMA: one elementwise launch from the counts, the close mask and
//   the grid: w = 2^-min(count, 63), v' = w v + (1 - w) score where the
//   voxel is occupied (score_point if close, score_unknown otherwise); it
//   also writes far = occupied & ~close and adds the occupied voxels to an
//   int32 count (one atomic per warp).
// * Demotion EMA: an epilogue mode of K1's int8 ball max (ball_pool.cu):
//   the same tile, staged in shared memory, holds unsafe = bg & ~safe,
//   computed while loading; a voxel within the ball of an unsafe one gets
//   v' = w1 v + c when sure_sufficient (read from its device pointer, no
//   host sync).  The demotion mask is never stored.  The max over 0/1
//   values is the same integer result as K1, so the mask is bit-equal to
//   K1's.
//
// * Exact demotion EMA (K13c, vofod_tpu/pipeline/sepclusters.py:365-390,
//   the exact-census mode): the same K1 tile, holding the extended-lattice
//   centre mask of the unsure coarse cells (computed while staging from
//   the occupancy and K13a's census), summed over the demotion ball: k
//   demotions per voxel, the EMA w1^k v + (1 - w1^k) score where
//   sure_sufficient (from K13a's two flags and the previous value, on the
//   device); the carried safe = bg & sure cell is written in the same
//   pass.  The centre mask, k, w1^k and the upsampled sure mask of the
//   plain version are never stored.
//
// Arithmetic: the EMAs as __fmul_rn / __fadd_rn in the plain version's
// order (no FMA contraction), exp2f as PyTorch's CUDA exp2 calls it, w1 and
// c rounded to float32 on the host as the tensor ops round the Python
// scalars; both entry points are bit-equal to their plain versions.
#include "common.cuh"

namespace {

constexpr int EMA_T = 256;

__global__ void __launch_bounds__(EMA_T)
    point_ema_kernel(const float* __restrict__ vals, const int32_t* __restrict__ counts,
                     const uint8_t* __restrict__ close, long long n, float score_point,
                     float score_unknown, float* __restrict__ out,
                     uint8_t* __restrict__ far, int* __restrict__ n_occupied) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int occ = 0;
  if (i < n) {
    const int c = counts[i];
    const bool cl = close[i] != 0;
    occ = c > 0;
    float v = vals[i];
    if (occ) {
      const float w = exp2f(-(float)min(max(c, 0), 63));
      const float score = cl ? score_point : score_unknown;
      v = __fadd_rn(__fmul_rn(w, v), __fmul_rn(__fsub_rn(1.0f, w), score));
    }
    out[i] = v;
    far[i] = occ && !cl;
  }
  for (int o = 16; o > 0; o >>= 1) occ += __shfl_down_sync(0xffffffffu, occ, o);
  if ((threadIdx.x & 31) == 0 && occ != 0) atomicAdd(n_occupied, occ);
}

// K1's tile (common.cuh load_tile) with unsafe = bg & ~safe computed while
// staging; out-of-grid cells read 0
__device__ __forceinline__ void load_unsafe_tile(const uint8_t* __restrict__ bg,
                                                 const uint8_t* __restrict__ safe,
                                                 uint8_t* tile, int nz, int ny, int nx,
                                                 int halo) {
  const int sx = TILE_X + 2 * halo, sy = TILE_Y + 2 * halo, sz = TILE_Z + 2 * halo;
  const int x0 = blockIdx.x * TILE_X - halo;
  const int y0 = blockIdx.y * TILE_Y - halo;
  const int z0 = blockIdx.z * TILE_Z - halo;
  const int tid = threadIdx.x + TILE_X * (threadIdx.y + TILE_Y * threadIdx.z);
  const int n = sx * sy * sz;
  for (int i = tid; i < n; i += TILE_X * TILE_Y * TILE_Z) {
    const int lx = i % sx;
    const int rest = i / sx;
    const int ly = rest % sy;
    const int lz = rest / sy;
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    uint8_t v = 0;
    if (gx >= 0 && gx < nx && gy >= 0 && gy < ny && gz >= 0 && gz < nz) {
      const size_t g = ((size_t)gz * ny + gy) * nx + gx;
      v = bg[g] != 0 && safe[g] == 0;
    }
    tile[i] = v;
  }
}

__global__ void __launch_bounds__(TILE_X* TILE_Y* TILE_Z)
    demote_ema_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ bg,
                      const uint8_t* __restrict__ safe,
                      const uint8_t* __restrict__ sure_sufficient, int nz, int ny, int nx,
                      BallTaps taps, float w1, float c, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char tile[];
  const int h = taps.halo;
  load_unsafe_tile(bg, safe, tile, nz, ny, nx, h);
  __syncthreads();

  const int x = blockIdx.x * TILE_X + threadIdx.x;
  const int y = blockIdx.y * TILE_Y + threadIdx.y;
  const int z = blockIdx.z * TILE_Z + threadIdx.z;
  if (x >= nx || y >= ny || z >= nz) return;
  const int sx = TILE_X + 2 * h, sy = TILE_Y + 2 * h;
  const int cx = threadIdx.x + h, cy = threadIdx.y + h, cz = threadIdx.z + h;
  uint8_t demote = 0;  // the K1 int8 max over the ball, > 0
  for (int t = 0; t < taps.n; ++t)
    demote |= tile[((cz + taps.dz[t]) * sy + cy + taps.dy[t]) * sx + cx + taps.dx[t]];
  const size_t g = ((size_t)z * ny + y) * nx + x;
  const float v = vals[g];
  out[g] = (demote && sure_sufficient[0]) ? __fadd_rn(__fmul_rn(w1, v), c) : v;
}

// K13c: the coarse lattice of the exact census
struct CoarseLattice {
  int ncz, ncy, ncx, lsz;
  float min_sure;  // a cell is sure when its census >= min_sure
};

__device__ __forceinline__ size_t cell_of(const CoarseLattice& c, int z, int y, int x) {
  return ((size_t)(z / c.lsz) * c.ncy + y / c.lsz) * c.ncx + x / c.lsz;
}

// K1's tile of the EXTENDED coarse-centre mask (vofod_tpu sepclusters.py
// _center_mask): a lattice point is set when it is the centre ijk * lsz +
// lsz / 2 of an unsure coarse cell (occupied, census < min_sure); points
// outside the extended lattice read 0
__device__ __forceinline__ void load_centre_tile(const uint8_t* __restrict__ occ_c,
                                                 const int32_t* __restrict__ census,
                                                 const CoarseLattice& c, uint8_t* tile,
                                                 int halo) {
  const int sx = TILE_X + 2 * halo, sy = TILE_Y + 2 * halo, sz = TILE_Z + 2 * halo;
  const int x0 = blockIdx.x * TILE_X - halo;
  const int y0 = blockIdx.y * TILE_Y - halo;
  const int z0 = blockIdx.z * TILE_Z - halo;
  const int tid = threadIdx.x + TILE_X * (threadIdx.y + TILE_Y * threadIdx.z);
  const int n = sx * sy * sz;
  const int mid = c.lsz / 2;
  for (int i = tid; i < n; i += TILE_X * TILE_Y * TILE_Z) {
    const int lx = i % sx;
    const int rest = i / sx;
    const int ly = rest % sy;
    const int lz = rest / sy;
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    uint8_t v = 0;
    if (gx >= 0 && gx < c.ncx * c.lsz && gy >= 0 && gy < c.ncy * c.lsz && gz >= 0 &&
        gz < c.ncz * c.lsz && gx % c.lsz == mid && gy % c.lsz == mid && gz % c.lsz == mid) {
      const size_t cell = cell_of(c, gz, gy, gx);
      v = occ_c[cell] != 0 && !((float)census[cell] >= c.min_sure);
    }
    tile[i] = v;
  }
}

__global__ void __launch_bounds__(TILE_X* TILE_Y* TILE_Z)
    exact_demote_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ occ_c,
                        const int32_t* __restrict__ census, const uint8_t* __restrict__ flags,
                        const uint8_t* __restrict__ prev_sure, int nz, int ny, int nx,
                        CoarseLattice c, BallTaps taps, float w1, float score, float thr_new,
                        float* __restrict__ out, uint8_t* __restrict__ safe,
                        uint8_t* __restrict__ sure_out) {
  extern __shared__ __align__(16) unsigned char tile[];
  const int h = taps.halo;
  load_centre_tile(occ_c, census, c, tile, h);
  __syncthreads();
  // empty background keeps the previous value (ref :1155-1159)
  const bool sure_sufficient = flags[0] ? flags[1] != 0 : prev_sure[0] != 0;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0 &&
      threadIdx.y == 0 && threadIdx.z == 0)
    sure_out[0] = sure_sufficient;

  const int x = blockIdx.x * TILE_X + threadIdx.x;
  const int y = blockIdx.y * TILE_Y + threadIdx.y;
  const int z = blockIdx.z * TILE_Z + threadIdx.z;
  if (x >= nx || y >= ny || z >= nz) return;
  const int sx = TILE_X + 2 * h, sy = TILE_Y + 2 * h;
  const int cx = threadIdx.x + h, cy = threadIdx.y + h, cz = threadIdx.z + h;
  int k = 0;  // K1's int32 ball sum of the centre mask
  for (int t = 0; t < taps.n; ++t)
    k += tile[((cz + taps.dz[t]) * sy + cy + taps.dy[t]) * sx + cx + taps.dx[t]];
  const size_t g = ((size_t)z * ny + y) * nx + x;
  const float v = vals[g];
  const float w1k = powf(w1, (float)k);  // torch.pow(w1, k.float()) on the card
  out[g] = sure_sufficient
               ? __fadd_rn(__fmul_rn(w1k, v), __fmul_rn(__fsub_rn(1.0f, w1k), score))
               : v;
  const size_t cell = cell_of(c, z, y, x);
  safe[g] = v > thr_new && occ_c[cell] != 0 && (float)census[cell] >= c.min_sure;
}

}  // namespace

// vals: device f32 grid [n]; counts: int32 [n]; close: bool [n].  Outputs:
// out f32 [n], far bool [n], n_occupied int32 scalar (zeroed by the
// caller).  Returns cudaGetLastError().
VOFOD_API int vofod_point_ema(const void* vals, const void* counts, const void* close,
                              long long n, float score_point, float score_unknown,
                              void* out, void* far, void* n_occupied, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + EMA_T - 1) / EMA_T;
  point_ema_kernel<<<(unsigned int)blocks, EMA_T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(counts),
      static_cast<const uint8_t*>(close), n, score_point, score_unknown,
      static_cast<float*>(out), static_cast<uint8_t*>(far), static_cast<int*>(n_occupied));
  return (int)cudaGetLastError();
}

// vals: device f32 grid (nz, ny, nx); bg, safe: bool grids; sure_sufficient:
// bool scalar; taps: host int32 [n_taps, 3] (dz, dy, dx) of the demotion
// ball; w1, c: the EMA v' = w1 v + c.  out: f32 grid.
VOFOD_API int vofod_demote_ema(const void* vals, const void* bg, const void* safe,
                               const void* sure_sufficient, int nz, int ny, int nx,
                               const int* taps, int n_taps, int halo, float w1, float c,
                               void* out, void* stream) {
  if (n_taps < 1 || n_taps > VOFOD_MAX_TAPS || halo < 0 || halo > 7)
    return (int)cudaErrorInvalidValue;
  const BallTaps t = make_taps(taps, n_taps, halo);
  demote_ema_kernel<<<tile_grid(nz, ny, nx), dim3(TILE_X, TILE_Y, TILE_Z), tile_elems(halo),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const uint8_t*>(bg),
      static_cast<const uint8_t*>(safe), static_cast<const uint8_t*>(sure_sufficient), nz,
      ny, nx, t, w1, c, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// K13c.  vals: device f32 grid (nz, ny, nx); occ_c: bool coarse cells
// (ncz, ncy, ncx) with ncz = ceil(nz / lsz) etc.; census: int32 per cell
// (K13a's out); flags: uint8 [2] (K13a's any occ, any sure); prev_sure:
// bool scalar.  taps: the demotion ball; floats: host f32 [min_sure, w1,
// score_ray, thr_new_obstacles].  Outputs: out f32 grid, safe bool grid,
// sure_out bool scalar.  Returns cudaGetLastError().
VOFOD_API int vofod_exact_demote_ema(const void* vals, const void* occ_c, const void* census,
                                     const void* flags, const void* prev_sure, int nz, int ny,
                                     int nx, int lsz, const int* taps, int n_taps, int halo,
                                     const float* floats, void* out, void* safe, void* sure_out,
                                     void* stream) {
  if (n_taps < 1 || n_taps > VOFOD_MAX_TAPS || halo < 0 || halo > 7 || lsz < 1)
    return (int)cudaErrorInvalidValue;
  const BallTaps t = make_taps(taps, n_taps, halo);
  CoarseLattice c;
  c.lsz = lsz;
  c.ncz = (nz + lsz - 1) / lsz; c.ncy = (ny + lsz - 1) / lsz; c.ncx = (nx + lsz - 1) / lsz;
  c.min_sure = floats[0];
  exact_demote_kernel<<<tile_grid(nz, ny, nx), dim3(TILE_X, TILE_Y, TILE_Z), tile_elems(halo),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const uint8_t*>(occ_c),
      static_cast<const int32_t*>(census), static_cast<const uint8_t*>(flags),
      static_cast<const uint8_t*>(prev_sure), nz, ny, nx, c, t, floats[1], floats[2], floats[3],
      static_cast<float*>(out), static_cast<uint8_t*>(safe), static_cast<uint8_t*>(sure_out));
  return (int)cudaGetLastError();
}
