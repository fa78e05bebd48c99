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
