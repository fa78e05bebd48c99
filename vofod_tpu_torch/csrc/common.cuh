// Shared helpers of the vofod_tpu_torch CUDA kernels.
//
// The kernels form one shared library with a plain C interface (loaded with
// ctypes by vofod_tpu_torch/kernels.py).  Every entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define VOFOD_API extern "C" __attribute__((visibility("default")))

// Euclidean-ball tap list (dz, dy, dx), built on the host by
// vofod_tpu_torch.ops.morphology and passed by value as a kernel parameter
// (no device allocation, no constant-memory upload).  Two capacities: the
// sets of at most 256 taps (every ball up to radius 3.9, 8 + 768 bytes of
// parameters: the production radii) and every ball up to halo 7 (the ball
// of r^2 < 64 holds 2,103 taps: 8 + 6,336 bytes, above the classic 4 KB
// parameter limit, within the 32,764 bytes that CUDA 12.1+ takes on sm_70+).
// A larger set goes to K2's wide form (csrc/propagate.cu: its taps in
// bands from global memory), never through these structs.
#define VOFOD_MAX_TAPS 256
#define VOFOD_MAX_TAPS_LARGE 2112
#define VOFOD_MAX_HALO 7

template <int CAP>
struct BallTapsN {
  int n;     // number of taps (123 at radius 3.0)
  int halo;  // the largest |offset| of the set: tile halo on every side
  signed char dz[CAP];
  signed char dy[CAP];
  signed char dx[CAP];
};
using BallTaps = BallTapsN<VOFOD_MAX_TAPS>;
using BallTapsLarge = BallTapsN<VOFOD_MAX_TAPS_LARGE>;

template <int CAP>
inline BallTapsN<CAP> make_taps(const int* taps, int n, int halo) {
  BallTapsN<CAP> t;
  t.n = n;
  t.halo = halo;
  for (int i = 0; i < n; ++i) {
    t.dz[i] = (signed char)taps[3 * i + 0];
    t.dy[i] = (signed char)taps[3 * i + 1];
    t.dx[i] = (signed char)taps[3 * i + 2];
  }
  return t;
}

inline bool taps_ok(int n, int halo) {
  return n >= 1 && n <= VOFOD_MAX_TAPS_LARGE && halo >= 0 && halo <= VOFOD_MAX_HALO;
}

// Launch a tiled stencil kernel with the tap set in the smaller parameter
// struct when it fits (the production radii keep that code path and its
// timing), else in the large one.  `launch` is a generic lambda taking the
// tap struct.
template <typename F>
inline int with_taps(const int* taps, int n, int halo, F&& launch) {
  if (!taps_ok(n, halo)) return (int)cudaErrorInvalidValue;
  if (n <= VOFOD_MAX_TAPS) return launch(make_taps<VOFOD_MAX_TAPS>(taps, n, halo));
  return launch(make_taps<VOFOD_MAX_TAPS_LARGE>(taps, n, halo));
}

// A tile above the 48 KB default of dynamic shared memory (an int32 tile
// from halo 6 on: 56,320 B at h = 6, 72,864 B at h = 7) needs the kernel's
// opt-in first, or the launch is refused.
template <typename K>
inline int allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute((const void*)kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Output tile of the 3-D stencils: one thread per output voxel.
constexpr int TILE_X = 32;
constexpr int TILE_Y = 8;
constexpr int TILE_Z = 4;

// Load the (TILE + 2*halo)^3 input box of the output tile (tx, ty, tz)
// into shared memory; out-of-grid cells read `fill` (the JAX pools pad
// with the fill value).  A persistent kernel's blocks walk over many
// tiles.  `in` is neither const nor __restrict__ at its callers, so the
// loads are coherent ones (never ld.global.nc): they
// read what other blocks wrote before a grid barrier whose acquire fence
// orders them after those writes.
template <typename T>
__device__ __forceinline__ void load_tile_at(const T* in, T* tile, int tx, int ty, int tz,
                                             int nz, int ny, int nx, int halo, T fill) {
  const int sx = TILE_X + 2 * halo, sy = TILE_Y + 2 * halo,
            sz = TILE_Z + 2 * halo;
  const int x0 = tx * TILE_X - halo;
  const int y0 = ty * TILE_Y - halo;
  const int z0 = tz * TILE_Z - halo;
  const int tid = threadIdx.x + TILE_X * (threadIdx.y + TILE_Y * threadIdx.z);
  const int n = sx * sy * sz;
  for (int i = tid; i < n; i += TILE_X * TILE_Y * TILE_Z) {
    const int lx = i % sx;
    const int rest = i / sx;
    const int ly = rest % sy;
    const int lz = rest / sy;
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    T v = fill;
    if (gx >= 0 && gx < nx && gy >= 0 && gy < ny && gz >= 0 && gz < nz)
      v = in[((size_t)gz * ny + gy) * nx + gx];
    tile[i] = v;
  }
}

inline size_t tile_elems(int halo) {
  return (size_t)(TILE_X + 2 * halo) * (TILE_Y + 2 * halo) *
         (TILE_Z + 2 * halo);
}

inline dim3 tile_grid(int nz, int ny, int nx) {
  return dim3((nx + TILE_X - 1) / TILE_X, (ny + TILE_Y - 1) / TILE_Y,
              (nz + TILE_Z - 1) / TILE_Z);
}

// Exclusive block-wide prefix sum of v (blockDim.x a multiple of 32, at most
// 1024 threads); the block total through *total.  warp_s: shared memory of
// blockDim.x / 32 elements.  The single-pass scans of K6 (csrc/compact.cu)
// and of K13b and K15b-6b (csrc/census.cu) scan each tile with it and add
// the tiles before by decoupled look-back (csrc/lookback.cuh).
template <typename T>
__device__ __forceinline__ T block_excl_scan(T v, T* warp_s, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  T before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const T s = warp_s[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}
