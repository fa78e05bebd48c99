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
// vofod_tpu_torch.ops.morphology.ball_offsets and passed by value as a kernel
// parameter (no device allocation, no constant-memory upload).
#define VOFOD_MAX_TAPS 256

struct BallTaps {
  int n;     // number of taps (123 at radius 3.0)
  int halo;  // floor(radius): tile halo on every side
  signed char dz[VOFOD_MAX_TAPS];
  signed char dy[VOFOD_MAX_TAPS];
  signed char dx[VOFOD_MAX_TAPS];
};

inline BallTaps make_taps(const int* taps, int n, int halo) {
  BallTaps t;
  t.n = n;
  t.halo = halo;
  for (int i = 0; i < n; ++i) {
    t.dz[i] = (signed char)taps[3 * i + 0];
    t.dy[i] = (signed char)taps[3 * i + 1];
    t.dx[i] = (signed char)taps[3 * i + 2];
  }
  return t;
}

// Output tile of the 3-D stencils: one thread per output voxel.
constexpr int TILE_X = 32;
constexpr int TILE_Y = 8;
constexpr int TILE_Z = 4;

// Load the (TILE + 2*halo)^3 input box of this block into shared memory;
// out-of-grid cells read `fill` (the JAX pools pad with the fill value).
template <typename T>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ in, T* tile, int nz, int ny, int nx, int halo,
    T fill) {
  const int sx = TILE_X + 2 * halo, sy = TILE_Y + 2 * halo,
            sz = TILE_Z + 2 * halo;
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
