// K1 — Euclidean-ball min / max / sum stencil over the (nz, ny, nx) grid.
//
// Replaces vofod_tpu/ops/morphology.py `_ball_pool` (via ball_pool_min /
// ball_pool_max / ball_pool_sum), which XLA runs as ~35 shifted full-grid
// passes (x running pools + one combine per (dz, dy) row).
//
// Bound on the H100: memory.  At the flagship grid (51 x 201 x 241 =
// 2.47 M voxels) one pass reads and writes 2.5 MB (int8) or 9.9 MB (int32),
// while the 123 taps of a radius-3 ball are cheap shared-memory reads.  The
// design therefore reads every input voxel from device memory once per
// output tile: a (4 + 2h) x (8 + 2h) x (32 + 2h) box (h = floor(radius)) is
// staged in shared memory and each thread combines its voxel's static tap
// list from there.  With h = 3 the box re-reads 2.6x the tile's own voxels
// from L2, the price of a simple tile shape; a later version can stream
// z-planes through a ring buffer instead.
//
// Integer min/max/sum are exact in any order, so the output is bit-equal to
// the JAX decomposition and to the plain PyTorch version.
//
// K14 — the traced-shell pools of vofod_tpu/ops/morphology.py
// `_ball_pool_traced` (`ball_pool_{min,max,sum}_traced`, cfg.dynamic_radii)
// — are this kernel with another tap set: shell 0 plus every equal-distance
// shell of the static bound whose squared distance is <= the runtime r²,
// chosen on the host (ops/morphology.shell_taps).  The JAX form pools each
// shell on its own and combines it under a `where`; min, max and integer
// sum do not depend on the order, so one pass over the kept taps is
// bit-equal to it.  The radius is a launch argument: nothing recompiles.
//
// Tap sets of up to 256 taps travel in the 776-byte parameter struct as
// before; larger balls (radius 4: 257 taps, 5: 515, up to halo 7: 2,103) in
// the large one, and an int32 tile above 48 KB (halo 6 and 7) opts in to
// that much dynamic shared memory before its launch.
#include "common.cuh"

#include <type_traits>

namespace {

template <typename T, int OP>  // OP: 0 = min, 1 = max, 2 = sum
__device__ __forceinline__ T combine(T a, T b) {
  if (OP == 0) return a < b ? a : b;
  if (OP == 1) return a > b ? a : b;
  // sum: wrap like XLA's int32 add (no UB on overflow)
  return (T)((uint32_t)a + (uint32_t)b);
}

template <typename T, int OP, typename Taps>
__global__ void __launch_bounds__(TILE_X* TILE_Y* TILE_Z)
    ball_pool_kernel(const T* __restrict__ in, T* __restrict__ out, int nz,
                     int ny, int nx, Taps taps, T fill) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int h = taps.halo;
  load_tile<T>(in, tile, nz, ny, nx, h, fill);
  __syncthreads();

  const int x = blockIdx.x * TILE_X + threadIdx.x;
  const int y = blockIdx.y * TILE_Y + threadIdx.y;
  const int z = blockIdx.z * TILE_Z + threadIdx.z;
  if (x >= nx || y >= ny || z >= nz) return;
  const int sx = TILE_X + 2 * h, sy = TILE_Y + 2 * h;
  const int cx = threadIdx.x + h, cy = threadIdx.y + h, cz = threadIdx.z + h;
  T acc = tile[((cz + taps.dz[0]) * sy + cy + taps.dy[0]) * sx + cx +
               taps.dx[0]];
  for (int t = 1; t < taps.n; ++t) {
    const T v = tile[((cz + taps.dz[t]) * sy + cy + taps.dy[t]) * sx + cx +
                     taps.dx[t]];
    acc = combine<T, OP>(acc, v);
  }
  out[((size_t)z * ny + y) * nx + x] = acc;
}

template <typename T, int OP>
int launch(const void* in, void* out, int nz, int ny, int nx, const int* taps,
           int n_taps, int halo, int fill, cudaStream_t stream) {
  const size_t smem = tile_elems(halo) * sizeof(T);
  return with_taps(taps, n_taps, halo, [&](const auto& t) {
    auto* kernel = ball_pool_kernel<T, OP, std::decay_t<decltype(t)>>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<tile_grid(nz, ny, nx), dim3(TILE_X, TILE_Y, TILE_Z), smem, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), nz, ny, nx, t, (T)fill);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// dtype: 0 = int8, 1 = int32.  op: 0 = min, 1 = max, 2 = sum (int32 only).
// taps: host int32 [n_taps, 3] (dz, dy, dx), 1 <= n_taps <= 2,112, every
// |offset| <= halo <= 7.  Returns cudaGetLastError().
VOFOD_API int vofod_ball_pool(const void* in, void* out, int dtype, int op,
                              int nz, int ny, int nx, const int* taps,
                              int n_taps, int halo, int fill, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (op == 0) return launch<int8_t, 0>(in, out, nz, ny, nx, taps, n_taps, halo, fill, s);
    if (op == 1) return launch<int8_t, 1>(in, out, nz, ny, nx, taps, n_taps, halo, fill, s);
  } else if (dtype == 1) {
    if (op == 0) return launch<int32_t, 0>(in, out, nz, ny, nx, taps, n_taps, halo, fill, s);
    if (op == 1) return launch<int32_t, 1>(in, out, nz, ny, nx, taps, n_taps, halo, fill, s);
    if (op == 2) return launch<int32_t, 2>(in, out, nz, ny, nx, taps, n_taps, halo, fill, s);
  }
  return (int)cudaErrorInvalidValue;
}
