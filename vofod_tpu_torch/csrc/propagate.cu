// K2 — one Jacobi sweep of ball-adjacency propagation, fused.
//
// Replaces the loop bodies of vofod_tpu/ops/components.py
// `label_components_seeded` (min-label sweep: key = occ ? min over the
// ball of key : SENTINEL) and `propagate_reach` (bool growth: cur |= occ &
// ballmax(cur)), each of which XLA runs as K1's ~35 shifted passes plus a
// masked select and a full-grid compare-and-reduce for the change flag.
//
// Bound on the H100: memory, as for K1 — per sweep the fused kernel reads
// the key grid once (plus halo re-reads from L2) and the occupancy mask
// once, and writes the new keys once.  The pool, the mask, the SENTINEL
// write and the change detection share that one pass; the change flag is a
// block-wide __syncthreads_or followed by one atomicOr per block.
//
// Each launch is exactly ONE sweep from buffer A into buffer B.  The
// flagship step runs a fixed 8 sweeps and deliberately leaves very large
// components unconverged (components.py:120-134), so an in-place update or
// several sweeps inside shared memory would change the labels and break
// parity with the JAX step; the wrapper ping-pongs two buffers instead.
//
// Run to a fixpoint (vofod_tpu/ops/components.py `label_components`, a
// while_loop that stops at the first sweep that changed nothing), each
// launch is also given the previous sweep's device flag: when it is 0 every
// block exits at once, so the host enqueues the cap's worth of sweeps with
// no sync.  The sweep that changed nothing wrote B equal to A, so both
// ping-pong buffers hold the fixpoint and the skipped launches lose nothing;
// when that is sweep 0, only the first buffer was written, so the wrapper
// starts the second as a copy of the initial labels.
//
// The ball is any K1 tap set: the static ball, or the traced shells of
// cfg.dynamic_radii (K14, ops/morphology.shell_taps), up to halo 7 (the
// large tap struct and the shared-memory opt-in of common.cuh).
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int32_t SENTINEL = 0x7fffffff;

// MODE 0: int32 labels, min-pool with fill SENTINEL, off-mask -> SENTINEL.
// MODE 1: uint8 reach mask, max-pool with fill 0, new = cur | (occ & pooled).
template <typename T, int MODE, typename Taps>
__global__ void __launch_bounds__(TILE_X* TILE_Y* TILE_Z)
    sweep_kernel(const T* __restrict__ a, T* __restrict__ b,
                 const uint8_t* __restrict__ occ, int nz, int ny, int nx,
                 Taps taps, int* __restrict__ changed,
                 const int* __restrict__ prev_changed) {
  if (prev_changed != nullptr && *prev_changed == 0) return;  // past the fixpoint
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int h = taps.halo;
  const T fill = MODE == 0 ? (T)SENTINEL : (T)0;
  load_tile<T>(a, tile, nz, ny, nx, h, fill);
  __syncthreads();

  const int x = blockIdx.x * TILE_X + threadIdx.x;
  const int y = blockIdx.y * TILE_Y + threadIdx.y;
  const int z = blockIdx.z * TILE_Z + threadIdx.z;
  int diff = 0;
  if (x < nx && y < ny && z < nz) {
    const int sx = TILE_X + 2 * h, sy = TILE_Y + 2 * h;
    const int cx = threadIdx.x + h, cy = threadIdx.y + h,
              cz = threadIdx.z + h;
    const T old = tile[(cz * sy + cy) * sx + cx];
    T acc = tile[((cz + taps.dz[0]) * sy + cy + taps.dy[0]) * sx + cx +
                 taps.dx[0]];
    for (int t = 1; t < taps.n; ++t) {
      const T v = tile[((cz + taps.dz[t]) * sy + cy + taps.dy[t]) * sx + cx +
                       taps.dx[t]];
      if (MODE == 0)
        acc = v < acc ? v : acc;
      else
        acc = v > acc ? v : acc;
    }
    const size_t i = ((size_t)z * ny + y) * nx + x;
    const bool o = occ[i] != 0;
    T nv;
    if (MODE == 0)
      nv = o ? acc : (T)SENTINEL;  // the ball holds its centre: min(key, pool) == pool
    else
      nv = (old != 0 || (o && acc != 0)) ? (T)1 : (T)0;
    b[i] = nv;
    diff = nv != old;
  }
  if (__syncthreads_or(diff) &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    atomicOr(changed, 1);
}

template <typename T, int MODE>
int launch(const void* a, void* b, const void* occ, int nz, int ny, int nx, const int* taps,
           int n_taps, int halo, int* changed, const int* prev, cudaStream_t stream) {
  const size_t smem = tile_elems(halo) * sizeof(T);
  return with_taps(taps, n_taps, halo, [&](const auto& t) {
    auto* kernel = sweep_kernel<T, MODE, std::decay_t<decltype(t)>>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<tile_grid(nz, ny, nx), dim3(TILE_X, TILE_Y, TILE_Z), smem, stream>>>(
        static_cast<const T*>(a), static_cast<T*>(b), static_cast<const uint8_t*>(occ), nz,
        ny, nx, t, changed, prev);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// mode 0: int32 min-label sweep; mode 1: uint8 reach sweep.  taps: host
// int32 [n_taps, 3], 1 <= n_taps <= 2,112, every |offset| <= halo <= 7.
// `changed` is a device int32 the kernel ORs 1 into when any voxel changed
// (the caller zeroes it); `prev_changed` is NULL or the previous sweep's
// flag, and the launch does nothing when it is 0.  Returns
// cudaGetLastError().
VOFOD_API int vofod_propagate_sweep(const void* a, void* b, const void* occ,
                                    int mode, int nz, int ny, int nx,
                                    const int* taps, int n_taps, int halo,
                                    void* changed, const void* prev_changed,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ch = static_cast<int*>(changed);
  const int* pv = static_cast<const int*>(prev_changed);
  if (mode == 0)
    return launch<int32_t, 0>(a, b, occ, nz, ny, nx, taps, n_taps, halo, ch, pv, s);
  if (mode == 1)
    return launch<uint8_t, 1>(a, b, occ, nz, ny, nx, taps, n_taps, halo, ch, pv, s);
  return (int)cudaErrorInvalidValue;
}
