// K2 — ball-adjacency propagation: Jacobi sweeps of masked min-label or
// max-reach ball pools, fused.
//
// Replaces the loop bodies of vofod_tpu/ops/components.py
// `label_components_seeded` (min-label sweep: key = occ ? min over the
// ball of key : SENTINEL), `propagate_reach` (bool growth: cur |= occ &
// ballmax(cur)) and `label_components` (the min-label sweep to the
// fixpoint or the cap), each of which XLA runs as K1's ~35 shifted passes
// plus a masked select and a full-grid compare-and-reduce for the change
// flag, inside a fori_loop or while_loop.
//
// Two entry points share the sweep arithmetic (`sweep_voxel`; the
// persistent one reads the taps' offsets into the tile from shared memory,
// the one-sweep one forms each tap's index from the tap struct):
//
// `vofod_propagate_sweeps` (the dense paths) runs every sweep of one call
// in ONE persistent cooperative launch: as many blocks as the occupancy
// calculator lets stay resident (every SM, one or two blocks each), each
// looping over the 32 x 8 x 4 tiles of the grid, with a grid-wide barrier
// between sweeps.  Bound on the H100: a full sweep is memory-bound (the key
// grid and the mask read once, the keys written once: 0.0066 ms for the
// flagship grid), but the sweeps a call needs are data-dependent and most
// tiles settle within a few of them.  So the design removes what does not
// depend on the data:
//   * the launch per sweep (and its ~25 us floor past the fixpoint): one
//     launch per call, every block returning after the barrier of the first
//     sweep that changed nothing (a fixpoint: every later sweep would
//     change nothing, so their flags stay 0, as the gated launches gave);
//   * the tiles that cannot change: sweep i >= 1 recomputes a tile only if
//     a tile within the ball's reach (itself, +-ceil(halo / extent) tiles
//     per axis) changed in sweep i - 1.  Otherwise the tile's inputs are
//     those of sweep i - 1, so its output is output(i - 1) = output(i - 2),
//     which the destination buffer of the ping-pong already holds (sweep 1
//     writes the buffer that holds the initial grid, output(-1); sweep 0
//     computes every tile).  A changed tile puts the tiles in its reach on
//     the next sweep's work list, which that sweep's blocks share evenly:
//     no block scans tiles that have nothing to do.
// The same Jacobi arithmetic as one launch per sweep, so the grid, the
// per-sweep flags and the tiles computed per sweep are bit-equal to the
// plain model ops/components.sweeps_tiled_plain.  The flagship step runs a
// fixed 8 sweeps and deliberately leaves very large components unconverged
// (components.py:120-134): an in-place update or several sweeps inside
// shared memory would change the labels, so the buffers still ping-pong.
// The barrier is a device counter (the cooperative launch guarantees that
// every block is resident) with the fences of cooperative groups' grid
// sync, so the ordinary loads after it see what every block wrote before.
//
// `vofod_propagate_sweep` (the grid-sharded step) is ONE sweep from buffer
// A into buffer B: the sharded sweep exchanges a halo between sweeps, and
// counts changes in the slab's interior rows only.  Given the previous
// sweep's device flag, a launch does nothing when it is 0, so the host
// enqueues the cap's worth of sweeps with no sync.
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
// One voxel of a sweep from the tile in shared memory (its box loaded
// around the tile's origin): `c` is the voxel's index in the tile, `at(t)`
// tap t's.  Returns the new value, `old` the voxel's own.
template <typename T, int MODE, typename At>
__device__ __forceinline__ T sweep_voxel(const T* tile, int n_taps, At at, int c, bool o,
                                         T* old) {
  *old = tile[c];
  T acc = tile[at(0)];
  for (int t = 1; t < n_taps; ++t) {
    const T v = tile[at(t)];
    if (MODE == 0)
      acc = v < acc ? v : acc;
    else
      acc = v > acc ? v : acc;
  }
  if (MODE == 0) return o ? acc : (T)SENTINEL;  // the ball holds its centre: min(key, pool) == pool
  return (*old != 0 || (o && acc != 0)) ? (T)1 : (T)0;
}

template <typename T, int MODE, typename Taps>
__global__ void __launch_bounds__(TILE_X* TILE_Y* TILE_Z)
    sweep_kernel(const T* __restrict__ a, T* __restrict__ b,
                 const uint8_t* __restrict__ occ, int nz, int ny, int nx,
                 Taps taps, int* __restrict__ changed,
                 const int* __restrict__ prev_changed, int flag_z0, int flag_z1) {
  if (prev_changed != nullptr && *prev_changed == 0) return;  // past the fixpoint
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  load_tile<T>(a, tile, nz, ny, nx, taps.halo, MODE == 0 ? (T)SENTINEL : (T)0);
  __syncthreads();

  const int x = blockIdx.x * TILE_X + threadIdx.x;
  const int y = blockIdx.y * TILE_Y + threadIdx.y;
  const int z = blockIdx.z * TILE_Z + threadIdx.z;
  int diff = 0;
  if (x < nx && y < ny && z < nz) {
    const size_t i = ((size_t)z * ny + y) * nx + x;
    const int h = taps.halo, sx = TILE_X + 2 * h, sy = TILE_Y + 2 * h;
    const int cx = threadIdx.x + h, cy = threadIdx.y + h, cz = threadIdx.z + h;
    T old;
    const T nv = sweep_voxel<T, MODE>(
        tile, taps.n,
        [&](int t) { return ((cz + taps.dz[t]) * sy + cy + taps.dy[t]) * sx + cx + taps.dx[t]; },
        (cz * sy + cy) * sx + cx, occ[i] != 0, &old);
    b[i] = nv;
    diff = nv != old && z >= flag_z0 && z < flag_z1;
  }
  if (__syncthreads_or(diff) &&
      threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    atomicOr(changed, 1);
}

// Grid-wide barrier number k (1, 2, ...) of a cooperative launch: every
// block adds one to the counter (zeroed before the launch) and waits until
// all gridDim.x blocks of this barrier have (the fences of cooperative
// groups' grid sync: each block's writes are ordered before its arrival,
// the other blocks' writes before its later loads).  `then` runs on thread
// 0 past the barrier, before the block's threads go on.
template <typename F>
__device__ __forceinline__ void grid_barrier(unsigned int* count, unsigned int k, F&& then) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const unsigned int target = k * gridDim.x;
    while (*reinterpret_cast<volatile unsigned int*>(count) < target) __nanosleep(64);
    __threadfence();
    then();
  }
  __syncthreads();
}

// Tiles of a sweep's work list a block reads at once.
constexpr int BLOCK_TILES = 8;

// The persistent form: sweeps 0 .. n - 1 from buf0 (the initial grid) and
// buf1 (any contents), sweep i reading buf[i % 2] and writing buf[(i + 1)
// % 2].  Sweep 0 computes every tile; a tile that changes in sweep i puts
// every tile within the ball's reach on sweep i + 1's work list (once: a
// mark per tile holds the last sweep it was listed for), so sweep i + 1
// computes exactly the tiles next to a change, spread evenly over the
// blocks.  scratch: int32 [2n + 1 + n_tiles] zeroed: changed[n] (1 iff a
// voxel changed in sweep i), tiles[n] (tiles computed in sweep i: the
// length of its list), the barrier counter, the marks.  lists: int32
// [2][n_tiles], the work lists by sweep parity.  Sets of at most 256 taps
// run two blocks a multiprocessor (32 registers: the tile loads of one
// overlap the other's taps); larger sets one (their tap loop spills at 32).
template <typename Taps>
constexpr int sweeps_blocks_per_sm() {
  return sizeof(Taps) <= sizeof(BallTaps) ? 2 : 1;
}

template <typename T, int MODE, typename Taps>
__global__ void __launch_bounds__(TILE_X* TILE_Y* TILE_Z, sweeps_blocks_per_sm<Taps>())
    sweeps_kernel(T* buf0, T* buf1, const uint8_t* __restrict__ occ, int nz, int ny, int nx,
                  Taps taps, int n_sweeps, int* scratch, int* lists) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // what thread 0 read for the block past a barrier (1,024 threads of every
  // block reading one address would queue at L2): the flag of the sweep
  // just done and the next sweep's list length; this block's list entries
  __shared__ int after[2], mine[BLOCK_TILES];
  const int h = taps.halo;
  T* tile = reinterpret_cast<T*>(smem_raw);
  // after the tile: each tap's offset into it (the host sizes the launch so)
  const size_t tile_bytes =
      (size_t)(TILE_X + 2 * h) * (TILE_Y + 2 * h) * (TILE_Z + 2 * h) * sizeof(T);
  int* off = reinterpret_cast<int*>(smem_raw + ((tile_bytes + 15) & ~(size_t)15));
  int* changed = scratch;
  int* tiles = scratch + n_sweeps;
  unsigned int* barrier = reinterpret_cast<unsigned int*>(scratch + 2 * n_sweeps);
  int* mark = scratch + 2 * n_sweeps + 1;
  const T fill = MODE == 0 ? (T)SENTINEL : (T)0;
  const int gx = (nx + TILE_X - 1) / TILE_X, gy = (ny + TILE_Y - 1) / TILE_Y,
            gz = (nz + TILE_Z - 1) / TILE_Z;
  const int n_tiles = gx * gy * gz;
  // the tiles a tile's ball reaches: +-ceil(h / extent) per axis
  const int rx = (h + TILE_X - 1) / TILE_X, ry = (h + TILE_Y - 1) / TILE_Y,
            rz = (h + TILE_Z - 1) / TILE_Z;
  const int wx = 2 * rx + 1, wy = 2 * ry + 1, n_near = wx * wy * (2 * rz + 1);
  const int tid = threadIdx.x + TILE_X * (threadIdx.y + TILE_Y * threadIdx.z);
  const bool lead = tid == 0;
  if (blockIdx.x == 0 && lead) tiles[0] = n_tiles;
  const int sx = TILE_X + 2 * h, sy = TILE_Y + 2 * h;
  const int centre = ((threadIdx.z + h) * sy + threadIdx.y + h) * sx + threadIdx.x + h;
  for (int t = tid; t < taps.n; t += TILE_X * TILE_Y * TILE_Z)
    off[t] = (taps.dz[t] * sy + taps.dy[t]) * sx + taps.dx[t];
  __syncthreads();

  int n_todo = n_tiles;
  for (int i = 0; i < n_sweeps; ++i) {
    const T* src = i & 1 ? buf1 : buf0;
    T* dst = i & 1 ? buf0 : buf1;
    const int* todo = lists + (size_t)(i & 1) * n_tiles;
    int* next = lists + (size_t)((i + 1) & 1) * n_tiles;
    const int n_mine = blockIdx.x < n_todo ? (n_todo - blockIdx.x - 1) / gridDim.x + 1 : 0;
    int any = 0;
    for (int c = 0; c < n_mine; c += BLOCK_TILES) {
      const int n_c = n_mine - c < BLOCK_TILES ? n_mine - c : BLOCK_TILES;
      if (i > 0) {  // (the last tile's barrier below ordered the reads of `mine`)
        if (tid < n_c) mine[tid] = todo[blockIdx.x + (c + tid) * gridDim.x];
        __syncthreads();
      }
      for (int k = 0; k < n_c; ++k) {
        const int t = i == 0 ? blockIdx.x + (c + k) * gridDim.x : mine[k];
        const int tx = t % gx, ty = (t / gx) % gy, tz = t / (gx * gy);
        load_tile_at<T>(src, tile, tx, ty, tz, nz, ny, nx, h, fill);
        __syncthreads();
        const int x = tx * TILE_X + threadIdx.x, y = ty * TILE_Y + threadIdx.y,
                  z = tz * TILE_Z + threadIdx.z;
        int diff = 0;
        if (x < nx && y < ny && z < nz) {
          const size_t v = ((size_t)z * ny + y) * nx + x;
          T old;
          const T nv = sweep_voxel<T, MODE>(
              tile, taps.n, [&](int t) { return centre + off[t]; }, centre, occ[v] != 0, &old);
          dst[v] = nv;
          diff = nv != old;
        }
        // also the barrier before the next tile's load overwrites `tile`
        const int tile_changed = __syncthreads_or(diff);
        any |= tile_changed;
        if (tile_changed && i + 1 < n_sweeps && tid < n_near) {
          const int qx = tx + tid % wx - rx, qy = ty + (tid / wx) % wy - ry,
                    qz = tz + tid / (wx * wy) - rz;
          if (qx >= 0 && qx < gx && qy >= 0 && qy < gy && qz >= 0 && qz < gz) {
            const int u = (qz * gy + qy) * gx + qx;
            if (atomicExch(mark + u, i + 1) != i + 1) next[atomicAdd(tiles + i + 1, 1)] = u;
          }
        }
      }
    }
    if (lead && any) atomicOr(changed + i, 1);
    grid_barrier(barrier, i + 1, [&] {
      after[0] = *reinterpret_cast<volatile int*>(changed + i);
      after[1] = i + 1 < n_sweeps ? *reinterpret_cast<volatile int*>(tiles + i + 1) : 0;
    });
    // a sweep that changed nothing is a fixpoint: every block leaves here
    if (after[0] == 0) return;
    n_todo = after[1];
  }
}

template <typename T, int MODE>
int launch(const void* a, void* b, const void* occ, int nz, int ny, int nx, const int* taps,
           int n_taps, int halo, int* changed, const int* prev, int fz0, int fz1,
           cudaStream_t stream) {
  const size_t smem = tile_elems(halo) * sizeof(T);
  return with_taps(taps, n_taps, halo, [&](const auto& t) {
    auto* kernel = sweep_kernel<T, MODE, std::decay_t<decltype(t)>>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<tile_grid(nz, ny, nx), dim3(TILE_X, TILE_Y, TILE_Z), smem, stream>>>(
        static_cast<const T*>(a), static_cast<T*>(b), static_cast<const uint8_t*>(occ), nz,
        ny, nx, t, changed, prev, fz0, fz1);
    return (int)cudaGetLastError();
  });
}

// The persistent launch: as many blocks as stay resident on every SM at
// this tile's shared memory (the occupancy calculator's count, at most one
// per tile), cooperative so that the launch is refused rather than run
// with blocks that could never reach the barrier.
template <typename T, int MODE>
int launch_sweeps(void* b0, void* b1, const void* occ, int nz, int ny, int nx, const int* taps,
                  int n_taps, int halo, int n_sweeps, int* scratch, int* lists,
                  int* blocks_out, cudaStream_t stream) {
  // the tile, then the taps' offsets into it
  const size_t smem = ((tile_elems(halo) * sizeof(T) + 15) & ~(size_t)15) + 4 * (size_t)n_taps;
  return with_taps(taps, n_taps, halo, [&](const auto& t) {
    auto* kernel = sweeps_kernel<T, MODE, std::decay_t<decltype(t)>>;
    if (const int err = allow_smem(kernel, smem)) return err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        TILE_X * TILE_Y * TILE_Z, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const dim3 g = tile_grid(nz, ny, nx);
    const int n_tiles = (int)(g.x * g.y * g.z);
    const int blocks = per_sm * sms < n_tiles ? per_sm * sms : n_tiles;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(TILE_X, TILE_Y, TILE_Z);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    *blocks_out = blocks;
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<T*>(b0), static_cast<T*>(b1),
                           static_cast<const uint8_t*>(occ), nz, ny, nx, t, n_sweeps, scratch,
                           lists);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  });
}

}  // namespace

// mode 0: int32 min-label sweep; mode 1: uint8 reach sweep.  taps: host
// int32 [n_taps, 3], 1 <= n_taps <= 2,112, every |offset| <= halo <= 7.
// `changed` is a device int32 the kernel ORs 1 into when any voxel changed
// (the caller zeroes it); `prev_changed` is NULL or the previous sweep's
// flag, and the launch does nothing when it is 0.  Only changes in the z
// rows [flag_z0, flag_z1) set the flag: the whole grid, or on the
// grid-sharded step the interior of a halo-extended slab, whose halo rows
// are the neighbours' and may change where the dense sweep sees no change.
// Returns cudaGetLastError().
VOFOD_API int vofod_propagate_sweep(const void* a, void* b, const void* occ,
                                    int mode, int nz, int ny, int nx,
                                    const int* taps, int n_taps, int halo,
                                    void* changed, const void* prev_changed,
                                    int flag_z0, int flag_z1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ch = static_cast<int*>(changed);
  const int* pv = static_cast<const int*>(prev_changed);
  if (mode == 0)
    return launch<int32_t, 0>(a, b, occ, nz, ny, nx, taps, n_taps, halo, ch, pv, flag_z0,
                              flag_z1, s);
  if (mode == 1)
    return launch<uint8_t, 1>(a, b, occ, nz, ny, nx, taps, n_taps, halo, ch, pv, flag_z0,
                              flag_z1, s);
  return (int)cudaErrorInvalidValue;
}

// mode 0: int32 min-label sweeps; mode 1: uint8 reach sweeps; taps as
// vofod_propagate_sweep.  Runs sweeps 0 .. n_sweeps - 1 in one cooperative
// launch, stopping after the first sweep that changed nothing: buf0 holds
// the initial grid (sweep 1 writes it), buf1 anything (sweep 0 writes all
// of it), and the result is in buf[n_sweeps % 2] (both buffers hold it
// after an early stop).  scratch: device int32 [2 n_sweeps + 1 + n_tiles],
// zeroed by the caller: per-sweep changed flags, per-sweep tiles computed,
// the barrier counter, the tiles' marks (n_tiles of 32 x 8 x 4).  lists:
// device int32 [2 n_tiles].  *blocks: the blocks launched.  Returns
// cudaGetLastError(), or the launch's refusal (never run in parts).
VOFOD_API int vofod_propagate_sweeps(void* buf0, void* buf1, const void* occ, int mode, int nz,
                                     int ny, int nx, const int* taps, int n_taps, int halo,
                                     int n_sweeps, void* scratch, void* lists, int* blocks,
                                     void* stream) {
  if (n_sweeps < 1 || blocks == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* sc = static_cast<int*>(scratch);
  int* ls = static_cast<int*>(lists);
  if (mode == 0)
    return launch_sweeps<int32_t, 0>(buf0, buf1, occ, nz, ny, nx, taps, n_taps, halo, n_sweeps,
                                     sc, ls, blocks, s);
  if (mode == 1)
    return launch_sweeps<uint8_t, 1>(buf0, buf1, occ, nz, ny, nx, taps, n_taps, halo, n_sweeps,
                                     sc, ls, blocks, s);
  return (int)cudaErrorInvalidValue;
}
