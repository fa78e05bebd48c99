// K2 — ball-adjacency propagation: Jacobi sweeps of masked min-label or
// max-reach ball pools, fused.
//
// Replaces the loop bodies of vofod_tpu/ops/components.py
// `label_components_seeded` (min-label sweep: key = occ ? min over the
// ball of key : SENTINEL), `propagate_reach` (bool growth: cur |= occ &
// ballmax(cur)) and `label_components` (the min-label sweep to the
// fixpoint or the cap), each of which XLA runs as K1's ~35 shifted passes
// plus a masked select and a full-grid compare-and-reduce for the change
// flag, inside a fori_loop or while_loop; and of their grid-sharded forms
// (vofod_tpu/parallel/gridops.py `label_seeded`, `label_components`: a
// halo exchange, one sweep and a psum'd or pmax'd flag a sweep).
//
// One kernel, `sweeps_kernel`, runs several sweeps in ONE persistent
// cooperative launch: as many blocks as the occupancy calculator lets stay
// resident (every SM, one or two blocks each), each looping over the 32 x
// 8 x 4 tiles of the grid, with a grid-wide barrier between sweeps.  Bound
// on the H100: a full sweep is memory-bound (the key grid and the mask read
// once, the keys written once: 0.0066 ms for the flagship grid), but the
// sweeps a call needs are data-dependent and most tiles settle within a few
// of them.  So the design removes what does not depend on the data:
//   * the launch per sweep (and its ~25 us floor past the fixpoint): one
//     launch per call, every block returning after the barrier of the first
//     sweep that leaves the next sweep nothing to compute;
//   * the tiles that cannot change: sweep i >= 1 recomputes a tile only if
//     a tile within the ball's reach (itself, +-ceil(halo / extent) tiles
//     per axis) changed in sweep i - 1.  Otherwise the tile's inputs are
//     those of sweep i - 1, so its output is output(i - 1) = output(i - 2),
//     which the destination buffer of the ping-pong already holds (sweep 1
//     writes the buffer that holds the initial grid, output(-1); sweep 0
//     computes every tile that holds an occupied voxel).  A changed tile
//     puts the tiles in its reach on the next sweep's work list, which
//     that sweep's blocks share evenly:
//     no block scans tiles that have nothing to do;
//   * the tiles and voxels off the mask: their value is the fill whatever
//     the ball holds, and both buffers start with it there, so a tile with
//     no occupied voxel (most of a sparse grid's) is never computed, and a
//     warp with none skips the tap loop.
// The same Jacobi arithmetic as one launch per sweep, so the grid, the
// per-sweep flags and the tiles computed per sweep are bit-equal to the
// plain model ops/components.sweeps_batch_plain.  The flagship step runs a
// fixed 8 sweeps and deliberately leaves very large components unconverged
// (components.py:120-134): an in-place update or several sweeps inside
// shared memory would change the labels, so the buffers still ping-pong.
// The barrier is a device counter (the cooperative launch guarantees that
// every block is resident) with the fences of cooperative groups' grid
// sync, so the ordinary loads after it see what every block wrote before.
//
// The dense paths run a whole `sweeps()` call in one launch.  The
// grid-sharded step runs k sweeps a launch on a shard's slab extended by
// H = k g rows of its neighbours' (g: at least the ball's z reach), so that
// one halo exchange serves k sweeps in place of one:
//   * after sweep j of a launch, the rows within j g of the extended slab's
//     ends are stale (each row needs rows g away that only a neighbour
//     held), while the interior [H, H + nzl) stays exact through sweep k.
//     Sweep j computes only the tiles that meet the rows [j g, rows - j g)
//     still exact after it (`grow` = g), and a change counts toward the work
//     lists only in those rows.  The stale rows are never read into an
//     exact row, and no count depends on them (they hold what the buffers
//     held before, which the plain model need not know);
//   * the per-sweep flags count changes in the interior rows only (the
//     dense sweep's flag); the host takes the k flags' max over the shards
//     in one collective;
//   * a launch given the previous launch's last global flag (`gate`, a
//     device int) does nothing when it is 0, a fixpoint: the host enqueues
//     the cap's launches with no sync;
//   * its blocks are the card's resident blocks divided by the shards that
//     share the card (`share`), so that every shard's cooperative launch
//     can be resident beside the others' on their own streams; each launch
//     has its own barrier counter, and each shard its scratch.
// k is the host's (parallel/gridops.py SWEEP_BATCH); a launch takes any
// number of sweeps.
//
// The ball is any K1 tap set: the static ball, or the traced shells of
// cfg.dynamic_radii (K14, ops/morphology.shell_taps).  Up to halo 7 and
// 2,112 taps the taps travel by value (the large tap struct and the
// shared-memory opt-in of common.cuh) and a tile's whole box sits in
// shared memory.  Past that (the wide form, vofod_propagate_sweeps_wide)
// neither fits: at halo 12 an int32 box takes 200,704 of the card's
// 232,448 bytes, at halo 16 the taps alone exceed the parameter limit.
// There the host (kernels.sweep_plan) cuts the taps into bands of at most
// BZ dz x BY dy values, and a tile's pool walks the bands: each stages the
// (TILE_Z + BZ - 1) x (TILE_Y + BY - 1) x (TILE_X + 2 halo) box its taps
// read and the band's offsets into it (from the plan in global memory),
// and every voxel folds the band's taps into its running min / max.  The
// work lists, barriers, flags and tile counts are the narrow form's, and
// min / max are exact in any order, so both forms give the same sweeps.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int32_t SENTINEL = 0x7fffffff;

// MODE 0: int32 labels, min-pool with fill SENTINEL, off-mask -> SENTINEL.
// MODE 1: uint8 reach mask, max-pool with fill 0, new = cur | (occ & pooled).
// One voxel of a sweep from the tile in shared memory (its box loaded
// around the tile's origin): `c` is the voxel's index in the tile, `at(t)`
// tap t's.  Returns the new value, `old` the voxel's own; an unoccupied
// voxel's does not depend on the pool, so it skips the taps.
template <typename T, int MODE, typename At>
__device__ __forceinline__ T sweep_voxel(const T* tile, int n_taps, At at, int c, bool o,
                                         T* old) {
  *old = tile[c];
  if (!o) return MODE == 0 ? (T)SENTINEL : (*old != 0 ? (T)1 : (T)0);
  T acc = tile[at(0)];
  for (int t = 1; t < n_taps; ++t) {
    const T v = tile[at(t)];
    if (MODE == 0)
      acc = v < acc ? v : acc;
    else
      acc = v > acc ? v : acc;
  }
  if (MODE == 0) return acc;  // the ball holds its centre: min(key, pool) == pool
  return (*old != 0 || acc != 0) ? (T)1 : (T)0;
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

// One launch's sweeps: sweeps i0 .. i0 + n - 1 of the caller's count.
struct Batch {
  int i0, n;
  int grow;        // rows the exact region loses at each end a sweep (0: all exact)
  int fz0, fz1;    // the rows whose changes set the flags
  const int* gate; // NULL, or a device flag: the launch does nothing when it is 0
};

// Sweeps 0 .. n - 1 of the launch from buf0 (its initial grid) and buf1,
// sweep s reading buf[s % 2] and writing buf[(s + 1) % 2]; both buffers
// hold the fill (SENTINEL, 0) at every voxel off the mask (the caller's
// contract, which every sweep keeps).  A tile holding no occupied voxel
// never changes and is never computed: first a warp a tile marks the
// tiles holding one (tile_occ) and lists those meeting sweep 0's exact
// rows.  Sweep s computes the tiles on its list: all those of sweep 0; for
// s >= 1, the occupied tiles within the ball's reach of a tile with a
// change in sweep s - 1's exact rows [s grow, nz - s grow) that meet sweep
// s's exact rows [(s + 1) grow, nz - (s + 1) grow) (listed once: a mark per
// tile holds the last sweep it was listed for), spread evenly over the
// blocks.  Per sweep i of the caller's count: changed[i] (1 iff a voxel of
// the rows [fz0, fz1) changed), tiles[i] (tiles computed: the length of its
// list); `barrier` this launch's counter, `mark` the tiles' marks, all
// zeroed before the caller's first launch.  lists: int32 [2][n_tiles], the
// work lists by sweep parity; tile_occ: int32 [n_tiles].  Sets of at most
// 256 taps run two blocks a multiprocessor (32 registers: the tile loads of
// one overlap the other's taps); larger sets one (their tap loop spills at
// 32).
// The wide form's taps: the host's band plan in global memory, int32
// [4 n_bands] (z0, y0, first, end: the band's dz from z0, dy from y0, and
// its taps' range) then each tap's offset into its band's box; bz, by the
// bands' extents, max_taps the most taps a band holds.
struct WideTaps {
  int halo, n_bands, bz, by, max_taps;
  const int* plan;
};

template <typename Taps>
constexpr int sweeps_blocks_per_sm() {
  return sizeof(Taps) <= sizeof(BallTaps) && !std::is_same<Taps, WideTaps>::value ? 2 : 1;
}

// The wide form's pool of one voxel: the running min / max over the bands
// of the tile (tx, ty, tz), `box` the band's staged box, `boff` its taps'
// offsets; every thread of the block takes part in the staging.  Returns
// the voxel's new value from `old` (its own) and `o` (occupied), as
// sweep_voxel.
template <typename T, int MODE>
__device__ __forceinline__ T sweep_voxel_wide(const T* src, T* box, int* boff,
                                              const WideTaps& w, int tx, int ty, int tz, int nz,
                                              int ny, int nx, T fill, bool in, bool o, T old) {
  const int h = w.halo, sx = TILE_X + 2 * h, sy = TILE_Y + w.by - 1, sz = TILE_Z + w.bz - 1;
  const int tid = threadIdx.x + TILE_X * (threadIdx.y + TILE_Y * threadIdx.z);
  constexpr int NT = TILE_X * TILE_Y * TILE_Z;
  const int base = (threadIdx.z * sy + threadIdx.y) * sx + threadIdx.x;
  T acc = fill;
  for (int b = 0; b < w.n_bands; ++b) {
    const int z0 = w.plan[4 * b], y0 = w.plan[4 * b + 1];
    const int t0 = w.plan[4 * b + 2], t1 = w.plan[4 * b + 3];
    const int gx0 = tx * TILE_X - h, gy0 = ty * TILE_Y + y0, gz0 = tz * TILE_Z + z0;
    __syncthreads();  // the last band's readers are done with the box
    for (int i = tid; i < sx * sy * sz; i += NT) {
      const int lx = i % sx, rest = i / sx, ly = rest % sy, lz = rest / sy;
      const int gx = gx0 + lx, gy = gy0 + ly, gz = gz0 + lz;
      T v = fill;
      if (gx >= 0 && gx < nx && gy >= 0 && gy < ny && gz >= 0 && gz < nz)
        v = src[((size_t)gz * ny + gy) * nx + gx];
      box[i] = v;
    }
    const int* offs = w.plan + 4 * w.n_bands;
    for (int t = t0 + tid; t < t1; t += NT) boff[t - t0] = offs[t];
    __syncthreads();
    if (in && o) {
      for (int t = 0; t < t1 - t0; ++t) {
        const T v = box[base + boff[t]];
        if (MODE == 0)
          acc = v < acc ? v : acc;
        else
          acc = v > acc ? v : acc;
      }
    }
  }
  if (!o) return MODE == 0 ? (T)SENTINEL : (old != 0 ? (T)1 : (T)0);
  if (MODE == 0) return acc;
  return (old != 0 || acc != 0) ? (T)1 : (T)0;
}

template <typename T, int MODE, typename Taps>
__global__ void __launch_bounds__(TILE_X* TILE_Y* TILE_Z, sweeps_blocks_per_sm<Taps>())
    sweeps_kernel(T* buf0, T* buf1, const uint8_t* __restrict__ occ, int nz, int ny, int nx,
                  Taps taps, Batch bt, int* changed, int* tiles, unsigned int* barrier,
                  int* mark, int* lists, int* tile_occ) {
  constexpr bool WIDE = std::is_same<Taps, WideTaps>::value;
  if (bt.gate != nullptr && *bt.gate == 0) return;  // past the fixpoint
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // what thread 0 read for the block past a barrier (1,024 threads of every
  // block reading one address would queue at L2): the next sweep's list
  // length; this block's list entries
  __shared__ int after, mine[BLOCK_TILES];
  const int h = taps.halo;
  T* tile = reinterpret_cast<T*>(smem_raw);
  // after the tile: each tap's offset into it (the host sizes the launch so)
  size_t tile_bytes;
  if constexpr (WIDE)
    tile_bytes = (size_t)(TILE_X + 2 * h) * (TILE_Y + taps.by - 1) * (TILE_Z + taps.bz - 1) *
                 sizeof(T);
  else
    tile_bytes = (size_t)(TILE_X + 2 * h) * (TILE_Y + 2 * h) * (TILE_Z + 2 * h) * sizeof(T);
  int* off = reinterpret_cast<int*>(smem_raw + ((tile_bytes + 15) & ~(size_t)15));
  const T fill = MODE == 0 ? (T)SENTINEL : (T)0;
  const int gx = (nx + TILE_X - 1) / TILE_X, gy = (ny + TILE_Y - 1) / TILE_Y,
            gz = (nz + TILE_Z - 1) / TILE_Z;
  const int plane_tiles = gx * gy, n_tiles = plane_tiles * gz;
  // the tiles a tile's ball reaches: +-ceil(h / extent) per axis
  const int rx = (h + TILE_X - 1) / TILE_X, ry = (h + TILE_Y - 1) / TILE_Y,
            rz = (h + TILE_Z - 1) / TILE_Z;
  const int wx = 2 * rx + 1, wy = 2 * ry + 1, n_near = wx * wy * (2 * rz + 1);
  const int tid = threadIdx.x + TILE_X * (threadIdx.y + TILE_Y * threadIdx.z);
  const bool lead = tid == 0;
  const int sx = TILE_X + 2 * h, sy = TILE_Y + 2 * h;
  const int centre = ((threadIdx.z + h) * sy + threadIdx.y + h) * sx + threadIdx.x + h;
  if constexpr (!WIDE) {
    for (int t = tid; t < taps.n; t += TILE_X * TILE_Y * TILE_Z)
      off[t] = (taps.dz[t] * sy + taps.dy[t]) * sx + taps.dx[t];
  }

  // the occupied tiles, a warp a tile (lane = x, the tile's 32 rows' bytes
  // loaded together), and sweep 0's list
  {
    constexpr int WARPS = TILE_X * TILE_Y * TILE_Z / 32;
    constexpr int ROWS = TILE_Y * TILE_Z;
    const int lane = tid & 31;
    for (int t = blockIdx.x * WARPS + (tid >> 5); t < n_tiles; t += gridDim.x * WARPS) {
      const int tx = t % gx, ty = (t / gx) % gy, tz = t / plane_tiles;
      const int x = tx * TILE_X + lane;
      int any = 0;
#pragma unroll 8
      for (int r = 0; r < ROWS; ++r) {
        const int y = ty * TILE_Y + r % TILE_Y, z = tz * TILE_Z + r / TILE_Y;
        if (x < nx && y < ny && z < nz) any |= occ[((size_t)z * ny + y) * nx + x];
      }
      const int held = __any_sync(0xffffffffu, any != 0);
      if (lane == 0) {
        tile_occ[t] = held;
        if (held && tz * TILE_Z < nz - bt.grow && tz * TILE_Z + TILE_Z > bt.grow)
          lists[atomicAdd(tiles + bt.i0, 1)] = t;
      }
    }
  }
  grid_barrier(barrier, 1, [&] { after = *reinterpret_cast<volatile int*>(tiles + bt.i0); });
  int n_todo = after;
  if (n_todo == 0) return;  // no occupied tile: nothing can change

  for (int s = 0; s < bt.n; ++s) {
    const int i = bt.i0 + s;
    const T* src = s & 1 ? buf1 : buf0;
    T* dst = s & 1 ? buf0 : buf1;
    const int* todo = lists + (size_t)(s & 1) * n_tiles;
    int* next = lists + (size_t)((s + 1) & 1) * n_tiles;
    const bool last = s + 1 == bt.n;
    // this sweep's exact rows, and the next one's
    const int lo = (s + 1) * bt.grow, hi = nz - lo;
    const int next_lo = lo + bt.grow, next_hi = hi - bt.grow;
    const int n_mine = blockIdx.x < n_todo ? (n_todo - blockIdx.x - 1) / gridDim.x + 1 : 0;
    int any = 0;
    for (int c = 0; c < n_mine; c += BLOCK_TILES) {
      const int n_c = n_mine - c < BLOCK_TILES ? n_mine - c : BLOCK_TILES;
      // (the last tile's barrier below ordered the reads of `mine`)
      if (tid < n_c) mine[tid] = todo[blockIdx.x + (c + tid) * gridDim.x];
      __syncthreads();
      for (int k = 0; k < n_c; ++k) {
        const int t = mine[k];
        const int tx = t % gx, ty = (t / gx) % gy, tz = t / plane_tiles;
        const int x = tx * TILE_X + threadIdx.x, y = ty * TILE_Y + threadIdx.y,
                  z = tz * TILE_Z + threadIdx.z;
        int diff = 0, inner = 0;
        if constexpr (WIDE) {
          const bool in = x < nx && y < ny && z < nz;
          const size_t v = in ? ((size_t)z * ny + y) * nx + x : 0;
          const bool o = in && occ[v] != 0;
          const T old = in ? src[v] : fill;
          const T nv = sweep_voxel_wide<T, MODE>(src, tile, off, taps, tx, ty, tz, nz, ny, nx,
                                                 fill, in, o, old);
          if (in) {
            dst[v] = nv;
            diff = nv != old && z >= lo && z < hi;
            inner = nv != old && z >= bt.fz0 && z < bt.fz1;
          }
        } else {
          load_tile_at<T>(src, tile, tx, ty, tz, nz, ny, nx, h, fill);
          __syncthreads();
          if (x < nx && y < ny && z < nz) {
            const size_t v = ((size_t)z * ny + y) * nx + x;
            T old;
            const T nv = sweep_voxel<T, MODE>(
                tile, taps.n, [&](int t) { return centre + off[t]; }, centre, occ[v] != 0, &old);
            dst[v] = nv;
            diff = nv != old && z >= lo && z < hi;
            inner = nv != old && z >= bt.fz0 && z < bt.fz1;
          }
        }
        // also the barrier before the next tile's load overwrites `tile`
        const int tile_changed = __syncthreads_or(diff);
        // the flag's rows lie inside the exact ones: a tile inside them
        // changed there iff it changed; one across their edge asks again
        const int z_lo = tz * TILE_Z, z_hi = z_lo + TILE_Z;
        if (z_lo >= bt.fz0 && z_hi <= bt.fz1)
          any |= tile_changed;
        else if (z_hi > bt.fz0 && z_lo < bt.fz1)
          any |= __syncthreads_or(inner);
        // (the wide form's reach can pass a thread a near tile)
        for (int q = tid; tile_changed && !last && q < n_near;
             q += WIDE ? TILE_X * TILE_Y * TILE_Z : n_near) {
          const int qx = tx + q % wx - rx, qy = ty + (q / wx) % wy - ry,
                    qz = tz + q / (wx * wy) - rz;
          if (qx >= 0 && qx < gx && qy >= 0 && qy < gy && qz >= 0 && qz < gz &&
              qz * TILE_Z < next_hi && qz * TILE_Z + TILE_Z > next_lo) {
            const int u = (qz * gy + qy) * gx + qx;
            if (tile_occ[u] && atomicExch(mark + u, i + 1) != i + 1)
              next[atomicAdd(tiles + i + 1, 1)] = u;
          }
        }
      }
    }
    if (lead && any) atomicOr(changed + i, 1);
    if (last) return;
    grid_barrier(barrier, s + 2, [&] { after = *reinterpret_cast<volatile int*>(tiles + i + 1); });
    // nothing on the next sweep's list: no later sweep can change a voxel
    // of the exact rows, so every block leaves here
    if (after == 0) return;
    n_todo = after;
  }
}

// The persistent launch: as many blocks as stay resident on every SM at
// this tile's shared memory (the occupancy calculator's count), divided by
// `share`, at most one per tile; cooperative so that the launch is refused
// rather than run with blocks that could never reach the barrier.
template <typename T, int MODE, typename Taps>
int launch_with(const Taps& t, size_t smem, void* b0, void* b1, const void* occ, int nz, int ny,
                int nx, const Batch& bt, int share, int* changed, int* tiles,
                unsigned int* barrier, int* mark, int* lists, int* tile_occ, int* blocks_out,
                cudaStream_t stream) {
  auto* kernel = sweeps_kernel<T, MODE, Taps>;
  if (const int err = allow_smem(kernel, smem)) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      TILE_X * TILE_Y * TILE_Z, smem);
  if (e != cudaSuccess) return (int)e;
  const int resident = per_sm * sms / share;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const dim3 g = tile_grid(nz, ny, nx);
  const int n_tiles = (int)(g.x * g.y * g.z);
  const int blocks = resident < n_tiles ? resident : n_tiles;
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
                         static_cast<const uint8_t*>(occ), nz, ny, nx, t, bt, changed, tiles,
                         barrier, mark, lists, tile_occ);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_sweeps(void* b0, void* b1, const void* occ, int nz, int ny, int nx, const int* taps,
                  int n_taps, int halo, const Batch& bt, int share, int* changed, int* tiles,
                  unsigned int* barrier, int* mark, int* lists, int* tile_occ, int* blocks_out,
                  cudaStream_t stream) {
  // the tile, then the taps' offsets into it
  const size_t smem = ((tile_elems(halo) * sizeof(T) + 15) & ~(size_t)15) + 4 * (size_t)n_taps;
  return with_taps(taps, n_taps, halo, [&](const auto& t) {
    return launch_with<T, MODE>(t, smem, b0, b1, occ, nz, ny, nx, bt, share, changed, tiles,
                                barrier, mark, lists, tile_occ, blocks_out, stream);
  });
}

// the wide form: a band's box, then its taps' offsets
template <typename T, int MODE>
int launch_sweeps_wide(void* b0, void* b1, const void* occ, int nz, int ny, int nx,
                       const WideTaps& w, const Batch& bt, int share, int* changed, int* tiles,
                       unsigned int* barrier, int* mark, int* lists, int* tile_occ,
                       int* blocks_out, cudaStream_t stream) {
  const size_t box = (size_t)(TILE_X + 2 * w.halo) * (TILE_Y + w.by - 1) * (TILE_Z + w.bz - 1);
  const size_t smem = ((box * sizeof(T) + 15) & ~(size_t)15) + 4 * (size_t)w.max_taps;
  return launch_with<T, MODE>(w, smem, b0, b1, occ, nz, ny, nx, bt, share, changed, tiles,
                              barrier, mark, lists, tile_occ, blocks_out, stream);
}

}  // namespace

// mode 0: int32 min-label sweeps; mode 1: uint8 reach sweeps.  taps: host
// int32 [n_taps, 3], 1 <= n_taps <= 2,112, every |offset| <= halo <= 7
// (past that: vofod_propagate_sweeps_wide).
// Runs sweeps i0 .. i0 + n_sweeps - 1 of the caller's count in one
// cooperative launch, stopping after the first sweep that leaves the next
// one nothing to compute: buf0 holds the launch's initial grid, buf1 the
// fill or earlier sweeps' values, both the fill (SENTINEL, 0) at every
// voxel off the mask; the exact rows' result is in buf[n_sweeps % 2] (both
// buffers hold it after an early stop).  grow: the rows the exact region
// loses at each end a sweep (0 on a whole grid; on a halo-extended slab its
// halo over n_sweeps, the ball's z reach at least); [flag_z0, flag_z1): the
// rows whose changes set the flags, inside the last sweep's exact rows.
// gate: NULL or a device int32 (the launch does nothing when it is 0).
// share: the launches that may run on the card at once (its resident
// blocks are split between them).  changed, tiles: device int32 [i0 +
// n_sweeps] (per-sweep flags, tiles computed); barrier: a device uint32 of
// this launch; marks: device int32 [n_tiles of 32 x 8 x 4]; all zeroed
// before the caller's first launch.  lists: device int32 [2 n_tiles];
// tile_occ: device int32 [n_tiles].  *blocks: the blocks launched.
// Returns cudaGetLastError(), or the launch's refusal (never run in parts).
VOFOD_API int vofod_propagate_sweeps(void* buf0, void* buf1, const void* occ, int mode, int nz,
                                     int ny, int nx, const int* taps, int n_taps, int halo,
                                     int i0, int n_sweeps, int grow, int flag_z0, int flag_z1,
                                     const void* gate, int share, void* changed, void* tiles,
                                     void* barrier, void* marks, void* lists, void* tile_occ,
                                     int* blocks, void* stream) {
  if (n_sweeps < 1 || i0 < 0 || share < 1 || grow < 0 || blocks == nullptr ||
      flag_z0 < n_sweeps * grow || flag_z1 > nz - n_sweeps * grow || flag_z0 >= flag_z1)
    return (int)cudaErrorInvalidValue;
  const Batch bt = {i0, n_sweeps, grow, flag_z0, flag_z1, static_cast<const int*>(gate)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ch = static_cast<int*>(changed);
  int* ti = static_cast<int*>(tiles);
  unsigned int* ba = static_cast<unsigned int*>(barrier);
  int* mk = static_cast<int*>(marks);
  int* ls = static_cast<int*>(lists);
  int* to = static_cast<int*>(tile_occ);
  if (mode == 0)
    return launch_sweeps<int32_t, 0>(buf0, buf1, occ, nz, ny, nx, taps, n_taps, halo, bt, share,
                                     ch, ti, ba, mk, ls, to, blocks, s);
  if (mode == 1)
    return launch_sweeps<uint8_t, 1>(buf0, buf1, occ, nz, ny, nx, taps, n_taps, halo, bt, share,
                                     ch, ti, ba, mk, ls, to, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// The wide form (a tap set past halo 7 or 2,112 taps): plan, the device
// int32 band plan of kernels.sweep_plan ([4 n_bands] bands, then each
// tap's offset into its band's box), its n_bands, the bands' extents bz x
// by and the most taps a band holds; halo: the set's.  Every other argument
// as vofod_propagate_sweeps'.
VOFOD_API int vofod_propagate_sweeps_wide(void* buf0, void* buf1, const void* occ, int mode,
                                          int nz, int ny, int nx, const void* plan, int n_bands,
                                          int bz, int by, int max_taps, int halo, int i0,
                                          int n_sweeps, int grow, int flag_z0, int flag_z1,
                                          const void* gate, int share, void* changed,
                                          void* tiles, void* barrier, void* marks, void* lists,
                                          void* tile_occ, int* blocks, void* stream) {
  if (n_sweeps < 1 || i0 < 0 || share < 1 || grow < 0 || blocks == nullptr ||
      flag_z0 < n_sweeps * grow || flag_z1 > nz - n_sweeps * grow || flag_z0 >= flag_z1 ||
      plan == nullptr || n_bands < 1 || bz < 1 || by < 1 || bz > 2 * halo + 1 ||
      by > 2 * halo + 1 || max_taps < 1 || halo < 0)
    return (int)cudaErrorInvalidValue;
  const Batch bt = {i0, n_sweeps, grow, flag_z0, flag_z1, static_cast<const int*>(gate)};
  const WideTaps w = {halo, n_bands, bz, by, max_taps, static_cast<const int*>(plan)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ch = static_cast<int*>(changed);
  int* ti = static_cast<int*>(tiles);
  unsigned int* ba = static_cast<unsigned int*>(barrier);
  int* mk = static_cast<int*>(marks);
  int* ls = static_cast<int*>(lists);
  int* to = static_cast<int*>(tile_occ);
  if (mode == 0)
    return launch_sweeps_wide<int32_t, 0>(buf0, buf1, occ, nz, ny, nx, w, bt, share, ch, ti, ba,
                                          mk, ls, to, blocks, s);
  if (mode == 1)
    return launch_sweeps_wide<uint8_t, 1>(buf0, buf1, occ, nz, ny, nx, w, bt, share, ch, ti, ba,
                                          mk, ls, to, blocks, s);
  return (int)cudaErrorInvalidValue;
}
