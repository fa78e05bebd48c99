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
// shared memory, every voxel walking every tap.  Past that (the wide form,
// vofod_propagate_sweeps_wide) a tile's pool takes K1's run decomposition
// (ops/morphology.WideRunTable, the host's kernels.sweep_plan, in global
// memory and copied into shared memory once a block): the tile's 4 + 2 h
// input planes are staged one at a time through a double buffer (each
// (8 + 2 h) x (32 + 2 h) cells, loaded into registers a plane ahead); per
// plane and group of (lo, hi) pairs, every staged row's x pools over the
// tile's 32 columns (the symmetric pairs one chain to the halo, carried
// from group to group, any other pair element by element); then each
// voxel combines the rows of its dz's slice (dz = plane - its own z) from
// those pools into its running min / max: ~Σ|rows| a voxel in place of one
// load a tap (r 12: 7,153 taps).  The work lists, barriers, flags and
// tile counts are the narrow form's, and min / max are exact in any
// order, so both forms give the same sweeps.
#include "ball_pool.cuh"

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
// 32).  The wide form runs one, its pools of a ball in one group
// (kernels.K2_WIDE_SMEM): at two blocks an SM its 32 registers spilled and
// its groups split, and fine-0125's label call took 1.45 device ms
// against 1.11 (the batched launches 7.95 against 8.05).
// The wide form's taps: the packed wide run table (ball_pool.cuh WideTab)
// in global memory, `len` ints, the set's halo (its z reach too).
struct WideTaps {
  int halo;
  const int* tab;
  int len;
};

template <typename Taps>
constexpr int sweeps_blocks_per_sm() {
  return sizeof(Taps) <= sizeof(BallTaps) && !std::is_same<Taps, WideTaps>::value ? 2 : 1;
}

// The wide form's shared memory: two pool buffers of a group's pairs over
// the tile's staged rows and columns, the chain's carry, two staged
// planes, each 16-byte aligned, then the table
template <typename T>
struct SweepWideShape {
  int sy, sx;
  size_t pools, carry, stage, smem;
  __host__ __device__ SweepWideShape(const WideTab& t) {
    sy = TILE_Y + 2 * t.h, sx = TILE_X + 2 * t.h;
    pools = ((size_t)2 * t.group * sy * TILE_X * sizeof(T) + 15) & ~(size_t)15;
    carry = ((size_t)sy * TILE_X * sizeof(T) + 15) & ~(size_t)15;
    stage = ((size_t)2 * sy * sx * sizeof(T) + 15) & ~(size_t)15;
    smem = pools + carry + stage + (size_t)t.len * 4;
  }
};

// cells of a staged plane a thread holds in registers (the rest, past
// halo 22, staged directly)
constexpr int SWEEP_WIDE_PF = 4;

// The wide form's pool of the tile (tx, ty, tz): the running min / max of
// this thread's voxel (fill where `pool` is false), every thread of the
// block taking part.  tb: the table in shared memory, its rows as offsets
// into a pool buffer from the voxel's row and column.
template <typename T, int MODE>
__device__ __forceinline__ T sweep_tile_wide(const T* src, unsigned char* smem, const int* tb,
                                             const WideTab& hd, int tx, int ty, int tz, int nz,
                                             int ny, int nx, T fill, bool pool) {
  constexpr int NT = TILE_X * TILE_Y * TILE_Z, OP = MODE == 0 ? 0 : 1;
  const SweepWideShape<T> sh(hd);
  const int h = hd.h, G = hd.group, SY = sh.sy, SX = sh.sx;
  T* pools = reinterpret_cast<T*>(smem);                              // [2][G][SY][TILE_X]
  T* carry = reinterpret_cast<T*>(smem + sh.pools);                   // [SY][TILE_X]
  T* stage = reinterpret_cast<T*>(smem + sh.pools + sh.carry);        // [2][SY][SX]
  const int pool_cells = G * SY * TILE_X, plane = SY * SX;
  const int n_planes = TILE_Z + 2 * h, n_steps = n_planes * hd.n_groups;
  const int tid = threadIdx.x + TILE_X * (threadIdx.y + TILE_Y * threadIdx.z);
  const int z0 = tz * TILE_Z - h, y0 = ty * TILE_Y - h, x0 = tx * TILE_X - h;
  auto op = [](T a, T b) { return OP == 0 ? (a < b ? a : b) : (a > b ? a : b); };
  int n_sym = 0;
  for (int w = 0; w <= h; ++w) n_sym += tb[hd.sym + w] >= 0;

  // this thread's staged cells tid + NT k: their global row and column
  int gyx[SWEEP_WIDE_PF];
#pragma unroll
  for (int k = 0; k < SWEEP_WIDE_PF; ++k) {
    const int c = tid + NT * k, r = c / SX, x = x0 + c - r * SX, y = y0 + r;
    gyx[k] = c < plane && y >= 0 && y < ny && x >= 0 && x < nx ? y * nx + x : -1;
  }
  T pf[SWEEP_WIDE_PF];
  auto fetch = [&](int p) {
    const int z = z0 + p;
    const bool z_ok = z >= 0 && z < nz;
#pragma unroll
    for (int k = 0; k < SWEEP_WIDE_PF; ++k)
      pf[k] = z_ok && gyx[k] >= 0 ? src[(size_t)z * ny * nx + gyx[k]] : fill;
  };
  auto put = [&](int p) {
    T* st = stage + (p & 1) * plane;
#pragma unroll
    for (int k = 0; k < SWEEP_WIDE_PF; ++k)
      if (tid + NT * k < plane) st[tid + NT * k] = pf[k];
    const int z = z0 + p;
    for (int c = tid + NT * SWEEP_WIDE_PF; c < plane; c += NT) {
      const int r = c / SX, x = x0 + c - r * SX, y = y0 + r;
      st[c] = z >= 0 && z < nz && y >= 0 && y < ny && x >= 0 && x < nx
                  ? src[((size_t)z * ny + y) * nx + x]
                  : fill;
    }
  };
  auto xpool = [&](int s) {
    const int p = s / hd.n_groups, g = s - p * hd.n_groups;
    const T* sbuf = stage + (p & 1) * plane;
    T* pbuf = pools + (s & 1) * pool_cells;
    for (int task = tid; task < SY * TILE_X; task += NT) {
      const T* e = sbuf + (task / TILE_X) * SX + task % TILE_X + h;  // e[k]: k columns right
      auto at = [&](int k) { return e[k]; };
      wide_row_pools<0>(tb, hd, g, n_sym, op, at, at, carry + task, pbuf + task, SY * TILE_X);
    }
  };

  T acc = fill;
  fetch(0);
  put(0);
  fetch(1);
  put(1);
  if (n_planes > 2) fetch(2);
  __syncthreads();
  xpool(0);
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int p = s / hd.n_groups, g = s - p * hd.n_groups;
    if (s + 1 < n_steps) xpool(s + 1);
    const int dz = p - h - (int)threadIdx.z;  // input plane tz * 4 - h + p, own plane tz * 4 + z
    if (pool && dz >= -h && dz <= h) {
      const int q = tb[hd.zs + g * (2 * h + 1) + h + dz];
      if (q >= 0) {
        const T* pbase =
            pools + (s & 1) * pool_cells + (threadIdx.y + h) * TILE_X + threadIdx.x;
        // two running values: the rows' loads overlap
        const int t1 = tb[hd.se + q];
        int t = tb[hd.sb + q];
        T acc2 = acc;
#pragma unroll 2
        for (; t + 1 < t1; t += 2) {
          acc = op(acc, pbase[tb[hd.row + t]]);
          acc2 = op(acc2, pbase[tb[hd.row + t + 1]]);
        }
        if (t < t1) acc = op(acc, pbase[tb[hd.row + t]]);
        acc = op(acc, acc2);
      }
    }
    if (g == hd.n_groups - 1) {
      if (p + 2 < n_planes) put(p + 2);  // plane p's buffer: its last x pool ran a step ago
      if (p + 3 < n_planes) fetch(p + 3);
    }
    __syncthreads();
  }
  return acc;
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
  int* off = nullptr;  // narrow: after the tile, each tap's offset into it
  int* tb = nullptr;   // wide: after the pools and planes, the table
  WideTab hd;
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
  if constexpr (WIDE) {
    hd = wide_tab(taps.tab);
    const SweepWideShape<T> sh(hd);
    tb = reinterpret_cast<int*>(smem_raw + sh.pools + sh.carry + sh.stage);
    for (int i = tid; i < taps.len; i += TILE_X * TILE_Y * TILE_Z) {
      int v = taps.tab[i];
      if (i >= hd.row) v = ((v & 0xFFFF) * sh.sy + (v >> 16)) * TILE_X;  // a row's pool offset
      tb[i] = v;
    }
  } else {
    const size_t tile_bytes =
        (size_t)(TILE_X + 2 * h) * (TILE_Y + 2 * h) * (TILE_Z + 2 * h) * sizeof(T);
    off = reinterpret_cast<int*>(smem_raw + ((tile_bytes + 15) & ~(size_t)15));
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
          const T pooled = sweep_tile_wide<T, MODE>(src, smem_raw, tb, hd, tx, ty, tz, nz, ny,
                                                    nx, fill, o);
          // an unoccupied voxel's value does not depend on the pool; the
          // ball holds its centre: min(key, pool) == pool
          const T nv = !o ? (MODE == 0 ? (T)SENTINEL : (T)(old != 0))
                          : (MODE == 0 ? pooled : (T)(old != 0 || pooled != 0));
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

// the wide form: its shared memory from the table (checked here)
template <typename T, int MODE>
int launch_sweeps_wide(void* b0, void* b1, const void* occ, int nz, int ny, int nx,
                       const int* host, const int* dev, int len, const Batch& bt, int share,
                       int* changed, int* tiles, unsigned int* barrier, int* mark, int* lists,
                       int* tile_occ, int* blocks_out, cudaStream_t stream) {
  WideTab t;
  if (dev == nullptr || !parse_wide(host, len, 120, &t) || t.zh != t.h)
    return (int)cudaErrorInvalidValue;
  const WideTaps w = {t.h, dev, len};
  return launch_with<T, MODE>(w, SweepWideShape<T>(t).smem, b0, b1, occ, nz, ny, nx, bt, share,
                              changed, tiles, barrier, mark, lists, tile_occ, blocks_out, stream);
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

// The wide form (a tap set past halo 7 or 2,112 taps): host, the packed
// wide run table of kernels.sweep_plan (ops/morphology.WideRunTable, host
// int32 [len], checked here), dev its device copy.  Every other argument
// as vofod_propagate_sweeps'.
VOFOD_API int vofod_propagate_sweeps_wide(void* buf0, void* buf1, const void* occ, int mode,
                                          int nz, int ny, int nx, const int* host,
                                          const int* dev, int len, int i0, int n_sweeps,
                                          int grow, int flag_z0, int flag_z1, const void* gate,
                                          int share, void* changed, void* tiles, void* barrier,
                                          void* marks, void* lists, void* tile_occ, int* blocks,
                                          void* stream) {
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
    return launch_sweeps_wide<int32_t, 0>(buf0, buf1, occ, nz, ny, nx, host, dev, len, bt, share,
                                          ch, ti, ba, mk, ls, to, blocks, s);
  if (mode == 1)
    return launch_sweeps_wide<uint8_t, 1>(buf0, buf1, occ, nz, ny, nx, host, dev, len, bt, share,
                                          ch, ti, ba, mk, ls, to, blocks, s);
  return (int)cudaErrorInvalidValue;
}
