// K13a, K13b — the per-component census of the exact sepclusters mode.
//
// K13a replaces vofod_tpu/parallel/gridops.py `DenseOps.label_census` and
// its use in vofod_tpu/pipeline/sepclusters.py `run_sepclusters_exact`
// (ref vofod_nodelet.cpp:1174-1183): an int32 scatter-add of each occupied
// coarse cell's sure count into its component's bucket (bucket = label, a
// flat cell id; SENTINEL and ids >= ncv dropped), then one pass that reads
// every cell's bucket back, `occ ? census[min(label, ncv - 1)] : 0`.  The
// read-back pass also ORs two device flags, any(occ) and any(occ & census
// >= min_sure), the two reductions sure_sufficient is made of, so the
// step needs no further full-grid pass for them.
//
// K13b replaces `_quirk_sure_counts` (the reference's VoxelGridCounted
// indexing quirk, voxel_grid_counted.cpp:185-187): U[k], the sure & bg
// voxels among the first k bg voxels in export order (x outer, y, z
// fastest), then per coarse cell (x-fastest order, `first` the exclusive
// prefix of the cells' bg counts) quirk = U[first + count] - U[first].
// Both prefixes ride one 64-bit word per voxel, (bg << 32) | (sure & bg).
// The export order walks whole (y, x) columns, so the export prefix at a
// voxel is (1) the sum of the columns before its own in export order, over
// every shard, (2) its column's rows on the shards below and (3) its own
// column's z prefix.  The dense K13b is the one-shard case; both run the
// same four passes (vofod_tpu_torch/pipeline/sepclusters.py
// `quirk_counts_columnwalk_plain` is their plain model):
//
//   1. columns: one thread per (y, x) column in native order sums its
//      rows; neighbouring threads read neighbouring bytes of each z row,
//      16 rows in flight.  Reads the bg and sure grids once, writes 8
//      bytes per column.
//   2. column prefix: one single-pass scan (decoupled look-back,
//      csrc/lookback.cuh) of the columns' totals in export order, e = x * ny +
//      y, reading column y * nx + x (summed over the shards' gathered
//      columns) and writing its exclusive prefix back at y * nx + x.  The
//      ~0.4 MB of columns stay in L2, so its strided accesses cost L2
//      sectors, not HBM bytes.
//   3. walk: one thread per (y, x) column in native order starts from its
//      prefix plus its rows on the shards below and walks the column's z
//      rows, writing u[rank] = t at each bg voxel; the shards-below bg
//      count is reduced per block into one atomic.  A thread per column,
//      not per voxel, because the z prefix is a chain: the walk's reads
//      coalesce across the warp (read-only loads, so that 16 rows are in
//      flight ahead of the stores), and its writes are the rank table's,
//      one int32 per bg voxel (scattered: neighbouring columns lie a
//      column's worth of ranks apart).
//   4. cells: one single-pass scan over the cells in x-fastest order of
//      their bg counts (lsz³ reads each, as words at leaf 1; the partial
//      top cells clipped), plus the shards-below count on a slab, and the
//      two reads of u per cell with bg.  Reads the bg grid once more,
//      writes 4 bytes a cell.
//
// The bound is memory: the two grids read twice (passes 1, 3), bg once
// more (pass 4), u written at the bg voxels and read twice per bg cell,
// the cells' counts written.  The look-back's state (a tile counter and
// one status word per tile) is zeroed by pass 1 on the dense path, so the
// dense K13b is four launches and nothing else: u gets no zero fill, since
// pass 4 reads u[k] only for k <= #bg, every one of which pass 3 writes
// but u[0], which pass 2 sets.  On the grid-sharded step the shards' u are
// psum'd, so each is zeroed (one memset of the full-grid table).
//
// The grid-sharded step (vofod_tpu/parallel/gridops.py ZShardOps) splits
// both around its collectives:
//
// K15b-6a (`gridops.py:440` `label_census`): K13a's two passes as two
// entries, `vofod_census_scatter` (the slab's cells into the global label
// space) and `vofod_census_read` (the read-back and the two flags); the
// step runs a psum of the int32 census between them and ORs the flags
// over the shards after.
//
// K15b-6b (`vofod_tpu/pipeline/sepclusters.py:243`
// `_quirk_sure_counts_sharded`): `vofod_quirk_columns` is pass 1 on the
// slab; the step all-gathers the columns; `vofod_quirk_ranks` is passes 2
// and 3 (the shards' ranks are disjoint); the step psums u;
// `vofod_quirk_query` is pass 4 on the slab's cells.  u is a replicated
// full-grid int32 table (9.9 MB at the flagship), as in JAX.
//
// K13a moves the label, count and occupancy grids (~22 MB at the
// flagship) and scatters at most one atomic per occupied cell into a 9.9
// MB bucket array; integer atomics add in any order to the same result.
// Everything here is integer arithmetic: bit-equal to the plain versions.
#include "lookback.cuh"

namespace {

constexpr int EW_T = 256;         // elementwise passes, the columns, the walk
constexpr int COL_T = 256;        // pass 2: threads per tile
constexpr int COL_ITEMS = 4;      //   consecutive columns per thread
constexpr int COL_TILE = COL_T * COL_ITEMS;
constexpr int CELL_T = 256;       // pass 4: threads per tile
constexpr int CELL_ITEMS = 16;    //   consecutive cells per thread
constexpr int CELL_TILE = CELL_T * CELL_ITEMS;

// ---------------------------------------------------------------- K13a

__global__ void __launch_bounds__(EW_T)
    census_add_kernel(const int32_t* __restrict__ labels, const int32_t* __restrict__ vals,
                      const uint8_t* __restrict__ occ, long long n, int ncv,
                      int32_t* __restrict__ census) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !occ[i]) return;
  const int32_t v = vals[i];
  const int32_t l = labels[i];
  if (v != 0 && l >= 0 && l < ncv) atomicAdd(census + l, v);
}

__global__ void __launch_bounds__(EW_T)
    census_read_kernel(const int32_t* __restrict__ labels, const uint8_t* __restrict__ occ,
                       const int32_t* __restrict__ census, long long n, int ncv, float min_sure,
                       int32_t* __restrict__ out, uint8_t* __restrict__ flags) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int any_occ = 0, any_sure = 0;
  if (i < n) {
    int32_t c = 0;
    if (occ[i]) {
      c = census[min(labels[i], ncv - 1)];
      any_occ = 1;
      any_sure = (float)c >= min_sure;
    }
    out[i] = c;
  }
  any_occ = __syncthreads_or(any_occ);
  any_sure = __syncthreads_or(any_sure);
  if (threadIdx.x == 0) {
    if (any_occ) flags[0] = 1;
    if (any_sure) flags[1] = 1;
  }
}

// ---------------------------------------------------------------- K13b

struct QuirkGrid {
  const uint8_t* bg;
  const uint8_t* sure;
  int nz, ny, nx;        // fine grid (a shard's slab on the sharded step)
  int lsz;               // coarse leaf size
  int ncz, ncy, ncx;     // coarse lattice
};

// a voxel's (bg << 32) | (sure & bg), through the read-only cache: the
// column passes store to u, which nvcc cannot tell apart from the grids,
// and __ldg lets it issue a column's loads ahead of those stores
__device__ __forceinline__ u64 voxel_pair(const QuirkGrid& q, size_t i) {
  const u64 b = __ldg(q.bg + i) != 0;
  return (b << 32) | (u64)(b && __ldg(q.sure + i) != 0);
}

// bg voxels of coarse cell c (x fastest), cells anchored at the grid origin
__device__ __forceinline__ unsigned int coarse_count(const QuirkGrid& q, long long c) {
  if (q.lsz == 1) return q.bg[c] != 0;
  const int cx = (int)(c % q.ncx);
  const long long t = c / q.ncx;
  const int cy = (int)(t % q.ncy);
  const int cz = (int)(t / q.ncy);
  unsigned int s = 0;
  for (int dz = 0; dz < q.lsz; ++dz) {
    const int z = cz * q.lsz + dz;
    if (z >= q.nz) break;
    for (int dy = 0; dy < q.lsz; ++dy) {
      const int y = cy * q.lsz + dy;
      if (y >= q.ny) break;
      for (int dx = 0; dx < q.lsz; ++dx) {
        const int x = cx * q.lsz + dx;
        if (x >= q.nx) break;
        s += q.bg[((size_t)z * q.ny + y) * q.nx + x] != 0;
      }
    }
  }
  return s;
}

// Pass 1: each (y, x) column's pair summed over the grid's (slab's) rows;
// the first threads also zero `nzero` words of look-back state
__global__ void __launch_bounds__(EW_T) quirk_columns_kernel(QuirkGrid q, u64* __restrict__ cols,
                                                             u64* __restrict__ zero,
                                                             long long nzero) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = c; i < nzero; i += (long long)gridDim.x * blockDim.x) zero[i] = 0;
  const size_t plane = (size_t)q.ny * q.nx;
  if (c >= (long long)plane) return;
  u64 s = 0;
#pragma unroll 16
  for (int z = 0; z < q.nz; ++z) s += voxel_pair(q, z * plane + c);
  cols[c] = s;
}

// Pass 2: excl[y * nx + x] = the sum of the columns before (y, x) in
// export order, each column summed over the nsh shards' `cols` [nsh][ny *
// nx].  Tile 0 also sets u[0] = 0 (dense) or *below = 0 (sharded).
__global__ void __launch_bounds__(COL_T)
    quirk_colprefix_kernel(const u64* __restrict__ cols, int nsh, int ny, int nx,
                           u64* __restrict__ excl, u64* state, int32_t* __restrict__ u0,
                           u64* __restrict__ below) {
  __shared__ u64 warp_s[COL_T / 32];
  __shared__ u64 s_excl;
  __shared__ int s_tile;
  const int tile = take_tile(state, &s_tile);
  const long long plane = (long long)ny * nx;
  const long long e0 = (long long)tile * COL_TILE + (long long)threadIdx.x * COL_ITEMS;
  u64 v[COL_ITEMS];
  u64 s = 0;
#pragma unroll
  for (int j = 0; j < COL_ITEMS; ++j) {
    const long long e = e0 + j;
    v[j] = 0;
    if (e < plane) {
      const long long c = (e % ny) * nx + e / ny;
      for (int sh = 0; sh < nsh; ++sh) v[j] += cols[sh * plane + c];
    }
    s += v[j];
  }
  u64 agg;
  u64 run = block_excl_scan<u64>(s, warp_s, &agg);
  run += look_back(state + 1, tile, agg, &s_excl);
#pragma unroll
  for (int j = 0; j < COL_ITEMS; ++j) {
    const long long e = e0 + j;
    if (e < plane) excl[(e % ny) * nx + e / ny] = run;
    run += v[j];
  }
  if (tile == 0 && threadIdx.x == 0) {
    if (u0 != nullptr) *u0 = 0;
    if (below != nullptr) *below = 0;
  }
}

// Pass 3: each column walked up its rows from excl plus its rows on the
// `rank` shards below (blocks [nsh][ny * nx], the gathered columns),
// u[rank] = t at each bg voxel; *below += the bg voxels of the shards
// below, one atomic per block
__global__ void __launch_bounds__(EW_T)
    quirk_walk_kernel(QuirkGrid q, const u64* __restrict__ excl, const u64* __restrict__ blocks,
                      int rank, int32_t* __restrict__ u, u64* __restrict__ below) {
  __shared__ unsigned int warp_s[EW_T / 32];
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)q.ny * q.nx;
  unsigned int below_bg = 0;
  if (c < (long long)plane) {
    u64 r = excl[c];
    for (int sh = 0; sh < rank; ++sh) {
      const u64 b = blocks[sh * plane + c];
      below_bg += (unsigned int)(b >> 32);
      r += b;
    }
#pragma unroll 16
    for (int z = 0; z < q.nz; ++z) {
      const u64 p = voxel_pair(q, z * plane + c);
      r += p;
      if (p >> 32) u[r >> 32] = (int32_t)(r & 0xffffffffu);
    }
  }
  if (below == nullptr) return;
  below_bg = __reduce_add_sync(0xffffffffu, below_bg);
  if ((threadIdx.x & 31) == 0) warp_s[threadIdx.x >> 5] = below_bg;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int s = 0;
    for (int w = 0; w < EW_T / 32; ++w) s += warp_s[w];
    if (s != 0) atomicAdd(below, (u64)s);
  }
}

// Pass 4: quirk[c] = count_c > 0 ? u[first + count_c] - u[first] : 0 over
// the nc cells in x-fastest order, first the exclusive prefix of the
// cells' bg counts plus *below when given.  At leaf 1 a thread whose
// bytes are 4-byte aligned reads them as words.
__global__ void __launch_bounds__(CELL_T)
    quirk_cells_kernel(QuirkGrid q, long long nc, const int32_t* __restrict__ u,
                       const u64* __restrict__ below, u64* state, int32_t* __restrict__ quirk) {
  static_assert(CELL_ITEMS % 4 == 0, "whole words and int4 stores");
  __shared__ u64 warp_s[CELL_T / 32];
  __shared__ u64 s_excl;
  __shared__ int s_tile;
  const int tile = take_tile(state, &s_tile);
  const long long c0 = (long long)tile * CELL_TILE + (long long)threadIdx.x * CELL_ITEMS;
  unsigned int cnt[CELL_ITEMS];
  u64 s = 0;
  if (q.lsz == 1 && c0 + CELL_ITEMS <= nc && reinterpret_cast<uintptr_t>(q.bg + c0) % 4 == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(q.bg + c0);
#pragma unroll
    for (int k = 0; k < CELL_ITEMS / 4; ++k) {
      const uint32_t b = w[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) cnt[4 * k + i] = ((b >> (8 * i)) & 0xffu) != 0;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CELL_ITEMS; ++j) cnt[j] = c0 + j < nc ? coarse_count(q, c0 + j) : 0;
  }
#pragma unroll
  for (int j = 0; j < CELL_ITEMS; ++j) s += cnt[j];
  u64 agg;
  u64 run = block_excl_scan<u64>(s, warp_s, &agg);
  run += look_back(state + 1, tile, agg, &s_excl);
  if (below != nullptr) run += *below;
  int32_t out[CELL_ITEMS];
#pragma unroll
  for (int j = 0; j < CELL_ITEMS; ++j) {
    out[j] = cnt[j] ? u[run + cnt[j]] - u[run] : 0;
    run += cnt[j];
  }
  if (c0 + CELL_ITEMS <= nc) {  // quirk 16-byte aligned (the entries check)
    int4* o = reinterpret_cast<int4*>(quirk + c0);
#pragma unroll
    for (int j = 0; j < CELL_ITEMS / 4; ++j)
      o[j] = make_int4(out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
  } else {
    for (int j = 0; j < CELL_ITEMS && c0 + j < nc; ++j) quirk[c0 + j] = out[j];
  }
}

// the QuirkGrid of a (slab of a) grid
QuirkGrid quirk_grid(const void* bg, const void* sure, int nz, int ny, int nx, int lsz) {
  QuirkGrid q;
  q.bg = static_cast<const uint8_t*>(bg);
  q.sure = static_cast<const uint8_t*>(sure);
  q.nz = nz; q.ny = ny; q.nx = nx; q.lsz = lsz;
  q.ncz = (nz + lsz - 1) / lsz; q.ncy = (ny + lsz - 1) / lsz; q.ncx = (nx + lsz - 1) / lsz;
  return q;
}

inline long long n_tiles(long long n, int tile) { return (n + tile - 1) / tile; }

// ranks (and bg counts) below 2^30 leave the status words their flag bits
inline bool quirk_size_ok(long long nv) { return nv > 0 && nv + 2 < (1ll << 30); }

}  // namespace

// K13a.  labels, vals: device int32 [n]; occ: bool [n]; census: int32
// [ncv], zeroed by the caller.  Outputs: out int32 [n] (occ ? census[min(
// label, ncv - 1)] : 0); flags uint8 [2], zeroed by the caller, set to
// (any occ, any occ & out >= min_sure).  Returns cudaGetLastError().
VOFOD_API int vofod_label_census(const void* labels, const void* vals, const void* occ,
                                 long long n, int ncv, float min_sure, void* census, void* out,
                                 void* flags, void* stream) {
  if (n <= 0 || ncv <= 0) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((n + EW_T - 1) / EW_T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  const uint8_t* o = static_cast<const uint8_t*>(occ);
  int32_t* cen = static_cast<int32_t*>(census);
  census_add_kernel<<<blocks, EW_T, 0, s>>>(lab, static_cast<const int32_t*>(vals), o, n, ncv, cen);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  census_read_kernel<<<blocks, EW_T, 0, s>>>(lab, o, cen, n, ncv, min_sure,
                                             static_cast<int32_t*>(out),
                                             static_cast<uint8_t*>(flags));
  return (int)cudaGetLastError();
}

// K13b's and K15b-6b's scan geometry: out int [4] = (columns per tile of
// pass 2, cells per tile of pass 4, blocks of pass 2 and of pass 4 the
// current device holds resident at once).  Returns a CUDA error code.
VOFOD_API int vofod_quirk_geometry(int* out) {
  int dev = 0, sms = 0, per2 = 0, per4 = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per2, quirk_colprefix_kernel, COL_T, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per4, quirk_cells_kernel, CELL_T, 0);
  out[0] = COL_TILE;
  out[1] = CELL_TILE;
  out[2] = per2 * sms;
  out[3] = per4 * sms;
  return (int)e;
}

// K13b.  bg, sure: device bool (nz, ny, nx); lsz: coarse leaf size; the
// coarse lattice is ceil(n / lsz) per axis.  scratch: device int64 [2 * ny
// * nx + 2 + ceil(ny * nx / COL_TILE) + ceil(cells / CELL_TILE)], any
// contents; u: int32 [nz * ny * nx + 2], any contents (written at 0 and
// the bg ranks).  Output: quirk int32 [ncz * ncy * ncx], 16-byte aligned.
// Four launches.
// Returns cudaGetLastError().
VOFOD_API int vofod_quirk_counts(const void* bg, const void* sure, int nz, int ny, int nx, int lsz,
                                 void* scratch, void* u, void* quirk, void* stream) {
  const long long nv = (long long)nz * ny * nx;
  if (nz < 1 || ny < 1 || nx < 1 || lsz < 1 || !quirk_size_ok(nv) ||
      reinterpret_cast<uintptr_t>(quirk) % 16)
    return (int)cudaErrorInvalidValue;
  const QuirkGrid q = quirk_grid(bg, sure, nz, ny, nx, lsz);
  const long long plane = (long long)ny * nx;
  const long long nc = (long long)q.ncz * q.ncy * q.ncx;
  const long long t2 = n_tiles(plane, COL_TILE), t4 = n_tiles(nc, CELL_TILE);
  u64* cols = static_cast<u64*>(scratch);
  u64* excl = cols + plane;
  u64* st2 = excl + plane;
  u64* st4 = st2 + 1 + t2;
  int32_t* uu = static_cast<int32_t*>(u);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int col_blocks = (unsigned int)n_tiles(plane, EW_T);
  quirk_columns_kernel<<<col_blocks, EW_T, 0, s>>>(q, cols, st2, 2 + t2 + t4);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  quirk_colprefix_kernel<<<(unsigned int)t2, COL_T, 0, s>>>(cols, 1, ny, nx, excl, st2, uu,
                                                            nullptr);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  quirk_walk_kernel<<<col_blocks, EW_T, 0, s>>>(q, excl, nullptr, 0, uu, nullptr);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  quirk_cells_kernel<<<(unsigned int)t4, CELL_T, 0, s>>>(q, nc, uu, nullptr, st4,
                                                         static_cast<int32_t*>(quirk));
  return (int)cudaGetLastError();
}

// K15b-6a, the scatter pass.  labels (global ids), vals: device int32 [n];
// occ: bool [n]; census: int32 [ncv] (the global label space), zeroed by
// the caller, accumulated into.  Returns cudaGetLastError().
VOFOD_API int vofod_census_scatter(const void* labels, const void* vals, const void* occ,
                                   long long n, int ncv, void* census, void* stream) {
  if (n <= 0 || ncv <= 0) return (int)cudaErrorInvalidValue;
  census_add_kernel<<<(unsigned int)((n + EW_T - 1) / EW_T), EW_T, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<const int32_t*>(vals),
      static_cast<const uint8_t*>(occ), n, ncv, static_cast<int32_t*>(census));
  return (int)cudaGetLastError();
}

// K15b-6a, the read-back pass: out int32 [n] = occ ? census[min(label, ncv
// - 1)] : 0; flags uint8 [2], zeroed by the caller, set to (any occ, any occ
// & out >= min_sure) of these n cells.  Returns cudaGetLastError().
VOFOD_API int vofod_census_read(const void* labels, const void* occ, const void* census,
                                long long n, int ncv, float min_sure, void* out, void* flags,
                                void* stream) {
  if (n <= 0 || ncv <= 0) return (int)cudaErrorInvalidValue;
  census_read_kernel<<<(unsigned int)((n + EW_T - 1) / EW_T), EW_T, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(labels), static_cast<const uint8_t*>(occ),
      static_cast<const int32_t*>(census), n, ncv, min_sure, static_cast<int32_t*>(out),
      static_cast<uint8_t*>(flags));
  return (int)cudaGetLastError();
}

// K15b-6b, pass 1.  bg, sure: device bool slab (nzl, ny, nx).  cols: int64
// [ny * nx], each column's sum of (bg << 32) | (sure & bg) over the slab.
VOFOD_API int vofod_quirk_columns(const void* bg, const void* sure, int nzl, int ny, int nx,
                                  void* cols, void* stream) {
  if (nzl < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const QuirkGrid q = quirk_grid(bg, sure, nzl, ny, nx, 1);
  quirk_columns_kernel<<<(unsigned int)n_tiles((long long)ny * nx, EW_T), EW_T, 0,
                         static_cast<cudaStream_t>(stream)>>>(q, static_cast<u64*>(cols),
                                                              nullptr, 0);
  return (int)cudaGetLastError();
}

// K15b-6b, passes 2 and 3.  blocks: device int64 [nsh][ny * nx], every
// shard's columns (rank order); scratch: int64 [ny * nx + 1 + ceil(ny * nx
// / COL_TILE)], any contents; u: int32 [nu] (nu = nz * ny * nx + 2 of the
// whole grid), any contents, zeroed here and written at the slab's bg
// ranks; below: int64 scalar, any contents, set to the bg voxels of the
// shards below.  Two memsets and two launches.  Returns cudaGetLastError().
VOFOD_API int vofod_quirk_ranks(const void* bg, const void* sure, int nzl, int ny, int nx,
                                const void* blocks, int nsh, int rank, void* scratch, void* u,
                                long long nu, void* below, void* stream) {
  if (nzl < 1 || ny < 1 || nx < 1 || nsh < 1 || rank < 0 || rank >= nsh ||
      !quirk_size_ok(nu - 2) || nu < (long long)nzl * ny * nx * nsh + 2)
    return (int)cudaErrorInvalidValue;
  const QuirkGrid q = quirk_grid(bg, sure, nzl, ny, nx, 1);
  const long long plane = (long long)ny * nx;
  const long long t2 = n_tiles(plane, COL_TILE);
  u64* excl = static_cast<u64*>(scratch);
  u64* st2 = excl + plane;
  int32_t* uu = static_cast<int32_t*>(u);
  u64* bel = static_cast<u64*>(below);
  const u64* blk = static_cast<const u64*>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(uu, 0, (size_t)nu * sizeof(int32_t), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(st2, 0, (size_t)(1 + t2) * sizeof(u64), s);
  if (e != cudaSuccess) return (int)e;
  quirk_colprefix_kernel<<<(unsigned int)t2, COL_T, 0, s>>>(blk, nsh, ny, nx, excl, st2, nullptr,
                                                            bel);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  quirk_walk_kernel<<<(unsigned int)n_tiles(plane, EW_T), EW_T, 0, s>>>(q, excl, blk, rank, uu,
                                                                        bel);
  return (int)cudaGetLastError();
}

// K15b-6b, pass 4: K13b's cell pass on the slab's cells (the slab's height
// a multiple of lsz); u: the psum'd int32 table; below: K15b-6b pass 3's.
// scratch: int64 [1 + ceil(cells / CELL_TILE)], any contents; quirk: int32
// [cells], 16-byte aligned.  One memset and one launch.  Returns cudaGetLastError().
VOFOD_API int vofod_quirk_query(const void* bg, int nzl, int ny, int nx, int lsz,
                                const void* u, const void* below, void* scratch, void* quirk,
                                void* stream) {
  if (nzl < 1 || ny < 1 || nx < 1 || lsz < 1 || nzl % lsz ||
      reinterpret_cast<uintptr_t>(quirk) % 16)
    return (int)cudaErrorInvalidValue;
  const QuirkGrid q = quirk_grid(bg, bg, nzl, ny, nx, lsz);
  const long long nc = (long long)q.ncz * q.ncy * q.ncx;
  const long long t4 = n_tiles(nc, CELL_TILE);
  u64* st4 = static_cast<u64*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(st4, 0, (size_t)(1 + t4) * sizeof(u64), s);
  if (e != cudaSuccess) return (int)e;
  quirk_cells_kernel<<<(unsigned int)t4, CELL_T, 0, s>>>(
      q, nc, static_cast<const int32_t*>(u), static_cast<const u64*>(below), st4,
      static_cast<int32_t*>(quirk));
  return (int)cudaGetLastError();
}
