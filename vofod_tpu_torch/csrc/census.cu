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
// indexing quirk, voxel_grid_counted.cpp:185-187): two device-wide prefix
// sums over the export order (x outer, y, z fastest) of bg and of sure & bg,
// packed into one 64-bit scan (high word: rank, low word: sure count), a
// scatter u[rank] = t at the bg voxels, then an exclusive prefix of the
// coarse bg counts in cell order (x fastest) and, per cell,
// quirk = u[first + count] - u[first].  Each prefix sum is K6's device-wide
// scan (common.cuh block_excl_scan / scan_block_totals): a count pass of
// block totals over CHUNK = 4096 elements, one block that scans the totals,
// and a write pass that rescans each block.
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
// `_quirk_sure_counts_sharded`): the export order interleaves every
// shard's rows within each (x, y) column, so the global export prefix at a
// local voxel is (the columns before it in export order, over all shards)
// + (its column's rows on the shards below) + (its local z prefix).
// `vofod_quirk_columns` sums each column's local (bg, sure) pair; the step
// all-gathers them; `vofod_quirk_ranks` scans the columns' totals in
// export order (K6's scan), walks each column's local rows from its
// global prefix and scatters u[rank] = t at the slab's bg voxels (the
// shards' ranks are disjoint), and sums the bg voxels of the shards below;
// the step psums u; `vofod_quirk_query` is K13b's cell pass on the slab's
// cells with that sum added to every first rank.  u is a replicated
// full-grid int32 table (9.9 MB at the flagship), as in JAX.
//
// Bound on the H100: memory.  K13a moves the label, count and occupancy
// grids (~22 MB at the flagship) and scatters at most one atomic per
// occupied cell into a 9.9 MB bucket array; integer atomics add in any
// order to the same result, so the output is bit-equal to the plain
// version.  K13b reads the bg and sure grids twice in export order, whose
// consecutive elements are nx * ny voxels apart (one 32-byte sector per
// byte read: the price of the reference's order, a transposed staging
// copy is the faster design), and writes the 9.9 MB rank table once.  All
// of it is integer arithmetic: bit-equal.
#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int CT = 256;         // threads per block of the count / write passes
constexpr int PER_THREAD = 16;  // consecutive elements per thread
constexpr int CHUNK = CT * PER_THREAD;
constexpr int SCAN_T = 1024;
constexpr int EW_T = 256;       // elementwise passes

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
  const u64* blocks;     // sharded: every shard's column sums [nsh][ny * nx]
  int nsh, rank;
};

// a voxel's (bg << 32) | (sure & bg)
__device__ __forceinline__ u64 voxel_pair(const QuirkGrid& q, size_t i) {
  const u64 b = q.bg[i] != 0;
  return (b << 32) | (u64)(b && q.sure[i] != 0);
}

// export position e (x outer, y, z fastest) -> (bg << 32) | (sure & bg)
__device__ __forceinline__ u64 export_pair(const QuirkGrid& q, long long e) {
  const int z = (int)(e % q.nz);
  const long long t = e / q.nz;
  const int y = (int)(t % q.ny);
  const int x = (int)(t / q.ny);
  return voxel_pair(q, ((size_t)z * q.ny + y) * q.nx + x);
}

// column e in export order (x outer, y) -> its pair summed over every shard
__device__ __forceinline__ u64 column_total(const QuirkGrid& q, long long e) {
  const int y = (int)(e % q.ny);
  const int x = (int)(e / q.ny);
  const size_t c = (size_t)y * q.nx + x, plane = (size_t)q.ny * q.nx;
  u64 s = 0;
  for (int j = 0; j < q.nsh; ++j) s += q.blocks[j * plane + c];
  return s;
}

// bg voxels of coarse cell c (x fastest), cells anchored at the grid origin
__device__ __forceinline__ u64 coarse_count(const QuirkGrid& q, long long c) {
  const int cx = (int)(c % q.ncx);
  const long long t = c / q.ncx;
  const int cy = (int)(t % q.ncy);
  const int cz = (int)(t / q.ncy);
  u64 s = 0;
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

template <int PASS>  // 0: export pairs; 1: coarse counts; 2: column totals
__device__ __forceinline__ u64 element(const QuirkGrid& q, long long i) {
  return PASS == 0 ? export_pair(q, i) : (PASS == 1 ? coarse_count(q, i) : column_total(q, i));
}

template <int PASS>
__global__ void __launch_bounds__(CT) quirk_count_kernel(QuirkGrid q, long long n,
                                                         u64* __restrict__ block_tot) {
  __shared__ u64 warp_s[CT / 32];
  const long long first = (long long)blockIdx.x * CHUNK + (long long)threadIdx.x * PER_THREAD;
  u64 s = 0;
  for (int j = 0; j < PER_THREAD; ++j)
    if (first + j < n) s += element<PASS>(q, first + j);
  u64 total;
  block_excl_scan<u64>(s, warp_s, &total);
  if (threadIdx.x == 0) block_tot[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_T) quirk_scan_kernel(const u64* __restrict__ block_tot,
                                                            u64* __restrict__ block_off, int nb) {
  __shared__ u64 warp_s[SCAN_T / 32];
  scan_block_totals<u64>(block_tot, block_off, nb, warp_s);
}

// PASS 0: u[rank] = t at every bg voxel (inclusive prefixes in export
// order); PASS 1: quirk[c] = count_c > 0 ? u[first + count_c] - u[first] :
// 0, every first rank moved on by *base when given (the bg voxels of the
// shards below); PASS 2 (sharded): from each column's global exclusive
// prefix plus its rows on the shards below, the walk over the column's
// local rows writing u[rank] = t at the bg voxels, and *base += the bg
// voxels of the shards below
template <int PASS>
__global__ void __launch_bounds__(CT) quirk_write_kernel(QuirkGrid q, long long n,
                                                         const u64* __restrict__ block_off,
                                                         int32_t* __restrict__ u,
                                                         int32_t* __restrict__ quirk,
                                                         u64* __restrict__ base) {
  __shared__ u64 warp_s[CT / 32];
  const long long first = (long long)blockIdx.x * CHUNK + (long long)threadIdx.x * PER_THREAD;
  u64 vals[PER_THREAD];
  u64 s = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    vals[j] = first + j < n ? element<PASS>(q, first + j) : 0;
    s += vals[j];
  }
  u64 total;
  u64 run = block_off[blockIdx.x] + block_excl_scan<u64>(s, warp_s, &total);
  if (PASS == 1 && base != nullptr) run += *base;
  u64 below_bg = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (first + j >= n) break;
    const u64 v = vals[j];
    if (PASS == 0) {
      run += v;
      if (v >> 32) u[run >> 32] = (int32_t)(run & 0xffffffffu);
    } else if (PASS == 1) {
      const long long f = (long long)run, cf = (long long)v;
      quirk[first + j] = cf > 0 ? u[f + cf] - u[f] : 0;
      run += v;
    } else {
      const long long e = first + j;
      const int y = (int)(e % q.ny), x = (int)(e / q.ny);
      const size_t plane = (size_t)q.ny * q.nx, c = (size_t)y * q.nx + x;
      u64 below = 0;
      for (int sh = 0; sh < q.rank; ++sh) below += q.blocks[sh * plane + c];
      below_bg += below >> 32;
      u64 r = run + below;
      for (int z = 0; z < q.nz; ++z) {
        const u64 p = voxel_pair(q, z * plane + c);
        r += p;
        if (p >> 32) u[r >> 32] = (int32_t)(r & 0xffffffffu);
      }
      run += v;
    }
  }
  if (PASS == 2 && below_bg != 0) atomicAdd(base, below_bg);
}

// K15b-6b's first pass: each (y, x) column's local pair sum
__global__ void __launch_bounds__(EW_T) quirk_columns_kernel(QuirkGrid q, u64* __restrict__ cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = (size_t)q.ny * q.nx;
  if (c >= (int)plane) return;
  u64 s = 0;
  for (int z = 0; z < q.nz; ++z) s += voxel_pair(q, z * plane + c);
  cols[c] = s;
}

template <int PASS>
int quirk_scan(const QuirkGrid& q, long long n, u64* tot, u64* off, int32_t* u, int32_t* quirk,
               cudaStream_t s, u64* base = nullptr) {
  const long long nb_ll = (n + CHUNK - 1) / CHUNK;
  if (nb_ll > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nb = (int)nb_ll;
  quirk_count_kernel<PASS><<<nb, CT, 0, s>>>(q, n, tot);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  quirk_scan_kernel<<<1, SCAN_T, 0, s>>>(tot, off, nb);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  quirk_write_kernel<PASS><<<nb, CT, 0, s>>>(q, n, off, u, quirk, base);
  return (int)cudaGetLastError();
}

// the QuirkGrid of a (slab of a) grid
QuirkGrid quirk_grid(const void* bg, const void* sure, int nz, int ny, int nx, int lsz) {
  QuirkGrid q;
  q.bg = static_cast<const uint8_t*>(bg);
  q.sure = static_cast<const uint8_t*>(sure);
  q.nz = nz; q.ny = ny; q.nx = nx; q.lsz = lsz;
  q.ncz = (nz + lsz - 1) / lsz; q.ncy = (ny + lsz - 1) / lsz; q.ncx = (nx + lsz - 1) / lsz;
  q.blocks = nullptr;
  q.nsh = 1; q.rank = 0;
  return q;
}

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

// K13b.  bg, sure: device bool (nz, ny, nx); lsz: coarse leaf size; the
// coarse lattice is ceil(n / lsz) per axis.  scratch: device int64 [2 *
// ceil(nz * ny * nx / 4096)]; u: int32 [nz * ny * nx + 2], zeroed by the
// caller.  Output: quirk int32 [ncz * ncy * ncx].  Returns
// cudaGetLastError().
VOFOD_API int vofod_quirk_counts(const void* bg, const void* sure, int nz, int ny, int nx, int lsz,
                                 void* scratch, void* u, void* quirk, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || lsz < 1) return (int)cudaErrorInvalidValue;
  const QuirkGrid q = quirk_grid(bg, sure, nz, ny, nx, lsz);
  const long long nv = (long long)nz * ny * nx;
  const long long nc = (long long)q.ncz * q.ncy * q.ncx;
  const long long nb = (nv + CHUNK - 1) / CHUNK;
  u64* tot = static_cast<u64*>(scratch);
  u64* off = tot + nb;
  int32_t* uu = static_cast<int32_t*>(u);
  int32_t* qq = static_cast<int32_t*>(quirk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = quirk_scan<0>(q, nv, tot, off, uu, qq, s);
  if (err != 0) return err;
  return quirk_scan<1>(q, nc, tot, off, uu, qq, s);
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
  const long long plane = (long long)ny * nx;
  quirk_columns_kernel<<<(unsigned int)((plane + EW_T - 1) / EW_T), EW_T, 0,
                         static_cast<cudaStream_t>(stream)>>>(q, static_cast<u64*>(cols));
  return (int)cudaGetLastError();
}

// K15b-6b, pass 2.  blocks: device int64 [nsh][ny * nx], every shard's
// columns (rank order); scratch: int64 [2 * ceil(ny * nx / 4096)]; u: int32
// [nz * ny * nx + 2] of the whole grid, zeroed by the caller, written at the
// slab's bg ranks; below: int64 scalar, zeroed by the caller, set to the bg
// voxels of the shards below.  Returns cudaGetLastError().
VOFOD_API int vofod_quirk_ranks(const void* bg, const void* sure, int nzl, int ny, int nx,
                                const void* blocks, int nsh, int rank, void* scratch, void* u,
                                void* below, void* stream) {
  if (nzl < 1 || ny < 1 || nx < 1 || nsh < 1 || rank < 0 || rank >= nsh)
    return (int)cudaErrorInvalidValue;
  QuirkGrid q = quirk_grid(bg, sure, nzl, ny, nx, 1);
  q.blocks = static_cast<const u64*>(blocks);
  q.nsh = nsh; q.rank = rank;
  const long long plane = (long long)ny * nx;
  u64* tot = static_cast<u64*>(scratch);
  return quirk_scan<2>(q, plane, tot, tot + (plane + CHUNK - 1) / CHUNK,
                       static_cast<int32_t*>(u), nullptr, static_cast<cudaStream_t>(stream),
                       static_cast<u64*>(below));
}

// K15b-6b, pass 3: K13b's cell pass on the slab's cells (the slab's height
// a multiple of lsz); u: the psum'd int32 table; below: K15b-6b pass 2's.
// scratch: int64 [2 * ceil(cells / 4096)]; quirk: int32 [cells].
VOFOD_API int vofod_quirk_query(const void* bg, int nzl, int ny, int nx, int lsz,
                                const void* u, const void* below, void* scratch, void* quirk,
                                void* stream) {
  if (nzl < 1 || ny < 1 || nx < 1 || lsz < 1 || nzl % lsz) return (int)cudaErrorInvalidValue;
  const QuirkGrid q = quirk_grid(bg, bg, nzl, ny, nx, lsz);
  const long long nc = (long long)q.ncz * q.ncy * q.ncx;
  u64* tot = static_cast<u64*>(scratch);
  return quirk_scan<1>(q, nc, tot, tot + (nc + CHUNK - 1) / CHUNK,
                       const_cast<int32_t*>(static_cast<const int32_t*>(u)),
                       static_cast<int32_t*>(quirk), static_cast<cudaStream_t>(stream),
                       const_cast<u64*>(static_cast<const u64*>(below)));
}
