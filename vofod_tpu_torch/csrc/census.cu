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
  int nz, ny, nx;        // fine grid
  int lsz;               // coarse leaf size
  int ncz, ncy, ncx;     // coarse lattice
};

// export position e (x outer, y, z fastest) -> (bg << 32) | (sure & bg)
__device__ __forceinline__ u64 export_pair(const QuirkGrid& q, long long e) {
  const int z = (int)(e % q.nz);
  const long long t = e / q.nz;
  const int y = (int)(t % q.ny);
  const int x = (int)(t / q.ny);
  const size_t i = ((size_t)z * q.ny + y) * q.nx + x;
  const u64 b = q.bg[i] != 0;
  return (b << 32) | (u64)(b && q.sure[i] != 0);
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

template <int PASS>  // 0: export pairs; 1: coarse counts
__device__ __forceinline__ u64 element(const QuirkGrid& q, long long i) {
  return PASS == 0 ? export_pair(q, i) : coarse_count(q, i);
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
// order); PASS 1: quirk[c] = count_c > 0 ? u[first + count_c] - u[first] : 0
template <int PASS>
__global__ void __launch_bounds__(CT) quirk_write_kernel(QuirkGrid q, long long n,
                                                         const u64* __restrict__ block_off,
                                                         int32_t* __restrict__ u,
                                                         int32_t* __restrict__ quirk) {
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
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (first + j >= n) break;
    const u64 v = vals[j];
    if (PASS == 0) {
      run += v;
      if (v >> 32) u[run >> 32] = (int32_t)(run & 0xffffffffu);
    } else {
      const long long f = (long long)run, cf = (long long)v;
      quirk[first + j] = cf > 0 ? u[f + cf] - u[f] : 0;
      run += v;
    }
  }
}

template <int PASS>
int quirk_scan(const QuirkGrid& q, long long n, u64* tot, u64* off, int32_t* u, int32_t* quirk,
               cudaStream_t s) {
  const long long nb_ll = (n + CHUNK - 1) / CHUNK;
  if (nb_ll > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nb = (int)nb_ll;
  quirk_count_kernel<PASS><<<nb, CT, 0, s>>>(q, n, tot);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  quirk_scan_kernel<<<1, SCAN_T, 0, s>>>(tot, off, nb);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  quirk_write_kernel<PASS><<<nb, CT, 0, s>>>(q, n, off, u, quirk);
  return (int)cudaGetLastError();
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
  QuirkGrid q;
  q.bg = static_cast<const uint8_t*>(bg);
  q.sure = static_cast<const uint8_t*>(sure);
  q.nz = nz; q.ny = ny; q.nx = nx; q.lsz = lsz;
  q.ncz = (nz + lsz - 1) / lsz; q.ncy = (ny + lsz - 1) / lsz; q.ncx = (nx + lsz - 1) / lsz;
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
