// K11 — the two full-grid EMA passes of the step.
//
// Replaces vofod_tpu/pipeline/background.py `_finish` (the point EMA,
// ref updateVoxel :789-795) and the demotion EMA of
// vofod_tpu/pipeline/sepclusters.py:144-156 (ref :1219-1244).
//
// * Point EMA: one elementwise launch from the counts, the close mask and
//   the grid: w = 2^-min(count, 63), v' = w v + (1 - w) score where the
//   voxel is occupied (score_point if close, score_unknown otherwise); it
//   also writes far = occupied & ~close and adds the occupied voxels to an
//   int32 count (one atomic per warp).  Bound: memory, one pass.
// * Demotion EMA: K1's streamed run-table pool (ball_pool.cuh pool_stream)
//   with its own staging and store.  Staging builds unsafe = bg & ~safe
//   (int8 0/1, out-of-grid 0) when it puts a plane into shared memory; the
//   int8 ball max runs on the run table as K1's does; the epilogue, where
//   K1 stores a unit of 8 voxels, reads the unit's grid values, sets v' =
//   w1 v + c where the max is set and sure_sufficient (read from its device
//   pointer, no host sync), and writes `out` once.  The demotion mask is
//   never stored.
//
// * Exact demotion EMA (K13c, vofod_tpu/pipeline/sepclusters.py:365-390,
//   the exact-census mode): the same pool, summing.  Staging builds the
//   extended-lattice centre mask of the unsure coarse cells from the
//   occupancy and K13a's census; its int8 0/1 values are summed as s16
//   pairs (a voxel's k is at most the centres in its ball, which the host
//   keeps below 2^15); the epilogue applies k
//   demotions, w1^k v + (1 - w1^k) score where sure_sufficient (from K13a's
//   two flags and the previous value, on the device), and writes the
//   carried safe = bg & sure cell beside the grid.  The centre mask, k,
//   w1^k and the upsampled sure mask of the plain version are never stored.
//   On the grid-sharded step it takes a z window: the grid is a shard's
//   slab and the coarse arrays hold its coarse rows with a halo of the
//   neighbours' (K15b-1), enough rows for the ball's reach.
//
// Bound on the H100: memory (10 bytes a voxel for K11's demotion, 9 + the
// coarse arrays for K13c: 7.4 / 10.3 us on the flagship grid at 3.35
// TB/s).  The first version of both staged a 32 x 8 x 4 box with its halo
// per block (a `%` and a `/` a cell) and walked every tap per voxel from
// shared memory: 0.051 / 0.103 ms device at the flagship radius, 2.26 ms at
// halo 7 on an H100 (chip_ab.py --demote-only; K1 alone on the same
// mask 0.025 / 0.030 / 0.146).  Pooling x-runs with K1's table cuts the tap
// walk to a few combines a voxel and streaming along z stages each plane
// once a chunk; what is left is K1's latency-bound plane steps, with the
// float grid's read and write on top.  Most blocks of a sweep scan have
// nothing to demote (no unsafe voxel, no occupied coarse cell within their
// chunk's reach): such a block tests its staged rows in 16-byte granules,
// agrees on it with one barrier (SKIP in pool_stream) and runs only its
// epilogue, on a pool of nothing, which gives the same grid.
//
// Where it could go wrong, and what the code does:
// - K13c's extended lattice.  The centres live on the lattice up to
//   ncx * lsz, ncy * lsz, ncz * lsz (JAX `_center_mask`): a boundary
//   cell's centre can lie outside the fine grid and still demote voxels
//   inside it, so CentreIO stages by the lattice, the held coarse rows
//   [zc_lo, zc_lo + ncz_held) and the global row z_off + z, never by the
//   fine grid (which agree only at lsz 1).
// - Row alignment.  nx = 241 is odd, so a float32 row starts 16-byte
//   aligned only every fourth row: the epilogues move each unit's 8 floats
//   (and K13c's 8 safe bytes) in the widest pieces its address allows
//   (16 / 8 / 4 bytes; 8 / 4 / 2 / 1 for bytes), element by element at the
//   row's end; the skip test reads whole 16-byte granules (one never
//   crosses a page) and counts the bytes around the row as "maybe".
// - Staging loads.  A staged value that needs two loads (bg and safe; occ
//   and census) is built when the plane is put into shared memory, a plane
//   step after its loads: built at the load, the second load's wait stalled
//   every step (the `&&` of the first version).
// - Rounding.  K11: __fadd_rn(__fmul_rn(w1, v), c); K13c: powf(w1, k) as
//   torch.pow rounds it on the card (1 exactly at k = 0, as powf gives),
//   then __fadd_rn(__fmul_rn(w1k, v), __fmul_rn(__fsub_rn(1, w1k), score));
//   w1 and c rounded to float32 on the host as the tensor ops round the
//   Python scalars.  Both entry points are bit-equal to their plain
//   versions.  sure_out is written by one thread.
// - The sharded call's slabs (17 + 2h planes) and the flagship grid take
//   their z chunk from the occupancy (auto_zchunk), 2 resident blocks an
//   SM at halo <= 3 (the tiny and small tables), 1 above.
// - A ball past halo 7 (the *_wide entries) takes ball_pool.cuh's wide
//   form (pool_stream_wide): the same staging and epilogue on units of 4
//   voxels, one launch; a set cut in z runs a launch a piece behind
//   PieceIO, the pools folded in a scratch of units and the epilogue run
//   once, by the last piece, on the folded unit.  A skipping block's
//   identity folds to nothing, so the skip stays exact.
#include "ball_pool.cuh"

#include <type_traits>

namespace {

constexpr int EMA_T = 256;

__global__ void __launch_bounds__(EMA_T)
    point_ema_kernel(const float* __restrict__ vals, const int32_t* __restrict__ counts,
                     const uint8_t* __restrict__ close, long long n, float score_point,
                     float score_unknown, float* __restrict__ out,
                     uint8_t* __restrict__ far, int* __restrict__ n_occupied) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int occ = 0;
  if (i < n) {
    const int c = counts[i];
    const bool cl = close[i] != 0;
    occ = c > 0;
    float v = vals[i];
    if (occ) {
      const float w = exp2f(-(float)min(max(c, 0), 63));
      const float score = cl ? score_point : score_unknown;
      v = __fadd_rn(__fmul_rn(w, v), __fmul_rn(__fsub_rn(1.0f, w), score));
    }
    out[i] = v;
    far[i] = occ && !cl;
  }
  for (int o = 16; o > 0; o >>= 1) occ += __shfl_down_sync(0xffffffffu, occ, o);
  if ((threadIdx.x & 31) == 0 && occ != 0) atomicAdd(n_occupied, occ);
}

// ---- a unit's N (8 or 4) floats / bytes in the widest pieces its address allows ----

// floats [O, N) of v to p, whose address is A floats past a 16-byte boundary
template <int N, int A, int O>
__device__ __forceinline__ void store_from(float* p, const float (&v)[N]) {
  if constexpr (O < N) {
    constexpr int mis = (A + O) & 3;
    if constexpr (mis == 0 && O + 4 <= N) {
      *reinterpret_cast<float4*>(p + O) = make_float4(v[O], v[O + 1], v[O + 2], v[O + 3]);
      store_from<N, A, O + 4>(p, v);
    } else if constexpr ((mis & 1) == 0 && O + 2 <= N) {
      *reinterpret_cast<float2*>(p + O) = make_float2(v[O], v[O + 1]);
      store_from<N, A, O + 2>(p, v);
    } else {
      p[O] = v[O];
      store_from<N, A, O + 1>(p, v);
    }
  }
}

// bytes [O, N) of b (byte j of the unit at bits 8 j) to p, A bytes past an
// 8-byte boundary
template <int N, int A, int O>
__device__ __forceinline__ void storeb_from(uint8_t* p, unsigned long long b) {
  if constexpr (O < N) {
    constexpr int mis = (A + O) & 7;
    if constexpr (mis == 0 && O == 0 && N == 8) {
      *reinterpret_cast<unsigned long long*>(p) = b;
    } else if constexpr ((mis & 3) == 0 && O + 4 <= N) {
      *reinterpret_cast<uint32_t*>(p + O) = (uint32_t)(b >> (8 * O));
      storeb_from<N, A, O + 4>(p, b);
    } else if constexpr ((mis & 1) == 0 && O + 2 <= N) {
      *reinterpret_cast<uint16_t*>(p + O) = (uint16_t)(b >> (8 * O));
      storeb_from<N, A, O + 2>(p, b);
    } else {
      p[O] = (uint8_t)(b >> (8 * O));
      storeb_from<N, A, O + 1>(p, b);
    }
  }
}

// floats [O, N) of p to v, p A floats past a 16-byte boundary
template <int N, int A, int O>
__device__ __forceinline__ void load_from(const float* p, float (&v)[N]) {
  if constexpr (O < N) {
    constexpr int mis = (A + O) & 3;
    if constexpr (mis == 0 && O + 4 <= N) {
      const float4 q = *reinterpret_cast<const float4*>(p + O);
      v[O] = q.x, v[O + 1] = q.y, v[O + 2] = q.z, v[O + 3] = q.w;
      load_from<N, A, O + 4>(p, v);
    } else if constexpr ((mis & 1) == 0 && O + 2 <= N) {
      const float2 q = *reinterpret_cast<const float2*>(p + O);
      v[O] = q.x, v[O + 1] = q.y;
      load_from<N, A, O + 2>(p, v);
    } else {
      v[O] = p[O];
      load_from<N, A, O + 1>(p, v);
    }
  }
}

// the first n of N floats at p (n < N: the row's end, element by element)
template <int N>
__device__ __forceinline__ void load_n(const float* p, int n, float (&v)[N]) {
  if (n >= N) {
    switch ((reinterpret_cast<uintptr_t>(p) >> 2) & 3) {
      case 0: load_from<N, 0, 0>(p, v); return;
      case 1: load_from<N, 1, 0>(p, v); return;
      case 2: load_from<N, 2, 0>(p, v); return;
      default: load_from<N, 3, 0>(p, v); return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = j < n ? p[j] : 0.0f;
}

template <int N>
__device__ __forceinline__ void store_n(float* p, int n, const float (&v)[N]) {
  if (n >= N) {
    switch ((reinterpret_cast<uintptr_t>(p) >> 2) & 3) {
      case 0: store_from<N, 0, 0>(p, v); return;
      case 1: store_from<N, 1, 0>(p, v); return;
      case 2: store_from<N, 2, 0>(p, v); return;
      default: store_from<N, 3, 0>(p, v); return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) p[j] = v[j];
}

template <int N>
__device__ __forceinline__ void storeb_n(uint8_t* p, int n, unsigned long long b) {
  if (n >= N) {
    switch (reinterpret_cast<uintptr_t>(p) & 7) {
      case 0: storeb_from<N, 0, 0>(p, b); return;
      case 1: storeb_from<N, 1, 0>(p, b); return;
      case 2: storeb_from<N, 2, 0>(p, b); return;
      case 3: storeb_from<N, 3, 0>(p, b); return;
      case 4: storeb_from<N, 4, 0>(p, b); return;
      case 5: storeb_from<N, 5, 0>(p, b); return;
      case 6: storeb_from<N, 6, 0>(p, b); return;
      default: storeb_from<N, 7, 0>(p, b); return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < n) p[j] = (uint8_t)(b >> (8 * j));
}

// The 16-byte granules holding bytes [lo, hi) of a row (at most 12: a
// staged row of 128 + 2 x 7 bytes): a granule that holds a byte of the
// array never crosses a page, so its bytes outside [lo, hi) are read
// harmlessly (and count: a skip test may answer "maybe")
constexpr int SKIP_GRANULES = 12;

__device__ __forceinline__ uintptr_t granule(const void* p) {
  return reinterpret_cast<uintptr_t>(p) & ~(uintptr_t)15;
}

// ---- K11's demotion ----

// Staging: unsafe = bg & ~safe over the grid, 0 outside it.  Store: the EMA
// of the unit's 8 voxels where their ball max is set.
struct DemoteIO {
  const float* __restrict__ vals;
  const uint8_t* __restrict__ bg;
  const uint8_t* __restrict__ safe;
  const uint8_t* __restrict__ sure_sufficient;
  float* __restrict__ out;
  int nz, ny, nx;
  float w1, c;
  bool sure;  // *sure_sufficient, read by each thread at its start
  struct Raw {
    uint8_t bg, safe;
  };
  Raw none;  // {0, 0}: 0 outside the grid
  __device__ __forceinline__ long long plane(int zi, bool& ok) const {
    ok = zi >= 0 && zi < nz;
    return (long long)(ok ? zi : 0) * ny * nx;
  }
  __device__ __forceinline__ int row(int gy, bool& ok) const {
    ok = gy >= 0 && gy < ny;
    return gy * nx;
  }
  __device__ __forceinline__ int col(int gx, bool& ok) const {
    ok = gx >= 0 && gx < nx;
    return gx;
  }
  __device__ __forceinline__ Raw load(long long i) const {
    return {__ldg(bg + i), __ldg(safe + i)};
  }
  __device__ __forceinline__ int8_t stage(Raw r) const {
    return (int8_t)(r.bg != 0 && r.safe == 0);
  }
  // any unsafe voxel among columns [lo, hi) of row gy of plane zi: bg &
  // ~safe of 16-byte granules (bool bytes are 0 / 1); "maybe" when the two
  // grids are not alike aligned
  static constexpr bool SKIP = true;
  __device__ __forceinline__ bool row_any(int zi, int gy, int lo, int hi) const {
    lo = max(lo, 0), hi = min(hi, nx);
    if (zi < 0 || zi >= nz || gy < 0 || gy >= ny || lo >= hi) return false;
    const size_t row = ((size_t)zi * ny + gy) * nx;
    const ptrdiff_t d = safe - bg;
    if (d & 15) return true;
    const uintptr_t g0 = granule(bg + row + lo), g1 = reinterpret_cast<uintptr_t>(bg + row + hi);
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < SKIP_GRANULES; ++k) {
      const uintptr_t g = g0 + 16 * k;
      if (g < g1) {
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(g));
        const uint4 s = __ldg(reinterpret_cast<const uint4*>(g + d));
        any |= (b.x & ~s.x) | (b.y & ~s.y) | (b.z & ~s.z) | (b.w & ~s.w);
      }
    }
    return any != 0;
  }
  template <int NW>  // a unit of 2 NW voxels (the narrow form's 8, the wide's 4)
  __device__ __forceinline__ void store(int zo, int gy, int gx,
                                        const Vec<uint32_t, NW>& pooled) const {
    constexpr int N = 2 * NW;
    const int n = nx - gx;
    if (n <= 0) return;
    const size_t g = ((size_t)zo * ny + gy) * nx + gx;
    float v[N];
    load_n<N>(vals + g, n, v);
    if (sure) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (lane_s16(pooled, j) > 0) v[j] = __fadd_rn(__fmul_rn(w1, v[j]), c);
    }
    store_n<N>(out + g, n, v);
  }
};

template <typename Tab>
__global__ void __launch_bounds__(Lanes<int8_t>::TXU* Lanes<int8_t>::TY)
    demote_ema_kernel(DemoteIO io, int nz, int ny, int nx, int zchunk,
                      const __grid_constant__ Tab tab) {
  DemoteIO at = io;
  at.sure = *io.sure_sufficient != 0;
  pool_stream<int8_t, 1>(at, nz, ny, nx, zchunk, tab);
}

// the policy inside a z piece's (the wide form cut in z)
__device__ __forceinline__ DemoteIO& inner(DemoteIO& io) { return io; }
template <typename Inner>
__device__ __forceinline__ Inner& inner(PieceIO<int8_t, 1, Inner>& io) {
  return io.in;
}

template <typename IO>
__global__ void __launch_bounds__(LanesW<int8_t>::TXU* LanesW<int8_t>::TY, WIDE_BLOCKS_PER_SM)
    demote_ema_wide_kernel(IO io, int nz, int ny, int nx, int zchunk,
                           const int* __restrict__ tab, int len) {
  IO at = io;
  inner(at).sure = *inner(at).sure_sufficient != 0;
  pool_stream_wide<int8_t, 1>(at, nz, ny, nx, zchunk, tab, len);
}

// ---- K13c ----

// the coarse lattice of the exact census
struct CoarseLattice {
  int ncz, ncy, ncx, lsz;  // the grid's lattice (ncz: every coarse row)
  int z_off;               // global fine row of the output's row 0
  int zc_lo, ncz_held;     // the coarse arrays hold the rows [zc_lo, zc_lo + ncz_held)
  float min_sure;          // a cell is sure when its census >= min_sure
};

// Staging: the EXTENDED coarse-centre mask (vofod_tpu sepclusters.py
// _center_mask): a lattice point is set when it is the centre ijk * lsz +
// lsz / 2 of an unsure coarse cell (occupied, census < min_sure); points off
// the extended lattice, outside the held coarse rows or off a centre read 0.
// Store: k demotions of the unit's 8 voxels and their safe bytes.
struct CentreIO {
  const float* __restrict__ vals;
  const uint8_t* __restrict__ occ_c;
  const int32_t* __restrict__ census;
  const uint8_t* __restrict__ flags;
  const uint8_t* __restrict__ prev_sure;
  float* __restrict__ out;
  uint8_t* __restrict__ safe;
  uint8_t* __restrict__ sure_out;
  CoarseLattice c;
  int ny, nx;
  float w1, score, thr_new;
  bool sure;  // sure_sufficient, from the flags at each thread's start
  struct Raw {
    uint8_t occ;
    int32_t census;
  };
  Raw none;  // {0, 0}: no centre
  __device__ __forceinline__ long long plane(int zi, bool& ok) const {
    const int gz = c.z_off + zi, mid = c.lsz / 2;  // global fine row
    ok = gz >= 0 && gz < c.ncz * c.lsz && gz % c.lsz == mid && gz / c.lsz >= c.zc_lo &&
         gz / c.lsz < c.zc_lo + c.ncz_held;
    return ok ? (long long)(gz / c.lsz - c.zc_lo) * c.ncy * c.ncx : 0;
  }
  __device__ __forceinline__ int row(int gy, bool& ok) const {
    ok = gy >= 0 && gy < c.ncy * c.lsz && gy % c.lsz == c.lsz / 2;
    return ok ? gy / c.lsz * c.ncx : 0;
  }
  __device__ __forceinline__ int col(int gx, bool& ok) const {
    ok = gx >= 0 && gx < c.ncx * c.lsz && gx % c.lsz == c.lsz / 2;
    return ok ? gx / c.lsz : 0;
  }
  __device__ __forceinline__ Raw load(long long i) const {
    return {__ldg(occ_c + i), __ldg(census + i)};
  }
  __device__ __forceinline__ int8_t stage(Raw r) const {
    return (int8_t)(r.occ != 0 && !((float)r.census >= c.min_sure));
  }
  // any occupied cell (a centre maybe unsure) among columns [lo, hi) of
  // row gy of plane zi, from 16-byte granules of occ_c: a census read here
  // would wait a second round trip where the cells are occupied
  static constexpr bool SKIP = true;
  __device__ __forceinline__ bool row_any(int zi, int gy, int lo, int hi) const {
    bool ok_z, ok_y;
    const long long base = plane(zi, ok_z) + row(gy, ok_y);
    const int c0 = max(lo, 0) / c.lsz, c1 = (min(hi, c.ncx * c.lsz) + c.lsz - 1) / c.lsz;
    if (!ok_z || !ok_y || c0 >= c1) return false;
    const uintptr_t g0 = granule(occ_c + base + c0);
    const uintptr_t g1 = reinterpret_cast<uintptr_t>(occ_c + base + c1);
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < SKIP_GRANULES; ++k) {
      const uintptr_t g = g0 + 16 * k;
      if (g < g1) {
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(g));
        any |= b.x | b.y | b.z | b.w;
      }
    }
    return any != 0;
  }
  template <int NW>  // a unit of 2 NW voxels (the narrow form's 8, the wide's 4)
  __device__ __forceinline__ void store(int zo, int gy, int gx,
                                        const Vec<uint32_t, NW>& pooled) const {
    constexpr int N = 2 * NW;
    const int n = nx - gx;
    if (n <= 0) return;
    const size_t g = ((size_t)zo * ny + gy) * nx + gx;
    // the held cells of this fine row (global row z_off + zo)
    const size_t crow =
        ((size_t)((c.z_off + zo) / c.lsz - c.zc_lo) * c.ncy + gy / c.lsz) * c.ncx;
    float v[N];
    load_n<N>(vals + g, n, v);
    unsigned long long sb = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      bool s = false;
      if (j < n && v[j] > thr_new) {  // safe = bg & a sure cell
        const size_t cell = crow + (gx + j) / c.lsz;
        s = occ_c[cell] != 0 && (float)census[cell] >= c.min_sure;
      }
      sb |= (unsigned long long)s << (8 * j);
      if (sure) {
        const int k = lane_s16(pooled, j);
        const float w1k = k == 0 ? 1.0f : powf(w1, (float)k);  // torch.pow(w1, k.float())
        v[j] = __fadd_rn(__fmul_rn(w1k, v[j]), __fmul_rn(__fsub_rn(1.0f, w1k), score));
      }
    }
    store_n<N>(out + g, n, v);
    storeb_n<N>(safe + g, n, sb);
  }
};

template <typename Tab>
__global__ void __launch_bounds__(Lanes<int8_t>::TXU* Lanes<int8_t>::TY)
    exact_demote_kernel(CentreIO io, int nz, int ny, int nx, int zchunk,
                        const __grid_constant__ Tab tab) {
  CentreIO at = io;
  // empty background keeps the previous value (ref :1155-1159)
  at.sure = io.flags[0] ? io.flags[1] != 0 : io.prev_sure[0] != 0;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0 &&
      threadIdx.y == 0)
    io.sure_out[0] = at.sure;
  pool_stream<int8_t, 2>(at, nz, ny, nx, zchunk, tab);
}

__device__ __forceinline__ CentreIO& inner(CentreIO& io) { return io; }
__device__ __forceinline__ bool last_piece(const CentreIO&) { return true; }
template <typename Inner>
__device__ __forceinline__ Inner& inner(PieceIO<int8_t, 2, Inner>& io) {
  return io.in;
}
template <typename Inner>
__device__ __forceinline__ bool last_piece(const PieceIO<int8_t, 2, Inner>& io) {
  return io.last;
}

template <typename IO>
__global__ void __launch_bounds__(LanesW<int8_t>::TXU* LanesW<int8_t>::TY, WIDE_BLOCKS_PER_SM)
    exact_demote_wide_kernel(IO io, int nz, int ny, int nx, int zchunk,
                             const int* __restrict__ tab, int len) {
  IO at = io;
  CentreIO& c = inner(at);
  c.sure = c.flags[0] ? c.flags[1] != 0 : c.prev_sure[0] != 0;
  if (last_piece(at) && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0)
    c.sure_out[0] = c.sure;
  pool_stream_wide<int8_t, 2>(at, nz, ny, nx, zchunk, tab, len);
}

DemoteIO demote_io(const void* vals, const void* bg, const void* safe,
                   const void* sure_sufficient, int nz, int ny, int nx, float w1, float c,
                   void* out) {
  DemoteIO io{};
  io.vals = static_cast<const float*>(vals);
  io.bg = static_cast<const uint8_t*>(bg);
  io.safe = static_cast<const uint8_t*>(safe);
  io.sure_sufficient = static_cast<const uint8_t*>(sure_sufficient);
  io.out = static_cast<float*>(out);
  io.nz = nz, io.ny = ny, io.nx = nx;
  io.w1 = w1, io.c = c;
  return io;
}

// K13c's policy, false for a window it cannot take
bool centre_io(const void* vals, const void* occ_c, const void* census, const void* flags,
               const void* prev_sure, int nz, int ny, int nx, int lsz, const float* floats,
               const int* window, void* out, void* safe, void* sure_out, CentreIO* io) {
  if (lsz < 1 || nz < 1 || ny < 1 || nx < 1) return false;
  CoarseLattice c;
  c.lsz = lsz;
  c.ncz = (nz + lsz - 1) / lsz; c.ncy = (ny + lsz - 1) / lsz; c.ncx = (nx + lsz - 1) / lsz;
  c.z_off = 0; c.zc_lo = 0; c.ncz_held = c.ncz;
  if (window != nullptr) {
    c.z_off = window[0]; c.zc_lo = window[1]; c.ncz_held = window[2]; c.ncz = window[3];
    if (c.z_off < 0 || c.z_off % lsz || c.z_off / lsz < c.zc_lo ||
        (c.z_off + nz + lsz - 1) / lsz > c.zc_lo + c.ncz_held)
      return false;
  }
  c.min_sure = floats[0];
  *io = CentreIO{};
  io->vals = static_cast<const float*>(vals);
  io->occ_c = static_cast<const uint8_t*>(occ_c);
  io->census = static_cast<const int32_t*>(census);
  io->flags = static_cast<const uint8_t*>(flags);
  io->prev_sure = static_cast<const uint8_t*>(prev_sure);
  io->out = static_cast<float*>(out);
  io->safe = static_cast<uint8_t*>(safe);
  io->sure_out = static_cast<uint8_t*>(sure_out);
  io->c = c;
  io->ny = ny, io->nx = nx;
  io->w1 = floats[1], io->score = floats[2], io->thr_new = floats[3];
  return true;
}

}  // namespace

// vals: device f32 grid [n]; counts: int32 [n]; close: bool [n].  Outputs:
// out f32 [n], far bool [n], n_occupied int32 scalar (zeroed by the
// caller).  Returns cudaGetLastError().
VOFOD_API int vofod_point_ema(const void* vals, const void* counts, const void* close,
                              long long n, float score_point, float score_unknown,
                              void* out, void* far, void* n_occupied, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + EMA_T - 1) / EMA_T;
  point_ema_kernel<<<(unsigned int)blocks, EMA_T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(counts),
      static_cast<const uint8_t*>(close), n, score_point, score_unknown,
      static_cast<float*>(out), static_cast<uint8_t*>(far), static_cast<int*>(n_occupied));
  return (int)cudaGetLastError();
}

// vals: device f32 grid (nz, ny, nx); bg, safe: bool grids; sure_sufficient:
// bool scalar; table: the packed run table of the demotion ball
// (ops/morphology.RunTable, host int16 [table_len]); w1, c: the EMA v' = w1
// v + c.  out: f32 grid.  used: as vofod_ball_pool's.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a table it cannot take.
VOFOD_API int vofod_demote_ema(const void* vals, const void* bg, const void* safe,
                               const void* sure_sufficient, int nz, int ny, int nx,
                               const short* table, int table_len, float w1, float c,
                               void* out, int* used, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const DemoteIO io = demote_io(vals, bg, safe, sure_sufficient, nz, ny, nx, w1, c, out);
  return with_table(table, table_len, [&](const auto& t) {
    using Tab = std::decay_t<decltype(t)>;
    return launch_pool<int8_t>(demote_ema_kernel<Tab>, io, nz, ny, nx, t, used,
                               static_cast<cudaStream_t>(stream));
  });
}

// K13c.  vals: device f32 grid (nz, ny, nx); occ_c: bool coarse cells
// (ncz, ncy, ncx) with ncz = ceil(nz / lsz) etc.; census: int32 per cell
// (K13a's out); flags: uint8 [2] (K13a's any occ, any sure); prev_sure:
// bool scalar.  table: the demotion ball's packed run table; floats: host
// f32 [min_sure, w1, score_ray, thr_new_obstacles].  window: NULL (the whole
// grid), or host int32 [z_off, zc_lo, ncz_held, ncz]: the grid is the rows
// [z_off, z_off + nz) of a grid of ncz coarse rows, occ_c / census hold its
// coarse rows [zc_lo, zc_lo + ncz_held).  Outputs: out f32 grid, safe bool
// grid, sure_out bool scalar; used: as vofod_ball_pool's.  Returns
// cudaGetLastError().
VOFOD_API int vofod_exact_demote_ema(const void* vals, const void* occ_c, const void* census,
                                     const void* flags, const void* prev_sure, int nz, int ny,
                                     int nx, int lsz, const short* table, int table_len,
                                     const float* floats, const int* window, void* out,
                                     void* safe, void* sure_out, int* used, void* stream) {
  CentreIO io;
  if (!centre_io(vals, occ_c, census, flags, prev_sure, nz, ny, nx, lsz, floats, window, out,
                 safe, sure_out, &io))
    return (int)cudaErrorInvalidValue;
  return with_table(table, table_len, [&](const auto& t) {
    using Tab = std::decay_t<decltype(t)>;
    return launch_pool<int8_t>(exact_demote_kernel<Tab>, io, nz, ny, nx, t, used,
                               static_cast<cudaStream_t>(stream));
  });
}

// The wide forms (a ball past halo 7): host, dev, lens, dz and n_pieces
// as vofod_ball_pool_wide's; acc: NULL for one piece, else device scratch
// of (nz, ny, ceil(nx / 4)) 8-byte units.  Other arguments as the entries
// above.
VOFOD_API int vofod_demote_ema_wide(const void* vals, const void* bg, const void* safe,
                                    const void* sure_sufficient, int nz, int ny, int nx,
                                    const int* host, const int* dev, const int* lens,
                                    const int* dz, int n_pieces, float w1, float c, void* out,
                                    void* acc, int* used, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const DemoteIO io = demote_io(vals, bg, safe, sure_sufficient, nz, ny, nx, w1, c, out);
  return launch_wide_pieces<int8_t, 1>(demote_ema_wide_kernel<DemoteIO>,
                                       demote_ema_wide_kernel<PieceIO<int8_t, 1, DemoteIO>>, io,
                                       nz, ny, nx, host, dev, lens, dz, n_pieces, acc, used,
                                       static_cast<cudaStream_t>(stream));
}

VOFOD_API int vofod_exact_demote_ema_wide(const void* vals, const void* occ_c, const void* census,
                                          const void* flags, const void* prev_sure, int nz,
                                          int ny, int nx, int lsz, const int* host,
                                          const int* dev, const int* lens, const int* dz,
                                          int n_pieces, const float* floats, const int* window,
                                          void* out, void* safe, void* sure_out, void* acc,
                                          int* used, void* stream) {
  CentreIO io;
  if (!centre_io(vals, occ_c, census, flags, prev_sure, nz, ny, nx, lsz, floats, window, out,
                 safe, sure_out, &io))
    return (int)cudaErrorInvalidValue;
  return launch_wide_pieces<int8_t, 2>(exact_demote_wide_kernel<CentreIO>,
                                       exact_demote_wide_kernel<PieceIO<int8_t, 2, CentreIO>>,
                                       io, nz, ny, nx, host, dev, lens, dz, n_pieces, acc, used,
                                       static_cast<cudaStream_t>(stream));
}
