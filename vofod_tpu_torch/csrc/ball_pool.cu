// K1 — Euclidean-ball min / max / sum stencil over the (nz, ny, nx) grid.
//
// Replaces vofod_tpu/ops/morphology.py `_ball_pool` (via ball_pool_min /
// ball_pool_max / ball_pool_sum), which XLA runs as ~35 shifted full-grid
// passes (x running pools + one combine per (dz, dy) row).
//
// K14 — the traced-shell pools of vofod_tpu/ops/morphology.py
// `_ball_pool_traced` (`ball_pool_{min,max,sum}_traced`, cfg.dynamic_radii)
// — and the compat hasCloseTo box (`hascloseto_pool_any`) are this kernel
// with other tap sets (ops/morphology.shell_taps, hascloseto_taps).
//
// Bound on the H100: instruction issue and latency, not bytes.  One pass
// over the flagship grid (51 x 201 x 241 = 2.47 M voxels) moves 4.9 MB
// (int8) or 19.8 MB (int32), 1.5 or 5.9 us at 3.35 TB/s.  The first
// version of this kernel walked all 123 taps of a radius-3 ball per voxel
// from a staged box, ~1,100-1,400 instructions a voxel, and took 0.175 ms.
// This design cuts the work a voxel and keeps every SM busy:
//
// - Runs, not taps.  The host (ops/morphology.RunTable) cuts the tap set
//   into x-runs (dz, dy, lo, hi), each tap in one run, and lists the
//   distinct (lo, hi) pairs.  Each staged input row is pooled once per
//   pair from a window of its elements held in registers: the symmetric
//   pairs (-w, w) on one chain, 2 combines a width as the JAX x pools,
//   any other pair element by element.
// - Equal z slices once.  The rows (dy, pair) of one dz form a slice; a
//   ball's slices at dz and -dz are equal, so each distinct slice combines
//   its rows' pools once and feeds every output plane it belongs to.
//   Radius 3: 6 + 18 + 7 combines a voxel instead of 123.
// - Streamed along z.  A block owns a 16-row column tile and a chunk of z
//   planes.  It stages each input plane of the chunk once (plus `halo`
//   planes on each side, the halo rows and 8 columns each side) into a
//   double-buffered shared plane, loading plane p + 3 into registers while
//   it pools plane p + 1 and combines the rows of plane p, one barrier a
//   step; the 2 halo + 1 output planes in flight sit in registers, and
//   plane z is stored once plane z + halo is pooled.  The chunk is chosen
//   at launch from the card's occupancy (auto_zchunk).
// - int8 as 16-bit pairs: min / max of sign-extended s16x2 words (the
//   H100's DPX instructions; a packed-byte __vmaxs4 is emulated in six),
//   each pair taken from the staged bytes by one prmt.  int32 sums wrap
//   like XLA's add.
// - Out-of-grid voxels are staged as `fill`, whole planes beyond z too, so
//   a run clipped at the grid edge combines the fill exactly as the plain
//   version's padding does.
// - One kernel for every tap set within halo 7: the table travels in the
//   kernel parameters, in a tiny struct (halo 1: 3 accumulators), a small
//   one (the production radii) or a large one (ball_pool.cuh with_table);
//   the pools of 8 pairs sit in shared memory at once, more pairs take
//   turns, and a block above 48 KB of shared memory opts in first.
// - Past halo 7 (vofod_ball_pool_wide), the wide form of ball_pool.cuh:
//   the set cut into pieces within halo 7 on every axis, one launch of
//   the same body a piece with its staging shifted by the piece's centre,
//   each folding its pool into a scratch of units, the last storing.  The
//   flagship's production radii never take it.
//
// Integer min / max / sum are exact in any order, so the output is
// bit-equal to the JAX decomposition and to the plain PyTorch version;
// ops/morphology.ball_pool_runs_plain is the plain model of this schedule.
// The kernel body is ball_pool.cuh's pool_stream, shared with the demotion
// EMAs of csrc/ema.cu: here it stages the input and stores the pool.
#include "ball_pool.cuh"

namespace {

// K1's staging and store: the input grid, out-of-grid cells read `fill`;
// the pooled unit stored as it is
template <typename T>
struct PoolIO {
  const T* __restrict__ in;
  T* __restrict__ out;
  int nz, ny, nx;
  T none;  // the fill
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
  using Raw = T;
  __device__ __forceinline__ T load(long long i) const { return __ldg(in + i); }
  __device__ __forceinline__ T stage(T v) const { return v; }
  static constexpr bool SKIP = false;
  __device__ __forceinline__ bool row_any(int, int, int, int) const { return true; }
  template <typename V>
  __device__ __forceinline__ void store(int zo, int gy, int gx, const V& v) const {
    store_unit<Lanes<T>::NW>(out + ((size_t)zo * ny + gy) * nx, gx, nx, v);
  }
};

template <typename T, int OP, typename Tab>
__global__ void __launch_bounds__(Lanes<T>::TXU* Lanes<T>::TY)
    ball_pool_kernel(PoolIO<T> io, int nz, int ny, int nx, int zchunk,
                     const __grid_constant__ Tab tab) {
  pool_stream<T, OP>(io, nz, ny, nx, zchunk, tab);
}

template <typename T, int OP>
__global__ void __launch_bounds__(Lanes<T>::TXU* Lanes<T>::TY)
    ball_pool_wide_kernel(PieceIO<T, OP, PoolIO<T>> io, int nz, int ny, int nx, int zchunk,
                          const __grid_constant__ RunTableLarge tab) {
  pool_stream<T, OP>(io, nz, ny, nx, zchunk, tab);
}

template <typename T, int OP>
int launch_wide(const void* in, void* out, int nz, int ny, int nx, const short* tables,
                const int* lens, const int* shifts, int n, int fill, void* acc, int* used,
                cudaStream_t stream) {
  const PoolIO<T> io{static_cast<const T*>(in), static_cast<T*>(out), nz, ny, nx, (T)fill};
  return launch_pieces<T, OP>(ball_pool_wide_kernel<T, OP>, io, nz, ny, nx, tables, lens, shifts,
                              n, acc, used, stream);
}

template <typename T, int OP, typename Tab>
int launch(const void* in, void* out, int nz, int ny, int nx, const Tab& tab, int fill,
           int* used, cudaStream_t stream) {
  const PoolIO<T> io{static_cast<const T*>(in), static_cast<T*>(out), nz, ny, nx, (T)fill};
  return launch_pool<T>(ball_pool_kernel<T, OP, Tab>, io, nz, ny, nx, tab, used, stream);
}

template <typename Tab>
int dispatch(const void* in, void* out, int dtype, int op, int nz, int ny, int nx,
             const Tab& t, int fill, int* used, cudaStream_t s) {
  if (dtype == 0) {
    if (op == 0) return launch<int8_t, 0>(in, out, nz, ny, nx, t, fill, used, s);
    if (op == 1) return launch<int8_t, 1>(in, out, nz, ny, nx, t, fill, used, s);
  } else if (dtype == 1) {
    if (op == 0) return launch<int32_t, 0>(in, out, nz, ny, nx, t, fill, used, s);
    if (op == 1) return launch<int32_t, 1>(in, out, nz, ny, nx, t, fill, used, s);
    if (op == 2) return launch<int32_t, 2>(in, out, nz, ny, nx, t, fill, used, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = int8, 1 = int32.  op: 0 = min, 1 = max, 2 = sum (int32 only).
// table: the packed run table of ops/morphology.RunTable (host int16
// [table_len]); used: if not null, receives the z chunk, the blocks
// launched and the resident blocks an SM.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a table the kernel cannot take.
VOFOD_API int vofod_ball_pool(const void* in, void* out, int dtype, int op, int nz, int ny,
                              int nx, const short* table, int table_len, int fill, int* used,
                              void* stream) {
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  return with_table(table, table_len, [&](const auto& t) {
    return dispatch(in, out, dtype, op, nz, ny, nx, t, fill, used,
                    static_cast<cudaStream_t>(stream));
  });
}

// The wide form: a tap set past halo 7 as n_pieces packed tables within
// halo 7 (ops/morphology.WideTable: tables back to back, host int16; lens:
// host int32 [n_pieces]; shifts: host int32 [n_pieces, 3], each piece's
// centre (dz, dy, dx)), one launch a piece in order.  acc: device scratch
// of (nz, ny, ceil(nx / 8)) 16-byte units (int8) or (nz, ny, ceil(nx /
// 4)) (int32).  Other arguments as vofod_ball_pool's; used: the first
// piece's schedule.
VOFOD_API int vofod_ball_pool_wide(const void* in, void* out, int dtype, int op, int nz, int ny,
                                   int nx, const short* tables, const int* lens,
                                   const int* shifts, int n_pieces, int fill, void* acc,
                                   int* used, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (op == 0)
      return launch_wide<int8_t, 0>(in, out, nz, ny, nx, tables, lens, shifts, n_pieces, fill,
                                    acc, used, s);
    if (op == 1)
      return launch_wide<int8_t, 1>(in, out, nz, ny, nx, tables, lens, shifts, n_pieces, fill,
                                    acc, used, s);
  } else if (dtype == 1) {
    if (op == 0)
      return launch_wide<int32_t, 0>(in, out, nz, ny, nx, tables, lens, shifts, n_pieces, fill,
                                     acc, used, s);
    if (op == 1)
      return launch_wide<int32_t, 1>(in, out, nz, ny, nx, tables, lens, shifts, n_pieces, fill,
                                     acc, used, s);
    if (op == 2)
      return launch_wide<int32_t, 2>(in, out, nz, ny, nx, tables, lens, shifts, n_pieces, fill,
                                     acc, used, s);
  }
  return (int)cudaErrorInvalidValue;
}
