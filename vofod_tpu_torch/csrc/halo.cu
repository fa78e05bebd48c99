// K15b-1 / K15b-2 — the halo kernels of the grid-sharded step.
//
// The grid is sharded along z, its leading axis, so a shard holds a slab of
// nzl whole planes and every block of rows it sends or receives is
// contiguous.  The rows themselves travel between shards as one copy each
// (vofod_tpu_torch/parallel/comm.py LocalComm.ppermutes); these kernels
// assemble and fold what arrived.
//
// K15b-1 `vofod_halo_exchange` replaces vofod_tpu/parallel/gridops.py
// ZShardOps.halo_exchange (:241): the slab extended by r rows of the
// neighbours' content on each side.  Hop h (1-based) brings min(nzl, rows
// still needed) rows from the shard h away: its LAST rows on the low side,
// its FIRST rows on the high side, so r > nzl takes several hops.  A hop
// with no shard that far (past the global edge) reads `fill`.  One launch
// writes the whole extended slab: each output element picks its source
// (the local slab, a received block or the fill) from its row alone.
//
// K15b-2 `vofod_halo_fold_min` replaces ZShardOps.halo_fold_min (:275):
// the inverse for min-combining writes (the explore's demotions).  The
// updated halo rows went back to their owners; each owner takes the
// elementwise min of its interior and every block it got back: from the
// shard h above onto its last take_h rows, from the shard h below onto its
// first take_h rows.  When 2 take_h > nzl those ranges overlap, so every
// block is min-ed in (a plain store of one would drop the other's min).
// The min is torch.minimum's (a NaN on either side gives NaN), so the
// order of the blocks does not matter.
//
// Bound on the H100: bytes.  K15b-1 reads the slab and the received rows
// once and writes the extended slab once; K15b-2 reads the extended slab's
// interior and the returned rows once and writes the interior once.  Both
// are grid-stride elementwise passes with no shared memory.
#include "common.cuh"

namespace {

constexpr int HALO_T = 256;
constexpr int MAX_HOPS = 16;

// The received blocks of every hop: `lo[h]` / `hi[h]` (device pointers,
// NULL = no shard that far: the fill, or for the fold nothing to min in),
// each of take[h] rows.
struct HaloBlocks {
  const void* lo[MAX_HOPS];
  const void* hi[MAX_HOPS];
  int take[MAX_HOPS];
  int hops;
};

template <typename T>
__global__ void __launch_bounds__(HALO_T)
    halo_exchange_kernel(const T* __restrict__ g, T* __restrict__ ext, HaloBlocks b, int nzl,
                         int r, long long plane, T fill) {
  const long long n = (long long)(nzl + 2 * r) * plane;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(i / plane);
    const long long off = i - (long long)row * plane;
    T v;
    if (row >= r && row < r + nzl) {
      v = g[(long long)(row - r) * plane + off];
    } else if (row < r) {
      const int d = r - row;  // 1 .. r rows below the interior
      const int h = (d - 1) / nzl;  // every hop but the last brings nzl rows
      const T* src = static_cast<const T*>(b.lo[h]);
      v = src != nullptr ? src[(long long)(b.take[h] - (d - h * nzl)) * plane + off] : fill;
    } else {
      const int d = row - r - nzl;  // 0 .. r-1 rows above the interior
      const int h = d / nzl;
      const T* src = static_cast<const T*>(b.hi[h]);
      v = src != nullptr ? src[(long long)(d - h * nzl) * plane + off] : fill;
    }
    ext[i] = v;
  }
}

// torch.minimum: NaN when either side is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return b < a ? b : a;
}

// b.lo[h]: the block from the shard h above (onto rows [nzl - take, nzl));
// b.hi[h]: the block from the shard h below (onto rows [0, take)).
__global__ void __launch_bounds__(HALO_T)
    halo_fold_min_kernel(const float* __restrict__ ext, float* __restrict__ out, HaloBlocks b,
                         int nzl, int r, long long plane) {
  const long long n = (long long)nzl * plane;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int z = (int)(i / plane);
    const long long off = i - (long long)z * plane;
    float v = ext[(long long)(r + z) * plane + off];
    for (int h = 0; h < b.hops; ++h) {
      const int take = b.take[h];
      const float* from_next = static_cast<const float*>(b.lo[h]);
      const float* from_prev = static_cast<const float*>(b.hi[h]);
      if (from_next != nullptr && z >= nzl - take)
        v = min_nan(v, from_next[(long long)(z - (nzl - take)) * plane + off]);
      if (from_prev != nullptr && z < take) v = min_nan(v, from_prev[(long long)z * plane + off]);
    }
    out[i] = v;
  }
}

unsigned grid_blocks(long long n) {
  const long long b = (n + HALO_T - 1) / HALO_T;
  return (unsigned)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

bool blocks_ok(const void* const* lo, const void* const* hi, const int* take, int hops, int nzl,
               HaloBlocks* out) {
  if (hops < 0 || hops > MAX_HOPS) return false;
  out->hops = hops;
  for (int h = 0; h < hops; ++h) {
    if (take[h] < 1 || take[h] > nzl) return false;
    out->lo[h] = lo[h];
    out->hi[h] = hi[h];
    out->take[h] = take[h];
  }
  return true;
}

}  // namespace

// g: device slab [nzl, plane] of `elem` bytes per element (1 or 4); ext:
// device [nzl + 2r, plane].  lo / hi / take: host arrays of `hops` entries
// (device pointers, NULL = fill; rows per hop).  fill: the element's bit
// pattern.  Returns cudaGetLastError().
VOFOD_API int vofod_halo_exchange(const void* g, void* ext, int elem, int nzl, int r,
                                  long long plane, const void* const* lo,
                                  const void* const* hi, const int* take, int hops,
                                  unsigned int fill, void* stream) {
  HaloBlocks b;
  if (nzl < 1 || r < 0 || plane < 1 || !blocks_ok(lo, hi, take, hops, nzl, &b))
    return (int)cudaErrorInvalidValue;
  int need = r;
  for (int h = 0; h < hops; ++h) need -= take[h];
  if (need != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = grid_blocks((long long)(nzl + 2 * r) * plane);
  if (elem == 4) {
    halo_exchange_kernel<uint32_t><<<blocks, HALO_T, 0, s>>>(
        static_cast<const uint32_t*>(g), static_cast<uint32_t*>(ext), b, nzl, r, plane, fill);
  } else if (elem == 1) {
    halo_exchange_kernel<uint8_t><<<blocks, HALO_T, 0, s>>>(
        static_cast<const uint8_t*>(g), static_cast<uint8_t*>(ext), b, nzl, r, plane,
        (uint8_t)fill);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ext: device f32 [nzl + 2r, plane]; out: device f32 [nzl, plane].
// from_next / from_prev / take: host arrays of `hops` entries (device
// pointers of the blocks sent back by the shard h above / below, NULL =
// none).  Returns cudaGetLastError().
VOFOD_API int vofod_halo_fold_min(const void* ext, void* out, int nzl, int r, long long plane,
                                  const void* const* from_next, const void* const* from_prev,
                                  const int* take, int hops, void* stream) {
  HaloBlocks b;
  if (nzl < 1 || r < 0 || plane < 1 || !blocks_ok(from_next, from_prev, take, hops, nzl, &b))
    return (int)cudaErrorInvalidValue;
  halo_fold_min_kernel<<<grid_blocks((long long)nzl * plane), HALO_T, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ext), static_cast<float*>(out), b, nzl, r, plane);
  return (int)cudaGetLastError();
}
