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
// neighbours' content on each side.  Hop h (0-based) brings take[h] rows
// from the shard h + 1 away: its LAST rows on the low side, its FIRST rows
// on the high side, nearest hop innermost, so r > nzl takes several hops.
// A hop with no shard that far (past the global edge) reads `fill`.
//
// Design (bound: bytes).  The extended slab is a run of contiguous
// segments: the low hops' blocks (farthest first), the interior, the high
// hops' blocks.  Each is one byte range copied from one source or filled
// with one pattern, whatever the dtype.  The host cuts every segment into
// tiles of TILE_CHUNKS 16-byte chunks of the destination and launches one
// block a tile, so a block's source is uniform and no element divides or
// branches.  A chunk is one 16-byte store; its load is one 16-byte load
// where source and destination agree mod 16, else four or five aligned
// 4-byte loads funnel-shifted into place (a row of 48,441 voxels is 193,764
// bytes, 4 mod 16, so most rows start misaligned).  The bytes before the
// first and after the last whole chunk (at most 15 each) go one a thread in
// a segment's first tile.  The in-place form (g NULL) skips the interior:
// the sharded K2 sweeps keep the slab in a halo'd buffer and fill only its
// 2r halo rows before each sweep.  The plain model of the table is
// vofod_tpu_torch/parallel/gridops.py halo_segments.
//
// K15b-2 `vofod_halo_fold_min` replaces ZShardOps.halo_fold_min (:275):
// the inverse for min-combining writes (the explore's demotions).  The
// updated halo rows went back to their owners; each owner takes the
// elementwise min of its interior and every block it got back: from the
// shard h above onto its last take_h rows, from the shard h below onto its
// first take_h rows.  When 2 take_h > nzl those ranges overlap, so every
// block is min-ed in (a plain store of one would drop the other's min).
// The min is torch.minimum's (a NaN on either side gives NaN), so the
// order of the blocks does not matter.  A grid-stride elementwise pass that
// reads the interior and the returned rows once and writes the interior
// once.
//
// Both take the hop table packed as `hops` 64-bit triples (lo pointer, hi
// pointer, rows; a NULL pointer = no shard that far).
#include "common.cuh"

namespace {

constexpr int HALO_T = 256;
constexpr int MAX_HOPS = 16;
constexpr int MAX_SEGS = 2 * MAX_HOPS + 1;
constexpr int CHUNKS_PER_THREAD = 2;
constexpr long long TILE_CHUNKS = (long long)HALO_T * CHUNKS_PER_THREAD;  // 8 KiB a tile

// The received blocks of every hop: `lo[h]` / `hi[h]` (device pointers,
// NULL = no shard that far: the fill, or for the fold nothing to min in),
// each of take[h] rows.
struct HaloBlocks {
  const void* lo[MAX_HOPS];
  const void* hi[MAX_HOPS];
  int take[MAX_HOPS];
  int hops;
};

// One contiguous byte range of the extended slab and its source (NULL:
// the fill pattern).  dst + bytes never crosses the slab's end.
struct Seg {
  const unsigned char* src;
  unsigned char* dst;
  long long bytes;
};

// Passed by value: 33 segments, ~1 KB of kernel parameters.
struct SegTable {
  Seg seg[MAX_SEGS];
  int tile_end[MAX_SEGS];  // inclusive prefix of the segments' tiles
  int n;
  unsigned int fill;  // byte (a & 3) of it is the fill's byte at address a
};

// The segment's whole 16-byte chunks [v0, v1) of the destination; the
// rest are its head [d0, v0) and tail [v1, d1).  Mirrored by halo_segments.
__host__ __device__ inline void chunk_span(uintptr_t d0, uintptr_t d1, uintptr_t* v0,
                                           uintptr_t* v1) {
  uintptr_t a = (d0 + 15) & ~(uintptr_t)15, b = d1 & ~(uintptr_t)15;
  if (a > b) a = b = d1;  // no whole chunk: every byte is head
  *v0 = a;
  *v1 = b;
}

// 16 source bytes at p into a register chunk.  mode (uniform per
// segment): 0 p 16-aligned, 1 p 4-aligned, 2 otherwise.  Mode 2 reads the
// aligned words holding p .. p + 15 only, so it never leaves the source's
// 4-byte words.
__device__ __forceinline__ uint4 load_chunk(const unsigned char* p, int mode) {
  if (mode == 0) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned* w = reinterpret_cast<const unsigned*>((uintptr_t)p & ~(uintptr_t)3);
  unsigned a = __ldg(w), b = __ldg(w + 1), c = __ldg(w + 2), d = __ldg(w + 3);
  if (mode == 1) return make_uint4(a, b, c, d);
  const unsigned e = __ldg(w + 4);
  const unsigned s = 8u * (unsigned)((uintptr_t)p & 3);
  return make_uint4(__funnelshift_r(a, b, s), __funnelshift_r(b, c, s), __funnelshift_r(c, d, s),
                    __funnelshift_r(d, e, s));
}

__global__ void __launch_bounds__(HALO_T) halo_exchange_kernel(const SegTable t) {
  int s = 0;
  while ((int)blockIdx.x >= t.tile_end[s]) ++s;  // uniform in the block
  const int tile = (int)blockIdx.x - (s ? t.tile_end[s - 1] : 0);
  const Seg g = t.seg[s];
  const uintptr_t d0 = (uintptr_t)g.dst, d1 = d0 + g.bytes;
  uintptr_t v0, v1;
  chunk_span(d0, d1, &v0, &v1);
  const long long shift = (long long)((uintptr_t)g.src) - (long long)d0;  // src = dst + shift
  if (tile == 0) {
    const int head = (int)(v0 - d0), edge = head + (int)(d1 - v1);
    if ((int)threadIdx.x < edge) {
      const uintptr_t a = (int)threadIdx.x < head ? d0 + threadIdx.x : v1 + (threadIdx.x - head);
      *reinterpret_cast<unsigned char*>(a) =
          g.src ? *reinterpret_cast<const unsigned char*>(a + shift)
                : (unsigned char)(t.fill >> (8u * (unsigned)(a & 3)));
    }
  }
  const long long chunks = (long long)(v1 - v0) / 16;
  const long long c0 = (long long)tile * TILE_CHUNKS + threadIdx.x;
  uint4 v[CHUNKS_PER_THREAD];
  if (g.src) {
    const uintptr_t sv0 = v0 + shift;
    const int mode = (sv0 & 15) == 0 ? 0 : (sv0 & 3) == 0 ? 1 : 2;
#pragma unroll
    for (int u = 0; u < CHUNKS_PER_THREAD; ++u) {
      const long long c = c0 + (long long)u * HALO_T;
      if (c < chunks) v[u] = load_chunk(reinterpret_cast<const unsigned char*>(sv0 + 16 * c), mode);
    }
  } else {
#pragma unroll
    for (int u = 0; u < CHUNKS_PER_THREAD; ++u) v[u] = make_uint4(t.fill, t.fill, t.fill, t.fill);
  }
#pragma unroll
  for (int u = 0; u < CHUNKS_PER_THREAD; ++u) {
    const long long c = c0 + (long long)u * HALO_T;
    if (c < chunks) *reinterpret_cast<uint4*>(v0 + 16 * c) = v[u];
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

// The packed hop table into HaloBlocks: 1 <= take <= nzl, the rows summing
// to r (the exchange) or to at most r (the fold: no hop past the edges).
bool blocks_ok(const long long* hops, int n, int nzl, int r, bool exact, HaloBlocks* out) {
  if (n < 0 || n > MAX_HOPS) return false;
  out->hops = n;
  long long need = r;
  for (int h = 0; h < n; ++h) {
    const long long take = hops[3 * h + 2];
    if (take < 1 || take > nzl) return false;
    out->lo[h] = reinterpret_cast<const void*>(hops[3 * h]);
    out->hi[h] = reinterpret_cast<const void*>(hops[3 * h + 1]);
    out->take[h] = (int)take;
    need -= take;
  }
  return exact ? need == 0 : need >= 0;
}

}  // namespace

// The tile a thread block covers and the blocks the card holds resident
// at once: out[0] = bytes a tile, out[1] = resident blocks.
VOFOD_API int vofod_halo_geometry(int* out) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, halo_exchange_kernel, HALO_T, 0);
  out[0] = (int)(TILE_CHUNKS * 16);
  out[1] = per * sms;
  return (int)e;
}

// g: device slab [nzl, plane] of `elem` (1 or 4) bytes an element, or NULL: fill
// only the 2r halo rows of ext in place.  ext: device [nzl + 2r, plane],
// `elem`-aligned.  hops: the packed hop table (host).  fill: the
// element's bit pattern.  Returns cudaGetLastError(); launches nothing
// when there is nothing to write.
VOFOD_API int vofod_halo_exchange(const void* g, void* ext, int elem, int nzl, int r,
                                  long long plane, const long long* hops, int nhops,
                                  unsigned int fill, void* stream) {
  HaloBlocks b;
  if (nzl < 1 || r < 0 || plane < 1 || (elem != 1 && elem != 4) ||
      ((uintptr_t)ext % elem) != 0 || !blocks_ok(hops, nhops, nzl, r, true, &b))
    return (int)cudaErrorInvalidValue;
  SegTable t;
  t.n = 0;
  t.fill = elem == 4 ? fill : (fill & 0xFFu) * 0x01010101u;
  const long long row = plane * elem;
  unsigned char* base = static_cast<unsigned char*>(ext);
  auto add = [&](const void* src, long long row0, long long rows) {
    t.seg[t.n++] = Seg{static_cast<const unsigned char*>(src), base + row0 * row, rows * row};
  };
  int below[MAX_HOPS];  // rows of the hops nearer than h
  for (int h = 0, acc = 0; h < nhops; acc += b.take[h], ++h) below[h] = acc;
  for (int h = nhops - 1; h >= 0; --h) add(b.lo[h], r - below[h] - b.take[h], b.take[h]);
  if (g != nullptr) add(g, r, nzl);
  for (int h = 0; h < nhops; ++h) add(b.hi[h], r + nzl + below[h], b.take[h]);
  long long tiles = 0;
  for (int s = 0; s < t.n; ++s) {
    uintptr_t v0, v1;
    const uintptr_t d0 = (uintptr_t)t.seg[s].dst;
    chunk_span(d0, d0 + t.seg[s].bytes, &v0, &v1);
    const long long chunks = (long long)(v1 - v0) / 16;
    tiles += chunks > 0 ? (chunks + TILE_CHUNKS - 1) / TILE_CHUNKS : 1;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    t.tile_end[s] = (int)tiles;
  }
  if (tiles == 0) return (int)cudaSuccess;
  halo_exchange_kernel<<<(unsigned)tiles, HALO_T, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}

// ext: device f32 [nzl + 2r, plane]; out: device f32 [nzl, plane].  hops:
// the packed hop table (host): per hop the blocks sent back by the shard
// h above (lo) and below (hi), NULL = none.  Returns cudaGetLastError().
VOFOD_API int vofod_halo_fold_min(const void* ext, void* out, int nzl, int r, long long plane,
                                  const long long* hops, int nhops, void* stream) {
  HaloBlocks b;
  if (nzl < 1 || r < 0 || plane < 1 || !blocks_ok(hops, nhops, nzl, r, false, &b))
    return (int)cudaErrorInvalidValue;
  halo_fold_min_kernel<<<grid_blocks((long long)nzl * plane), HALO_T, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ext), static_cast<float*>(out), b, nzl, r, plane);
  return (int)cudaGetLastError();
}
