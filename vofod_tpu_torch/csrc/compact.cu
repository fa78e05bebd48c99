// K6 — fixed-capacity stream compaction: the flat ids of the first `cap`
// set elements of a mask, ascending, plus the device count of all of them.
//
// Replaces vofod_tpu/ops/compaction.py `masked_compact` (block totals, a
// rank over block starts and a triangular MXU matmul per output slot) at
// its three call sites: the far voxels (2,470,491 -> 2048), the explore
// queries (2,470,491 -> 256) and the own-airframe hits (131,072 -> 4096).
// The query form also replaces the materialised query mask
// `far & isin(labels, sel)`: the predicate is evaluated in the kernel, with
// the K <= 32 selected labels in shared memory and the label grid read only
// where `far` is set.
//
// Bound on the H100: memory — one read of the 2.47 MB bool mask against
// launch latency and the look-back's chain; the ids written are at most
// 16 KB.  One launch, no memset, no host sync; `total` stays a device
// scalar.  A single-pass scan with decoupled look-back (csrc/lookback.cuh)
// over tiles of TILE mask bytes:
//
//   - the tiles cover the mask's bytes from the 16-byte boundary at or
//     below its start (a contiguous view may start at any byte): thread t
//     of a tile reads the VEC 16-byte chunks at t * 16, (CT + t) * 16, ...
//     (each warp-wide load 512 contiguous bytes), as one vector load where
//     the chunk lies inside the mask and byte by byte at its head and tail;
//     a block loads the chunks of tile blockIdx.x while it takes its
//     ticket, and again only when the ticket is another tile;
//   - the query form loads the labels of a thread's set elements
//     together, 16 at a time (predicated, unrolled), and tests each
//     against a 1,024-bit filter of the selection in shared memory; only
//     those that pass compare with the <= 32 selected labels;
//   - a thread's counts ride one 64-bit word, 16 bits a chunk, so one
//     block scan ranks every chunk; the tile publishes its count (every
//     tile: `total` counts every set element, past the capacity too) and
//     looks back for the count before it;
//   - a tile whose exclusive prefix is already >= cap writes no id; the
//     others write each set element's id at its rank when that is < cap;
//   - the last tile by ticket stores `total`, `valid[q] = q < total` and
//     ids[q] = 0 for total <= q < cap.
//
// The look-back state (ticket, one status word per tile) reads as zero at
// the start of every launch without a memset launch: the wrapper
// (kernels.masked_compact) keeps two state buffers per CUDA stream, zeroed
// once when they are made, and alternates them; each launch uses one and
// zeroes the other, which the launch before it (on the same stream, so
// finished) used.  No block waits for another to finish and no counter of
// finished tiles is kept.  Launches on one stream run in order, so each
// finds its buffer zeroed; the grid-sharded step's shards, each on its own
// stream (parallel/comm.LocalComm), run concurrently on buffers of their
// own.  The pair assumes eager launches, the host flipping it at each one:
// a captured CUDA graph would replay a fixed buffer order, so graph capture
// needs another scheme (an epoch tag in each status word, or the last tile
// clearing the state).  The outputs are bit-equal to the plain version (ops/compaction.py);
// `masked_compact_lookback_plain` there models this schedule.
#include "lookback.cuh"

namespace {

// kernels.COMPACT_THREADS and kernels.COMPACT_VEC hold the same values
constexpr int CT = 256;             // threads per tile
constexpr int VEC = 4;              // 16-byte chunks per thread (<= 4: 16-bit counts)
constexpr int TILE = CT * VEC * 16;  // mask bytes per tile
constexpr int MAX_SEL = 32;
static_assert(VEC >= 1 && VEC <= 4, "a thread's chunk counts are 16-bit fields of one u64");

struct Pred {
  const uint8_t* base;    // the mask's address rounded down to 16 bytes
  long long off;          // mask - base, 0-15
  long long n;
  const int32_t* labels;  // null: plain mask form; else indexed by element id
  int nsel;
};

// bit b of the result: byte b of w is nonzero
__device__ __forceinline__ unsigned int nonzero_bits4(unsigned int w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Whether the 16-byte chunk at aligned byte `pos` lies inside the mask.
__device__ __forceinline__ bool chunk_inside(const Pred& p, long long pos) {
  return pos >= p.off && pos - p.off + 16 <= p.n;
}

// The chunk at aligned byte `pos` as one vector load, where it lies inside
// the mask (zero elsewhere: chunk_bits reads those bytes one by one).
__device__ __forceinline__ uint4 chunk_load(const Pred& p, long long pos) {
  return chunk_inside(p, pos) ? *reinterpret_cast<const uint4*>(p.base + pos)
                              : make_uint4(0u, 0u, 0u, 0u);
}

// Bits j of the chunk at aligned byte `pos` (loaded as v) whose element
// pos - off + j is set in the mask.
__device__ __forceinline__ unsigned int chunk_bits(const Pred& p, long long pos, uint4 v) {
  if (chunk_inside(p, pos))
    return nonzero_bits4(v.x) | nonzero_bits4(v.y) << 4 | nonzero_bits4(v.z) << 8 |
           nonzero_bits4(v.w) << 12;
  unsigned int bits = 0;
  for (int j = 0; j < 16; ++j) {
    const long long i = pos - p.off + j;
    if (i >= 0 && i < p.n && p.base[pos + j] != 0) bits |= 1u << j;
  }
  return bits;
}

// The selection's filter: bit h(v) of a 1,024-bit map set for each
// selected label v.  A label whose bit is clear is not selected (one shared
// load); one whose bit is set is compared with every selected label.
__device__ __forceinline__ unsigned int sel_hash(int32_t v) {
  return ((unsigned int)v * 2654435761u) >> 22;
}

// The query form: of a thread's set elements (bit 16 k + j: element
// first + k * CT * 16 + j, chunk k), those whose label is selected.
// Sixteen at a time: their labels loaded together (predicated, unrolled),
// then tested against the filter together; only the elements that pass it
// compare labels.
__device__ __forceinline__ u64 select_labels(const Pred& p, const int32_t* sel_s,
                                             const unsigned int* filt_s, long long first,
                                             u64 bits) {
  u64 keep = 0;
  for (u64 rest = bits; rest != 0;) {
    int b[16];
    int32_t l[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      b[i] = rest != 0 ? __ffsll((long long)rest) - 1 : -1;
      rest &= rest - 1;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      l[i] = b[i] >= 0 ? __ldg(p.labels + first + (b[i] >> 4) * (CT * 16) + (b[i] & 15)) : 0;
    unsigned int pass = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const unsigned int h = sel_hash(l[i]);
      pass |= (unsigned int)(b[i] >= 0 && (filt_s[h >> 5] >> (h & 31)) & 1u) << i;
    }
    for (; pass != 0; pass &= pass - 1) {
      const int i = __ffs(pass) - 1;
      int32_t v = 0;
      int bi = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k)  // l[i], b[i] without a dynamic register index
        if (k == i) v = l[k], bi = b[k];
      bool hit = false;
      for (int k = 0; k < p.nsel; ++k) hit |= sel_s[k] == v;
      if (hit) keep |= 1ull << bi;
    }
  }
  return keep;
}

// state: [0] ticket, [1, 1 + ntiles) status words, zero; other: the other
// buffer of the stream's pair, other_words words, zeroed here
__global__ void __launch_bounds__(CT)
    compact_kernel(Pred p, const int32_t* __restrict__ sel, int ntiles, int cap,
                   int* __restrict__ ids, uint8_t* __restrict__ valid, int* __restrict__ total,
                   u64* state, u64* __restrict__ other, int other_words) {
  __shared__ int32_t sel_s[MAX_SEL];
  __shared__ unsigned int filt_s[32];
  __shared__ u64 warp_s[CT / 32];
  __shared__ u64 s_excl;
  __shared__ int s_tile;
  for (int i = blockIdx.x * CT + threadIdx.x; i < other_words; i += gridDim.x * CT) other[i] = 0;
  if (p.labels != nullptr) {
    if (threadIdx.x < 32) filt_s[threadIdx.x] = 0;
    if (threadIdx.x < p.nsel) sel_s[threadIdx.x] = sel[threadIdx.x];
  }
  // the chunks of tile blockIdx.x, loaded while the ticket is taken: the
  // ticket is most often that tile (else they are loaded again)
  uint4 raw[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    raw[k] = chunk_load(p, ((long long)blockIdx.x * VEC + k) * CT * 16 + threadIdx.x * 16);
  const int tile = take_tile(state, &s_tile);  // its barrier publishes sel_s
  const long long pos0 = (long long)tile * TILE + (long long)threadIdx.x * 16;
  if (tile != (int)blockIdx.x) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) raw[k] = chunk_load(p, pos0 + (long long)k * CT * 16);
  }
  if (p.labels != nullptr) {
    if (threadIdx.x < p.nsel) {
      const unsigned int h = sel_hash(sel_s[threadIdx.x]);
      atomicOr(filt_s + (h >> 5), 1u << (h & 31));
    }
    __syncthreads();
  }
  unsigned int bits[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) bits[k] = chunk_bits(p, pos0 + (long long)k * CT * 16, raw[k]);
  if (p.labels != nullptr) {
    u64 all = 0;
#pragma unroll
    for (int k = 0; k < VEC; ++k) all |= (u64)bits[k] << (16 * k);
    all = select_labels(p, sel_s, filt_s, pos0 - p.off, all);
#pragma unroll
    for (int k = 0; k < VEC; ++k) bits[k] = (unsigned int)(all >> (16 * k)) & 0xffffu;
  }
  u64 packed = 0;  // 16 bits a chunk: its count
#pragma unroll
  for (int k = 0; k < VEC; ++k) packed |= (u64)__popc(bits[k]) << (16 * k);
  u64 tile_packed;
  const u64 excl_packed = block_excl_scan<u64>(packed, warp_s, &tile_packed);
  u64 agg = 0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) agg += (tile_packed >> (16 * k)) & 0xffffu;
  const u64 before = look_back(state + 1, tile, agg, &s_excl);

  if (before < (u64)cap) {
    u64 chunk_base = before;  // the count before chunk k of the tile
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      u64 rank = chunk_base + ((excl_packed >> (16 * k)) & 0xffffu);
      const long long first = pos0 + (long long)k * CT * 16 - p.off;
      for (unsigned int b = bits[k]; b != 0 && rank < (u64)cap; b &= b - 1)
        ids[rank++] = (int)(first + __ffs(b) - 1);
      chunk_base += (tile_packed >> (16 * k)) & 0xffffu;
    }
  }
  if (tile == ntiles - 1) {
    const u64 t = before + agg;
    if (threadIdx.x == 0) *total = (int)t;
    for (int q = threadIdx.x; q < cap; q += CT) {
      valid[q] = (u64)q < t ? 1 : 0;
      if ((u64)q >= t) ids[q] = 0;
    }
  }
}

inline long long compact_tiles(const void* mask, long long n) {
  return (n + (long long)(reinterpret_cast<uintptr_t>(mask) & 15) + TILE - 1) / TILE;
}

}  // namespace

// K6's geometry: out int [2] = (mask bytes per tile, blocks the current
// device holds resident at once).  Returns a CUDA error code.
VOFOD_API int vofod_compact_geometry(int* out) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, compact_kernel, CT, 0);
  out[0] = TILE;
  out[1] = per * sms;
  return (int)e;
}

// mask: device uint8/bool [n], any byte alignment.  labels: device int32
// [n] or null; with labels, an element is set when mask[i] && labels[i] is
// one of sel[0:nsel] (device int32, nsel <= 32).  state, other: the
// stream's two look-back buffers, device int64 [words] each, with words >=
// 1 + the launch's tiles (ceil((n + mask % 16) / tile)): state zero (used
// here), other zeroed here for the next launch.  Outputs: ids int32 [cap],
// valid uint8 [cap], total int32 scalar.  One launch.  Returns
// cudaGetLastError().
VOFOD_API int vofod_compact(const void* mask, const void* labels, const void* sel, int nsel,
                            long long n, int cap, void* state, void* other, long long words,
                            void* ids, void* valid, void* total, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL || cap <= 0 || nsel < 0 || nsel > MAX_SEL ||
      (labels != nullptr && sel == nullptr) || words > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long ntiles = compact_tiles(mask, n);
  if (words < ntiles + 1) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  Pred p{reinterpret_cast<const uint8_t*>(addr & ~(uintptr_t)15), (long long)(addr & 15), n,
         static_cast<const int32_t*>(labels), labels != nullptr ? nsel : 0};
  compact_kernel<<<(unsigned int)ntiles, CT, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t*>(sel), (int)ntiles, cap, static_cast<int*>(ids),
      static_cast<uint8_t*>(valid), static_cast<int*>(total), static_cast<u64*>(state),
      static_cast<u64*>(other), (int)words);
  return (int)cudaGetLastError();
}
