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
// Bound on the H100: memory — one read of the 2.47 MB bool mask per pass
// (two passes) against a few hundred launches' worth of latency; the ids
// written are at most 16 KB.  Three launches, no host sync, `total` stays a
// device scalar:
//   1. count: each block owns CHUNK = 4096 consecutive elements (16 per
//      thread, consecutive), counts them and stores its total;
//   2. scan: one block scans the ~600 block totals into block offsets,
//      stores `total`, `valid[q] = q < total` and zeroes ids[q >= total];
//   3. write: a block whose offset is already >= cap exits at once; the
//      others re-evaluate their elements, scan the per-thread counts and
//      write each set element's id at its global rank when that is < cap.
// The outputs are bit-equal to the plain version (ops/compaction.py).
#include "common.cuh"

namespace {

constexpr int CT = 256;             // threads per block
constexpr int PER_THREAD = 16;      // consecutive elements per thread
constexpr int CHUNK = CT * PER_THREAD;
constexpr int MAX_SEL = 32;
constexpr int SCAN_T = 1024;

struct Pred {
  const uint8_t* mask;
  const int32_t* labels;  // null: plain mask form
  const int32_t* sel;     // device [nsel]
  int nsel;
  long long n;
};

__device__ __forceinline__ void load_sel(const Pred& p, int32_t* sel_s) {
  if (p.labels != nullptr && threadIdx.x < p.nsel) sel_s[threadIdx.x] = p.sel[threadIdx.x];
  __syncthreads();
}

// Bits j of this thread's 16 consecutive elements that are set.
__device__ __forceinline__ unsigned thread_bits(const Pred& p, const int32_t* sel_s,
                                                long long first) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const long long i = first + j;
    if (i >= p.n || p.mask[i] == 0) continue;
    bool hit = true;
    if (p.labels != nullptr) {
      const int32_t l = p.labels[i];
      hit = false;
      for (int k = 0; k < p.nsel; ++k) hit |= sel_s[k] == l;
    }
    if (hit) bits |= 1u << j;
  }
  return bits;
}

// Exclusive block-wide prefix sum of v (CT threads); returns the block total
// through *total.
__device__ __forceinline__ int block_excl_scan(int v, int* warp_s, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_s[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int s = warp_s[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

__global__ void __launch_bounds__(CT) count_kernel(Pred p, int* __restrict__ block_tot) {
  __shared__ int32_t sel_s[MAX_SEL];
  __shared__ int warp_s[CT / 32];
  load_sel(p, sel_s);
  const long long first = (long long)blockIdx.x * CHUNK + (long long)threadIdx.x * PER_THREAD;
  const int c = __popc(thread_bits(p, sel_s, first));
  int total;
  block_excl_scan(c, warp_s, &total);
  if (threadIdx.x == 0) block_tot[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_T) scan_kernel(
    const int* __restrict__ block_tot, int* __restrict__ block_off, int nb, int cap,
    int* __restrict__ ids, uint8_t* __restrict__ valid, int* __restrict__ total_out) {
  __shared__ int warp_s[SCAN_T / 32];
  int carry = 0;
  for (int base = 0; base < nb; base += SCAN_T) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? block_tot[i] : 0;
    int tile;
    const int excl = block_excl_scan(v, warp_s, &tile);
    if (i < nb) block_off[i] = carry + excl;
    carry += tile;
  }
  if (threadIdx.x == 0) *total_out = carry;
  for (int q = threadIdx.x; q < cap; q += SCAN_T) {
    valid[q] = q < carry ? 1 : 0;
    if (q >= carry) ids[q] = 0;
  }
}

__global__ void __launch_bounds__(CT) write_kernel(
    Pred p, const int* __restrict__ block_off, int cap, int* __restrict__ ids) {
  const int off = block_off[blockIdx.x];
  if (off >= cap) return;  // every element here ranks past the capacity
  __shared__ int32_t sel_s[MAX_SEL];
  __shared__ int warp_s[CT / 32];
  load_sel(p, sel_s);
  const long long first = (long long)blockIdx.x * CHUNK + (long long)threadIdx.x * PER_THREAD;
  unsigned bits = thread_bits(p, sel_s, first);
  int total;
  int rank = off + block_excl_scan(__popc(bits), warp_s, &total);
  while (bits != 0 && rank < cap) {
    const int j = __ffs(bits) - 1;
    ids[rank++] = (int)(first + j);
    bits &= bits - 1;
  }
}

}  // namespace

// mask: device uint8/bool [n].  labels: device int32 [n] or null; with
// labels, an element is set when mask[i] && labels[i] is one of sel[0:nsel]
// (device int32, nsel <= 32).  scratch: device int32 [2 * nblocks] with
// nblocks = ceil(n / 4096).  Outputs: ids int32 [cap], valid uint8 [cap],
// total int32 scalar.  Returns cudaGetLastError().
VOFOD_API int vofod_compact(const void* mask, const void* labels, const void* sel, int nsel,
                            long long n, int cap, void* scratch, void* ids, void* valid,
                            void* total, void* stream) {
  if (n <= 0 || cap <= 0 || nsel < 0 || nsel > MAX_SEL || (labels != nullptr && sel == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long nb_ll = (n + CHUNK - 1) / CHUNK;
  if (nb_ll > 0x7fffffffLL || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nb = (int)nb_ll;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Pred p{static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(labels),
         static_cast<const int32_t*>(sel), labels != nullptr ? nsel : 0, n};
  int* tot = static_cast<int*>(scratch);
  int* off = tot + nb;
  count_kernel<<<nb, CT, 0, s>>>(p, tot);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  scan_kernel<<<1, SCAN_T, 0, s>>>(tot, off, nb, cap, static_cast<int*>(ids),
                                   static_cast<uint8_t*>(valid), static_cast<int*>(total));
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  write_kernel<<<nb, CT, 0, s>>>(p, off, cap, static_cast<int*>(ids));
  return (int)cudaGetLastError();
}
