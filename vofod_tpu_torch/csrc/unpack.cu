// K15a — the device half of the prebinned ingest: unpack the host-binned
// uint8 grid into the frontend's count and blocker grids.
//
// Replaces vofod_tpu/pipeline/frontend.py:86 `run_frontend_prebinned`
// (counts = packed & 0x3F as int32, blockers = packed >= 0x80), which XLA
// fuses into one elementwise pass.  The host bins each scan with
// native/frontend.cpp (vofod_tpu_torch/io/binner.py): low 6 bits = the
// filtered point count clamped to 63, bit 7 = any return in the grid.
//
// Bound on the H100: memory.  At the flagship grid (2,470,491 voxels) the
// pass reads 2.47 MB and writes 9.88 MB of int32 counts and 2.47 MB of
// bools: 14.8 MB, 4.4 us at 3.35 TB/s.  A block unpacks 4,096 voxels:
// each thread one 16-byte load and one 16-byte blocker store, the packed
// words passed through shared memory so that each warp's count stores
// cover 512 contiguous bytes, when the three pointers are 16-byte aligned
// (fresh PyTorch allocations are); the last, partial block, or unaligned
// pointers, go one voxel a thread.  Measured device time (torch.profiler,
// chip_ab.py, NVIDIA H100 80GB HBM3 at 700 W): 4.1 us a call, under the
// HBM bound because back-to-back calls find the 14.8 MB in L2; the first
// version, whose threads stored their counts as four 16-byte stores 16 B
// apart, took 9.3-9.6 us.  Integer work only: bit-equal to the plain
// version.
#include "common.cuh"

namespace {

constexpr int UNPACK_T = 256;
constexpr int PER_THREAD = 16;
constexpr int PER_BLOCK = UNPACK_T * PER_THREAD;

__global__ void __launch_bounds__(UNPACK_T)
    unpack_kernel(const uint8_t* __restrict__ packed, int32_t* __restrict__ counts,
                  uint8_t* __restrict__ blockers, long long n, int vec) {
  __shared__ uint4 words[UNPACK_T];
  const long long block0 = (long long)blockIdx.x * PER_BLOCK;
  if (vec && block0 + PER_BLOCK <= n) {
    // one 16-byte load and one 16-byte blocker store a thread; the counts
    // through shared memory, so that each warp stores 512 contiguous bytes
    const long long base = block0 + (long long)threadIdx.x * PER_THREAD;
    const uint4 p = *reinterpret_cast<const uint4*>(packed + base);
    *reinterpret_cast<uint4*>(blockers + base) =
        make_uint4((p.x >> 7) & 0x01010101u, (p.y >> 7) & 0x01010101u,
                   (p.z >> 7) & 0x01010101u, (p.w >> 7) & 0x01010101u);
    words[threadIdx.x] = p;
    __syncthreads();
    const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = threadIdx.x + UNPACK_T * q;  // word i: voxels 4 i .. 4 i + 3 of the block
      const uint32_t v = w[i];
      reinterpret_cast<int4*>(counts + block0)[i] =
          make_int4((int)(v & 0x3Fu), (int)((v >> 8) & 0x3Fu), (int)((v >> 16) & 0x3Fu),
                    (int)((v >> 24) & 0x3Fu));
    }
    return;
  }
  const long long end = block0 + PER_BLOCK < n ? block0 + PER_BLOCK : n;
  for (long long i = block0 + threadIdx.x; i < end; i += UNPACK_T) {
    const uint8_t v = packed[i];
    counts[i] = v & 0x3F;
    blockers[i] = v >= 0x80;
  }
}

}  // namespace

// packed: device uint8 [n]; outputs counts int32 [n], blockers bool [n].
// Returns cudaGetLastError().
VOFOD_API int vofod_unpack(const void* packed, void* counts, void* blockers, long long n,
                           void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)packed % 16 == 0) && ((uintptr_t)counts % 16 == 0) &&
                  ((uintptr_t)blockers % 16 == 0);
  const long long blocks = (n + PER_BLOCK - 1) / PER_BLOCK;
  unpack_kernel<<<(unsigned int)blocks, UNPACK_T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<int32_t*>(counts),
      static_cast<uint8_t*>(blockers), n, vec);
  return (int)cudaGetLastError();
}
