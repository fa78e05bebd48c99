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
// bools: 14.8 MB, 4.4 us at 3.35 TB/s.  Each thread unpacks 16 voxels: one
// 16-byte load of the packed grid, four 16-byte stores of counts and one of
// blockers, when the three pointers are 16-byte aligned (fresh PyTorch
// allocations are); the ragged tail, or unaligned pointers, go one voxel at
// a time.  Integer work only: bit-equal to the plain version.
#include "common.cuh"

namespace {

constexpr int UNPACK_T = 256;
constexpr int PER_THREAD = 16;

__global__ void __launch_bounds__(UNPACK_T)
    unpack_kernel(const uint8_t* __restrict__ packed, int32_t* __restrict__ counts,
                  uint8_t* __restrict__ blockers, long long n, int vec) {
  const long long base = ((long long)blockIdx.x * UNPACK_T + threadIdx.x) * PER_THREAD;
  if (base >= n) return;
  if (vec && base + PER_THREAD <= n) {
    const uint4 p = *reinterpret_cast<const uint4*>(packed + base);
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
    uint32_t b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int4 c;
      c.x = (int)(w[q] & 0x3Fu);
      c.y = (int)((w[q] >> 8) & 0x3Fu);
      c.z = (int)((w[q] >> 16) & 0x3Fu);
      c.w = (int)((w[q] >> 24) & 0x3Fu);
      reinterpret_cast<int4*>(counts + base)[q] = c;
      b[q] = (w[q] >> 7) & 0x01010101u;  // bit 7 of each byte -> a bool byte
    }
    *reinterpret_cast<uint4*>(blockers + base) = make_uint4(b[0], b[1], b[2], b[3]);
    return;
  }
  const long long end = base + PER_THREAD < n ? base + PER_THREAD : n;
  for (long long i = base; i < end; ++i) {
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
  const long long threads = (n + PER_THREAD - 1) / PER_THREAD;
  const long long blocks = (threads + UNPACK_T - 1) / UNPACK_T;
  unpack_kernel<<<(unsigned int)blocks, UNPACK_T, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<int32_t*>(counts),
      static_cast<uint8_t*>(blockers), n, vec);
  return (int)cudaGetLastError();
}
