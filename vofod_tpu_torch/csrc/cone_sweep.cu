// K4 — six-cone plane-sweep transmittance (the freespace raycast's core).
//
// Replaces vofod_tpu/ops/raycast.py `_sweep_cones` / `_cone_scan_step`
// inside `_sweep_frame`: for each of the six axis cones (x+, x-, y+, y-,
// z+, z-) a sequential recurrence over the planes moving away from the
// sensor, T_in(plane) = seed ? 1 : resample(carry), carry = T_in * (1 -
// opacity), where the resample is a separable 4-tap interpolation of the
// previous plane toward the sensor (first along the lateral B axis, then
// along A).  The carry is bf16, as in the JAX sweep.
//
// Bound on the H100: latency, not bytes.  The flagship window is 97 x 97 x
// 51 voxels around the sensor, so the x/y cones step through 97 planes of
// 51 x 97 and the z cones through 51 planes of 97 x 97; each plane step
// depends on the previous one.  The design keeps one cone's whole sweep in
// ONE thread block: the carry and the B-resampled plane stay in shared
// memory in bf16 (2 x 97 x 97 x 2 B = 37.6 KB), the per-plane tap weights
// are computed into shared memory by the block itself, and each plane costs
// three block barriers and no device-memory round trip except the f32 T it
// writes.  Six blocks leave most of the 132 SMs idle: the first thing to
// fix later (split each cone's lateral plane over a thread-block cluster).
//
// Arithmetic, fixed so that the plain PyTorch version reproduces it: tap
// weights in f32 exactly as `_tap_weights`, rounded to bf16; each resample
// is w0*p[i-1] + w1*p[i] + w2*p[i+1] + w3*p[i+2] in f32, summed left to
// right with __fmul_rn / __fadd_rn (no FMA), out-of-plane taps reading 1.0,
// and rounded to bf16 after each of the two lateral passes.
//
// The grid-sharded sweep (vofod_tpu/ops/raycast.py raycast_sweep_zsharded)
// has two kernels here, with K4's arithmetic so that its T is bit-equal:
//
// K15b-3 `vofod_cone_sweep_lat` replaces `_sweep_cones_lat_sharded`
// (raycast.py:248): the x and y cones of a shard holding nzl of the nz z
// rows, whose A (= z) resample needs 1 row below and 2 above the slab.  One
// launch per plane step: the A pass of plane k - 1 on the B-resampled rows
// received from the neighbours, the seed, the T write and the carry, then
// the B pass of plane k, whose edge rows the host sends before the next
// launch (the carry row stays in the block).  Bound: latency; 98 launches
// and exchanges per scan per shard, launch-bound by design in this version.
//
// K15b-4a `vofod_cone_sweep_z` replaces `_sweep_cones_z_pipelined`
// (raycast.py:361): the z cones with the sweep axis sharded.  One launch
// runs K4's z-cone loop over the shard's planes from a carry plane in to a
// carry plane out; n rounds with the carry passed along (cone 0 up, cone 1
// down) make the pipeline, and each shard keeps cone 0 from round `rank`
// and cone 1 from round n - 1 - rank.  Bound: latency, as K4's z cones.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int SWEEP_THREADS = 1024;
constexpr int LAT_THREADS = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// `_tap_weights` for one lateral lane: sample the previous plane at
// -rel_lat / rel_s (clipped to +-1 voxel per plane), 4 bf16-rounded weights.
__device__ __forceinline__ void tap_weights(float rel_s, float rel_lat,
                                            float* w) {
  const float rs = fabsf(rel_s) < 0.5f ? 0.5f : rel_s;
  const float f = fminf(fmaxf(__fdiv_rn(-rel_lat, rs), -1.0f), 1.0f);
  const float lo = floorf(f);
  const float frac = __fsub_rn(f, lo);
  const float omf = __fsub_rn(1.0f, frac);
  w[0] = round_bf16(lo == -1.0f ? omf : 0.0f);
  w[1] = round_bf16(__fadd_rn(lo == -1.0f ? frac : 0.0f, lo == 0.0f ? omf : 0.0f));
  w[2] = round_bf16(__fadd_rn(lo == 0.0f ? frac : 0.0f, lo == 1.0f ? omf : 0.0f));
  w[3] = round_bf16(lo == 1.0f ? frac : 0.0f);
}

__device__ __forceinline__ float lerp4(const float* w, float m1, float c,
                                       float p1, float p2) {
  float v = __fmul_rn(w[0], m1);
  v = __fadd_rn(v, __fmul_rn(w[1], c));
  v = __fadd_rn(v, __fmul_rn(w[2], p1));
  return __fadd_rn(v, __fmul_rn(w[3], p2));
}

// One cone's plane loop (K4's, shared by K15b-4a): nS planes moving away
// from the sensor, the carry and the B-resampled plane in shared memory
// (the caller fills the carry; the first barrier below orders that).  Per
// plane s: T_in = seed ? 1 : resample(carry), written to Tc (skipped when
// Tc is NULL), carry = T_in where transparent, 0 where opaque.
__device__ __forceinline__ void sweep_planes(
    const uint8_t* __restrict__ opaque, const float* __restrict__ rel_s,
    const float* __restrict__ rel_a, const float* __restrict__ rel_b, int nS, int nA, int nB,
    size_t st_s, size_t st_a, size_t st_b, bool back, float* wa, float* wb,
    __nv_bfloat16* carry, __nv_bfloat16* tmp, float* __restrict__ Tc) {
  const int nP = nA * nB;
  for (int p = 0; p < nS; ++p) {
    const int s = back ? nS - 1 - p : p;
    const float rs = back ? -rel_s[s] : rel_s[s];
    for (int i = threadIdx.x; i < nA + nB; i += blockDim.x) {
      if (i < nA)
        tap_weights(rs, rel_a[i], wa + 4 * i);
      else
        tap_weights(rs, rel_b[i - nA], wb + 4 * (i - nA));
    }
    __syncthreads();  // weights ready; previous plane's carry complete

    // pass 1: resample along B (the carry's fastest axis)
    for (int i = threadIdx.x; i < nP; i += blockDim.x) {
      const int a = i / nB, b = i - a * nB;
      const __nv_bfloat16* row = carry + a * nB;
      const float m1 = b >= 1 ? __bfloat162float(row[b - 1]) : 1.0f;
      const float c0 = __bfloat162float(row[b]);
      const float p1 = b + 1 < nB ? __bfloat162float(row[b + 1]) : 1.0f;
      const float p2 = b + 2 < nB ? __bfloat162float(row[b + 2]) : 1.0f;
      tmp[i] = __float2bfloat16_rn(lerp4(wb + 4 * b, m1, c0, p1, p2));
    }
    __syncthreads();

    // pass 2: resample along A, seed, write T, attenuate into the carry
    const bool seed = rs <= 1.0f;
    for (int i = threadIdx.x; i < nP; i += blockDim.x) {
      const int a = i / nB, b = i - a * nB;
      float t;
      if (seed) {
        t = 1.0f;
      } else {
        const float m1 = a >= 1 ? __bfloat162float(tmp[i - nB]) : 1.0f;
        const float c0 = __bfloat162float(tmp[i]);
        const float p1 = a + 1 < nA ? __bfloat162float(tmp[i + nB]) : 1.0f;
        const float p2 = a + 2 < nA ? __bfloat162float(tmp[i + 2 * nB]) : 1.0f;
        t = round_bf16(lerp4(wa + 4 * a, m1, c0, p1, p2));
      }
      const size_t g = (size_t)s * st_s + (size_t)a * st_a + (size_t)b * st_b;
      if (Tc != nullptr) Tc[g] = t;
      carry[i] = __float2bfloat16_rn(opaque[g] ? 0.0f : t);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SWEEP_THREADS)
    cone_sweep_kernel(const uint8_t* __restrict__ opaque,
                      const float* __restrict__ rel_x,
                      const float* __restrict__ rel_y,
                      const float* __restrict__ rel_z, float* __restrict__ T,
                      int nz, int ny, int nx) {
  const int cone = blockIdx.x;  // x+, x-, y+, y-, z+, z-
  const int axis = cone >> 1;
  const bool back = cone & 1;
  int nS, nA, nB;
  size_t st_s, st_a, st_b;
  const float *rel_s, *rel_a, *rel_b;
  if (axis == 0) {  // x cones: A = z, B = y
    nS = nx; nA = nz; nB = ny;
    st_s = 1; st_a = (size_t)ny * nx; st_b = nx;
    rel_s = rel_x; rel_a = rel_z; rel_b = rel_y;
  } else if (axis == 1) {  // y cones: A = z, B = x
    nS = ny; nA = nz; nB = nx;
    st_s = nx; st_a = (size_t)ny * nx; st_b = 1;
    rel_s = rel_y; rel_a = rel_z; rel_b = rel_x;
  } else {  // z cones: A = y, B = x
    nS = nz; nA = ny; nB = nx;
    st_s = (size_t)ny * nx; st_a = nx; st_b = 1;
    rel_s = rel_z; rel_a = rel_y; rel_b = rel_x;
  }
  const int nP = nA * nB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wa = reinterpret_cast<float*>(smem_raw);  // [nA][4]
  float* wb = wa + 4 * nA;                          // [nB][4]
  __nv_bfloat16* carry = reinterpret_cast<__nv_bfloat16*>(wb + 4 * nB);
  __nv_bfloat16* tmp = carry + nP;

  for (int i = threadIdx.x; i < nP; i += blockDim.x)
    carry[i] = __float2bfloat16_rn(1.0f);
  sweep_planes(opaque, rel_s, rel_a, rel_b, nS, nA, nB, st_s, st_a, st_b, back, wa, wb, carry,
               tmp, T + (size_t)cone * nz * ny * nx);
}

// K15b-3: launch k of the x/y cone sweep with the lateral A axis (= grid
// z) sharded.  One block per (cone, local row a), one thread per B lane.
//   A phase (k >= 1, plane k - 1 of this cone): the z resample of the
//     B-resampled rows of plane k - 1 (tmp_in for the local rows, `lo` for
//     the row below the slab, `hi` for the two above; NULL = 1.0, the
//     global edge), the seed, the T write and the attenuation into the
//     block's carry row (shared memory).  k == 0 starts the carry at 1.0.
//   B phase (plane k): the B resample of that carry row into tmp_out,
//     whose edge rows the caller sends to the neighbours before launch
//     k + 1.
// The carry row never leaves the block, so the only state between launches
// is the B-resampled plane.  Arithmetic and rounding points are K4's, so T
// is bit-equal to the dense sweep's.  tmp / lo / hi rows are [4][PB] bf16
// (cone-major, PB = max(wx, wy)).
__global__ void __launch_bounds__(LAT_THREADS)
    cone_lat_kernel(const uint8_t* __restrict__ opaque, const float* __restrict__ rel_x,
                    const float* __restrict__ rel_y, const float* __restrict__ rel_z,
                    const __nv_bfloat16* __restrict__ tmp_in,
                    const __nv_bfloat16* __restrict__ lo, const __nv_bfloat16* __restrict__ hi,
                    __nv_bfloat16* __restrict__ tmp_out, float* __restrict__ T, int nzl,
                    int wy, int wx, int k) {
  const int cone = blockIdx.x;  // x+, x-, y+, y-
  const int a = blockIdx.y;
  const int axis = cone >> 1;
  const bool back = cone & 1;
  const int nS = axis == 0 ? wx : wy;
  const int nB = axis == 0 ? wy : wx;
  const float* rel_s = axis == 0 ? rel_x : rel_y;
  const float* rel_b = axis == 0 ? rel_y : rel_x;
  const int PB = wx > wy ? wx : wy;
  const size_t row = 4 * (size_t)PB;  // elements per row of tmp / lo / hi
  const size_t col = (size_t)cone * PB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* crow = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [nB]

  if (k > nS) return;  // this cone has finished (block-uniform)
  if (k == 0) {
    for (int b = threadIdx.x; b < nB; b += blockDim.x) crow[b] = __float2bfloat16_rn(1.0f);
  } else {
    const int s = back ? nS - 1 - (k - 1) : k - 1;
    const float rs = back ? -rel_s[s] : rel_s[s];
    const bool seed = rs <= 1.0f;
    float wa[4];
    tap_weights(rs, rel_z[a], wa);
    float* Tc = T + (size_t)cone * nzl * wy * wx;
    for (int b = threadIdx.x; b < nB; b += blockDim.x) {
      float t = 1.0f;
      if (!seed) {
        float v[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const int r = a - 1 + d;
          const __nv_bfloat16* src =
              r < 0 ? lo : (r >= nzl ? (hi != nullptr ? hi + (r - nzl) * row : nullptr)
                                     : tmp_in + r * row);
          v[d] = src != nullptr ? __bfloat162float(src[col + b]) : 1.0f;
        }
        t = round_bf16(lerp4(wa, v[0], v[1], v[2], v[3]));
      }
      const size_t g = axis == 0 ? ((size_t)a * wy + b) * wx + s : ((size_t)a * wy + s) * wx + b;
      Tc[g] = t;
      crow[b] = __float2bfloat16_rn(opaque[g] ? 0.0f : t);
    }
  }
  __syncthreads();
  if (k == nS) return;
  const int s = back ? nS - 1 - k : k;
  const float rs = back ? -rel_s[s] : rel_s[s];
  for (int b = threadIdx.x; b < nB; b += blockDim.x) {
    float wb[4];
    tap_weights(rs, rel_b[b], wb);
    const float m1 = b >= 1 ? __bfloat162float(crow[b - 1]) : 1.0f;
    const float c0 = __bfloat162float(crow[b]);
    const float p1 = b + 1 < nB ? __bfloat162float(crow[b + 1]) : 1.0f;
    const float p2 = b + 2 < nB ? __bfloat162float(crow[b + 2]) : 1.0f;
    tmp_out[a * row + col + b] = __float2bfloat16_rn(lerp4(wb, m1, c0, p1, p2));
  }
}

// K15b-4a: one round of the pipelined z cones on a shard's nzl planes: K4's
// z-cone loop (A = y, B = x), cone 0 ascending and cone 1 descending,
// starting from carry_in [2][wy][wx] and leaving the last plane's carry in
// carry_out.  T (the z+ and z- cones of the local T6) is written only for
// the cones in keep_mask (bit c): the rounds a shard does not keep compute
// discarded values, as the JAX pipeline's do.
__global__ void __launch_bounds__(SWEEP_THREADS)
    cone_z_kernel(const uint8_t* __restrict__ opaque, const float* __restrict__ rel_x,
                  const float* __restrict__ rel_y, const float* __restrict__ rel_z,
                  const __nv_bfloat16* __restrict__ carry_in,
                  __nv_bfloat16* __restrict__ carry_out, float* __restrict__ T, int nzl, int wy,
                  int wx, int keep_mask) {
  const int cone = blockIdx.x;  // z+, z-
  const int nP = wy * wx;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wa = reinterpret_cast<float*>(smem_raw);  // [wy][4]
  float* wb = wa + 4 * wy;                          // [wx][4]
  __nv_bfloat16* carry = reinterpret_cast<__nv_bfloat16*>(wb + 4 * wx);
  __nv_bfloat16* tmp = carry + nP;
  for (int i = threadIdx.x; i < nP; i += blockDim.x) carry[i] = carry_in[(size_t)cone * nP + i];
  float* Tc = (keep_mask >> cone) & 1 ? T + (size_t)cone * nzl * nP : nullptr;
  sweep_planes(opaque, rel_z, rel_y, rel_x, nzl, wy, wx, (size_t)nP, (size_t)wx, 1, cone == 1,
               wa, wb, carry, tmp, Tc);
  for (int i = threadIdx.x; i < nP; i += blockDim.x) carry_out[(size_t)cone * nP + i] = carry[i];
}

// Bytes of dynamic shared memory the sweep needs for this window: the tap
// weights (2 x 4 f32 per lateral lane) and the carry + resampled plane (bf16)
// of the largest of the three plane shapes.
long long cone_sweep_smem(int nz, int ny, int nx) {
  long long best = 0;
  const int shapes[3][2] = {{nz, ny}, {nz, nx}, {ny, nx}};
  for (int k = 0; k < 3; ++k) {
    const long long nA = shapes[k][0], nB = shapes[k][1];
    const long long bytes = 16 * (nA + nB) + 4 * nA * nB;
    if (bytes > best) best = bytes;
  }
  return best;
}

}  // namespace

// opaque: device uint8 (nz, ny, nx); rel_*: device f32 voxel-centre offsets
// from the sensor; T: device f32 [6, nz, ny, nx].  Returns cudaGetLastError().
VOFOD_API int vofod_cone_sweep(const void* opaque, const void* rel_x,
                               const void* rel_y, const void* rel_z, void* T,
                               int nz, int ny, int nx, void* stream) {
  const long long smem = cone_sweep_smem(nz, ny, nx);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cone_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cone_sweep_kernel<<<6, SWEEP_THREADS, (size_t)smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(opaque), static_cast<const float*>(rel_x),
      static_cast<const float*>(rel_y), static_cast<const float*>(rel_z),
      static_cast<float*>(T), nz, ny, nx);
  return (int)cudaGetLastError();
}

// K15b-3, launch k (0 <= k <= max(wx, wy)).  opaque: device uint8 local
// window [nzl, wy, wx]; rel_x [wx], rel_y [wy], rel_z [nzl]: device f32
// offsets (rel_z the slab's rows of the global column); tmp_in / tmp_out:
// device bf16 [nzl][4][max(wx, wy)] (tmp_in unused at k == 0); lo [1][4][PB]
// and hi [2][4][PB]: the received rows, NULL = 1.0 (the global edges); T:
// device f32 [4, nzl, wy, wx] (the x and y cones of the local T6).
VOFOD_API int vofod_cone_sweep_lat(const void* opaque, const void* rel_x, const void* rel_y,
                                   const void* rel_z, const void* tmp_in, const void* lo,
                                   const void* hi, void* tmp_out, void* T, int nzl, int wy,
                                   int wx, int k, void* stream) {
  const int pb = wx > wy ? wx : wy;
  if (nzl < 2 || wy < 1 || wx < 1 || k < 0 || k > pb || (k > 0 && tmp_in == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = pb >= LAT_THREADS ? LAT_THREADS : ((pb + 31) / 32) * 32;
  cone_lat_kernel<<<dim3(4, nzl), threads, (size_t)pb * sizeof(__nv_bfloat16),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(opaque), static_cast<const float*>(rel_x),
      static_cast<const float*>(rel_y), static_cast<const float*>(rel_z),
      static_cast<const __nv_bfloat16*>(tmp_in), static_cast<const __nv_bfloat16*>(lo),
      static_cast<const __nv_bfloat16*>(hi), static_cast<__nv_bfloat16*>(tmp_out),
      static_cast<float*>(T), nzl, wy, wx, k);
  return (int)cudaGetLastError();
}

// K15b-4a, one round.  opaque: device uint8 local window [nzl, wy, wx];
// rel_*: as K15b-3; carry_in / carry_out: device bf16 [2, wy, wx]; T:
// device f32 [2, nzl, wy, wx] (the z cones of the local T6); keep_mask: bit
// c writes cone c's T.
VOFOD_API int vofod_cone_sweep_z(const void* opaque, const void* rel_x, const void* rel_y,
                                 const void* rel_z, const void* carry_in, void* carry_out,
                                 void* T, int nzl, int wy, int wx, int keep_mask,
                                 void* stream) {
  const long long smem = 16 * ((long long)wy + wx) + 4 * (long long)wy * wx;
  if (nzl < 1 || wy < 1 || wx < 1 || smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cone_z_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cone_z_kernel<<<2, SWEEP_THREADS, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(opaque), static_cast<const float*>(rel_x),
      static_cast<const float*>(rel_y), static_cast<const float*>(rel_z),
      static_cast<const __nv_bfloat16*>(carry_in), static_cast<__nv_bfloat16*>(carry_out),
      static_cast<float*>(T), nzl, wy, wx, keep_mask);
  return (int)cudaGetLastError();
}
