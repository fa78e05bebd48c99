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
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int SWEEP_THREADS = 1024;

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
  float* Tc = T + (size_t)cone * nz * ny * nx;

  for (int i = threadIdx.x; i < nP; i += blockDim.x)
    carry[i] = __float2bfloat16_rn(1.0f);

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
      Tc[g] = t;
      carry[i] = __float2bfloat16_rn(opaque[g] ? 0.0f : t);
    }
    __syncthreads();
  }
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
