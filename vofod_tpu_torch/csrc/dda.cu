// K12 — exact Amanatides-Woo DDA: every ray's chord length in every voxel it
// crosses, summed into a float32 raylen grid.
//
// Replaces vofod_tpu/ops/raycast.py `raycast_dda` and `dda_emissions` (a
// lax.scan over n_steps ray steps that emits a (flat id, chord) pair per ray
// and step, then one scatter-add of the R x n_steps stream; ref
// voxel_map.cpp:229-263 forEachRay).
//
// Bound on the H100: the scattered adds.  One thread walks one ray (131,072
// rays x at most ceil(20 m / 0.5 m * sqrt 3) + 3 = 73 steps at the
// flagship) with the ray's state in registers; each step with a nonzero
// chord is one float64 atomicAdd into a zeroed full-grid accumulator (19.8
// MB, mostly L2-resident), which a second pass rounds to the float32 raylen
// grid.  A thread stops at the first step where its ray is
// dead, so no zero-weight emission is ever issued, and the emission stream
// is never stored (the JAX form materialises R x n_steps ids and weights).
// The full grid is used, not a window: lengths follow the live-tunable
// max distance, so only the step cap bounds the walk.
//
// Arithmetic: every float op as the JAX function rounds it (no FMA
// contraction: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), the argmin
// tie-break x, then y, then z, and a select on zero-direction axes.  The
// chords are those of the plain version; their sum is not.  The JAX scatter
// (and the plain version) adds each voxel's chords in float32 in (step, ray)
// order, and the voxel holding the sensor sums ~all 131,072 rays' first
// chords to ~34 km, so its own rounding reaches ~1e-4 relative.  Float32
// atomics would add another order-dependent error of the same size that
// changes from run to run.  Float64 atomics keep each voxel's sum exact to
// ~1e-11 whatever the order, so raylen is the correctly rounded sum of the
// chords (within one float32 ulp where the sum lies on a rounding midpoint),
// and it differs from the sequential sum by that sum's own rounding only.
#include "common.cuh"

namespace {

constexpr int DDA_T = 128;

struct DdaGrid {
  float ox, oy, oz;  // grid origin (float32)
  float vs, inv;     // voxel size, 1 / voxel size (float32)
  float half_vs;     // vs / 2
  int nx, ny, nz;
  int n_steps;
};

// XLA's float -> int32 conversion: NaN -> 0, saturating
__device__ __forceinline__ int to_i32(float f) {
  if (f != f) return 0;
  if (f >= 2147483648.0f) return 0x7fffffff;
  if (f < -2147483648.0f) return (int)0x80000000;
  return (int)f;
}

__global__ void __launch_bounds__(DDA_T)
    dda_kernel(const float* __restrict__ starts, const float* __restrict__ dirs,
               const float* __restrict__ lengths, const uint8_t* __restrict__ valid, int n_rays,
               DdaGrid g, double* __restrict__ acc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float L = lengths[r];
  if (!valid[r] || !(L > 0.0f)) return;  // alive0 = valid & (L > 0)

  const float s[3] = {starts[3 * r], starts[3 * r + 1], starts[3 * r + 2]};
  const float o[3] = {g.ox, g.oy, g.oz};
  const int last_pos[3] = {g.nx - 1, g.ny - 1, g.nz - 1};
  int cur[3], step[3], last[3];
  float tmax[3], tdelta[3];
  for (int a = 0; a < 3; ++a) {
    const float d = dirs[3 * r + a];
    const float ad = fabsf(d);
    step[a] = d > 0.0f ? 1 : (d < 0.0f ? -1 : 0);
    cur[a] = to_i32(floorf(__fmul_rn(__fsub_rn(s[a], o[a]), g.inv)));
    const float centre = __fadd_rn(__fmul_rn(__fadd_rn((float)cur[a], 0.5f), g.vs), o[a]);
    const float ctr = __fsub_rn(centre, s[a]);
    if (ad > 0.0f) {
      tdelta[a] = __fdiv_rn(g.vs, ad);
      tmax[a] = __fdiv_rn(__fadd_rn(g.half_vs, __fmul_rn((float)step[a], ctr)), ad);
    } else {
      tdelta[a] = INFINITY;
      tmax[a] = INFINITY;
    }
    last[a] = step[a] > 0 ? last_pos[a] : 0;
  }

  float prev = 0.0f;
  for (int k = 0; k < g.n_steps; ++k) {
    // jnp.min / jnp.argmin: the first minimum, x before y before z
    const int axis = (tmax[0] <= tmax[1] && tmax[0] <= tmax[2]) ? 0 : (tmax[1] <= tmax[2] ? 1 : 2);
    const float dist = tmax[axis];
    const float ddist = fmaxf(__fsub_rn(fminf(dist, L), prev), 0.0f);
    if (ddist > 0.0f) {
      // the JAX scatter drops ids outside the grid (mode="drop")
      const long long fid = ((long long)cur[2] * g.ny + cur[1]) * g.nx + cur[0];
      if (fid >= 0 && fid < (long long)g.nx * g.ny * g.nz) atomicAdd(acc + fid, (double)ddist);
    }
    const bool at_edge = cur[axis] == last[axis];
    if (!(dist < L) || at_edge) return;  // dead: every later emission is 0
    cur[axis] += step[axis];
    tmax[axis] = __fadd_rn(tmax[axis], tdelta[axis]);
    prev = dist;
  }
}

__global__ void __launch_bounds__(256)
    round_kernel(const double* __restrict__ acc, long long n, float* __restrict__ raylen) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) raylen[i] = __double2float_rn(acc[i]);
}

}  // namespace

// starts, dirs: device f32 [n_rays, 3] (x, y, z); lengths f32 [n_rays];
// valid bool [n_rays] (the step gates on in_limits(starts), so a valid ray
// starts inside the grid and dies at its edge).  floats: host f32 [ox, oy, oz, vs, inv,
// vs / 2]; ints: host int32 [nx, ny, nz, n_steps].  acc: device f64 grid,
// zeroed by the caller, accumulated into; raylen: device f32 grid, written
// (acc rounded to nearest).  Returns cudaGetLastError().
VOFOD_API int vofod_dda(const void* starts, const void* dirs, const void* lengths,
                        const void* valid, int n_rays, const float* floats, const int* ints,
                        void* acc, void* raylen, void* stream) {
  if (n_rays <= 0) return (int)cudaErrorInvalidValue;
  DdaGrid g;
  g.ox = floats[0]; g.oy = floats[1]; g.oz = floats[2];
  g.vs = floats[3]; g.inv = floats[4]; g.half_vs = floats[5];
  g.nx = ints[0]; g.ny = ints[1]; g.nz = ints[2]; g.n_steps = ints[3];
  if (g.nx < 1 || g.ny < 1 || g.nz < 1 || g.n_steps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* a = static_cast<double*>(acc);
  dda_kernel<<<(n_rays + DDA_T - 1) / DDA_T, DDA_T, 0, s>>>(
      static_cast<const float*>(starts), static_cast<const float*>(dirs),
      static_cast<const float*>(lengths), static_cast<const uint8_t*>(valid), n_rays, g, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long nv = (long long)g.nx * g.ny * g.nz;
  round_kernel<<<(unsigned int)((nv + 255) / 256), 256, 0, s>>>(a, nv, static_cast<float*>(raylen));
  return (int)cudaGetLastError();
}
