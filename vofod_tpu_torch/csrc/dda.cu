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
// flagship) with the ray's state in registers, and the chords go into a
// zeroed full-grid float64 accumulator (19.8 MB, mostly L2-resident), which a
// second pass rounds to the float32 raylen grid.  The emission stream is
// never stored (the JAX form materialises R x n_steps ids and weights).
// Every ray starts within centimetres of the sensor and a warp's 32 rays
// are azimuth neighbours of one beam row, so at one step a warp's lanes
// mostly add into the same few voxels: one float64 atomicAdd per chord put
// ~6.4 M adds a flagship exact scan on the L2, the sensor's voxel alone
// taking one from every ray.  So the warp stays converged through its step
// loop (a finished lane emits nothing until the whole warp is done), the
// lanes with a chord into an in-grid, owned voxel group by
// __match_any_sync on its id, each group sums its chords in float64 to its
// lowest lane by pointer-jumping shuffles, and that lane issues ONE
// atomicAdd (~0.74 M adds at the flagship).  One warp vote a step says
// whether any lane adds (else the match is skipped) and whether any still
// walks.  The walk itself is latency-bound (one wave of 4,096 warps), so
// the ray's state is indexed by constants only and stays in registers.
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
// ~1e-11 whatever the order (of the groups, or within one), so raylen is
// the correctly rounded sum of the chords (within one float32 ulp where the
// sum lies on a rounding midpoint), and it differs from the sequential sum
// by that sum's own rounding only.
//
// K15b-6c, the grid-sharded form (vofod_tpu/parallel/gridops.py
// `ZShardOps.raycast_dda`), is this kernel with a z window: every shard
// walks every ray (ray-space work is replicated) and adds into an
// accumulator of its own nzl rows only the emissions whose flat id lies in
// them, as JAX's ownership filter does; a lane whose chord lies outside
// the slab joins no group, a ray whose z rows miss the slab is not walked,
// and a ray stops once its rows have passed the slab's.  Each voxel gets
// the dense walk's set of chords, summed in float64 and rounded once, so a
// shard's raylen is the dense raylen's rows.
#include "common.cuh"

namespace {

constexpr int DDA_T = 128;
constexpr unsigned FULL = 0xffffffffu;

struct DdaGrid {
  float ox, oy, oz;  // grid origin (float32)
  float vs, inv;     // voxel size, 1 / voxel size (float32)
  float half_vs;     // vs / 2
  int nx, ny, nz;
  int n_steps;
  int z0, nzl;  // the accumulator holds the grid rows [z0, z0 + nzl)
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
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u, above = 0xfffffffeu << lane;
  // the lanes match on their voxel's slab-local id (< 2^31); a lane with no
  // chord this step on a key of its own, so every lane joins the match
  const unsigned own_key = 0x80000000u | lane;
  float L = 0.0f;
  bool alive = false;  // alive0 = valid & (L > 0)
  if (r < n_rays) {
    L = lengths[r];
    alive = valid[r] && L > 0.0f;
  }
  const int last_pos[3] = {g.nx - 1, g.ny - 1, g.nz - 1};
  int cur[3] = {0, 0, 0}, step[3] = {0, 0, 0}, last[3] = {0, 0, 0};
  float tmax[3] = {INFINITY, INFINITY, INFINITY}, tdelta[3] = {INFINITY, INFINITY, INFINITY};
  if (alive) {
    const float s[3] = {starts[3 * r], starts[3 * r + 1], starts[3 * r + 2]};
    const float o[3] = {g.ox, g.oy, g.oz};
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
      }
      last[a] = step[a] > 0 ? last_pos[a] : 0;
    }
    if (g.nzl < g.nz) {
      // a slab: the walk's z rows run monotonically from the start's row to
      // the row of start + L dir; a ray whose rows (2 rows wider, for the
      // rounding of either end) miss the slab adds nothing to it, and a ray
      // stops once its rows have passed the slab's (below)
      const float dz = dirs[3 * r + 2], zs = (float)cur[2];
      const float ze = dz == 0.0f ? zs : floorf((s[2] + L * dz - g.oz) * g.inv);
      alive = fmaxf(zs, ze) + 2.0f >= (float)g.z0 &&
              fminf(zs, ze) - 2.0f < (float)(g.z0 + g.nzl);
    }
  }
  const long long plane = (long long)g.nx * g.ny;
  const long long n_all = plane * g.nz, z0 = g.z0 * plane, n_own = plane * g.nzl;

  float prev = 0.0f;
  bool more = __any_sync(FULL, alive);  // a lane of the warp is still walking
  for (int k = 0; k < g.n_steps && more; ++k) {
    long long lf = -1;  // this step's owned voxel, -1 for none
    double w = 0.0;
    if (alive) {
      // jnp.min / jnp.argmin: the first minimum, x before y before z.  The
      // ray's state is indexed by constants only (selects, not tmax[axis]),
      // so it stays in registers.
      const bool on_x = tmax[0] <= tmax[1] && tmax[0] <= tmax[2];
      const bool on_y = !on_x && tmax[1] <= tmax[2];
      const float dist = on_x ? tmax[0] : (on_y ? tmax[1] : tmax[2]);
      const float ddist = fmaxf(__fsub_rn(fminf(dist, L), prev), 0.0f);
      // the JAX scatter drops ids outside the grid (mode="drop")
      const long long fid = ((long long)cur[2] * g.ny + cur[1]) * g.nx + cur[0];
      if (ddist > 0.0f && fid >= 0 && fid < n_all && fid - z0 >= 0 && fid - z0 < n_own) {
        lf = fid - z0;
        w = (double)ddist;
      }
      const bool at_edge =
          on_x ? cur[0] == last[0] : (on_y ? cur[1] == last[1] : cur[2] == last[2]);
      if (!(dist < L) || at_edge) {
        alive = false;  // dead: every later emission is 0
      } else {
        if (on_x) {
          cur[0] += step[0];
          tmax[0] = __fadd_rn(tmax[0], tdelta[0]);
        } else if (on_y) {
          cur[1] += step[1];
          tmax[1] = __fadd_rn(tmax[1], tdelta[1]);
        } else {
          cur[2] += step[2];
          tmax[2] = __fadd_rn(tmax[2], tdelta[2]);
        }
        prev = dist;
        // z rows only grow (or only fall) along a ray: past the slab's
        // rows it adds nothing more to the slab
        alive = step[2] > 0 ? cur[2] < g.z0 + g.nzl : (step[2] < 0 ? cur[2] >= g.z0 : true);
      }
    }
    // one vote a step: does a lane add, is a lane still walking
    const unsigned votes = __reduce_or_sync(FULL, (lf >= 0 ? 1u : 0u) | (alive ? 2u : 0u));
    more = (votes & 2u) != 0;
    if (!(votes & 1u)) continue;
    // the lanes adding into one voxel, and the next of them above this lane
    const unsigned grp = __match_any_sync(FULL, lf >= 0 ? (unsigned)lf : own_key);
    int next = __ffs(grp & above) - 1;
    // pointer jumping: in round i each member adds the partial of the member
    // 2^i ranks above it (`next`), which holds the sum of the 2^i ranks from
    // there, then takes that member's `next`; after ceil(log2 size) rounds
    // the lowest lane holds the group's sum
    while (__any_sync(FULL, next >= 0)) {
      const int src = next >= 0 ? next : (int)lane;
      const double o = __shfl_sync(FULL, w, src);
      const int nn = __shfl_sync(FULL, next, src);
      if (next >= 0) {
        w += o;
        next = nn;
      }
    }
    if (lf >= 0 && (grp & below) == 0) atomicAdd(acc + lf, w);
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
// vs / 2]; ints: host int32 [nx, ny, nz, n_steps, z0, nzl]: the output
// holds the grid rows [z0, z0 + nzl) (the whole grid: 0, nz).  acc: device
// f64 [nzl, ny, nx], zeroed by the caller, accumulated into; raylen: device
// f32 [nzl, ny, nx], written (acc rounded to nearest).  Returns
// cudaGetLastError().
VOFOD_API int vofod_dda(const void* starts, const void* dirs, const void* lengths,
                        const void* valid, int n_rays, const float* floats, const int* ints,
                        void* acc, void* raylen, void* stream) {
  if (n_rays <= 0) return (int)cudaErrorInvalidValue;
  DdaGrid g;
  g.ox = floats[0]; g.oy = floats[1]; g.oz = floats[2];
  g.vs = floats[3]; g.inv = floats[4]; g.half_vs = floats[5];
  g.nx = ints[0]; g.ny = ints[1]; g.nz = ints[2]; g.n_steps = ints[3];
  g.z0 = ints[4]; g.nzl = ints[5];
  const long long nv = (long long)g.nx * g.ny * g.nzl;
  if (g.nx < 1 || g.ny < 1 || g.nz < 1 || g.n_steps < 1 || g.z0 < 0 || g.nzl < 1 ||
      g.z0 + g.nzl > g.nz || nv > 0x7fffffff)  // int32 flat ids, as the port's grids
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* a = static_cast<double*>(acc);
  dda_kernel<<<(n_rays + DDA_T - 1) / DDA_T, DDA_T, 0, s>>>(
      static_cast<const float*>(starts), static_cast<const float*>(dirs),
      static_cast<const float*>(lengths), static_cast<const uint8_t*>(valid), n_rays, g, a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  round_kernel<<<(unsigned int)((nv + 255) / 256), 256, 0, s>>>(a, nv, static_cast<float*>(raylen));
  return (int)cudaGetLastError();
}
