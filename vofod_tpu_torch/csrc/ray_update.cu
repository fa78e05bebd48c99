// K5b — ray assembly, gate expansion and the flag-guarded ray EMA, in place
// on the sweep window of the confidence grid.
//
// Replaces vofod_tpu/ops/raycast.py `_expand_gate` (two tent einsums per
// cone) and `_assemble_raylen` (cone partition, chord-length density
// T * density * vs^3 / d^2, FOV and range masks), the full-grid zeros +
// window update of `raycast_sweep`, and vofod_tpu/pipeline/step.py
// `ray_update` (the EMA toward score_ray where raylen > 0 and no point
// landed this scan).
//
// Bound on the H100: memory, and little of it.  The window is 51 x 97 x 97
// = 479,859 voxels at the flagship, but at the 20 m range and the +-24 m
// window only a quarter to two fifths of them lie inside both the range
// ball and the vertical FOV, and only those can change.  A block takes a
// tile of RAY_TX x RAY_TY voxels of one z plane (a warp two rows of 16,
// which the range ball's and the FOV cone's edges cut through less often
// than a row of 32) and first culls itself: a tile whose nearest voxel
// centre lies farther than max_d plus one voxel from the sensor returns
// before any load (the margin keeps the test conservative; the offsets
// increase along each axis, so the nearest centre is at the tile's ends).
// A voxel then runs its tests in order of cost: the range (d from its
// offsets, in registers); a voxel in range loads its point flag (1 B), its
// cone's T (4 B, K4's output; 0 or NaN gives a raylen of 0 or NaN) and its
// grid value (4 B) together, then tests the point flag, T, the elevation
// and the FOV; only the voxels past all of them read the gate's faces
// (each tent has at most two nonzero taps, so the two einsums become
// two-term sums), compute the density and apply the EMA (the grid value
// written).  What remains sets the time: the launch of the window's blocks
// with their tile test, and the arithmetic of the warps that hold a voxel
// past the tests.  The plain PyTorch form materialised a second [6, 51,
// 97, 97] gate tensor, ~40 elementwise temporaries and two full-grid
// passes.  Voxels outside the window have raylen 0 and are never touched.
//
// Under the old update rule the EMA needs max(raylen) first: pass 1 writes
// the window's raylen (0 where the range or the FOV cuts a voxel of a tile
// that survives) and an atomicMax on its float bits (raylen > 0, so integer
// order is float order; a NaN raylen, which torch.max keeps, as the largest
// NaN pattern); pass 2 repeats the tile and range tests and applies the
// EMA.  Pass 1 culls by neither the point flag (the max takes every voxel)
// nor T (a T of 0 times a NaN gate is NaN).  The default new rule is one
// pass.  Every cull drops only voxels whose raylen is 0 or NaN (or, under
// the new rule, that had a point), none of which the EMA changes: the
// plain model ops/raycast.py ray_cull_plain replays the cull.
//
// A second entry point, vofod_ray_ema, is K12's second pass: the same EMA
// (both rules, the same max construction) on the exact DDA's full-grid
// raylen field — one elementwise pass over the 2.47 M voxels (~19 MB moved)
// in place of the plain version's chain of full-grid temporaries.
//
// Arithmetic, fixed so that the plain PyTorch version (ops/raycast.py
// ray_window_plain + ray_ema_plain) reproduces it bit for bit: every float
// op with __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn in the plain
// version's order (no FMA contraction); bf16 rounding where `_expand_gate`
// rounds (tent weights, the faces, each einsum's output); constants
// rounded to float32 on the host as the tensor ops round them; asinf,
// cosf, exp2f and powf as PyTorch's CUDA ops call them, with torch.pow's
// special cases for the exponents 1, 2, 3 and 0.5.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int RAY_TX = 16, RAY_TY = 16;  // ops/raycast.py RAY_TILE: K5b's tile
constexpr int RAY_T = 256;  // K12's EMA pass

// float32 constants, in the order of kernels.py ray_update
struct RayF {
  float vs, vs3, vs2, c_dens, fov_lim, max_d;  // ops/raycast.py RayConsts
  float coef, its, weight, score;              // ops/raycast.py RayEma
};

struct RayI {
  int nz, ny, nx;  // grid
  int wy, wx;      // window (all nz planes)
  int y0, x0;      // window offset in the grid
  int F;           // face texture side; 0 = no gate
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

// the two nonzero taps of the tent at face coordinate x in [-1, 1]
__device__ __forceinline__ void tent2(float x, int F, int* i, float* w) {
  const float g = __fmul_rn(__fadd_rn(x, 1.0f), 0.5f * (float)(F - 1));
  const float k0 = floorf(g), k1 = k0 + 1.0f;
  w[0] = round_bf16(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(g, k0))), 0.0f));
  w[1] = round_bf16(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(g, k1))), 0.0f));
  i[0] = min(max((int)k0, 0), F - 1);
  i[1] = min(max((int)k1, 0), F - 1);
}

// one cone's gate factor at face coordinates (u, v): the face texture
// [F (u), F (v)] through both tents, bf16 at the einsums' rounding points
__device__ __forceinline__ float gate_factor(const float* __restrict__ face, int F,
                                             float u, float v) {
  int iu[2], iv[2];
  float wu[2], wv[2];
  tent2(u, F, iu, wu);
  tent2(v, F, iv, wv);
  float tmp[2];
  for (int g = 0; g < 2; ++g) {
    const float f0 = round_bf16(face[iu[0] * F + iv[g]]);
    const float f1 = round_bf16(face[iu[1] * F + iv[g]]);
    tmp[g] = round_bf16(__fadd_rn(__fmul_rn(wu[0], f0), __fmul_rn(wu[1], f1)));
  }
  return round_bf16(__fadd_rn(__fmul_rn(wv[0], tmp[0]), __fmul_rn(wv[1], tmp[1])));
}

// |offset| of the nearest voxel centre of a tile spanning [a, b] along one
// axis (the offsets increase along each axis): 0 where it holds the sensor
__device__ __forceinline__ float nearest(float a, float b) {
  return (a <= 0.0f && b >= 0.0f) ? 0.0f : fminf(fabsf(a), fabsf(b));
}

// A voxel's offsets from the sensor and its distance, as ray_window_plain
struct Geo {
  float X, Y, Z, rx, ry, rz, d2, d;
};

__device__ __forceinline__ Geo geometry(float X, float Y, float Z, const RayF& f) {
  Geo v;
  v.X = X;
  v.Y = Y;
  v.Z = Z;
  v.rx = __fmul_rn(X, f.vs);
  v.ry = __fmul_rn(Y, f.vs);
  v.rz = __fmul_rn(Z, f.vs);
  v.d2 = __fadd_rn(__fadd_rn(__fmul_rn(v.rx, v.rx), __fmul_rn(v.ry, v.ry)),
                   __fmul_rn(v.rz, v.rz));
  v.d = __fsqrt_rn(v.d2);
  return v;
}

// cone partition, priority x > y > z on ties
struct Cone {
  bool in_x, in_y, pos;
  float rel_s;
  int id;
};

__device__ __forceinline__ Cone cone_of(const Geo& v) {
  const float ax = fabsf(v.X), ay = fabsf(v.Y), az = fabsf(v.Z);
  Cone c;
  c.in_x = ax >= ay && ax >= az;
  c.in_y = !c.in_x && ay >= az;
  c.rel_s = c.in_x ? v.X : (c.in_y ? v.Y : v.Z);
  c.pos = c.rel_s > 0.0f;
  c.id = 2 * (c.in_x ? 0 : (c.in_y ? 1 : 2)) + (c.pos ? 0 : 1);
  return c;
}

// the elevation *el in the SENSOR frame (s = R^T (c - o)) inside the
// vertical FOV
__device__ __forceinline__ bool in_fov(const Geo& v, const float* __restrict__ rot,
                                       const RayF& f, float* el) {
  const float d_safe = fmaxf(v.d, f.vs);
  const float sz = __fadd_rn(__fadd_rn(__fmul_rn(rot[2], v.rx), __fmul_rn(rot[5], v.ry)),
                             __fmul_rn(rot[8], v.rz));
  *el = asinf(clampf(__fdiv_rn(sz, d_safe), -1.0f, 1.0f));
  return fabsf(*el) <= f.fov_lim;
}

// raylen of a voxel past every test: its cone's T times the gate factor,
// the chord-length density at elevation el
__device__ __forceinline__ float raylen(float T, const Geo& v, const Cone& c, float el,
                                        const float* __restrict__ faces, const RayI& n,
                                        const RayF& f) {
  if (n.F > 0) {
    float rs = c.pos ? c.rel_s : -c.rel_s;
    rs = fabsf(rs) < 0.5f ? 0.5f : rs;
    const float ra = (c.in_x || c.in_y) ? v.Z : v.Y;  // x, y cones: A = z; z cones: A = y
    const float rb = c.in_x ? v.Y : v.X;              // x cones: B = y; y, z cones: B = x
    const float u = clampf(__fdiv_rn(ra, rs), -1.0f, 1.0f);
    const float w = clampf(__fdiv_rn(rb, rs), -1.0f, 1.0f);
    T = __fmul_rn(T, gate_factor(faces + (size_t)c.id * n.F * n.F, n.F, u, w));
  }
  const float cos_el = fmaxf(cosf(el), 0.05f);
  const float density = __fdiv_rn(1.0f, __fmul_rn(f.c_dens, cos_el));
  return __fdiv_rn(__fmul_rn(__fmul_rn(T, density), f.vs3), fmaxf(v.d2, f.vs2));
}

// torch.pow(base, its) as PyTorch computes it on the card
__device__ __forceinline__ float torch_pow(float b, float e) {
  if (e == 1.0f) return b;
  if (e == 2.0f) return __fmul_rn(b, b);
  if (e == 3.0f) return __fmul_rn(__fmul_rn(b, b), b);
  if (e == 0.5f) return __fsqrt_rn(b);
  return powf(b, e);
}

__device__ __forceinline__ float ema(float g, float w1, float score) {
  return __fadd_rn(__fmul_rn(w1, g), __fmul_rn(__fsub_rn(1.0f, w1), score));
}

// mode 0: new rule, one pass; 1: old rule pass 1 (raylen + max);
// 2: old rule pass 2 (the EMA from the stored raylen).  A block per tile
// (x, y tiles of plane blockIdx.z), a warp on RAY_TX x 32 / RAY_TX voxels.
template <int MODE>
__global__ void __launch_bounds__(RAY_TX * RAY_TY)
    ray_update_kernel(float* __restrict__ vals, const uint8_t* __restrict__ had,
                      const float* __restrict__ T6, const float* __restrict__ faces,
                      const float* __restrict__ rel_x, const float* __restrict__ rel_y,
                      const float* __restrict__ rel_z, const float* __restrict__ rot,
                      RayI n, RayF f, float* __restrict__ raylen_w,
                      unsigned int* __restrict__ max_bits) {
  const int z = blockIdx.z, xa = blockIdx.x * RAY_TX, ya = blockIdx.y * RAY_TY;
  const int i = xa + (int)threadIdx.x % RAY_TX, j = ya + (int)threadIdx.x / RAY_TX;
  const bool live = i < n.wx && j < n.wy;
  // the offsets of the tile's ends and of this voxel, loaded together
  const float ex0 = rel_x[xa], ex1 = rel_x[min(xa + RAY_TX, n.wx) - 1];
  const float ey0 = rel_y[ya], ey1 = rel_y[min(ya + RAY_TY, n.wy) - 1];
  const float Z = rel_z[z], X = rel_x[min(i, n.wx - 1)], Y = rel_y[min(j, n.wy - 1)];
  {  // the tile test, in voxel units: nothing of the tile within max_d + 1 voxel
    const float nx = nearest(ex0, ex1), ny = nearest(ey0, ey1), nz = fabsf(Z);
    const float dn2 = __fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)),
                                __fmul_rn(nz, nz));
    const float lim = __fadd_rn(__fdiv_rn(f.max_d, f.vs), 1.0f);
    if (dn2 > __fmul_rn(lim, lim)) return;  // the whole block
  }
  const size_t t = ((size_t)z * n.wy + j) * n.wx + i;                      // window voxel
  const size_t g = ((size_t)z * n.ny + (n.y0 + j)) * n.nx + (n.x0 + i);  // its grid voxel
  const Geo v = geometry(X, Y, Z, f);
  const bool in_range = live && v.d <= f.max_d;  // in registers
  // a voxel in range loads what its tests and its EMA read, together: its
  // point flag, its cone's T (pass 2: the stored raylen) and grid value
  const Cone c = cone_of(v);
  bool hit = false;
  float T = 0.0f, g_val = 0.0f;
  if (in_range) {
    if (MODE != 1) hit = had[g] != 0;
    T = MODE == 2 ? raylen_w[t] : T6[(((size_t)c.id * n.nz + z) * n.wy + j) * n.wx + i];
    if (MODE != 1) g_val = vals[g];
  }
  const bool reach = in_range && !hit;  // a point landed: no EMA
  float rl = 0.0f;
  if (MODE == 2) {
    rl = reach ? T : 0.0f;
  } else if (reach && (MODE == 1 || T > 0.0f || T < 0.0f)) {
    // (T = 0 or NaN: a raylen of 0 or NaN, which the old rule's max keeps)
    float el;
    if (in_fov(v, rot, f, &el)) rl = raylen(T, v, c, el, faces, n, f);
  }
  if (MODE == 1) {
    if (live) raylen_w[t] = rl;
    float m = rl;  // the max, a NaN kept as torch.max keeps it
    for (int o = 16; o > 0; o >>= 1) {
      const float x = __shfl_xor_sync(0xffffffffu, m, o);
      m = (m != m || x != x) ? __int_as_float(0x7fffffff) : fmaxf(m, x);
    }
    if ((threadIdx.x & 31) == 0 && (m != m || m > 0.0f))
      atomicMax(max_bits, m != m ? 0x7fffffffu : __float_as_uint(m));
    return;
  }
  if (!(rl > 0.0f)) return;
  float w1;
  if (MODE == 0) {
    w1 = exp2f(__fmul_rn(-f.its, __fmul_rn(f.coef, rl)));
  } else {
    const float max_val = clamp_min(__uint_as_float(*max_bits), 1e-20f);
    const float w_single = __fmul_rn(f.weight, __fsqrt_rn(__fdiv_rn(rl, max_val)));
    w1 = clampf(torch_pow(__fsub_rn(1.0f, w_single), f.its), 0.0f, 1.0f);
  }
  vals[g] = ema(g_val, w1, f.score);
}

// K12's second pass: the same EMA on a full-grid raylen field (the exact
// DDA's).  MODE 0: new rule; 1: old rule, max(raylen) only; 2: old rule EMA.
template <int MODE>
__global__ void __launch_bounds__(RAY_T)
    ray_ema_grid_kernel(float* __restrict__ vals, const uint8_t* __restrict__ had,
                        const float* __restrict__ raylen, long long n, RayF f,
                        unsigned int* __restrict__ max_bits) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float rl = g < n ? raylen[g] : 0.0f;
  if (MODE == 1) {
    float m = rl;
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0 && m > 0.0f) atomicMax(max_bits, __float_as_uint(m));
    return;
  }
  if (g >= n || had[g] || !(rl > 0.0f)) return;
  float w1;
  if (MODE == 0) {
    w1 = exp2f(__fmul_rn(-f.its, __fmul_rn(f.coef, rl)));
  } else {
    const float max_val = fmaxf(__uint_as_float(*max_bits), 1e-20f);
    const float w_single = __fmul_rn(f.weight, __fsqrt_rn(__fdiv_rn(rl, max_val)));
    w1 = clampf(torch_pow(__fsub_rn(1.0f, w_single), f.its), 0.0f, 1.0f);
  }
  vals[g] = ema(vals[g], w1, f.score);
}

}  // namespace

// out = (RAY_TX, RAY_TY): K5b's tile, which ops/raycast.py RAY_TILE mirrors
VOFOD_API int vofod_ray_update_geometry(int* out) {
  out[0] = RAY_TX;
  out[1] = RAY_TY;
  return 0;
}

// vals: device f32 grid [nz, ny, nx], updated in place; had: bool grid;
// T6: f32 [6, nz, wy, wx] (K4); faces: f32 [6, F, F] or NULL (F = 0);
// rel_x [wx], rel_y [wy], rel_z [nz]: f32 voxel-centre offsets from the
// sensor; rot: f32 [3, 3]; ints: host int32 [nz, ny, nx, wy, wx, y0, x0, F];
// floats: host f32 RayF.  new_rule: 1 launch; old rule: 2 launches, with
// raylen_w (f32 [nz*wy*wx]) and max_bits (uint32, zeroed by the caller) as
// scratch; `passes` (old rule) picks them: bit 0 the raylen + max pass, bit
// 1 the EMA pass (the grid-sharded step takes the max over the shards
// between the two).  Returns cudaGetLastError().
VOFOD_API int vofod_ray_update(void* vals, const void* had, const void* T6,
                               const void* faces, const void* rel_x,
                               const void* rel_y, const void* rel_z,
                               const void* rot, const int* ints,
                               const float* floats, int new_rule, void* raylen_w,
                               void* max_bits, int passes, void* stream) {
  RayI n;
  n.nz = ints[0]; n.ny = ints[1]; n.nx = ints[2]; n.wy = ints[3]; n.wx = ints[4];
  n.y0 = ints[5]; n.x0 = ints[6]; n.F = ints[7];
  if (n.wy < 1 || n.wx < 1 || n.y0 < 0 || n.x0 < 0 || n.y0 + n.wy > n.ny ||
      n.x0 + n.wx > n.nx || n.F < 0 || (n.F > 0 && faces == nullptr) ||
      (!new_rule && (raylen_w == nullptr || max_bits == nullptr)))
    return (int)cudaErrorInvalidValue;
  RayF f;
  f.vs = floats[0]; f.vs3 = floats[1]; f.vs2 = floats[2]; f.c_dens = floats[3];
  f.fov_lim = floats[4]; f.max_d = floats[5]; f.coef = floats[6]; f.its = floats[7];
  f.weight = floats[8]; f.score = floats[9];
  const dim3 blocks((n.wx + RAY_TX - 1) / RAY_TX, (n.wy + RAY_TY - 1) / RAY_TY, n.nz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vals);
  const uint8_t* h = static_cast<const uint8_t*>(had);
  const float *t6 = static_cast<const float*>(T6), *fc = static_cast<const float*>(faces),
              *rx = static_cast<const float*>(rel_x), *ry = static_cast<const float*>(rel_y),
              *rz = static_cast<const float*>(rel_z), *r = static_cast<const float*>(rot);
  float* rl = static_cast<float*>(raylen_w);
  unsigned int* mb = static_cast<unsigned int*>(max_bits);
  if (new_rule) {
    ray_update_kernel<0><<<blocks, RAY_TX * RAY_TY, 0, s>>>(v, h, t6, fc, rx, ry, rz, r, n, f, rl, mb);
    return (int)cudaGetLastError();
  }
  if (passes & 1) {
    ray_update_kernel<1><<<blocks, RAY_TX * RAY_TY, 0, s>>>(v, h, t6, fc, rx, ry, rz, r, n, f, rl, mb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (passes & 2)
    ray_update_kernel<2><<<blocks, RAY_TX * RAY_TY, 0, s>>>(v, h, t6, fc, rx, ry, rz, r, n, f, rl, mb);
  return (int)cudaGetLastError();
}

// K12's EMA pass, in place on vals (device f32 [n]); had: bool [n]; raylen:
// f32 [n]; floats: host f32 [coef, its, weight, score] (ops/raycast.py
// RayEma).  new_rule: 1 launch; old rule: 2 launches, max_bits (uint32,
// zeroed by the caller) as scratch; `passes` (old rule) picks them: bit 0
// the max pass, bit 1 the EMA pass (the grid-sharded step takes the max
// over the shards between the two).  Returns cudaGetLastError().
VOFOD_API int vofod_ray_ema(void* vals, const void* had, const void* raylen, long long n,
                            const float* floats, int new_rule, void* max_bits, int passes,
                            void* stream) {
  if (n <= 0 || (!new_rule && max_bits == nullptr)) return (int)cudaErrorInvalidValue;
  RayF f = {};
  f.coef = floats[0]; f.its = floats[1]; f.weight = floats[2]; f.score = floats[3];
  const unsigned int blocks = (unsigned int)((n + RAY_T - 1) / RAY_T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vals);
  const uint8_t* h = static_cast<const uint8_t*>(had);
  const float* rl = static_cast<const float*>(raylen);
  unsigned int* mb = static_cast<unsigned int*>(max_bits);
  if (new_rule) {
    ray_ema_grid_kernel<0><<<blocks, RAY_T, 0, s>>>(v, h, rl, n, f, mb);
    return (int)cudaGetLastError();
  }
  if (passes & 1) {
    ray_ema_grid_kernel<1><<<blocks, RAY_T, 0, s>>>(v, h, rl, n, f, mb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (passes & 2) ray_ema_grid_kernel<2><<<blocks, RAY_T, 0, s>>>(v, h, rl, n, f, mb);
  return (int)cudaGetLastError();
}
