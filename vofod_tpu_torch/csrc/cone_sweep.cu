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
// depends on the previous one, so the time is planes x the latency of one
// step.  The design (`cone_cluster_kernel`) shortens that step:
//   * each cone runs on a thread-block cluster of C = 16 blocks (a
//     non-portable size), each block owning a band of the plane's A
//     rows (z for the x/y cones, y for the z cones): 96 SMs in place of 6;
//   * the B pass (along a row) reads only the block's own carry rows; the
//     A pass at row a reads the B-resampled rows a - 1 .. a + 2, at a
//     band's edge from the neighbouring blocks through distributed shared
//     memory.  The B-resampled plane is double-buffered by plane parity, so
//     one cluster barrier and one block barrier a plane suffice: no block
//     can overwrite a buffer a neighbour still reads;
//   * nothing inside the recurrence reads device memory: before the plane
//     loop each block packs its band's opacity for every plane as bits (32
//     voxels of x a word, from aligned 16-byte loads) and copies the
//     offsets into shared memory;
//     each plane's tap weights (bf16, 8 bytes a lane) are computed during
//     the plane before, by the threads the passes leave idle, into a
//     buffer of the other parity;
//   * T is written in runs along x: the y and z cones' lanes are x already;
//     the x cones stage 32 planes of their lanes in shared memory (bf16: T
//     is bf16-exact) and store each lane's 32 planes as one 128-byte run.
// The carry stays in bf16 in shared memory as before.
//
// Arithmetic, fixed so that the plain PyTorch version reproduces it: tap
// weights in f32 exactly as `_tap_weights`, rounded to bf16; each resample
// is w0*p[i-1] + w1*p[i] + w2*p[i+1] + w3*p[i+2] in f32, summed left to
// right with __fmul_rn / __fadd_rn (no FMA), out-of-plane taps reading 1.0,
// and rounded to bf16 after each of the two lateral passes.  So T is
// bit-equal to the plain version's.
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
// runs a one-block z-cone loop (`sweep_planes`, K4's arithmetic) over the
// shard's planes from a carry plane in to a carry plane out; n rounds with
// the carry passed along (cone 0 up, cone 1 down) make the pipeline, and
// each shard keeps cone 0 from round `rank` and cone 1 from round n - 1 -
// rank.  Bound: latency, one block a cone.
//
// K15b-4b `vofod_cone_sweep_zt` replaces `_sweep_cones_z_transposed`
// (raycast.py:308, zcone_mode="transpose"): the z cones after an
// all_to_all has made the window y-sharded, so a shard holds all nz planes
// of its nyl = ceil(wy / n) rows of the (padded) window y.  It is K15b-3's
// scheme with the sweep along z, A = y (the sharded lateral axis) and B =
// x: one launch per plane step, the A pass of plane k - 1 on the
// B-resampled rows with the neighbours' edge rows (1 below, 2 above), then
// the B pass of plane k.  The pad rows at or past wy are set to exactly
// bf16 1.0 after every B pass (`pin_rows`, raycast.py:283-287), the value
// the dense sweep's A taps read past the window's edge, so T is bit-equal
// to K4's z cones.  Both cones are written in grid order (z ascending), as
// K4 writes them.  Bound: latency; nz + 1 launches and nz exchanges per
// scan per shard, launch-bound by design in this version.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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

// The lateral-sharded sweeps' row r of the B-resampled plane around a slab
// of n_rows local rows: tmp_in for the slab's own rows, `lo` the row below,
// `hi` the two above; NULL past the global edge (reads 1.0)
__device__ __forceinline__ const __nv_bfloat16* slab_row(const __nv_bfloat16* tmp_in,
                                                         const __nv_bfloat16* lo,
                                                         const __nv_bfloat16* hi, int r,
                                                         int n_rows, size_t row) {
  if (r < 0) return lo;
  if (r < n_rows) return tmp_in + r * row;
  return hi != nullptr ? hi + (r - n_rows) * row : nullptr;
}

// the A pass at local row a: the 4-tap resample across the slab's rows at
// lane `col` (seed: 1.0), rounded to bf16
__device__ __forceinline__ float slab_a_pass(const float* wa, const __nv_bfloat16* tmp_in,
                                             const __nv_bfloat16* lo, const __nv_bfloat16* hi,
                                             int a, int n_rows, size_t row, size_t col,
                                             bool seed) {
  if (seed) return 1.0f;
  float v[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const __nv_bfloat16* src = slab_row(tmp_in, lo, hi, a - 1 + d, n_rows, row);
    v[d] = src != nullptr ? __bfloat162float(src[col]) : 1.0f;
  }
  return round_bf16(lerp4(wa, v[0], v[1], v[2], v[3]));
}

// the B pass of a carry row at lane b (1.0 past its ends), before rounding
__device__ __forceinline__ float row_b_pass(const float* wb, const __nv_bfloat16* crow, int b,
                                            int nB) {
  const float m1 = b >= 1 ? __bfloat162float(crow[b - 1]) : 1.0f;
  const float c0 = __bfloat162float(crow[b]);
  const float p1 = b + 1 < nB ? __bfloat162float(crow[b + 1]) : 1.0f;
  const float p2 = b + 2 < nB ? __bfloat162float(crow[b + 2]) : 1.0f;
  return lerp4(wb, m1, c0, p1, p2);
}

// One cone's plane loop in one block (K15b-4a's): nS planes moving away
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
      tmp[i] = __float2bfloat16_rn(row_b_pass(wb + 4 * b, carry + a * nB, b, nB));
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

// One cone's geometry in the window: nS planes of nA x nB lanes, the
// strides of the sweep axis S and the lateral axes A, B in T's [nz, ny,
// nx] layout, and the voxel-centre offsets along each.
struct Cone {
  int nS, nA, nB;
  size_t st_s, st_a, st_b;
  const float *rel_s, *rel_a, *rel_b;
};

__device__ __forceinline__ Cone cone_of(int axis, const float* rel_x, const float* rel_y,
                                        const float* rel_z, int nz, int ny, int nx) {
  if (axis == 0)  // x cones: A = z, B = y
    return {nx, nz, ny, 1, (size_t)ny * nx, (size_t)nx, rel_x, rel_z, rel_y};
  if (axis == 1)  // y cones: A = z, B = x
    return {ny, nz, nx, (size_t)nx, (size_t)ny * nx, 1, rel_y, rel_z, rel_x};
  return {nz, ny, nx, (size_t)ny * nx, (size_t)nx, 1, rel_z, rel_y, rel_x};  // z: A = y, B = x
}

constexpr int CLUSTER_THREADS = 1024;
constexpr int CONE_CLUSTER = 16;  // blocks a cone: 96 SMs for the six cones
constexpr int STAGE = 32;        // planes of the x cones' T staged per store run
constexpr int STAGE_PITCH = 34;  // bf16 a staged lane: 17 words, so lanes hit distinct banks

// Byte offsets of one block's shared memory, the same in every block of the
// launch (sized for the largest of the three cone shapes at cluster size C;
// the host sizes the launch with the same function).
struct ClusterSmem {
  size_t rs, rel_b, rel_a, wb, wa, bits, rowp, carry, tmp, stage, total;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline ClusterSmem cluster_smem(int nz, int ny, int nx, int C) {
  const int band_z = (nz + C - 1) / C, band_y = (ny + C - 1) / C;
  const int band = imax(band_z, band_y), n_b = imax(nx, ny);
  const int n_s = imax(nx, imax(ny, nz));
  const int lanes = imax(band_z * n_b, band_y * nx);
  const int words = imax(band_z * ny, nz * band_y) * ((nx + 31) / 32);
  ClusterSmem m;
  m.rs = 0;
  m.rel_b = align16(m.rs + 4 * (size_t)n_s);
  m.rel_a = align16(m.rel_b + 4 * (size_t)n_b);
  m.wb = align16(m.rel_a + 4 * (size_t)band);
  m.wa = align16(m.wb + 8 * 2 * (size_t)n_b);
  m.bits = align16(m.wa + 8 * 2 * (size_t)band);
  m.rowp = align16(m.bits + 4 * (size_t)words);
  m.carry = align16(m.rowp + 8 * 2 * (size_t)(band + 3));
  m.tmp = align16(m.carry + 2 * (size_t)lanes);
  m.stage = align16(m.tmp + 2 * 2 * (size_t)lanes);
  m.total = align16(m.stage + 2 * (size_t)STAGE_PITCH * band_z * ny);
  return m;
}

// Tap weights of plane p for lane i of the block: B lane i < nB, else its
// own A row i - nB; packed as 4 bf16 (each weight is bf16-rounded, so its
// upper 16 bits are the bf16).
__device__ __forceinline__ void plane_weights(const float* rs, const float* rel_b,
                                              const float* rel_a, int p, int i, int nB,
                                              uint2* wb, uint2* wa) {
  float w[4];
  tap_weights(rs[p], i < nB ? rel_b[i] : rel_a[i - nB], w);
  const uint2 packed =
      make_uint2((__float_as_uint(w[0]) >> 16) | (__float_as_uint(w[1]) & 0xffff0000u),
                 (__float_as_uint(w[2]) >> 16) | (__float_as_uint(w[3]) & 0xffff0000u));
  if (i < nB)
    wb[i] = packed;
  else
    wa[i - nB] = packed;
}

__device__ __forceinline__ void unpack_weights(uint2 p, float* w) {
  w[0] = __uint_as_float(p.x << 16);
  w[1] = __uint_as_float(p.x & 0xffff0000u);
  w[2] = __uint_as_float(p.y << 16);
  w[3] = __uint_as_float(p.y & 0xffff0000u);
}

// K4: cluster c = blockIdx.x / C sweeps cone c (x+, x-, y+, y-, z+, z-);
// block rank k of the cluster owns the A rows [k nA / C, (k + 1) nA / C).
__global__ void __launch_bounds__(CLUSTER_THREADS)
    cone_cluster_kernel(const uint8_t* __restrict__ opaque, const float* __restrict__ rel_x,
                        const float* __restrict__ rel_y, const float* __restrict__ rel_z,
                        float* __restrict__ T, int nz, int ny, int nx) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cone = blockIdx.x / C;
  const int axis = cone >> 1;
  const bool back = cone & 1;
  const Cone g = cone_of(axis, rel_x, rel_y, rel_z, nz, ny, nx);
  const int nS = g.nS, nA = g.nA, nB = g.nB;
  const int a0 = rank * nA / C, band = (rank + 1) * nA / C - a0;
  const int band_max = (nA + C - 1) / C;  // the tmp rows of every block of the cluster
  const int lanes = band * nB;
  const int nwx = (nx + 31) / 32;
  const int tid = threadIdx.x, nthr = blockDim.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ClusterSmem m = cluster_smem(nz, ny, nx, C);
  float* rs = reinterpret_cast<float*>(smem_raw + m.rs);        // [nS] signed rel_s a plane
  float* rel_b = reinterpret_cast<float*>(smem_raw + m.rel_b);  // [nB]
  float* rel_a = reinterpret_cast<float*>(smem_raw + m.rel_a);  // [band], own rows
  uint2* wb = reinterpret_cast<uint2*>(smem_raw + m.wb);        // [2][nB] by plane parity
  uint2* wa = reinterpret_cast<uint2*>(smem_raw + m.wa);        // [2][band]
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem_raw + m.bits);
  const __nv_bfloat16** rowp = reinterpret_cast<const __nv_bfloat16**>(smem_raw + m.rowp);
  __nv_bfloat16* carry = reinterpret_cast<__nv_bfloat16*>(smem_raw + m.carry);  // [band][nB]
  __nv_bfloat16* tmp = reinterpret_cast<__nv_bfloat16*>(smem_raw + m.tmp);  // [2][band_max][nB]
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw + m.stage);
  // --- prologue: offsets, plane 0's weights, opacity bits, carry, the A
  // pass's row pointers, all in shared memory
  for (int i = tid; i < nS + nB + band; i += nthr) {
    if (i < nS) {
      const int s = back ? nS - 1 - i : i;
      rs[i] = back ? -g.rel_s[s] : g.rel_s[s];
    } else if (i < nS + nB) {
      rel_b[i - nS] = g.rel_b[i - nS];
    } else {
      rel_a[i - nS - nB] = g.rel_a[a0 + i - nS - nB];
    }
  }
  // opacity rows (z, y) of this block as bits, 32 voxels of x a word: the
  // band's z rows and every y (x/y cones), or every z and the band's y rows
  // (z cones).  For each z those rows are one run of bytes, read in aligned
  // 16-byte loads, 4 in flight a thread; the opaque voxels are OR-ed in.
  const int rz = axis < 2 ? band : nz, ry = axis < 2 ? ny : band;
  const int z0 = axis < 2 ? a0 : 0, y0 = axis < 2 ? 0 : a0;
  const int n_words = rz * ry * nwx;
  for (int w = tid; w < n_words; w += nthr) bits[w] = 0u;
  __syncthreads();
  const long run = (long)ry * nx;
  const int n16 = (int)((run + 30) / 16);  // 16-byte words a run spans at most
  constexpr int IN_FLIGHT = 4;
  for (int q0 = tid; q0 < rz * n16; q0 += IN_FLIGHT * nthr) {
    uint4 v[IN_FLIGHT];
    long first[IN_FLIGHT];  // byte offset of each load's first byte in its run
    int zr[IN_FLIGHT];
#pragma unroll
    for (int k = 0; k < IN_FLIGHT; ++k) {
      const int q = q0 + k * nthr;
      zr[k] = q / n16;
      const uint8_t* base = opaque + ((size_t)(z0 + zr[k]) * ny + y0) * nx;
      const uintptr_t lo = reinterpret_cast<uintptr_t>(base) & ~(uintptr_t)15;
      first[k] = (long)(lo - reinterpret_cast<uintptr_t>(base)) + 16L * (q - zr[k] * n16);
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (q < rz * n16 && first[k] < run)
        v[k] = *reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(lo) +
                                               16L * (q - zr[k] * n16));
    }
#pragma unroll
    for (int k = 0; k < IN_FLIGHT; ++k) {
      const uint32_t w4[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      for (int j = 0; j < 16; ++j) {
        const long off = first[k] + j;
        if (((w4[j >> 2] >> (8 * (j & 3))) & 0xffu) == 0u || off < 0 || off >= run) continue;
        const int r = (int)(off / nx), x = (int)(off - (long)r * nx);
        atomicOr(&bits[(zr[k] * ry + r) * nwx + (x >> 5)], 1u << (x & 31));
      }
    }
  }
  for (int i = tid; i < lanes; i += nthr) carry[i] = __float2bfloat16_rn(1.0f);
  // rowp[par][k]: row a0 - 1 + k of the B-resampled plane of parity par, in
  // the shared memory of the block that owns it; NULL past the plane (1.0)
  for (int i = tid; i < 2 * (band + 3); i += nthr) {
    const int par = i / (band + 3), r = a0 - 1 + i % (band + 3);
    const __nv_bfloat16* ptr = nullptr;
    if (r >= 0 && r < nA) {
      const int owner = ((r + 1) * C - 1) / nA;
      __nv_bfloat16* local = tmp + ((size_t)par * band_max + r - owner * nA / C) * nB;
      ptr = cluster.map_shared_rank(local, owner);
    }
    rowp[i] = ptr;
  }
  __syncthreads();
  for (int i = tid; i < nB + band; i += nthr) plane_weights(rs, rel_b, rel_a, 0, i, nB, wb, wa);
  __syncthreads();

  float* Tc = T + (size_t)cone * nz * ny * nx;
  for (int p = 0; p < nS; ++p) {
    const int s = back ? nS - 1 - p : p;
    const bool seed = rs[p] <= 1.0f;
    const int par = p & 1;
    __nv_bfloat16* tb = tmp + (size_t)par * band_max * nB;
    const uint2* wbp = wb + par * nB;
    const uint2* wap = wa + par * band;
    // pass 1: resample the own carry rows along B
    for (int i = tid; i < lanes; i += nthr) {
      const int al = i / nB, b = i - al * nB;
      float w[4];
      unpack_weights(wbp[b], w);
      tb[i] = __float2bfloat16_rn(row_b_pass(w, carry + al * nB, b, nB));
    }
    cluster.sync();  // every block's B-resampled rows of this plane are ready
    // pass 2: resample along A (rows a - 1 .. a + 2, some in the
    // neighbours' shared memory), seed, T, attenuate into the carry
    const __nv_bfloat16* const* rows = rowp + par * (band + 3);
    for (int i = tid; i < lanes; i += nthr) {
      const int al = i / nB, b = i - al * nB;
      float t = 1.0f;
      if (!seed) {
        float w[4], v[4];
        unpack_weights(wap[al], w);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const __nv_bfloat16* src = rows[al + d];
          v[d] = src != nullptr ? __bfloat162float(src[b]) : 1.0f;
        }
        t = round_bf16(lerp4(w, v[0], v[1], v[2], v[3]));
      }
      int x, word;
      if (axis == 0) {  // (z, y) = (a, b), x = s
        x = s;
        word = (al * ny + b) * nwx;
      } else if (axis == 1) {  // (z, y) = (a, s), x = b
        x = b;
        word = (al * ny + s) * nwx;
      } else {  // (z, y) = (s, a), x = b
        x = b;
        word = (s * band + al) * nwx;
      }
      const bool op = (bits[word + (x >> 5)] >> (x & 31)) & 1u;
      if (axis == 0)
        stage[i * STAGE_PITCH + p % STAGE] = __float2bfloat16_rn(t);  // bf16-exact
      else
        Tc[(size_t)s * g.st_s + (size_t)(a0 + al) * g.st_a + (size_t)b * g.st_b] = t;
      carry[i] = __float2bfloat16_rn(op ? 0.0f : t);
    }
    // the next plane's weights, off the recurrence, by the highest threads
    // (idle in the passes above where the block has fewer lanes)
    if (p + 1 < nS)
      for (int i = nthr - 1 - tid; i < nB + band; i += nthr)
        plane_weights(rs, rel_b, rel_a, p + 1, i, nB, wb + (par ^ 1) * nB,
                      wa + (par ^ 1) * band);
    __syncthreads();  // the carry, the staged planes and the weights complete
    if (axis == 0 && (p % STAGE == STAGE - 1 || p == nS - 1)) {
      // each lane's staged planes as one run along x (descending for x-);
      // the next plane's A pass rewrites `stage` only after its cluster
      // barrier, which every thread reaches after this loop
      const int p0 = p - p % STAGE, cnt = p - p0 + 1;
      for (int i = tid; i < lanes * STAGE; i += nthr) {
        const int l = i / STAGE, j = i - l * STAGE;
        if (j >= cnt) continue;
        const int al = l / nB, b = l - al * nB;
        const int sj = back ? nS - 1 - (p0 + j) : p0 + j;
        Tc[(size_t)(a0 + al) * g.st_a + (size_t)b * g.st_b + sj] =
            __bfloat162float(stage[l * STAGE_PITCH + j]);
      }
    }
  }
  cluster.sync();  // no block leaves while a neighbour may read its rows
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
      const float t = slab_a_pass(wa, tmp_in, lo, hi, a, nzl, row, col + b, seed);
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
    tmp_out[a * row + col + b] = __float2bfloat16_rn(row_b_pass(wb, crow, b, nB));
  }
}

// K15b-4b: launch k of the transposed z cones on a shard's nyl rows of the
// padded window y.  One block per (cone, local row a), one thread per x
// lane.  A phase (k >= 1, plane k - 1 of the cone): the y resample of the
// x-resampled rows (tmp_in, `lo` below the slab, `hi` above; NULL = 1.0,
// the global edge), the seed, the T write and the carry row.  B phase
// (plane k): the x resample of the carry row into tmp_out, rows at or past
// pin_from set to bf16 1.0.  tmp / lo / hi rows are [2][wx] bf16.
__global__ void __launch_bounds__(LAT_THREADS)
    cone_zt_kernel(const uint8_t* __restrict__ opaque, const float* __restrict__ rel_x,
                   const float* __restrict__ rel_y, const float* __restrict__ rel_z,
                   const __nv_bfloat16* __restrict__ tmp_in,
                   const __nv_bfloat16* __restrict__ lo, const __nv_bfloat16* __restrict__ hi,
                   __nv_bfloat16* __restrict__ tmp_out, float* __restrict__ T, int nz, int nyl,
                   int wx, int pin_from, int k) {
  const int cone = blockIdx.x;  // z+, z-
  const int a = blockIdx.y;
  const bool back = cone & 1;
  const size_t row = 2 * (size_t)wx;  // elements per row of tmp / lo / hi
  const size_t col = (size_t)cone * wx;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* crow = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [wx]

  if (k == 0) {
    for (int b = threadIdx.x; b < wx; b += blockDim.x) crow[b] = __float2bfloat16_rn(1.0f);
  } else {
    const int s = back ? nz - k : k - 1;
    const float rs = back ? -rel_z[s] : rel_z[s];
    const bool seed = rs <= 1.0f;
    float wa[4];
    tap_weights(rs, rel_y[a], wa);
    float* Tc = T + (size_t)cone * nz * nyl * wx;
    for (int b = threadIdx.x; b < wx; b += blockDim.x) {
      const float t = slab_a_pass(wa, tmp_in, lo, hi, a, nyl, row, col + b, seed);
      const size_t g = ((size_t)s * nyl + a) * wx + b;
      Tc[g] = t;
      crow[b] = __float2bfloat16_rn(opaque[g] ? 0.0f : t);
    }
  }
  __syncthreads();
  if (k == nz) return;
  const int s = back ? nz - 1 - k : k;
  const float rs = back ? -rel_z[s] : rel_z[s];
  const bool pinned = a >= pin_from;
  for (int b = threadIdx.x; b < wx; b += blockDim.x) {
    float q = 1.0f;
    if (!pinned) {
      float wb[4];
      tap_weights(rs, rel_x[b], wb);
      q = row_b_pass(wb, crow, b, wx);
    }
    tmp_out[a * row + col + b] = __float2bfloat16_rn(q);
  }
}

// K15b-4a: one round of the pipelined z cones on a shard's nzl planes: the
// one-block z-cone loop (A = y, B = x), cone 0 ascending and cone 1 descending,
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

}  // namespace

// opaque: device uint8 (nz, ny, nx); rel_*: device f32 voxel-centre offsets
// from the sensor; T: device f32 [6, nz, ny, nx].  Each cone runs on a
// cluster of CONE_CLUSTER blocks (non-portable); clusters the card cannot
// hold at once run one after another.  Returns cudaGetLastError(), or the
// refusal of a cluster the card cannot schedule at all (never another
// launch).
VOFOD_API int vofod_cone_sweep(const void* opaque, const void* rel_x, const void* rel_y,
                               const void* rel_z, void* T, int nz, int ny, int nx,
                               void* stream) {
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(nz, ny, nx, CONE_CLUSTER).total;
  if (smem > 232448) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(cone_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(cone_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CONE_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(6 * CONE_CLUSTER);
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, cone_cluster_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, cone_cluster_kernel, static_cast<const uint8_t*>(opaque),
                         static_cast<const float*>(rel_x), static_cast<const float*>(rel_y),
                         static_cast<const float*>(rel_z), static_cast<float*>(T), nz, ny, nx);
  if (e != cudaSuccess) return (int)e;
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

// K15b-4b, launch k (0 <= k <= nz).  opaque: device uint8 [nz, nyl, wx], the
// shard's rows of the padded window after the all_to_all; rel_x [wx], rel_y
// [nyl] (the shard's rows), rel_z [nz] (the global column): device f32;
// tmp_in / tmp_out: device bf16 [nyl][2][wx] (tmp_in unused at k == 0); lo
// [1][2][wx] and hi [2][2][wx]: the received rows, NULL = 1.0; T: device
// f32 [2, nz, nyl, wx]; pin_from: the first local row at or past wy.
VOFOD_API int vofod_cone_sweep_zt(const void* opaque, const void* rel_x, const void* rel_y,
                                  const void* rel_z, const void* tmp_in, const void* lo,
                                  const void* hi, void* tmp_out, void* T, int nz, int nyl,
                                  int wx, int pin_from, int k, void* stream) {
  if (nz < 1 || nyl < 2 || wx < 1 || k < 0 || k > nz || pin_from < 0 ||
      (k > 0 && tmp_in == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = wx >= LAT_THREADS ? LAT_THREADS : ((wx + 31) / 32) * 32;
  cone_zt_kernel<<<dim3(2, nyl), threads, (size_t)wx * sizeof(__nv_bfloat16),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(opaque), static_cast<const float*>(rel_x),
      static_cast<const float*>(rel_y), static_cast<const float*>(rel_z),
      static_cast<const __nv_bfloat16*>(tmp_in), static_cast<const __nv_bfloat16*>(lo),
      static_cast<const __nv_bfloat16*>(hi), static_cast<__nv_bfloat16*>(tmp_out),
      static_cast<float*>(T), nz, nyl, wx, pin_from, k);
  return (int)cudaGetLastError();
}
